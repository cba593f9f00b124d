"""`ceph` CLI: the admin command surface over a durable cluster.

Analog of the reference's `ceph` tool verbs (reference: src/ceph.in →
mon/mgr command handlers): `-s`/`status` (now with the PGMap rate lines
— client IO B/s and op/s, recovery B/s — and the health-mute state),
`health [detail]`, `health mute|unmute <KEY>` (persisted in the cluster
meta like the mon's mutes), `top` (live rate/queue/health digest;
``--iterations``/``--interval`` pace it), `flight dump` (capture an
anomaly flight-recorder bundle), `osd tree` (the CRUSH hierarchy with
weights/status, OSDMonitor's 'osd tree' dump shape), `osd df`,
`pg dump` (PGMap's per-PG table: state, objects, log version,
up/acting), `df`.  Like the rados CLI, every invocation reopens the
FileStore-backed cluster under ``--data-dir`` — boot peering and log
replay included — so the admin view reflects exactly what is durable.

    python -m ceph_tpu_torch.tools.ceph_cli --data-dir D status
    python -m ceph_tpu_torch.tools.ceph_cli --data-dir D health mute SLOW_OPS
    python -m ceph_tpu_torch.tools.ceph_cli --data-dir D top --iterations 3

The port's copy of ``ceph_tpu.tools.ceph_cli``: every verb, over the
port's ``MiniCluster.load``.  ``device roofline`` shows the launch
ledger's rows of THIS process (the kernels its reopen and verb ran);
``device profile start|stop`` need the live process's admin socket.
"""
from __future__ import annotations

import argparse
import sys
import time


def render_osd_tree(cluster) -> str:
    """The 'ceph osd tree' table from the live CRUSH map + OSDMap:
    WEIGHT is the CRUSH weight everywhere (leaves sum to their bucket),
    REWEIGHT is the osdmap 16.16 override — the reference's two columns."""
    cmap = cluster.osdmap.crush
    lines = ["ID    WEIGHT    REWEIGHT  TYPE NAME                 STATUS"]
    # shadow (per-class clone) trees stay hidden, like the reference's
    # 'osd tree' without --show-shadow (CrushWrapper find_nonshadow_roots)
    roots = [bid for bid in cmap.buckets
             if not any(bid in b.items for b in cmap.buckets.values())
             and not cmap.is_shadow(bid)]

    def walk(item: int, depth: int, crush_w: float) -> None:
        indent = "    " * depth
        if item >= 0:
            st = "up" if cluster.osdmap.is_up(item) else "down"
            if cluster.osdmap.is_out(item):
                st += "/out"
            rw = cluster.osdmap.osd_weight[item] / 0x10000
            lines.append(f"{item:>4}  {crush_w:8.5f}  {rw:8.5f}  "
                         f"{indent}osd.{item:<12} {st}")
            return
        b = cmap.buckets[item]
        tname = cmap.type_names.get(b.type, str(b.type))
        name = cmap.item_names.get(item, f"{tname}-{-item}")
        weight = sum(b.item_weights) / 0x10000
        lines.append(f"{item:>4}  {weight:8.5f}  {'-':>8}  "
                     f"{indent}{tname} {name}")
        for child, w in zip(b.items, b.item_weights):
            walk(child, depth + 1, w / 0x10000)

    for root in sorted(roots, reverse=True):
        walk(root, 0, 0.0)
    return "\n".join(lines)


def render_pg_dump(cluster) -> str:
    """PGMap's per-PG table (the 'ceph pg dump' brief shape)."""
    lines = ["PG_ID     STATE             OBJECTS  LOG   UP/ACTING  PRIMARY"]
    for pid, pool in sorted(cluster.pools.items()):
        for ps, g in sorted(pool["pgs"].items()):
            state = cluster.pg_state(g)
            n_obj = len(g.backend._local_oids())
            lines.append(
                f"{pid}.{ps:<7} {state:<17} {n_obj:>7}  "
                f"{g.backend.pg_log.head:<5} {str(g.acting):<10} "
                f"{g.backend.whoami}")
    return "\n".join(lines)


def main(argv=None) -> int:
    # '-s' is the classic status alias; argparse would eat it as an
    # unknown option before the positional, so translate it up front
    argv = [{"-s": "status", "-w": "watch"}.get(a, a)
            for a in (sys.argv[1:] if argv is None else list(argv))]
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("--data-dir")
    ap.add_argument("--connect", metavar="HOST:PORT",
                    help="talk to a live cluster process over TCP "
                         "(status/health/df)")
    ap.add_argument("--keyring",
                    help="client.admin keyring (default: "
                         "<data-dir>/client.admin.keyring)")
    ap.add_argument("--iterations", type=int, default=1,
                    help="top/watch/daemonperf: refresh rounds "
                         "(watch: 0 = follow forever)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="top/watch/daemonperf: seconds between rounds")
    ap.add_argument("cmd", nargs="+",
                    help="status | -s | health [detail] | "
                         "health mute|unmute KEY | top | daemonperf | "
                         "log last [N] | watch | -w | flight dump | "
                         "slo status | slo dump | "
                         "device roofline | device profile status | "
                         "osd pool set POOL KEY VALUE | heat top [N] | "
                         "tier status | osd tree | osd df | pg dump | df")
    args = ap.parse_args(argv)

    import os
    if args.connect:
        return _run_remote(args)
    if args.data_dir is None:
        ap.error("--data-dir is required (or --connect for remote mode)")
    if args.cmd[0] == "watch":
        # `ceph -w`: follow the persisted clusterlog FILE — no cluster
        # reopen (a live process may hold the stores; the log file is
        # the one surface both can share)
        return _run_watch(os.path.join(args.data_dir, "clusterlog"),
                          args.iterations, args.interval)
    from ..cluster import MiniCluster
    if not os.path.exists(os.path.join(args.data_dir, "cluster_meta.pkl")):
        print(f"error: no cluster at {args.data_dir}", file=sys.stderr)
        return 2
    c = MiniCluster.load(args.data_dir)
    try:
        cmd = " ".join(args.cmd)
        if cmd in ("status", "-s"):
            print(_fmt_status(c.status(), c.health()))
        elif cmd in ("health", "health detail"):
            if cmd == "health detail":
                # ONE evaluation serves both the status line and the
                # detail listing (two would re-walk every pool/PG and
                # could disagree if state moved between them)
                from ..mgr.health import thin_view
                ev = c.health_detail()
                _print_health(thin_view(ev), True, detail_ev=ev)
            else:
                _print_health(c.health(), False)
        elif len(args.cmd) == 3 and args.cmd[0] == "health" and \
                args.cmd[1] in ("mute", "unmute"):
            key = args.cmd[2]
            if args.cmd[1] == "mute":
                if key not in c.health_engine.registered():
                    print(f"warning: {key!r} is not a registered check "
                          f"(muting anyway)", file=sys.stderr)
                c.mute_health(key)      # mute + persist in one step
            else:
                c.unmute_health(key)
            print(f"{args.cmd[1]}d {key}")
        elif cmd == "top":
            _run_top(c, args.iterations, args.interval)
        elif cmd == "daemonperf":
            _run_daemonperf(c, args.iterations, args.interval)
        elif args.cmd[0] == "log" and len(args.cmd) >= 2 and \
                args.cmd[1] == "last":
            n = int(args.cmd[2]) if len(args.cmd) > 2 else 20
            from ..common.clusterlog import format_entry
            for e in c.clusterlog.last(n):
                print(format_entry(e))
        elif cmd in ("slo status", "slo dump"):
            # the admin-socket fns fold the tracer ring first, so the
            # table reflects every trace this (reopened) process ran;
            # a live process's `slo status` sees the full history
            out = c.cct.admin_socket.call(cmd)
            if cmd == "slo dump":
                import json as _json
                print(_json.dumps(out, indent=2, default=str))
            else:
                from ..mgr.slo import render_status
                print(render_status(out))
        elif cmd == "device roofline":
            from ..common import roofline
            print(roofline.render_table(roofline.report(cct=c.cct)))
        elif args.cmd[:2] == ["device", "profile"]:
            sub = args.cmd[2] if len(args.cmd) > 2 else "status"
            if sub != "status":
                # a profiler window is PROCESS-scoped state: this CLI
                # reopens the cluster per invocation, so a window opened
                # here would be force-closed on exit before any work ran,
                # and a later 'stop' would land in a fresh process that
                # never saw it.  Only the live process's admin socket can
                # span start..work..stop.
                print("error: 'device profile start|stop' needs the LIVE "
                      "process — call 'device profile start' on its "
                      "admin socket (in-process or via 'rados serve'); "
                      "this reopen-per-invocation CLI can only report "
                      "'device profile status' (on-disk captures)",
                      file=sys.stderr)
                return 2
            import json as _json
            print(_json.dumps(c.profiler.status(), indent=2,
                              default=str))
        elif cmd == "flight dump":
            b = c.flight.dump(reason="cli", force=True)
            print(f"captured flight bundle seq={b['seq']} "
                  f"reason={b['reason']}"
                  + (f" -> {b['path']}" if "path" in b else ""))
        elif cmd == "osd tree":
            print(render_osd_tree(c))
        elif cmd == "osd df":
            from ..backend.pg_backend import PG_META, shard_store
            for o in range(c.n_osds):
                n_obj = 0
                for p in c.pools.values():
                    for g in p["pgs"].values():
                        if o not in g.bus.handlers:
                            continue
                        n_obj += sum(1 for gobj in
                                     shard_store(g.bus, o).list_objects()
                                     if gobj.shard == o
                                     and gobj.oid != PG_META)
                st = "up" if c.osdmap.is_up(o) else "down"
                print(f"osd.{o:<4} {st:<6} {n_obj} shard objects")
        elif args.cmd[:3] == ["osd", "pool", "set"] and len(args.cmd) == 6:
            # `ceph osd pool set <pool> <key> <value>` — live-tunable pool
            # params; hit_set_* keys re-arm the hit-set engines in place
            name, key, value = args.cmd[3:]
            if name not in c.pool_ids:
                print(f"error: no pool {name!r}", file=sys.stderr)
                return 2
            c.pool_set(c.pool_ids[name], key, value)
            print(f"set pool {name} {key} to {value}")
        elif args.cmd[:2] == ["heat", "top"]:
            n = int(args.cmd[2]) if len(args.cmd) > 2 else 20
            rows = c.cct.admin_socket.call("heat top", n=n)["top"]
            print("POOL/OID                       TEMPERATURE")
            for r in rows:
                print(f"{r['pool']}/{r['oid']:<28} {r['temperature']}")
        elif cmd == "tier status":
            import json as _json
            try:
                print(_json.dumps(c.cct.admin_socket.call(cmd),
                                  indent=2, default=str))
            except KeyError:
                # the admin command registers with the first
                # create_tier — a tier is a RUNTIME binding, so a
                # reopened CLI process has none until one is bound
                print("no cache tiers bound in this process "
                      "(bind one with MiniCluster.create_tier)",
                      file=sys.stderr)
                return 2
        elif cmd == "pg dump":
            print(render_pg_dump(c))
        elif cmd == "df":
            from ..osd.primary_log_pg import is_clone_oid
            st = c.status()
            for name, pid in sorted(c.pool_ids.items()):
                # user objects only: after a reload the bookkeeping also
                # carries snapshot clone oids (same filter rados ls uses)
                n = sum(1 for oid in c.objects.get(pid, ())
                        if not is_clone_oid(oid))
                print(f"pool {name:<12} id {pid}  objects {n}")
            print(f"total: {st['pgmap']['num_pgs']} pgs on "
                  f"{st['osdmap']['num_osds']} osds")
        else:
            print(f"error: unknown command {cmd!r}", file=sys.stderr)
            return 2
        return 0
    finally:
        c.shutdown()


def _health_line(h: dict) -> str:
    """`HEALTH_X (muted: A, B)` — ONE rendering of status + mute state
    for every surface (status header, health verb, top)."""
    status = h["status"]
    if h.get("muted"):
        status += f" (muted: {', '.join(sorted(h['muted']))})"
    return status


def _print_health(h: dict, detail: bool, detail_ev: dict | None = None
                  ) -> None:
    print(_health_line(h))
    if detail:
        if detail_ev is not None:       # rich engine evaluation (local)
            for key, c in sorted(detail_ev["checks"].items()):
                mute = " (MUTED)" if c["muted"] else ""
                print(f"[{c['severity']}] {key}{mute}: {c['summary']}")
                for line in c["detail"]:
                    print(f"    {line}")
        else:                           # thin view (remote mode)
            for key, msg in sorted(h["checks"].items()):
                print(f"[{key}] {msg}")


def _fmt_bytes_s(v: float) -> str:
    for unit in ("B/s", "KiB/s", "MiB/s", "GiB/s"):
        if v < 1024 or unit == "GiB/s":
            return f"{v:.1f} {unit}" if unit != "B/s" else f"{v:.0f} B/s"
        v /= 1024.0
    return f"{v:.1f} GiB/s"             # pragma: no cover


def _fmt_io_lines(rates: dict | None) -> str:
    """The 'io:' section (PGMap overall_client_io_rate_summary shape);
    recovery shows only when active, like the reference."""
    if not rates:
        return ""
    cl = rates["client_io"]
    lines = [f"    client:   {_fmt_bytes_s(cl['rd_bytes_s'])} rd, "
             f"{_fmt_bytes_s(cl['wr_bytes_s'])} wr, "
             f"{cl['rd_op_s']:.0f} op/s rd, {cl['wr_op_s']:.0f} op/s wr"]
    rec = rates["recovery"]
    queued = int(rec.get("queued_pgs", 0))
    active = int(rec.get("active_pgs", 0))
    if rec["bytes_s"] or rec["op_s"] or queued or active:
        line = (f"    recovery: {_fmt_bytes_s(rec['bytes_s'])}, "
                f"{rec['op_s']:.0f} obj/s")
        if queued or active:
            line += f" ({active} pgs recovering, {queued} queued)"
        lines.append(line)
    srv = rates["serving"]
    if srv["op_s"]:
        lines.append(f"    serving:  {srv['op_s']:.0f} op/s in "
                     f"{srv['batch_s']:.0f} batch/s, "
                     f"{_fmt_bytes_s(srv['bytes_s'])}")
    return "\n  io:\n" + "\n".join(lines)


def _fmt_status(st: dict, h: dict) -> str:
    states = ", ".join(f"{n} {s}" for s, n in
                       sorted(st["pgmap"]["pgs_by_state"].items()))
    # the recovery scheduler's block (queued/recovering PG jobs and
    # reservation occupancy), present only when a scheduler is attached
    rec = st["pgmap"].get("recovery")
    rec_line = ""
    if rec and (rec["queued_pgs"] or rec["active_pgs"] or
                rec["reservations"]["granted"] or
                rec["reservations"]["queued"]):
        rec_line = (f"\n    recovery: {rec['active_pgs']} pgs "
                    f"recovering, {rec['queued_pgs']} queued; "
                    f"reservations: {rec['reservations']['granted']} "
                    f"in-flight, {rec['reservations']['queued']} waiting")
    return (f"  cluster:\n    health: {_health_line(h)}\n"
            f"  services:\n"
            f"    osd: {st['osdmap']['num_osds']} osds: "
            f"{st['osdmap']['num_up_osds']} up "
            f"(epoch {st['osdmap']['epoch']})\n"
            f"  data:\n"
            f"    pools:   {st['pgmap']['num_pools']} pools, "
            f"{st['pgmap']['num_pgs']} pgs\n"
            f"    pgs:     {states}"
            + rec_line
            + _fmt_io_lines(st["pgmap"].get("io_rates")))


def render_top(c) -> str:
    """One `ceph top` frame: health, rate digest, throttle
    occupancy, launch-key churn (jit), daemon queue depth — the operator's
    is-it-moving-right-now view."""
    c.stats.sample()
    d = c.stats.digest()
    h = c.health()
    lines = [f"health: {_health_line(h)}"
             + (f"  checks: {', '.join(sorted(h['checks']))}"
                if h["checks"] else ""),
             f"window: {d['window_s']:.1f}s over {d['samples']} samples"]
    cl = d["client_io"]
    lines.append(f"client io: {_fmt_bytes_s(cl['rd_bytes_s'])} rd, "
                 f"{_fmt_bytes_s(cl['wr_bytes_s'])} wr, "
                 f"{cl['rd_op_s']:.0f}/{cl['wr_op_s']:.0f} op/s rd/wr")
    rec = d["recovery"]
    rec_line = (f"recovery:  {_fmt_bytes_s(rec['bytes_s'])}, "
                f"{rec['op_s']:.0f} obj/s")
    if getattr(c, "recovery", None) is not None:
        s = c.recovery.summary()
        rec_line += (f", {s['active_pgs']} pgs recovering / "
                     f"{s['queued_pgs']} queued, "
                     f"{s['reservations']['granted']} reservations "
                     f"in-flight")
    lines.append(rec_line)
    lines.append(f"serving:   {d['serving']['op_s']:.0f} op/s, "
                 f"{d['serving']['batch_s']:.0f} batch/s")
    w = d["wire"]
    if w["tx_bytes_s"] or w["tx_msgs_s"]:
        lines.append(f"wire:      {_fmt_bytes_s(w['tx_bytes_s'])} tx, "
                     f"{w['tx_msgs_s']:.0f} msg/s")
    lines.append(f"jit:       {d['jit']['compiles']:.0f} compiles, "
                 f"{d['jit']['cache_hits']:.0f} cache hits (window)")
    from ..mgr.health import iter_throttles
    throttles = [f"{name.removeprefix('throttle.')}={int(val)}/{int(mx)}"
                 for name, val, mx in iter_throttles(c.cct)]
    if throttles:
        lines.append("throttles: " + " ".join(throttles))
    depths = {o: sum(sum(cls.values()) for cls in
                     daemon.queue_depths().values())
              for o, daemon in sorted(c.osds.items())}
    busy = {o: n for o, n in depths.items() if n}
    if busy:
        lines.append("queues:    " + " ".join(
            f"osd.{o}={n}" for o, n in sorted(busy.items())))
    return "\n".join(lines)


def _run_top(c, iterations: int, interval: float) -> None:
    for i in range(max(1, iterations)):
        if i:
            time.sleep(interval)
            print()
        print(render_top(c))


def _run_watch(path: str, iterations: int, interval: float) -> int:
    """`ceph -w`: print the clusterlog tail, then follow the FILE for
    appends (another process's MiniCluster writing it live).
    ``iterations=0`` follows forever; N bounds the poll rounds (tests,
    scripts)."""
    import os
    from ..common.clusterlog import format_entry, read_log_file
    if not os.path.exists(path):
        print(f"error: no clusterlog at {path} (cluster never ran "
              f"durable, or nothing logged yet)", file=sys.stderr)
        return 2
    entries = read_log_file(path)
    for e in entries[-10:]:
        print(format_entry(e), flush=True)
    seen = max((e.get("seq", 0) for e in entries), default=0)
    rounds = 0
    while iterations <= 0 or rounds < iterations:
        rounds += 1
        time.sleep(interval)
        for e in read_log_file(path):
            if e.get("seq", 0) > seen:
                seen = e["seq"]
                print(format_entry(e), flush=True)
    return 0


def render_daemonperf(c, prev: dict | None = None) -> tuple[str, dict]:
    """One `daemonperf` frame: per-daemon queue counter DELTAS since
    ``prev`` plus the cluster rate digest — the reference's
    ``ceph daemonperf osd.N`` columns generalized over every daemon.
    Returns (rendered text, new prev) so the caller owns the cadence."""
    c.stats.sample()
    d = c.stats.digest()
    cur = {o: dict(daemon.queue_stats) for o, daemon in sorted(c.osds.items())}
    prev = prev or {}
    lines = ["daemon   enq   deq   rej  wait_ms | "
             "wr/s   rd/s   rec_B/s   wire_B/s"]
    cluster_cols = (f"{d['client_io']['wr_op_s']:6.0f} "
                    f"{d['client_io']['rd_op_s']:6.0f} "
                    f"{d['recovery']['bytes_s']:9.0f} "
                    f"{d['wire']['tx_bytes_s']:10.0f}")
    for o, qs in cur.items():
        p = prev.get(o, {})
        enq = qs["enqueued"] - p.get("enqueued", 0)
        deq = qs["dequeued"] - p.get("dequeued", 0)
        rej = qs["throttled_rejects"] - p.get("throttled_rejects", 0)
        wait = (qs["wait_sum"] - p.get("wait_sum", 0.0)) * 1000.0
        lines.append(f"osd.{o:<4} {enq:5d} {deq:5d} {rej:5d} "
                     f"{wait:8.1f} | {cluster_cols}")
        cluster_cols = " " * len(cluster_cols)   # once per frame
    return "\n".join(lines), cur


def _run_daemonperf(c, iterations: int, interval: float) -> None:
    prev: dict | None = None
    for i in range(max(1, iterations)):
        if i:
            time.sleep(interval)
            print()
        text, prev = render_daemonperf(c, prev)
        print(text)


def _run_remote(args) -> int:
    """status/health/df against a live served cluster (TcpRados RPC)."""
    from ..net import cli_connect
    try:
        r = cli_connect(args.connect, args.keyring, args.data_dir)
    except Exception as e:        # AuthError/Unpickling/IO/Value: all
        print(f"error: {e}", file=sys.stderr)   # operator-facing
        return 2
    try:
        cmd = " ".join(args.cmd)
        if cmd in ("status", "-s"):
            print(_fmt_status(r.status(), r.call("health")))
        elif cmd in ("health", "health detail"):
            _print_health(r.call("health"), cmd == "health detail")
        elif cmd == "df":
            st = r.status()
            print(f"{st['pgmap']['num_pools']} pools, "
                  f"{st['pgmap']['num_pgs']} pgs")
        else:
            print(f"error: {cmd!r} not supported over --connect",
                  file=sys.stderr)
            return 2
        return 0
    except (IOError, KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        r.close()


if __name__ == "__main__":
    sys.exit(main())
