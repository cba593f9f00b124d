"""`rados` CLI over a durable cluster directory.

Analog of the reference's `rados` tool (reference: src/tools/rados/
rados.cc — put/get/ls/rm/stat/mksnap/rmsnap/lssnap/rollback/setxattr/
getxattr/listxattr verbs): each invocation reopens the FileStore-backed
MiniCluster under ``--data-dir`` (boot peering + log replay included),
performs one operation through the librados facade, and checkpoints on
exit — so consecutive shell commands observe each other's writes, the
way the real tool's commands do through the cluster.

    python -m ceph_tpu_torch.tools.rados_cli --data-dir D mkpool data k=4 m=2
    python -m ceph_tpu_torch.tools.rados_cli --data-dir D put data obj ./file
    python -m ceph_tpu_torch.tools.rados_cli --data-dir D ls data
    python -m ceph_tpu_torch.tools.rados_cli --data-dir D serve --port 0
    python -m ceph_tpu_torch.tools.rados_cli --connect HOST:PORT \
        --keyring D/client.admin.keyring put data obj ./file

The port's copy of ``ceph_tpu.tools.rados_cli``.  An EC pool made by
``mkpool`` carries no ``device`` key unless the profile names one, so it
runs on the card (``device=cpu`` in the profile asks for the host).
``serve`` builds or loads the card's kernels before it accepts, so a
client's first put does not wait on ``nvcc``.  ``--connect`` is a pure
client: it never initialises CUDA.
"""
from __future__ import annotations

import argparse
import sys


def warm_card() -> None:
    """Build (or load from ``ops/build/``) the EC write path's kernels and
    start CUDA before the server accepts: a cold first put would otherwise
    spend the client's per-attempt timeout waiting on ``nvcc``.  No card:
    nothing to warm (a pool without a ``device`` key then fails its first
    put, as everywhere in the port)."""
    import torch
    if not torch.cuda.is_available():
        return
    from ..ops import cuda_build
    for name in ("gf_apply", "crc32c"):
        cuda_build.load(name)
    torch.cuda.init()


def _parse_profile(parts):
    """(kv dict, replicated?) from 'k=4 m=2' / 'replicated size=3'."""
    kv = dict(p.split("=", 1) for p in parts if "=" in p)
    return kv, "replicated" in parts


def _read_input(path: str) -> bytes:
    return sys.stdin.buffer.read() if path == "-" else \
        open(path, "rb").read()


def _write_output(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        open(path, "wb").write(data)


def _fmt_df(st: dict) -> str:
    return (f"{st['pgmap']['num_pools']} pools, "
            f"{st['pgmap']['num_pgs']} pgs, "
            f"{st['osdmap']['num_up_osds']}/"
            f"{st['osdmap']['num_osds']} osds up")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("--store-backend", default="file",
                    choices=["file", "bluestore"],
                    help="durable store flavour for a NEW cluster "
                         "(bluestore: extent allocator + checksums at "
                         "rest + compression); existing clusters reopen "
                         "with their recorded backend")
    ap.add_argument("--data-dir",
                    help="durable cluster directory (local mode)")
    ap.add_argument("--connect", metavar="HOST:PORT",
                    help="talk to a LIVE cluster process over TCP "
                         "(cephx-authenticated, HMAC-secured v2 frames) "
                         "instead of reopening --data-dir")
    ap.add_argument("--keyring",
                    help="client.admin keyring path (default: "
                         "<data-dir>/client.admin.keyring)")
    ap.add_argument("--n-osds", type=int, default=9,
                    help="cluster size when creating a new directory")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mkpool")
    p.add_argument("pool")
    p.add_argument("profile", nargs="*",
                   help="k=4 m=2 ... (EC); 'replicated size=3' for a "
                        "replicated pool")
    for verb in ("put", "get"):
        p = sub.add_parser(verb)
        p.add_argument("pool")
        p.add_argument("oid")
        p.add_argument("file", help="- for stdin/stdout")
    for verb in ("rm", "stat", "listxattr", "lssnap"):
        p = sub.add_parser(verb)
        p.add_argument("pool")
        if verb in ("rm", "stat", "listxattr"):
            p.add_argument("oid")
    p = sub.add_parser("ls")
    p.add_argument("pool")
    p = sub.add_parser("setxattr")
    p.add_argument("pool"), p.add_argument("oid")
    p.add_argument("name"), p.add_argument("value")
    p = sub.add_parser("getxattr")
    p.add_argument("pool"), p.add_argument("oid"), p.add_argument("name")
    for verb in ("mksnap", "rmsnap"):
        p = sub.add_parser(verb)
        p.add_argument("pool"), p.add_argument("snap")
    p = sub.add_parser("rollback")
    p.add_argument("pool"), p.add_argument("oid"), p.add_argument("snap")
    p = sub.add_parser("df")
    p = sub.add_parser("serve", help="serve the cluster over TCP (cephx, "
                       "HMAC frames); builds or loads the card's kernels "
                       "before it accepts")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral, printed on start)")

    args = ap.parse_args(argv)
    if args.connect:
        if args.cmd == "serve":
            ap.error("serve runs the cluster locally; it cannot combine "
                     "with --connect")
        return _run_remote(args)
    if args.data_dir is None:
        ap.error("--data-dir is required (or --connect for remote mode)")

    import os
    from ..client.rados import Rados
    from ..cluster import MiniCluster
    fresh = not os.path.exists(os.path.join(args.data_dir,
                                            "cluster_meta.pkl"))
    if fresh:
        c = MiniCluster(n_osds=args.n_osds, data_dir=args.data_dir,
                        store_backend=args.store_backend)
    else:
        c = MiniCluster.load(args.data_dir)
    try:
        if args.cmd == "serve":
            from ..net import ClusterServer
            warm_card()
            server = ClusterServer(c, port=args.port)
            print(f"serving on 127.0.0.1:{server.port}", flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            server.stop()
            return 0

        if args.cmd == "mkpool":
            kv, replicated = _parse_profile(args.profile)
            if replicated:
                c.create_replicated_pool(args.pool,
                                         size=int(kv.get("size", 3)))
            else:
                c.create_ec_pool(args.pool, kv)
            print(f"pool {args.pool} created")
            return 0

        rados = Rados(c)
        if args.cmd == "df":
            print(_fmt_df(rados.cluster_stat()))
            return 0
        io = rados.open_ioctx(args.pool)
        if args.cmd == "put":
            io.write_full(args.oid, _read_input(args.file))
        elif args.cmd == "get":
            # object_info carries the exact size
            _write_output(args.file, io.read(args.oid))
        elif args.cmd == "ls":
            for oid in io.list_objects():
                print(oid)
        elif args.cmd == "rm":
            io.remove_object(args.oid)
        elif args.cmd == "stat":
            size, mtime = io.stat(args.oid)
            print(f"{args.pool}/{args.oid} size {size} mtime {mtime:.0f}")
        elif args.cmd == "setxattr":
            io.set_xattr(args.oid, args.name, args.value.encode())
        elif args.cmd == "getxattr":
            v = io.get_xattr(args.oid, args.name)
            print(v.decode() if isinstance(v, bytes) else v)
        elif args.cmd == "listxattr":
            for name in sorted(io.get_xattrs(args.oid)):
                print(name)
        elif args.cmd == "mksnap":
            sid = io.snap_create(args.snap)
            print(f"created pool {args.pool} snap {args.snap} ({sid})")
        elif args.cmd == "rmsnap":
            io.snap_remove(args.snap)
        elif args.cmd == "lssnap":
            for sid, name in sorted(io.snap_list().items()):
                print(f"{sid}\t{name}")
        elif args.cmd == "rollback":
            io.snap_rollback(args.oid, args.snap)
            print(f"rolled back {args.pool}/{args.oid} to {args.snap}")
        return 0
    except (IOError, KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        c.shutdown()


def _run_remote(args) -> int:
    """Remote mode: every verb through TcpRados over the live socket."""
    from ..net import cli_connect
    try:
        r = cli_connect(args.connect, args.keyring, args.data_dir)
    except Exception as e:        # AuthError/Unpickling/IO/Value: all
        print(f"error: {e}", file=sys.stderr)   # operator-facing
        return 2
    try:
        if args.cmd == "mkpool":
            kv, replicated = _parse_profile(args.profile)
            if replicated:
                r.mkpool(args.pool, replicated=True,
                         size=int(kv.get("size", 3)))
            else:
                r.mkpool(args.pool, profile=kv)
            print(f"pool {args.pool} created")
        elif args.cmd == "put":
            r.put(args.pool, args.oid, _read_input(args.file))
        elif args.cmd == "get":
            _write_output(args.file, r.get(args.pool, args.oid))
        elif args.cmd == "ls":
            for oid in r.ls(args.pool):
                print(oid)
        elif args.cmd == "rm":
            r.remove(args.pool, args.oid)
        elif args.cmd == "stat":
            size, mtime = r.stat(args.pool, args.oid)
            print(f"{args.pool}/{args.oid} size {size} mtime {mtime:.0f}")
        elif args.cmd == "setxattr":
            r.setxattr(args.pool, args.oid, args.name,
                       args.value.encode())
        elif args.cmd == "getxattr":
            v = r.getxattr(args.pool, args.oid, args.name)
            print(v.decode() if isinstance(v, bytes) else v)
        elif args.cmd == "df":
            print(_fmt_df(r.status()))
        else:
            print(f"error: {args.cmd!r} not supported over --connect",
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
