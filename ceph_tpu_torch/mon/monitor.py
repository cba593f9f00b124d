"""Monitor: failure reports -> map commits, the control-plane authority.

Mirror of the reference's OSDMonitor failure handling (reference:
src/mon/OSDMonitor.cc): ``prepare_failure`` collects per-target reports
(:2874-2930, ``failure_info_t.add_report``), ``check_failure`` marks a
target down once the failure has aged past the heartbeat grace AND enough
*distinct failure-domain subtrees* have reported it (:2764-2850 — reporters
are grouped by ``mon_osd_reporter_subtree_level`` so one flapping host
can't take peers down), gated by ``can_mark_down``'s nodown flag and
minimum up-ratio (:2671-2705).  Commits are OSDMap incrementals (the Paxos
``propose_pending`` analog — single-monitor here, so a commit IS quorum);
subscribers receive each new map like daemons receiving osdmap epochs.
Down OSDs age out via ``mon_osd_down_out_interval`` (tick), triggering
CRUSH remapping exactly like the reference's auto-out.

The port's copy of ``ceph_tpu.mon.monitor``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..common import Context, default_context
from ..failure.markdown import MarkDownLimiter
from ..osdmap import Incremental, OSDMap, OSD_UP, apply_incremental


@dataclass
class _FailureInfo:
    """failure_info_t: reporter -> earliest failed_since."""
    reporters: dict[int, float] = field(default_factory=dict)

    def add_report(self, reporter: int, failed_since: float) -> None:
        self.reporters.setdefault(reporter, failed_since)

    def max_failed_since(self) -> float:
        return max(self.reporters.values()) if self.reporters else 0.0


class Monitor:
    def __init__(self, osdmap: OSDMap, cct: Context | None = None):
        self.cct = cct if cct is not None else default_context()
        self.osdmap = osdmap
        self.failure_info: dict[int, _FailureInfo] = {}
        self.pending = Incremental()
        self.subscribers: list = []             # fn(new_map, inc)
        self.down_stamp: dict[int, float] = {}  # osd -> when marked down
        self.nodown: set[int] = set()
        # multi-monitor mode: when set, propose_pending hands the pending
        # Incremental to the Paxos layer instead of applying it directly
        # (the PaxosService::propose_pending split; single-mon mode keeps
        # the commit==quorum shortcut)
        self.submit_fn = None
        # flap damping (osd_markdown_log analog, failure/markdown.py): an
        # OSD marked down osd_markdown_count times within
        # osd_markdown_window stays down — boots are refused until the
        # operator clears the record (clear_markdown)
        self.markdown = MarkDownLimiter(
            count=self.cct.conf.get("osd_markdown_count"),
            window=self.cct.conf.get("osd_markdown_window"))
        # optional cluster log (clog): up/down/flap transitions land
        # where an incident reads first (MiniCluster.attach_monitor
        # wires).  In a quorum, apply_committed runs on EVERY replica;
        # clog_gate (set per replica) keeps only the current leader
        # logging so one commit is one line, not n_mons lines.
        self.clog = None
        self.clog_gate = None
        self._flap_logged: set[int] = set()

    def _clog(self):
        """The cluster log iff this monitor should speak (single-mon:
        always; quorum member: only while leader)."""
        if self.clog is not None and \
                (self.clog_gate is None or self.clog_gate()):
            return self.clog
        return None

    # -- failure reports (OSDMonitor.cc:2874) ------------------------------

    def prepare_failure(self, target: int, reporter: int,
                        failed_since: float, now: float) -> bool:
        """One OSD reporting a peer failed.  Returns True when the report
        pushed the target over the down threshold (committed on the next
        propose/tick)."""
        if not self.osdmap.is_up(target):
            return False
        fi = self.failure_info.setdefault(target, _FailureInfo())
        fi.add_report(reporter, failed_since)
        if self.can_mark_down(target):
            return self.check_failure(now, target)
        return False

    def cancel_failure(self, target: int, reporter: int) -> None:
        """A peer heard from the target again (:2911-2930)."""
        fi = self.failure_info.get(target)
        if fi is None:
            return
        fi.reporters.pop(reporter, None)
        if not fi.reporters:
            del self.failure_info[target]

    def can_mark_down(self, osd: int) -> bool:
        """(:2671-2705): nodown flag + minimum up ratio."""
        if osd in self.nodown:
            return False
        num = self.osdmap.max_osd
        if num == 0:
            return False
        pending_down = sum(
            1 for o, st in self.pending.new_state.items()
            if st & OSD_UP and self.osdmap.is_up(o))
        up = sum(1 for o in range(num) if self.osdmap.is_up(o)) - pending_down
        return (up / num) >= self.cct.conf.get("mon_osd_min_up_ratio")

    def check_failure(self, now: float, target: int) -> bool:
        """(:2764-2850): grace + distinct reporter subtrees."""
        if (self.pending.new_state.get(target, 0) & OSD_UP):
            return True                          # already pending
        fi = self.failure_info.get(target)
        if fi is None or not fi.reporters:
            return False
        failed_for = now - fi.max_failed_since()
        grace = self.cct.conf.get("osd_heartbeat_grace")
        level = self.cct.conf.get("mon_osd_reporter_subtree_level")
        subtrees = set()
        for reporter in fi.reporters:
            loc = self.osdmap.crush.get_full_location(reporter)
            subtrees.add(loc.get(level, f"osd.{reporter}"))
        if (failed_for >= grace and
                len(subtrees) >=
                self.cct.conf.get("mon_osd_min_down_reporters")):
            self.pending.new_state[target] = \
                self.pending.new_state.get(target, 0) | OSD_UP
            self.cct.dout("osd", 1,
                          f"osd.{target} failed ({len(subtrees)} reporters "
                          f"from different {level} after {failed_for:.1f} "
                          f">= grace {grace})")
            return True
        return False

    # -- boots / outs ------------------------------------------------------

    def mark_osd_down(self, osd: int) -> bool:
        """The operator's ``ceph osd down`` (and the first step of ``ceph
        osd destroy``): queue the mark-down in the pending incremental,
        committed by the next propose.  Returns False when the OSD is
        already down."""
        if not self.osdmap.is_up(osd):
            return False
        self.pending.new_state[osd] = \
            self.pending.new_state.get(osd, 0) | OSD_UP
        return True

    def osd_boot(self, osd: int, now: float | None = None) -> bool:
        """An OSD (re)announcing itself (OSDMonitor preprocess_boot
        path).  Returns False — the boot is REFUSED — while the OSD is
        flap-damped: marked down too often inside the markdown window,
        it stays down until :meth:`clear_markdown` (the reference's
        osd_markdown_log rejection).  ``now`` is accepted for symmetry
        with the failure-report API; damping is deliberately sticky
        (operator-cleared), not time-expiring, so the boot decision
        itself is clock-free."""
        if not self.markdown.allow_up(osd):
            if osd not in self._flap_logged:
                self._flap_logged.add(osd)
                self.cct.dout("mon", 1,
                              f"osd.{osd} boot denied: flapping "
                              f"(damped until operator clear)")
                clog = self._clog()
                if clog is not None:
                    clog.warn(
                        f"mon: osd.{osd} boot denied — flapping "
                        f"({self.markdown.count} mark-downs within "
                        f"{self.markdown.window:.0f}s); down until "
                        f"cleared", channel="mon")
            return False
        if not self.osdmap.is_up(osd):
            self.pending.new_state[osd] = \
                self.pending.new_state.get(osd, 0) | OSD_UP
        self.failure_info.pop(osd, None)
        return True

    def clear_markdown(self, osd: int) -> bool:
        """Operator clear of the flap-damping record ('ceph osd
        clear-markdown' analog): boots are allowed again (the OSD still
        has to boot — clearing does not itself mark up)."""
        was = self.markdown.clear(osd)
        self._flap_logged.discard(osd)
        clog = self._clog()
        if was and clog is not None:
            clog.info(f"mon: osd.{osd} markdown record cleared by "
                           f"operator", channel="mon")
        return was

    # -- commit (the Paxos propose_pending analog) -------------------------

    def propose_pending(self, now: float) -> OSDMap | None:
        if (not self.pending.new_state and not self.pending.new_weight and
                not self.pending.new_pg_temp and
                not self.pending.new_pg_upmap_items):
            return None
        inc, self.pending = self.pending, Incremental()
        if self.submit_fn is not None:
            # quorum mode: the commit arrives back via apply_committed
            # once a majority of monitors accepted it.  A refused submit
            # (no quorum) restores the pending state — it re-proposes on a
            # later tick rather than being parked as a stale Incremental.
            if not self.submit_fn(now, inc):
                self.pending = inc
            return None
        return self.apply_committed(now, inc)

    def apply_committed(self, now: float, inc: Incremental) -> OSDMap:
        """Apply a committed incremental to this monitor's map and notify
        subscribers — the refresh path every quorum member runs after a
        Paxos commit (single-mon mode calls it directly)."""
        old = self.osdmap
        self.osdmap = apply_incremental(old, inc)
        for o, st in inc.new_state.items():
            if st & OSD_UP:
                if old.is_up(o) and not self.osdmap.is_up(o):
                    self.down_stamp[o] = now
                    self.failure_info.pop(o, None)
                    # flap accounting: every committed mark-down counts
                    # toward the damping window
                    tripped = self.markdown.record_down(o, now)
                    clog = self._clog()
                    if clog is not None:
                        clog.warn(f"mon: osd.{o} marked down",
                                  channel="mon")
                        if tripped:
                            clog.warn(
                                f"mon: osd.{o} is flapping "
                                f"(>= {self.markdown.count} mark-downs "
                                f"in {self.markdown.window:.0f}s) — "
                                f"boots damped until operator clear",
                                channel="mon")
                elif not old.is_up(o) and self.osdmap.is_up(o):
                    self.down_stamp.pop(o, None)
                    clog = self._clog()
                    if clog is not None:
                        clog.info(f"mon: osd.{o} marked up",
                                  channel="mon")
        for fn in self.subscribers:
            fn(self.osdmap, inc)
        return self.osdmap

    def tick(self, now: float) -> OSDMap | None:
        """Periodic work: age pending failures, auto-out long-down OSDs."""
        for target in list(self.failure_info):
            if self.can_mark_down(target):
                self.check_failure(now, target)
        out_after = self.cct.conf.get("mon_osd_down_out_interval")
        for o, since in list(self.down_stamp.items()):
            if (now - since >= out_after and self.osdmap.is_in(o) and
                    not self.osdmap.is_up(o)):
                self.pending.new_weight[o] = 0
                self.cct.dout("osd", 1, f"osd.{o} auto-out after "
                                        f"{now - since:.0f}s down")
                del self.down_stamp[o]
        return self.propose_pending(now)
