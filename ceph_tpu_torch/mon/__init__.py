"""Cluster control plane: failure detection and map commits (SURVEY.md §5).

Monitor (monitor.py) mirrors the reference's OSDMonitor failure path
(src/mon/OSDMonitor.cc prepare_failure :2874, check_failure :2764,
can_mark_down :2671) over this framework's OSDMap incrementals; heartbeats
(heartbeat.py) mirror the OSD's peer-ping machinery
(src/osd/OSD.cc:4547-4996).

The port's copy of ``ceph_tpu.mon``."""
from .monitor import Monitor
from .heartbeat import HeartbeatAgent, VirtualClock
from .paxos import MonCluster, PaxosMonitor

__all__ = ["Monitor", "HeartbeatAgent", "VirtualClock", "MonCluster",
           "PaxosMonitor"]
