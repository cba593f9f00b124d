"""The port's TCP front end (``ceph_tpu_torch.net``) on the CPU, after the
reference's ``tests/test_net.py``: a live port cluster served over
sockets with cephx and HMAC-secured v2 frames.

Covered: secured put/get and the op surface; two concurrent clients;
watch/notify across two client PROCESSES; RPC frames refused before
authentication; the ``rados_cli serve`` process and its ``--connect``
verbs (each a fresh interpreter); the cephx handshake across packages
(the port's ``dial_and_handshake`` against a JAX ``ClusterServer`` and
the JAX one against a port server, over one shared keyring); and a port
client process that loads no JAX and never initialises CUDA.  EC pools
here carry ``device=cpu`` (the plain PyTorch versions).  Every wait is
bounded; servers, clients and subprocesses stop in ``finally`` or in a
fixture's teardown.
"""
from __future__ import annotations

import json
import os
import pickle
import selectors
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.net import ClusterServer, TcpRados

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EC = {"k": "2", "m": "1", "device": "cpu"}


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _port_env():
    """A fresh interpreter that imports the repo's packages (the port's
    processes never import JAX; PYTHONPATH keeps the checkout first)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _spawn_server(data_dir, env):
    """Start the port's ``rados serve`` and wait (bounded) for its port
    line and keyring."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli",
         "--data-dir", str(data_dir), "serve", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + 60
    line = ""
    try:
        while time.monotonic() < deadline and not line:
            if sel.select(timeout=1.0):
                line = proc.stdout.readline()
            if proc.poll() is not None:
                raise AssertionError(f"serve died rc={proc.returncode}: "
                                     f"{proc.stderr.read()}")
        assert "serving on" in line, f"no port line within 60s: {line!r}"
        keyring = os.path.join(str(data_dir), "client.admin.keyring")
        while not os.path.exists(keyring):
            assert time.monotonic() < deadline, "keyring never appeared"
            time.sleep(0.1)
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise
    finally:
        sel.close()
    return proc, int(line.rsplit(":", 1)[1]), keyring


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
    for f in (proc.stdout, proc.stderr):
        if f is not None:
            f.close()


@pytest.fixture
def served(tmp_path):
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    c = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                    cct=Context(), data_dir=tmp_path)
    server = ClusterServer(c)
    server.start()
    yield server, tmp_path / "client.admin.keyring"
    server.stop()
    c.shutdown()


def test_put_get_roundtrip_secured(served):
    server, keyring = served
    r = TcpRados("127.0.0.1", server.port, keyring)
    try:
        r.mkpool("p", profile=EC)
        data = _data(20000, 1)
        r.put("p", "obj", data)
        assert r.get("p", "obj") == data
        assert r.stat("p", "obj")[0] == len(data)
        assert r.ls("p") == ["obj"] and "p" in r.pools()
        assert r.ch.secret is not None          # HMAC frames post-auth
        r.setxattr("p", "obj", "k", b"v")
        assert r.getxattr("p", "obj", "k") == b"v"
        assert r.status()["osdmap"]["num_osds"] == 3
        r.remove("p", "obj")
        with pytest.raises(IOError):
            r.get("p", "obj")
        # the stored object is the port's encode of the bytes sent
        g = server.cluster.pg_group(server.cluster.pool_ids["p"], "obj")
        assert g.backend.pg_log.head >= 2
    finally:
        r.close()


def test_two_concurrent_clients(served):
    server, keyring = served
    a = TcpRados("127.0.0.1", server.port, keyring)
    b = TcpRados("127.0.0.1", server.port, keyring)
    errs = []
    try:
        a.mkpool("p", profile=EC, pg_num=4)

        def worker(r, tag):
            try:
                for i in range(12):
                    r.put("p", f"{tag}{i}", _data(600 + i, i))
                for i in range(12):
                    assert r.get("p", f"{tag}{i}") == _data(600 + i, i)
            except Exception as e:            # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=worker, args=(a, "a")),
              threading.Thread(target=worker, args=(b, "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
        assert not errs
        assert a.get("p", "b3") == _data(603, 3)
        assert b.get("p", "a7") == _data(607, 7)
    finally:
        a.close()
        b.close()


_WATCHER = """
import json, sys, threading
from ceph_tpu_torch.net import TcpRados
port, keyring = int(sys.argv[1]), sys.argv[2]
r = TcpRados("127.0.0.1", port, keyring)
got, ev = [], threading.Event()
def on_notify(notify_id, cookie, payload):
    got.append(bytes(payload).decode())
    ev.set()
    return b"seen:" + bytes(payload)
r.watch("p", "watched", cookie=77, on_notify=on_notify)
print("watching", flush=True)
ok = ev.wait(60)
sys.stdin.read()        # the test closes stdin once the notifier has its ack
r.close()
print(json.dumps({"got": got, "ok": ok}), flush=True)
"""

_NOTIFIER = """
import json, sys
from ceph_tpu_torch.net import TcpRados
port, keyring = int(sys.argv[1]), sys.argv[2]
r = TcpRados("127.0.0.1", port, keyring)
acks = r.notify("p", "watched", b"ping")
r.close()
print(json.dumps({str(k): (v.decode() if isinstance(v, bytes) else repr(v))
                  for k, v in acks.items()}))
"""


def test_watch_notify_across_client_processes(served):
    """Process A watches; process B notifies through the cluster; A's
    callback value rides the ack back to B."""
    server, keyring = served
    r = TcpRados("127.0.0.1", server.port, keyring)
    try:
        r.mkpool("p", replicated=True, size=3)
        r.put("p", "watched", b"x")
    finally:
        r.close()
    env = _port_env()
    watcher = subprocess.Popen(
        [sys.executable, "-c", _WATCHER, str(server.port), str(keyring)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)
    try:
        sel = selectors.DefaultSelector()
        sel.register(watcher.stdout, selectors.EVENT_READ)
        assert sel.select(timeout=60), "watcher never armed its watch"
        sel.close()
        assert watcher.stdout.readline().strip() == "watching"
        notifier = subprocess.run(
            [sys.executable, "-c", _NOTIFIER, str(server.port),
             str(keyring)], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=120)
        assert notifier.returncode == 0, notifier.stderr
        assert json.loads(notifier.stdout.strip().splitlines()[-1]) == \
            {"77": "seen:ping"}
        out, err = watcher.communicate(input="", timeout=60)
        assert watcher.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1]) == {
            "got": ["ping"], "ok": True}
    finally:
        if watcher.poll() is None:
            watcher.kill()
            watcher.communicate(timeout=30)


def test_wrong_key_rejected(served):
    server, keyring = served
    bad = keyring.parent / "bad.keyring"
    with open(keyring, "rb") as f:
        saved = pickle.load(f)
    saved["key"] = b"\x00" * 32
    with open(bad, "wb") as f:
        pickle.dump(saved, f)
    with pytest.raises((IOError, ConnectionError)):
        TcpRados("127.0.0.1", server.port, bad).close()


def test_rpc_frames_rejected_before_auth(served):
    """A peer skipping cephx cannot reach the pickle decoder: the server
    drops the connection instead of unpickling."""
    import socket
    from ceph_tpu_torch.backend.wire import BANNER, frame_encode
    server, _keyring = served
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    try:
        sock.recv(65536)                       # the server's banner
        evil = frame_encode(17, [b"RpcCall", pickle.dumps({"any": 1})])
        sock.sendall(BANNER + evil)
        assert sock.recv(65536) == b""
    finally:
        sock.close()


def test_keyring_has_no_rotating_secrets(served):
    _server, keyring = served
    with open(keyring, "rb") as f:
        assert set(pickle.load(f)) == {"key"}


# -- across packages ---------------------------------------------------------

def test_handshake_across_packages(tmp_path):
    """The handshake carries no pickle, so it runs across packages: the
    port's dial_and_handshake against a JAX ClusterServer, then the
    JAX one against a port server holding the same secrets
    (``convert.keyring_from_reference``), one client keyring for both."""
    import ceph_tpu.net as jnet
    from ceph_tpu.cluster import MiniCluster as JCluster
    from ceph_tpu.common import Context as JContext
    from ceph_tpu_torch import convert
    from ceph_tpu_torch import net
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    jc = JCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                  cct=JContext(), data_dir=tmp_path / "jax")
    jserver = jnet.ClusterServer(jc)
    jserver.start()
    pc = pserver = None
    try:
        with open(tmp_path / "jax" / jnet.KEYRING, "rb") as f:
            key = pickle.load(f)["key"]
        sock, skey = net.dial_and_handshake("127.0.0.1", jserver.port, key)
        sock.close()
        assert len(skey) == 32
        pc = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                         cct=Context(), data_dir=tmp_path / "port")
        convert.keyring_from_reference(jserver.keyserver,
                                       data_dir=tmp_path / "port")
        pserver = ClusterServer(pc)
        pserver.start()
        assert pserver.keyserver.entity_keys == \
            jserver.keyserver.entity_keys
        with open(tmp_path / "port" / net.KEYRING, "rb") as f:
            assert pickle.load(f)["key"] == key
        sock, skey2 = jnet.dial_and_handshake("127.0.0.1", pserver.port,
                                              key)
        sock.close()
        assert len(skey2) == 32
        # and the port's own client, end to end, on that keyring
        r = TcpRados("127.0.0.1", pserver.port,
                     tmp_path / "jax" / jnet.KEYRING)
        try:
            r.mkpool("p", replicated=True, size=3)
            r.put("p", "o", b"shared-keyring")
            assert r.get("p", "o") == b"shared-keyring"
        finally:
            r.close()
    finally:
        jserver.stop()
        jc.shutdown()
        if pserver is not None:
            pserver.stop()
        if pc is not None:
            pc.shutdown()


_CLIENT_PROBE = """
import json, sys
from ceph_tpu_torch.net import TcpRados
r = TcpRados("127.0.0.1", int(sys.argv[1]), sys.argv[2])
r.put("p", "probe", b"q" * 3000)
ok = r.get("p", "probe") == b"q" * 3000
r.close()
import torch
print(json.dumps({"ok": ok, "cuda": torch.cuda.is_initialized(),
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in
                                   ("jax", "jaxlib", "ceph_tpu"))}))
"""


def test_client_process_loads_no_jax_and_no_cuda(served):
    server, keyring = served
    r = TcpRados("127.0.0.1", server.port, keyring)
    try:
        r.mkpool("p", profile=EC)
    finally:
        r.close()
    proc = subprocess.run(
        [sys.executable, "-c", _CLIENT_PROBE, str(server.port),
         str(keyring)], capture_output=True, text=True, env=_port_env(),
        cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "ok": True, "cuda": False, "loaded": []}


# -- the CLIs ----------------------------------------------------------------

def test_cli_serve_and_connect_verbs(tmp_path):
    """``rados_cli serve`` in one process; each ``--connect`` verb in a
    fresh one; the file put comes back equal."""
    env = _port_env()
    proc, port, keyring = _spawn_server(tmp_path / "d", env)
    try:
        def cli(*argv, data=None):
            return subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli",
                 "--connect", f"127.0.0.1:{port}", "--keyring", keyring,
                 *argv], input=data, capture_output=True, env=env,
                cwd=ROOT, timeout=120)
        src = tmp_path / "in.bin"
        src.write_bytes(_data(70000, 4))
        r = cli("mkpool", "p", "k=2", "m=1", "device=cpu")
        assert r.returncode == 0, r.stderr
        r = cli("put", "p", "obj", str(src))
        assert r.returncode == 0, r.stderr
        r = cli("get", "p", "obj", str(tmp_path / "out.bin"))
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
        r = cli("ls", "p")
        assert r.stdout.decode().split() == ["obj"]
        r = cli("stat", "p", "obj")
        assert r.returncode == 0 and b"size 70000" in r.stdout
        r = cli("df")
        assert b"pools" in r.stdout
        r = cli("get", "p", "missing", "-")
        assert r.returncode == 2 and b"error:" in r.stderr
    finally:
        _stop(proc)


def test_cli_serve_refuses_connect():
    r = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli",
         "--connect", "127.0.0.1:1", "serve"], capture_output=True,
        text=True, env=_port_env(), cwd=ROOT, timeout=120)
    assert r.returncode == 2 and "cannot combine" in r.stderr


def test_rados_bench_on_the_host_and_without_a_card():
    """``--device cpu`` runs write and seq on the plain versions and
    prints the reference's output block and the launch counts (0 on the
    host); without a card and without ``--device cpu`` it raises."""
    base = [sys.executable, "-m", "ceph_tpu_torch.bench.rados_bench",
            "--seconds", "0.2", "--k", "2", "--m", "1", "--osds", "3",
            "--pg-num", "4", "--object-size", "8K", "--chunk-size", "512",
            "--concurrency", "4"]
    for mode in ("write", "seq"):
        r = subprocess.run(base + [mode, "--device", "cpu"],
                           capture_output=True, text=True,
                           env=_port_env(), cwd=ROOT, timeout=120)
        assert r.returncode == 0, r.stderr
        lines = r.stdout.strip().splitlines()
        block = dict(line.split(":", 1) for line in lines[:-1])
        assert int(block["Object size"]) == 8192
        assert float(block["Bandwidth (MB/sec)"]) > 0
        assert json.loads(lines[-1])["launches"]["gf_apply"] == 0
    r = subprocess.run(base + ["write"], capture_output=True, text=True,
                       env=_port_env(), cwd=ROOT, timeout=120)
    assert r.returncode != 0 and "torch.cuda.is_available()" in r.stderr
