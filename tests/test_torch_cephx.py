"""The port's cephx (``ceph_tpu_torch.auth.cephx``) against the JAX
package's, on the CPU.

With ``os.urandom`` replaced by the same seeded byte stream in both
packages, one whole exchange (entity key, rotating secret, server
challenge, session envelope, service-ticket envelope, authorizer,
mutual-auth reply) gives the same bytes, and each package opens the
other's blobs: ``seal`` pickles only dicts of primitives.  The
protocol's refusals (a wrong key, a tampered or replayed authorizer, a
stale ticket, rotation past the grace generation) are the reference's
(``tests/test_cephx.py``).  Tolerance: bitwise.
"""
from __future__ import annotations

import os
import random

import pytest

from ceph_tpu.auth import cephx as jcephx
from ceph_tpu_torch.auth import cephx
from ceph_tpu_torch.auth import (AuthError, CephxClient, CephxServiceHandler,
                                 KeyServer)


def _seeded_urandom(monkeypatch, seed: int) -> None:
    rng = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: rng.randbytes(n))


def _exchange(mod, monkeypatch, seed: int, now: float = 100.0) -> dict:
    """One full exchange on ``mod`` (either package's cephx) with a seeded
    ``os.urandom``; every blob it produces, in order."""
    _seeded_urandom(monkeypatch, seed)
    out = {}
    ks = mod.KeyServer()
    out["entity_key"] = ks.create_entity("client.admin")
    out["secret_id"] = ks.rotate("osd")
    out["rotating"] = ks.service_secret("osd")[1]
    client = mod.CephxClient("client.admin", out["entity_key"])
    out["server_challenge"] = ks.get_challenge("client.admin")
    client_challenge = os.urandom(16)
    proof = mod._proof(client.key, out["server_challenge"], client_challenge)
    out["session_env"] = ks.issue_session_key(
        "client.admin", client_challenge, proof, now)
    client.session_key = mod.unseal(client.key, out["session_env"])[
        "session_key"]
    out["session_key"] = client.session_key
    out["ticket_env"] = ks.issue_service_ticket("client.admin", "osd", now)
    ticket = client.get_ticket(ks, "osd", now)
    out["ticket"] = (ticket.service, ticket.blob, ticket.secret_id,
                     ticket.session_key, ticket.expires)
    authz = client.build_authorizer("osd", now + 1)
    out["authorizer"] = (authz.service, authz.blob, authz.secret_id,
                         authz.nonce, authz.proof)
    name, reply = mod.CephxServiceHandler("osd", ks).verify_authorizer(
        authz, now + 1)
    client.verify_reply("osd", reply, authz.nonce)
    out["entity"], out["reply"] = name, reply
    out["sealed"] = mod.seal(out["session_key"], {"n": 7, "b": b"x"})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exchange_bitwise_against_reference(monkeypatch, seed):
    port = _exchange(cephx, monkeypatch, seed)
    ref = _exchange(jcephx, monkeypatch, seed)
    assert port.keys() == ref.keys()
    for key in ref:
        assert port[key] == ref[key], key
    assert port["entity"] == "client.admin"


def test_blobs_open_across_packages(monkeypatch):
    """What one package seals the other unseals; a reference ticket blob
    verifies through the port's service handler and back."""
    key = b"\x11" * 32
    blob = jcephx.seal(key, {"session_key": b"s" * 32, "expires": 5.0})
    assert cephx.unseal(key, blob) == {"session_key": b"s" * 32,
                                       "expires": 5.0}
    assert jcephx.unseal(key, cephx.seal(key, {"a": 1})) == {"a": 1}
    jks = jcephx.KeyServer()
    jkey = jks.create_entity("client.admin")
    jks.rotate("osd")
    jclient = jcephx.CephxClient("client.admin", jkey)
    jclient.authenticate(jks, now=0.0)
    jclient.get_ticket(jks, "osd", now=0.0)
    authz = jclient.build_authorizer("osd", now=1.0)
    from ceph_tpu_torch import convert
    ks = convert.keyring_from_reference(jks)
    port_authz = cephx.Authorizer(authz.service, authz.blob,
                                  authz.secret_id, authz.nonce, authz.proof)
    name, reply = CephxServiceHandler("osd", ks).verify_authorizer(
        port_authz, now=1.0)
    assert name == "client.admin"
    jclient.verify_reply("osd", reply, authz.nonce)


@pytest.fixture()
def world():
    ks = KeyServer()
    key = ks.create_entity("client.admin")
    ks.rotate("osd")
    return ks, CephxClient("client.admin", key), CephxServiceHandler("osd",
                                                                     ks)


def _authed(ks, client, now=0.0):
    client.authenticate(ks, now=now)
    client.get_ticket(ks, "osd", now=now)


def test_full_mutual_auth(world):
    ks, client, osd = world
    _authed(ks, client)
    authz = client.build_authorizer("osd", now=1.0)
    name, reply = osd.verify_authorizer(authz, now=1.0)
    assert name == "client.admin"
    client.verify_reply("osd", reply, authz.nonce)
    with pytest.raises(AuthError, match="mutual auth"):
        client.verify_reply("osd", reply, authz.nonce + 1)


@pytest.mark.parametrize("who, key, match", [
    ("client.admin", b"\x00" * 32, "bad authenticate"),
    ("client.ghost", b"\x00" * 32, "unknown entity")])
def test_wrong_key_or_entity_rejected(world, who, key, match):
    ks, _, _ = world
    with pytest.raises(AuthError, match=match):
        CephxClient(who, key).authenticate(ks, now=0.0)


def test_ticket_requires_session(world):
    ks, client, _ = world
    with pytest.raises(AuthError, match="authenticate first"):
        client.get_ticket(ks, "osd", now=0.0)


def test_tampered_and_replayed_authorizers(world):
    ks, client, osd = world
    _authed(ks, client)
    authz = client.build_authorizer("osd", now=0.0)
    good = authz.blob
    authz.blob = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(AuthError, match="bad magic"):
        osd.verify_authorizer(authz, now=0.0)
    authz.blob = good
    osd.verify_authorizer(authz, now=0.0)
    with pytest.raises(AuthError, match="replay"):
        osd.verify_authorizer(authz, now=0.0)
    ks.rotate("mds")
    with pytest.raises(AuthError, match="wrong service"):
        CephxServiceHandler("mds", ks).verify_authorizer(
            client.build_authorizer("osd", now=0.0), now=0.0)


def test_stale_ticket_rejected_then_renewed(world):
    ks, client, osd = world
    _authed(ks, client)
    late = KeyServer.TICKET_VALIDITY + 1
    with pytest.raises(AuthError, match="expired"):
        client.build_authorizer("osd", now=late)
    _authed(ks, client, now=late)
    authz = client.build_authorizer("osd", now=late + 1)
    assert osd.verify_authorizer(authz, now=late + 1)[0] == "client.admin"


def test_rotation_grace_then_expiry(world):
    ks, client, osd = world
    _authed(ks, client)
    ks.rotate("osd")                            # one generation: grace
    assert osd.verify_authorizer(client.build_authorizer("osd", now=1.0),
                                 now=1.0)[0] == "client.admin"
    ks.rotate("osd")                            # two: the ticket is stale
    with pytest.raises(AuthError, match="expired"):
        osd.verify_authorizer(client.build_authorizer("osd", now=1.0),
                              now=1.0)
    client.get_ticket(ks, "osd", now=1.0)
    assert osd.verify_authorizer(client.build_authorizer("osd", now=1.0),
                                 now=1.0)[0] == "client.admin"


def test_ticket_pickles_the_ports_class():
    t = cephx.Ticket("osd", b"b", 1, b"k" * 32, 9.0)
    assert type(t).__module__ == "ceph_tpu_torch.auth.cephx"
    import pickle
    assert b"ceph_tpu_torch.auth.cephx" in pickle.dumps(t)
