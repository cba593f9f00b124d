"""cephx: ticket-based mutual authentication.

Analog of the reference's cephx protocol (reference: src/auth/cephx/ —
CephxProtocol.{h,cc}, CephxKeyServer.{h,cc}; ~5.8k LoC per SURVEY §2.4),
modeling the protocol structure faithfully over an authenticated
stream cipher built from SHA-256 (the reference uses AES; the primitive
is swappable, the PROTOCOL is the point):

1. the client proves knowledge of its entity secret to the monitor's
   KeyServer via challenge-response (CEPHX_GET_AUTH_SESSION_KEY:
   client_challenge + server_challenge hashed under the entity key) and
   receives a SESSION KEY sealed under its entity secret;
2. it then requests SERVICE TICKETS (CEPHX_GET_PRINCIPAL_SESSION_KEY):
   each ticket carries a service session key and expiry, sealed under
   the service's ROTATING secret (so the service can open it without
   talking to the monitor), plus a copy of the service session key
   sealed under the client's session key;
3. to connect to a service the client builds an AUTHORIZER — the ticket
   blob plus a nonce proof sealed under the service session key; the
   service unseals the ticket with its rotating secret (current or
   previous generation, allowing rotation grace), checks expiry, then
   proves ITS identity by answering nonce+1 (mutual auth,
   CephxAuthorizeReply) and challenges the client once per connection to
   defeat authorizer replay (CephxAuthorizeChallenge).

The port's copy of ``ceph_tpu.auth.cephx``: the same sealed blobs byte
for byte given the same ``os.urandom`` stream (``seal`` pickles only
dicts of primitives), so a keyring either package wrote authenticates
the other's clients.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import pickle
from dataclasses import dataclass, field


class AuthError(Exception):
    pass


# -- sealed boxes (the AES role; authenticated stream cipher) -----------------

def _stream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(key + nonce + counter.to_bytes(8, "big")).digest()
        counter += 1
    return out[:n]


def seal(key: bytes, obj) -> bytes:
    """Encrypt-then-MAC under ``key``."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    nonce = os.urandom(16)
    ct = bytes(a ^ b for a, b in zip(payload,
                                     _stream(key, nonce, len(payload))))
    tag = hmac.new(key, nonce + ct, hashlib.sha256).digest()
    return nonce + tag + ct


def unseal(key: bytes, blob: bytes):
    nonce, tag, ct = blob[:16], blob[16:48], blob[48:]
    want = hmac.new(key, nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise AuthError("bad magic / corrupt sealed blob")
    payload = bytes(a ^ b for a, b in zip(ct, _stream(key, nonce, len(ct))))
    return pickle.loads(payload)


def _proof(key: bytes, *parts: bytes) -> bytes:
    return hmac.new(key, b"|".join(parts), hashlib.sha256).digest()


# -- tickets ------------------------------------------------------------------

@dataclass
class Ticket:
    """A service ticket as held by the CLIENT: the opaque blob for the
    service + the service session key it shares (CephXTicketBlob +
    session_key, CephxProtocol.h)."""
    service: str
    blob: bytes                 # sealed under the service's rotating secret
    secret_id: int              # which rotating generation sealed it
    session_key: bytes
    expires: float


@dataclass
class Authorizer:
    """CephXAuthorizer: ticket blob + a nonce proof under the service
    session key."""
    service: str
    blob: bytes
    secret_id: int
    nonce: int
    proof: bytes                # seal(service_session_key, {nonce, ...})


# -- the monitor side ---------------------------------------------------------

@dataclass
class _RotatingSecret:
    secrets: dict[int, bytes] = field(default_factory=dict)
    current: int = 0


class KeyServer:
    """Entity secrets + per-service rotating secrets (CephxKeyServer)."""

    TICKET_VALIDITY = 3600.0

    def __init__(self):
        self.entity_keys: dict[str, bytes] = {}
        self.rotating: dict[str, _RotatingSecret] = {}
        self._pending: dict[str, bytes] = {}      # name -> server_challenge
        self._sessions: dict[str, bytes] = {}     # name -> session key

    def create_entity(self, name: str) -> bytes:
        key = os.urandom(32)
        self.entity_keys[name] = key
        return key

    def rotate(self, service: str) -> int:
        rs = self.rotating.setdefault(service, _RotatingSecret())
        rs.current += 1
        rs.secrets[rs.current] = os.urandom(32)
        # keep one previous generation (the rotation grace window)
        for sid in list(rs.secrets):
            if sid < rs.current - 1:
                del rs.secrets[sid]
        return rs.current

    def service_secret(self, service: str, secret_id: int | None = None):
        rs = self.rotating.get(service)
        if rs is None or not rs.secrets:
            raise AuthError(f"no rotating secret for {service}")
        sid = rs.current if secret_id is None else secret_id
        if sid not in rs.secrets:
            raise AuthError(f"{service} secret generation {sid} expired")
        return sid, rs.secrets[sid]

    # CEPHX_GET_AUTH_SESSION_KEY, step 1: hand out the server challenge
    def get_challenge(self, name: str) -> bytes:
        if name not in self.entity_keys:
            raise AuthError(f"unknown entity {name}")
        ch = os.urandom(16)
        self._pending[name] = ch
        return ch

    # step 2: verify the proof, issue the session key
    def issue_session_key(self, name: str, client_challenge: bytes,
                          proof: bytes, now: float):
        server_challenge = self._pending.pop(name, None)
        if server_challenge is None:
            raise AuthError("no challenge outstanding")
        key = self.entity_keys[name]
        want = _proof(key, server_challenge, client_challenge)
        if not hmac.compare_digest(proof, want):
            raise AuthError(f"bad authenticate for {name}")
        session_key = os.urandom(32)
        env = seal(key, {"session_key": session_key,
                         "expires": now + self.TICKET_VALIDITY})
        self._sessions[name] = session_key
        return env

    # CEPHX_GET_PRINCIPAL_SESSION_KEY: service tickets under the session
    def issue_service_ticket(self, name: str, service: str, now: float):
        sessions = self._sessions
        if name not in sessions:
            raise AuthError(f"{name} has no session")
        sid, svc_secret = self.service_secret(service)
        svc_session_key = os.urandom(32)
        expires = now + self.TICKET_VALIDITY
        blob = seal(svc_secret, {"name": name,
                                 "session_key": svc_session_key,
                                 "expires": expires})
        env = seal(sessions[name], {"service": service, "blob": blob,
                                    "secret_id": sid,
                                    "session_key": svc_session_key,
                                    "expires": expires})
        return env


# -- the client side ----------------------------------------------------------

class CephxClient:
    def __init__(self, name: str, key: bytes):
        self.name = name
        self.key = key
        self.session_key: bytes | None = None
        self.tickets: dict[str, Ticket] = {}
        self._nonce = 0

    def authenticate(self, keyserver: KeyServer, now: float) -> None:
        server_challenge = keyserver.get_challenge(self.name)
        client_challenge = os.urandom(16)
        proof = _proof(self.key, server_challenge, client_challenge)
        env = keyserver.issue_session_key(self.name, client_challenge,
                                          proof, now)
        self.session_key = unseal(self.key, env)["session_key"]

    def get_ticket(self, keyserver: KeyServer, service: str,
                   now: float) -> Ticket:
        if self.session_key is None:
            raise AuthError("authenticate first")
        env = keyserver.issue_service_ticket(self.name, service, now)
        t = unseal(self.session_key, env)
        ticket = Ticket(service=service, blob=t["blob"],
                        secret_id=t["secret_id"],
                        session_key=t["session_key"], expires=t["expires"])
        self.tickets[service] = ticket
        return ticket

    def build_authorizer(self, service: str, now: float) -> Authorizer:
        ticket = self.tickets.get(service)
        if ticket is None:
            raise AuthError(f"no ticket for {service}")
        if now >= ticket.expires:
            raise AuthError(f"ticket for {service} expired")
        self._nonce += 1
        nonce = int.from_bytes(os.urandom(8), "big") + self._nonce
        proof = seal(ticket.session_key, {"nonce": nonce,
                                          "name": self.name})
        return Authorizer(service=service, blob=ticket.blob,
                          secret_id=ticket.secret_id, nonce=nonce,
                          proof=proof)

    def verify_reply(self, service: str, reply: bytes, nonce: int) -> None:
        """Mutual auth: the service answers nonce+1 under the session key
        (CephXAuthorizeReply.nonce_plus_one)."""
        t = self.tickets[service]
        got = unseal(t.session_key, reply)
        if got.get("nonce_plus_one") != nonce + 1:
            raise AuthError(f"{service} failed mutual auth")


# -- the service side ---------------------------------------------------------

class CephxServiceHandler:
    """An OSD/MDS verifying authorizers with its rotating secret."""

    def __init__(self, service: str, keyserver: KeyServer):
        self.service = service
        self.keyserver = keyserver
        self._seen_nonces: set[int] = set()

    def verify_authorizer(self, authz: Authorizer, now: float) -> tuple:
        """Returns (entity name, reply blob).  Raises AuthError on any
        tamper/expiry/replay."""
        if authz.service != self.service:
            raise AuthError("authorizer for the wrong service")
        _, secret = self.keyserver.service_secret(self.service,
                                                  authz.secret_id)
        ticket = unseal(secret, authz.blob)
        if now >= ticket["expires"]:
            raise AuthError("ticket expired")
        svc_session_key = ticket["session_key"]
        proof = unseal(svc_session_key, authz.proof)
        if proof.get("nonce") != authz.nonce or \
                proof.get("name") != ticket["name"]:
            raise AuthError("authorizer proof mismatch")
        # replay defense (the role CephxAuthorizeChallenge plays per
        # connection): a nonce may establish at most one session
        if authz.nonce in self._seen_nonces:
            raise AuthError("authorizer replay")
        self._seen_nonces.add(authz.nonce)
        reply = seal(svc_session_key, {"nonce_plus_one": authz.nonce + 1})
        return ticket["name"], reply
