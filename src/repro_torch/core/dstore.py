"""Distributed two-level store: per-host memory shards, one PFS namespace.

DESIGN.md §11.  The paper's architecture is N compute nodes whose local
memory tiers (Tachyon) sit over M shared data servers (OrangeFS) — the
aggregate read rate scales as N·ν while bytes are memory-resident
(Section 4, Eqs. 1-7).  :class:`DistributedStore` turns the single-process
:class:`~repro_torch.core.store.TwoLevelStore` into that cluster: every host
runs one store (its *memory-tier shard*) over the **same** PFS root, and
three mechanisms coordinate them:

* **Lease-based metadata ownership.**  Each logical file has exactly one
  owner host.  Ownership is a per-file lease under the shared namespace
  (``_dstore/leases/``) bound to the owner's heartbeat epoch
  (``_dstore/hosts/``): the lease is valid while its owner's heartbeat
  file is unexpired *and* still carries the epoch the lease was claimed
  under.  A crashed owner stops heartbeating; once its heartbeat expires,
  any host may **take over** the file (exclusive sidecar lock + atomic
  rename), bump nothing on the PFS data path — the durable copy was
  always there — and serve bit-identical bytes.  A stale owner that lost
  its lease is **fenced**: its next write re-validates the lease and
  raises :class:`LeaseLost` instead of double-writing (double-owner
  rejection).
* **Peer block reads for hot bytes.**  A non-owner reads a file's blocks
  from the owner's memory tier over a local socket transport when they
  are hot there (one request per block; the owner answers from
  ``TwoLevelStore.peek_block`` — zero-copy resident bytes plus the block
  CRC it already holds).  The CRC is *carried with the transfer*, not
  recomputed on either side of the wire (DESIGN.md §4's no-extra-pass
  discipline extends across hosts).  Blocks the owner does not have hot
  are read from the PFS tier directly (``PFS_BYPASS`` — the paper's read
  mode (e)), never promoted into the non-owner's shard: residency belongs
  to the owner.
* **Writes route through the owner.**  A ``put`` on a non-owner forwards
  the bytes to the owner, whose store runs its normal write mode — so
  async write-back coalescing and the adaptive flush lanes (DESIGN.md
  §10) stay per-owner, and two hosts can never interleave writes to one
  file's blocks.

**Controller federation.**  Each host periodically publishes its live
(ν, q, f, per-class footprint) estimates — from its
:class:`~repro_torch.core.sched.IOController` when one is attached — to the
gossip board (``_dstore/gossip/``), and ingests peers' into its
controller (``IOController.note_peer``).  Placement planners consume the
same board: :func:`repro.data.pipeline.plan_shard_placement` and
:func:`repro.apps.shuffle.place_reducers` assign shards/reducers to the
hosts whose shards already hold their bytes hot, which is what makes the
multihost benchmark's locality phase beat random placement.

**Resilience layer (DESIGN.md §12).**  Peer RPCs run under a
:class:`~repro_torch.core.resilience.RetryPolicy` (bounded exponential backoff
+ seeded jitter + per-request deadline; reads retry freely, forwarded
puts re-resolve the owner lease before every retry so fencing still
rejects double-owners) behind a per-peer
:class:`~repro_torch.core.resilience.CircuitBreaker`.  An open circuit
degrades gracefully: reads fall back to the ``PFS_BYPASS`` cold path,
writes fall back to claim-or-forward-to-next-live-owner — the client
stack never sees :class:`PeerUnreachable` for bytes the shared PFS tier
still holds.  A background **reclamation thread** watches the host
registry for expired heartbeats and proactively takes over the dead
host's leases (rate-limited, hottest-by-gossip first, optionally
pre-warming the hottest bytes into the new owner's shard) so readers no
longer pay takeover latency inline.

Fault injection: the step-counted
:class:`repro.runtime.failure.FailureInjector` still fires on public
data-plane ops, and a site-addressable
:class:`repro.runtime.failure.ChaosInjector` can be attached to fire
named faults — connection drop, request delay/jitter, torn PFS stripe
write, heartbeat pause, lease-file corruption, mid-takeover crash — at
hooks threaded through the peer transport, the lease table, the host
registry, and the PFS tier.  Without an injector every hook is a
``None``-check: zero cost.

All coordination state lives under ``<pfs_root>/_dstore/`` — the PFS
tree *is* the one shared namespace, exactly as the paper's OrangeFS
deployment is the only thing its Tachyon instances share.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import threading
import time
import zlib

from repro_torch.core import codec as blockcodec
from repro_torch.core.resilience import CircuitBreaker, CircuitOpen, RetryPolicy
from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode
from repro_torch.core.tiers import BlockNotFound, IntegrityError, TierError

__all__ = [
    "DistributedStore",
    "HostRegistry",
    "LeaseTable",
    "LeaseInfo",
    "GossipBoard",
    "LeaseLost",
    "NotOwner",
    "PeerUnreachable",
    "DStoreStats",
]


class LeaseLost(TierError):
    """A host acted as owner of a file whose lease it no longer holds."""


class NotOwner(TierError):
    """The operation requires ownership this host does not have and
    cannot take over (the current owner is still live)."""


class PeerUnreachable(TierError):
    """The owner host did not answer on the peer transport."""


def _safe(name: str) -> str:
    # Same convention as PFSTier._safe: store names never organically
    # contain "__" or "@", so the mapping is invertible.
    return name.replace(os.sep, "__").replace(":", "@")


def _atomic_write(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)  # atomic: readers see old or new, never partial


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (FileNotFoundError, json.JSONDecodeError):
        # A decode error means we raced a non-atomic writer from a foreign
        # build; treat as absent — every writer here is atomic-rename.
        return None


# --------------------------------------------------------------------- hosts


class HostRegistry:
    """Heartbeat files: one JSON per host under ``_dstore/hosts/``.

    A host's liveness record is ``{host, addr, epoch, expires}``; a renew
    thread refreshes ``expires`` every ``ttl/3``.  ``epoch`` increases
    across incarnations of the same host id, which is what binds leases to
    *this* run of the owner: a restarted owner has a new epoch, so every
    lease claimed under the old one is immediately invalid (its memory
    tier is empty anyway — the durable copies are on the PFS tier).
    """

    def __init__(self, root: str, host_id: int, ttl_s: float = 5.0, chaos=None) -> None:
        self.dir = os.path.join(root, "_dstore", "hosts")
        os.makedirs(self.dir, exist_ok=True)
        self.host_id = host_id
        self.ttl_s = ttl_s
        self._chaos = chaos
        prev = _read_json(self._path(host_id))
        self.epoch = int(prev["epoch"]) + 1 if prev else 1
        self.addr: str = ""
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._renew_hooks: list = []  # callables run on every renew tick

    def _path(self, host_id: int) -> str:
        return os.path.join(self.dir, f"h{host_id:04d}.json")

    def publish(self, addr: str) -> None:
        self.addr = addr
        self.renew()

    def renew(self) -> None:
        if self._chaos is not None:
            # Chaos site "registry.renew": a heartbeat_pause fault skips
            # this renew tick — ``count`` consecutive firings emulate a
            # partitioned host whose heartbeat lapses while it still runs.
            spec = self._chaos.at("registry.renew", host=self.host_id)
            if spec is not None and spec.kind == "heartbeat_pause":
                return
        _atomic_write(
            self._path(self.host_id),
            {
                "host": self.host_id,
                "addr": self.addr,
                "epoch": self.epoch,
                "expires": time.time() + self.ttl_s,
            },
        )

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.ttl_s / 3.0):
                self.renew()
                for hook in list(self._renew_hooks):
                    try:
                        hook()
                    except Exception:
                        pass  # gossip is best-effort; the heartbeat must live

        self._thread = threading.Thread(target=loop, daemon=True, name="dstore-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        """Stop heartbeating (tests use this to simulate a silent host)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def lookup(self, host_id: int) -> dict | None:
        return _read_json(self._path(host_id))

    def live(self, host_id: int, now: float | None = None) -> dict | None:
        """The host's record if its heartbeat is unexpired, else ``None``."""
        rec = self.lookup(host_id)
        if rec is None:
            return None
        return rec if (now or time.time()) < rec.get("expires", 0.0) else None

    def hosts(self) -> list[dict]:
        out = []
        for fn in sorted(os.listdir(self.dir)):
            if fn.endswith(".json"):
                rec = _read_json(os.path.join(self.dir, fn))
                if rec is not None:
                    out.append(rec)
        return out


# -------------------------------------------------------------------- leases


@dataclasses.dataclass(frozen=True)
class LeaseInfo:
    name: str
    owner: int
    epoch: int  # the owner's heartbeat epoch at claim time


class LeaseTable:
    """Per-file ownership leases under the shared namespace.

    A lease file ``_dstore/leases/<safe>.lease`` holds ``{owner, epoch}``.
    Validity is derived, not stored: the lease stands while its owner's
    heartbeat is live *and* carries the claimed epoch — so one heartbeat
    renewal keeps every lease a host holds alive (no per-file renewal
    traffic), and one missed expiry invalidates them all at once.

    * **Claim** (unowned file) — exclusive create via ``os.link`` of a
      unique temp file onto the lease path: exactly one concurrent
      claimant wins, the rest see ``FileExistsError``.
    * **Takeover** (dead owner) — guarded by an exclusive sidecar
      ``.lock`` (O_CREAT|O_EXCL); inside it the taker re-validates that
      the lease is actually orphaned, then atomically replaces it.  A
      lock left by a taker that died mid-takeover is broken after
      ``ttl``.
    * **Fencing** — ``check(name)`` re-reads the lease; an owner whose
      lease was taken over (or whose own heartbeat lapsed) gets
      :class:`LeaseLost` before any bytes move (double-owner rejection).
    """

    def __init__(self, root: str, registry: HostRegistry, chaos=None) -> None:
        self.dir = os.path.join(root, "_dstore", "leases")
        os.makedirs(self.dir, exist_ok=True)
        self.registry = registry
        self._chaos = chaos

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, _safe(name) + ".lease")

    def _chaos_lease_written(self, path: str) -> None:
        """Chaos site "lease.write": a ``corrupt`` fault scribbles garbage
        over the lease file just written.  ``_read_json`` treats a decode
        error as an absent lease, so the system self-heals by re-claiming
        — which is exactly the property the fault exists to prove."""
        if self._chaos is None:
            return
        spec = self._chaos.at("lease.write", path=path)
        if spec is not None and spec.kind == "corrupt":
            with open(path, "w") as fh:
                fh.write("{torn-lease")

    def read(self, name: str) -> LeaseInfo | None:
        rec = _read_json(self._path(name))
        if rec is None:
            return None
        return LeaseInfo(name=name, owner=int(rec["owner"]), epoch=int(rec["epoch"]))

    def valid(self, info: LeaseInfo | None, now: float | None = None) -> bool:
        """A lease stands iff its owner heartbeats with the claimed epoch."""
        if info is None:
            return False
        rec = self.registry.live(info.owner, now)
        return rec is not None and int(rec.get("epoch", -1)) == info.epoch

    def claim(self, name: str) -> LeaseInfo:
        """Claim an unowned (or orphaned) file for this host.

        Returns the resulting lease — which may name *another* host if it
        won a concurrent claim; callers must check ``owner``.
        """
        path = self._path(name)
        me = LeaseInfo(name=name, owner=self.registry.host_id, epoch=self.registry.epoch)
        existing = self.read(name)
        if existing is not None and self.valid(existing):
            return existing
        if existing is None:
            tmp = f"{path}.claim.{me.owner}.{os.getpid()}"
            _atomic_write(tmp, {"owner": me.owner, "epoch": me.epoch})
            try:
                os.link(tmp, path)  # exclusive: exactly one claimant wins
                self._chaos_lease_written(path)
                return me
            except FileExistsError:
                won = self.read(name)
                if won is None:
                    # The lease path exists but holds garbage (a corrupted
                    # or torn write): break it and re-claim.  Atomic-rename
                    # writers never leave partials, so unreadable == dead.
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
                    return self.claim(name)
                return won
            finally:
                try:
                    os.unlink(tmp)
                except FileNotFoundError:
                    pass  # a recursive re-claim already reaped the same tmp
        return self._takeover(name, existing)

    def _takeover(self, name: str, stale: LeaseInfo) -> LeaseInfo:
        """Replace an orphaned lease under the exclusive sidecar lock."""
        path = self._path(name)
        lock = path + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            # Another taker is mid-takeover.  Break its lock only if it is
            # older than the heartbeat ttl (the taker died inside).
            try:
                age = time.time() - os.path.getmtime(lock)
            except FileNotFoundError:
                return self.claim(name)
            if age <= self.registry.ttl_s:
                won = self.read(name)
                return won if won is not None else self.claim(name)
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass
            return self.claim(name)
        if self._chaos is not None:
            # Chaos site "lease.takeover.locked" sits *outside* the
            # try/finally below on purpose: a ``crash`` fault raises here
            # and leaves the sidecar lock on disk — exactly the torn state
            # the stale-lock breaking above exists to recover from.
            self._chaos.at("lease.takeover.locked", name=name)
        try:
            current = self.read(name)
            if current is not None and (current != stale or self.valid(current)):
                return current  # someone else already took it over / owner revived
            me = LeaseInfo(name=name, owner=self.registry.host_id, epoch=self.registry.epoch)
            _atomic_write(path, {"owner": me.owner, "epoch": me.epoch})
            self._chaos_lease_written(path)
            return me
        finally:
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass

    def check(self, name: str) -> None:
        """Fencing: raise :class:`LeaseLost` unless this host validly owns
        ``name`` right now (the double-owner rejection point)."""
        info = self.read(name)
        if (
            info is None
            or info.owner != self.registry.host_id
            or info.epoch != self.registry.epoch
            or not self.valid(info)
        ):
            raise LeaseLost(
                f"host {self.registry.host_id} no longer owns {name!r} "
                f"(lease: {info})"
            )

    def release(self, name: str) -> None:
        """Drop this host's lease (no-op if not held)."""
        info = self.read(name)
        if info is not None and info.owner == self.registry.host_id:
            try:
                os.unlink(self._path(name))
            except FileNotFoundError:
                pass

    def owned(self) -> list[str]:
        out = []
        for fn in os.listdir(self.dir):
            if not fn.endswith(".lease"):
                continue
            rec = _read_json(os.path.join(self.dir, fn))
            if rec is not None and int(rec["owner"]) == self.registry.host_id:
                out.append(fn[: -len(".lease")].replace("@", ":").replace("__", os.sep))
        return out


# -------------------------------------------------------------------- gossip


class GossipBoard:
    """Per-host estimate files under ``_dstore/gossip/`` — the federation
    plane.  Each host publishes ``{host, time, nu, q, f, classes, hot}``
    (controller estimates when an :class:`IOController` is attached, tier
    ledgers otherwise); peers read the board to plan capacity per host and
    to place work where bytes are already hot (``hot`` maps owned file →
    resident bytes, top-``hot_limit`` by residency)."""

    def __init__(self, root: str, host_id: int, hot_limit: int = 256) -> None:
        self.dir = os.path.join(root, "_dstore", "gossip")
        os.makedirs(self.dir, exist_ok=True)
        self.host_id = host_id
        self.hot_limit = hot_limit

    def publish(self, payload: dict) -> None:
        hot = payload.get("hot")
        if hot and len(hot) > self.hot_limit:
            top = sorted(hot.items(), key=lambda kv: (-kv[1], kv[0]))[: self.hot_limit]
            payload = dict(payload, hot=dict(top))
        _atomic_write(
            os.path.join(self.dir, f"h{self.host_id:04d}.json"),
            dict(payload, host=self.host_id, time=time.time()),
        )

    def peers(self, include_self: bool = False) -> dict[int, dict]:
        out: dict[int, dict] = {}
        for fn in sorted(os.listdir(self.dir)):
            if not fn.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self.dir, fn))
            if rec is None:
                continue
            host = int(rec.get("host", -1))
            if host >= 0 and (include_self or host != self.host_id):
                out[host] = rec
        return out

    def hot_bytes(self) -> dict[int, dict[str, int]]:
        """host -> {file name -> hot (memory-resident) bytes} over the board."""
        return {
            host: {str(k): int(v) for k, v in rec.get("hot", {}).items()}
            for host, rec in self.peers(include_self=True).items()
        }


# ----------------------------------------------------------- peer transport


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    pos = 0
    while pos < n:
        got = sock.recv_into(view[pos:], n - pos)
        if not got:
            raise ConnectionError("peer closed mid-message")
        pos += got
    return bytes(buf)


def _send_msg(sock: socket.socket, header: dict, payload=b"") -> None:
    h = json.dumps(header).encode()
    # Prefix and header in one segment: a 8-byte write followed by a small
    # header write Nagle-stalls on the unacked first segment (~40 ms of
    # delayed ACK per request on loopback).  The bulk payload goes out
    # separately so it is never copied.
    sock.sendall(struct.pack(">II", len(h), len(payload)) + h)
    if len(payload):
        sock.sendall(payload)


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


class _PeerServer:
    """Block/metadata server for one host shard (loopback TCP).

    Serves: ``read_block`` (hot bytes + carried CRC, or a miss), ``put``
    (the forwarded-write path — runs the owner's write mode after a lease
    fencing check), ``delete``, ``size``, ``ping``.  One thread per
    connection; connections are long-lived (a peer keeps one open).
    """

    def __init__(self, dstore: "DistributedStore", port: int = 0) -> None:
        self._d = dstore
        # Pinning ``port`` lets restart_peer_server() come back on the same
        # addr — the restarted-peer scenario whose stale persistent sockets
        # _PeerClient must detect and survive.
        self._sock = socket.create_server(("127.0.0.1", port))
        self.addr = "{}:{}".format(*self._sock.getsockname())
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._accept = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="dstore-peer-accept")
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Accepted sockets must carry SO_REUSEADDR too, or their
            # lingering close states block a same-port server restart.
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="dstore-peer-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        header, payload = _recv_msg(conn)
                    except (ConnectionError, OSError, struct.error):
                        return
                    chaos = self._d.chaos
                    if chaos is not None:
                        # Chaos site "peer.serve": a drop here closes the
                        # connection after the request was received — the
                        # client cannot tell whether the op was applied
                        # (the classic ambiguous-failure window that makes
                        # non-idempotent retries need owner re-resolve).
                        spec = chaos.at("peer.serve", op=header.get("op"))
                        if spec is not None and spec.kind in ("drop", "error"):
                            return
                    try:
                        resp, out = self._dispatch(header, payload)
                    except LeaseLost as exc:
                        resp, out = {"ok": False, "err": "lease-lost", "msg": str(exc)}, b""
                    except (TierError, KeyError, ValueError) as exc:
                        resp, out = {"ok": False, "err": type(exc).__name__, "msg": str(exc)}, b""
                    try:
                        _send_msg(conn, resp, out)
                    except OSError:
                        return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _dispatch(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        d = self._d
        op = header.get("op")
        if op == "ping":
            return {"ok": True, "host": d.host_id}, b""
        if op == "read_block":
            hit = d.store.peek_block_wire(header["name"], int(header["idx"]))
            if hit is None:
                return {"ok": True, "hot": False}, b""
            blob, crc, enc, fb = hit
            with d._stats_lock:
                d.stats.peer_blocks_served += 1
                d.stats.peer_bytes_served += len(blob)
            resp = {"ok": True, "hot": True, "crc": crc}
            if enc is not None:
                # Wire compression (DESIGN.md §13): the payload is a TLC1
                # container and the CRC covers the *compressed* bytes.
                resp["enc"] = enc
                resp["fb"] = fb
            return resp, blob
        if op == "put":
            name = header["name"]
            d.leases.check(name)  # fencing: refuse if ownership moved
            mode = WriteMode(header["mode"]) if header.get("mode") else None
            d.store.put(name, payload, mode=mode)
            with d._stats_lock:
                d.stats.forwarded_puts_served += 1
            return {"ok": True}, b""
        if op == "delete":
            name = header["name"]
            d.leases.check(name)
            found = d.store.delete(name)
            d.leases.release(name)
            d._owned.discard(name)
            return {"ok": True, "found": found}, b""
        if op == "size":
            return {"ok": True, "size": d.store.file_size(header["name"])}, b""
        return {"ok": False, "err": "bad-op", "msg": str(op)}, b""

    def close(self) -> None:
        self._stop.set()
        # shutdown() wakes the thread blocked in accept(); close() alone
        # leaves the in-flight syscall holding the kernel socket open, so
        # the port would stay in LISTEN and block a same-port restart.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept.join(timeout=5)
        # Close accepted connections too: blocked _serve threads wake with
        # a socket error, and peers holding persistent connections see a
        # reset on their next send — which is what a restarted host looks
        # like from the outside.
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


class _PeerClient:
    """One persistent connection to a peer host (requests serialized).

    A peer that restarted at the same addr (or a transport blip) leaves
    this side holding a dead socket that only fails on the next send.
    ``request`` detects that first failure, reconnects **once**, and —
    only for idempotent requests — resends; a non-idempotent request
    (forwarded put) is never blindly resent because the first copy may
    already have been applied, so the failure surfaces as
    :class:`PeerUnreachable` for the owner-re-resolving retry layer.
    """

    def __init__(self, addr: str, chaos=None) -> None:
        self.addr = addr
        self._chaos = chaos
        self._lock = threading.Lock()
        self.reconnects = 0  # successful reconnect-and-resend recoveries
        self._sock = self._connect()

    def _connect(self) -> socket.socket:
        host, port = self.addr.rsplit(":", 1)
        if self._chaos is not None:
            # Chaos site "peer.connect": drop/error refuses the dial
            # (delay specs have already slept inside ``at``).
            spec = self._chaos.at("peer.connect", addr=self.addr)
            if spec is not None and spec.kind in ("drop", "error"):
                raise PeerUnreachable(f"connect {self.addr}: injected {spec.kind}")
        try:
            sock = socket.create_connection((host, int(port)), timeout=10.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as exc:
            raise PeerUnreachable(f"connect {self.addr}: {exc}") from exc

    def request(self, header: dict, payload=b"", idempotent: bool = True) -> tuple[dict, bytes]:
        with self._lock:
            if self._chaos is not None:
                # Chaos site "peer.request": drop/error breaks the
                # connection under this request, exactly like a peer that
                # died mid-exchange (delay specs sleep inside ``at``).
                spec = self._chaos.at("peer.request", addr=self.addr, op=header.get("op"))
                if spec is not None and spec.kind in ("drop", "error"):
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    raise PeerUnreachable(f"request to {self.addr}: injected {spec.kind}")
            try:
                _send_msg(self._sock, header, payload)
                return _recv_msg(self._sock)
            except (OSError, ConnectionError, struct.error) as exc:
                try:
                    self._sock.close()
                except OSError:
                    pass
                if not idempotent:
                    raise PeerUnreachable(f"request to {self.addr}: {exc}") from exc
                try:
                    self._sock = self._connect()
                    _send_msg(self._sock, header, payload)
                    resp = _recv_msg(self._sock)
                except (OSError, ConnectionError, struct.error, PeerUnreachable) as exc2:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    raise PeerUnreachable(f"request to {self.addr}: {exc2}") from exc2
                self.reconnects += 1
                return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------- stats


@dataclasses.dataclass
class DStoreStats:
    local_reads: int = 0
    local_read_bytes: int = 0
    peer_hot_blocks: int = 0  # blocks this host fetched from a peer's tier
    peer_hot_bytes: int = 0
    peer_cold_blocks: int = 0  # blocks read from the PFS tier directly
    peer_cold_bytes: int = 0
    peer_blocks_served: int = 0  # blocks this host served to others
    peer_bytes_served: int = 0
    forwarded_puts: int = 0  # writes this host routed to an owner
    forwarded_puts_served: int = 0  # writes this host performed for others
    lease_claims: int = 0
    takeovers: int = 0
    lease_lost: int = 0
    # -- resilience layer (DESIGN.md §12) --
    peer_retries: int = 0  # idempotent peer RPC attempts beyond the first
    peer_reconnects: int = 0  # stale persistent sockets recovered in-place
    circuit_short_circuits: int = 0  # requests refused by an open breaker
    cold_fallback_reads: int = 0  # peer reads degraded to the PFS cold path
    put_redirects: int = 0  # forwarded puts re-routed to a new owner
    reclaim_ticks: int = 0
    reclaimed_files: int = 0  # leases adopted by the background reclaimer
    reclaim_warmed_bytes: int = 0  # bytes pre-warmed into this shard
    reclaim_errors: int = 0
    recovery_events: list = dataclasses.field(default_factory=list)
    # -- self-healing cold tier (DESIGN.md §15) --
    scrub_repairs: int = 0  # keys this host's scrubber healed
    scrub_repaired_units: int = 0  # stripe-unit replicas it rewrote

    def peer_hot_fraction(self) -> float:
        """Of remotely-owned bytes this host read, the fraction served hot
        from the owner's memory shard (vs cold from the PFS tier)."""
        total = self.peer_hot_bytes + self.peer_cold_bytes
        return self.peer_hot_bytes / total if total else 0.0


# ----------------------------------------------------------------- the store


class DistributedStore:
    """One host shard of the distributed two-level store.

    Wraps a local :class:`TwoLevelStore` (this host's memory tier + the
    shared PFS tree) and routes every op by file ownership: owned files
    use the full local data path; remote files read hot bytes from the
    owner's shard (carried CRC, no wire re-verify) and cold bytes from
    the PFS tier directly, and forward writes to the owner.  Files with
    no (valid) lease are claimed on first write — or taken over on any
    access once their owner's heartbeat expires.

    Every host must be constructed with the same block/stripe geometry;
    the first host records it in ``_dstore/config.json`` and later hosts
    refuse to join with a mismatch (a peer-read block is only meaningful
    if both sides agree what a block is).
    """

    def __init__(
        self,
        host_id: int,
        pfs_root: str,
        mem_capacity_bytes: int = 1 << 30,
        lease_ttl_s: float = 5.0,
        failure=None,  # runtime.failure.FailureInjector | None
        controller=None,  # sched.IOController | None (bound to the local store)
        gossip_hot_limit: int = 256,
        auto_gossip: bool = True,
        chaos=None,  # runtime.failure.ChaosInjector | None
        retry: RetryPolicy | None = None,  # schedule for idempotent peer reads
        breaker_threshold: int = 3,
        breaker_reset_s: float | None = None,  # default: lease_ttl/2
        auto_reclaim: bool = True,
        reclaim_interval_s: float | None = None,  # default: lease_ttl/2
        reclaim_max_files: int = 8,  # leases adopted per tick (rate limit)
        reclaim_warm_bytes: int = 64 << 20,  # pre-warm budget per tick
        **store_kwargs,
    ) -> None:
        self.host_id = host_id
        self.root = pfs_root
        os.makedirs(os.path.join(pfs_root, "_dstore"), exist_ok=True)
        self.chaos = chaos
        self.store = TwoLevelStore(
            pfs_root,
            mem_capacity_bytes=mem_capacity_bytes,
            controller=controller,
            chaos=chaos,
            **store_kwargs,
        )
        self._check_config()
        self.failure = failure
        self._op = 0
        self.stats = DStoreStats()
        self._stats_lock = threading.Lock()
        self._owned: set[str] = set()
        self._owner_cache: dict[str, tuple[float, LeaseInfo | None]] = {}
        self._owner_cache_ttl = min(0.25, lease_ttl_s / 4.0)
        self._peers: dict[str, _PeerClient] = {}
        self._peers_lock = threading.Lock()
        # Resilience layer: read retries are free (idempotent); the
        # forwarded-put schedule is sized so a dead owner's heartbeat
        # expires *inside* the retry window — the final re-resolve then
        # finds an orphaned lease and the write lands via takeover.
        self._read_retry = retry or RetryPolicy(
            max_attempts=3, base_delay_s=0.02, max_delay_s=0.25,
            deadline_s=max(1.0, lease_ttl_s), seed=host_id,
        )
        self._fwd_retry = RetryPolicy(
            max_attempts=64, base_delay_s=0.05, max_delay_s=0.5,
            deadline_s=lease_ttl_s * 2.2, seed=host_id * 7 + 1,
        )
        self._breakers: dict[int, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = (
            breaker_reset_s if breaker_reset_s is not None else max(0.5, lease_ttl_s / 2.0)
        )
        # Serializes the claim/takeover slow path against the background
        # reclaimer so one orphan is adopted (and counted) exactly once
        # per host; the owner==self fast path stays lock-free.
        self._claim_lock = threading.Lock()

        self.registry = HostRegistry(pfs_root, host_id, ttl_s=lease_ttl_s, chaos=chaos)
        self.leases = LeaseTable(pfs_root, self.registry, chaos=chaos)
        self.gossip = GossipBoard(pfs_root, host_id, hot_limit=gossip_hot_limit)
        # Scrub coordination (DESIGN.md §15): when the wrapped store runs a
        # scrubber (scrub_interval_s in **store_kwargs), partition scrub
        # ownership by lease — each file is scrubbed by exactly one host —
        # and publish repair events on the gossip board.
        self._repair_events: list[dict] = []
        if self.store.scrubber is not None:
            self.store.scrubber.filter_fn = self._scrub_owns
            self.store.scrubber.on_repair = self._on_scrub_repair
        self.server = _PeerServer(self)
        self.registry.publish(self.server.addr)
        if auto_gossip:
            self.registry._renew_hooks.append(self.publish_gossip)
        self.registry.start()
        self.auto_reclaim = auto_reclaim
        self.reclaim_interval_s = (
            reclaim_interval_s if reclaim_interval_s is not None else max(0.25, lease_ttl_s / 2.0)
        )
        self.reclaim_max_files = reclaim_max_files
        self.reclaim_warm_bytes = reclaim_warm_bytes
        self._reclaim_stop = threading.Event()
        self._reclaim_thread: threading.Thread | None = None
        if auto_reclaim:
            self._reclaim_thread = threading.Thread(
                target=self._reclaim_loop, daemon=True, name="dstore-reclaim"
            )
            self._reclaim_thread.start()
        self._closed = False

    # ------------------------------------------------------------ plumbing

    def _check_config(self) -> None:
        path = os.path.join(self.root, "_dstore", "config.json")
        mine = {
            "block_bytes": self.store.layout.block_size,
            "n_pfs_servers": self.store.pfs.n_servers,
            "stripe_bytes": self.store.pfs.stripe_bytes,
            "replication": self.store.pfs.replication,
        }
        existing = _read_json(path)
        if existing is None:
            _atomic_write(path, mine)
            existing = _read_json(path) or mine
        if existing != mine:
            self.store.close()
            raise ValueError(
                f"host geometry {mine} differs from the namespace's {existing} — "
                "all shards of one distributed store must agree on block/stripe layout"
            )

    def _step(self) -> None:
        """Fault-injection hook: each public data-plane op is one step."""
        if self.failure is not None:
            self._op += 1
            self.failure.maybe_fail(self._op)

    def owner_of(self, name: str, fresh: bool = False) -> LeaseInfo | None:
        """The file's current lease (cached briefly; ``fresh`` forces a read)."""
        now = time.monotonic()
        if not fresh:
            hit = self._owner_cache.get(name)
            if hit is not None and now - hit[0] < self._owner_cache_ttl:
                return hit[1]
        info = self.leases.read(name)
        self._owner_cache[name] = (now, info)
        return info

    def _peer(self, host_id: int) -> _PeerClient:
        rec = self.registry.live(host_id)
        if rec is None or not rec.get("addr"):
            raise PeerUnreachable(f"host {host_id} has no live heartbeat")
        addr = rec["addr"]
        with self._peers_lock:
            client = self._peers.get(addr)
            if client is None:
                client = self._peers[addr] = _PeerClient(addr, chaos=self.chaos)
            return client

    def _drop_peer(self, client: _PeerClient) -> None:
        with self._peers_lock:
            self._peers.pop(client.addr, None)
        client.close()

    def _breaker(self, host_id: int) -> CircuitBreaker:
        with self._breakers_lock:
            br = self._breakers.get(host_id)
            if br is None:
                br = self._breakers[host_id] = CircuitBreaker(
                    failure_threshold=self._breaker_threshold,
                    reset_s=self._breaker_reset_s,
                    name=f"peer-{host_id}",
                )
            return br

    def _peer_request(
        self, owner: int, header: dict, payload=b"", idempotent: bool = True
    ) -> tuple[dict, bytes]:
        """One peer RPC under the resilience layer: circuit breaker in
        front, bounded retry behind (idempotent requests only).

        Raises :class:`CircuitOpen` without touching the wire while the
        peer's breaker is open, and :class:`PeerUnreachable` once the
        retry schedule is spent — callers degrade (cold fallback for
        reads, owner re-resolve for writes) rather than propagate.
        """
        br = self._breaker(owner)

        def attempt(_i: int) -> tuple[dict, bytes]:
            if not br.allow():
                with self._stats_lock:
                    self.stats.circuit_short_circuits += 1
                raise CircuitOpen(f"peer {owner} circuit open")
            client = self._peer(owner)  # PeerUnreachable if no live heartbeat
            before = client.reconnects
            try:
                out = client.request(header, payload, idempotent=idempotent)
            except PeerUnreachable:
                self._drop_peer(client)
                br.record_failure()
                raise
            if client.reconnects != before:
                with self._stats_lock:
                    self.stats.peer_reconnects += 1
            br.record_success()
            return out

        if not idempotent:
            return attempt(0)

        def on_retry(_n: int, _exc: BaseException) -> None:
            with self._stats_lock:
                self.stats.peer_retries += 1

        return self._read_retry.run(attempt, retry_on=(PeerUnreachable,), on_retry=on_retry)

    def _ensure_owned(self, name: str) -> None:
        """Claim/validate ownership of ``name`` for this host, taking over
        an orphaned lease if its owner is gone.  Raises :class:`NotOwner`
        if a *live* peer owns it."""
        info = self.owner_of(name, fresh=True)
        if info is not None and info.owner == self.host_id:
            self.leases.check(name)  # also catches our own stale epoch
            self._owned.add(name)
            return
        if info is not None and self.leases.valid(info):
            raise NotOwner(f"{name!r} is owned by live host {info.owner}")
        with self._claim_lock:
            # Re-read under the lock: the background reclaimer (or another
            # reader thread) may have just adopted this file for us — the
            # takeover must be observed once, not re-run.
            info = self.owner_of(name, fresh=True)
            if info is not None and info.owner == self.host_id:
                self.leases.check(name)
                self._owned.add(name)
                return
            if info is not None and self.leases.valid(info):
                raise NotOwner(f"{name!r} is owned by live host {info.owner}")
            took_over = info is not None
            won = self.leases.claim(name)
            self._owner_cache[name] = (time.monotonic(), won)
            if won.owner != self.host_id:
                raise NotOwner(f"{name!r} was claimed concurrently by host {won.owner}")
            self._owned.add(name)
            with self._stats_lock:
                self.stats.lease_claims += 1
                if took_over:
                    self.stats.takeovers += 1
            if took_over:
                # The dead owner's bytes are durable only on the PFS tier
                # from this host's view; adopt them into the block path so
                # reads promote into the new owner's memory shard.
                self.store.adopt_cold(name)

    # ---------------------------------------------------------- write path

    def put(self, name: str, data, mode: WriteMode | None = None) -> None:
        """Write a file through its owner's flush lanes.

        Owned (or unowned) files run the local store's write path; files
        owned by a live peer are forwarded over the transport and written
        by the owner under its own write mode and lease check.  A dead
        owner's files are taken over first — the new owner's write then
        supersedes whatever the dead shard never flushed (the durable
        contract was always the PFS copy).
        """
        self._step()
        info = self.owner_of(name, fresh=True)
        if info is not None and info.owner != self.host_id and self.leases.valid(info):
            if name in self._owned:
                # Double-owner rejection: this host held the lease and lost
                # it (crash takeover while it was silent).  Its first write
                # afterwards must fail loudly — its unflushed shard state is
                # superseded — rather than silently racing the new owner.
                self._owned.discard(name)
                with self._stats_lock:
                    self.stats.lease_lost += 1
                raise LeaseLost(
                    f"host {self.host_id} lost the lease on {name!r} to "
                    f"host {info.owner}"
                )
            self._forward_put(info, name, data, mode)
            return
        self._ensure_owned(name)
        self.store.put(name, data, mode=mode)
        try:
            # Fencing check *after* the write too: if the lease moved while
            # bytes were in flight the caller must learn its copy may be
            # superseded.  (Check-then-write keeps the common path cheap.)
            self.leases.check(name)
        except LeaseLost:
            with self._stats_lock:
                self.stats.lease_lost += 1
            raise

    def _forward_put(self, info: LeaseInfo, name: str, data, mode: WriteMode | None) -> None:
        """Forward a write to the file's owner, surviving owner death.

        Non-idempotent, so every retry is preceded by a **fresh owner
        re-resolve** (never a blind resend — the first copy may have been
        applied, and fencing must keep rejecting double-owners):

        * owner still live and leased → back off and retry the same host
          within the policy budget (sized so a dead owner's heartbeat
          expires inside it);
        * lease moved to another live host → redirect immediately;
        * lease moved to *us* (the reclaimer adopted it) → write locally;
        * lease orphaned → claim-or-takeover, then write locally.

        The owner answering ``lease-lost`` is the same re-resolve trigger:
        the server refused because ownership moved under the forwarder.
        """
        payload = bytes(data)
        policy = self._fwd_retry
        t0 = time.monotonic()
        attempt = 0
        while True:
            header = {"op": "put", "name": name, "mode": mode.value if mode else None}
            resp = None
            try:
                resp, _ = self._peer_request(info.owner, header, payload, idempotent=False)
            except (PeerUnreachable, CircuitOpen):
                pass
            if resp is not None:
                if resp.get("ok"):
                    with self._stats_lock:
                        self.stats.forwarded_puts += 1
                    return
                if resp.get("err") != "lease-lost":
                    raise TierError(f"forwarded put of {name!r} failed: {resp}")
            # Re-resolve before any retry (idempotency-aware schedule).
            attempt += 1
            with self._stats_lock:
                self.stats.peer_retries += 1
            fresh = self.owner_of(name, fresh=True)
            if fresh is None or not self.leases.valid(fresh) or fresh.owner == self.host_id:
                # Orphaned (owner died / lease corrupted) or already ours:
                # claim-or-takeover, then run the local write path.
                try:
                    self._ensure_owned(name)
                except NotOwner:
                    fresh = self.owner_of(name, fresh=True)
                    if fresh is None:
                        raise
                    # lost the claim race — fall through to redirect
                else:
                    self.store.put(name, data, mode=mode)
                    return
            if fresh.owner != info.owner:
                info = fresh  # new owner: redirect with no backoff
                with self._stats_lock:
                    self.stats.put_redirects += 1
                continue
            delay = policy.backoff(attempt)
            if policy.give_up(attempt, t0, delay):
                raise PeerUnreachable(
                    f"forwarded put of {name!r} to live host {info.owner} "
                    f"failed after {attempt} attempts"
                )
            time.sleep(delay)

    def delete(self, name: str) -> bool:
        self._step()
        info = self.owner_of(name, fresh=True)
        if info is not None and info.owner != self.host_id and self.leases.valid(info):
            try:
                resp, _ = self._peer_request(info.owner, {"op": "delete", "name": name})
            except (PeerUnreachable, CircuitOpen):
                # Owner died under the delete: if its lease lapsed, finish
                # the delete as the new owner; a live-but-unreachable owner
                # still surfaces (deletes must not silently half-apply).
                if self.leases.valid(self.owner_of(name, fresh=True)):
                    raise
            else:
                if not resp.get("ok"):
                    raise TierError(f"forwarded delete of {name!r} failed: {resp}")
                self._owner_cache.pop(name, None)
                return bool(resp.get("found"))
        self._ensure_owned(name)
        found = self.store.delete(name)
        self.leases.release(name)
        self._owned.discard(name)
        self._owner_cache.pop(name, None)
        return found

    # ----------------------------------------------------------- read path

    def get(self, name: str) -> bytes:
        """Read a whole file from the nearest copies.

        Owner: the local tiered path (memory hit → ν, miss → PFS).
        Non-owner with a live peer: per-block peer reads for bytes hot in
        the owner's shard (CRC carried with each transfer), PFS-direct
        for the rest — never promoting into this host's tier.
        Orphaned file: take over the lease, then read locally (cold bytes
        come off the PFS tier bit-identically — that is the takeover
        correctness the multihost benchmark gates).
        """
        self._step()
        info = self.owner_of(name)
        if info is None or info.owner == self.host_id:
            if info is None and not self.store.exists(name):
                raise BlockNotFound(name)
            data = self.store.get(name)
            with self._stats_lock:
                self.stats.local_reads += 1
                self.stats.local_read_bytes += len(data)
            return data
        if self.leases.valid(info):
            try:
                return self._remote_get(info, name)
            except (PeerUnreachable, CircuitOpen):
                pass  # live heartbeat but dead transport: degrade to cold
            return self._cold_get(name)
        # Orphaned: the owner's heartbeat lapsed — take the file over.
        self._ensure_owned(name)
        data = self.store.get(name)
        with self._stats_lock:
            self.stats.local_reads += 1
            self.stats.local_read_bytes += len(data)
        return data

    def get_range(self, name: str, offset: int, size: int) -> bytes:
        """Ranged read with the same routing as :meth:`get` (owner-local
        ranged path; non-owners read the covering blocks hot-or-cold)."""
        self._step()
        info = self.owner_of(name)
        if info is None or info.owner == self.host_id or not self.leases.valid(info):
            if info is not None and info.owner != self.host_id:
                self._ensure_owned(name)  # orphaned: takeover, then local
            return self.store.get_range(name, offset, size)
        total = self.file_size(name)
        end = min(offset + size, total)
        if end <= offset:
            return b""
        bb = self.store.layout.block_size
        parts = []
        for idx in range(offset // bb, (end - 1) // bb + 1):
            blk = self._remote_block(info, name, idx, min(bb, total - idx * bb))
            lo = max(offset, idx * bb) - idx * bb
            hi = min(end, (idx + 1) * bb) - idx * bb
            parts.append(blk[lo:hi])
        return b"".join(parts)

    def _remote_get(self, info: LeaseInfo, name: str) -> bytes:
        total = self._remote_size(info, name)
        bb = self.store.layout.block_size
        n_blocks = (total + bb - 1) // bb
        parts = [
            self._remote_block(info, name, i, min(bb, total - i * bb))
            for i in range(n_blocks)
        ]
        return b"".join(parts)

    def _remote_block(self, info: LeaseInfo, name: str, idx: int, blen: int) -> bytes:
        """One block of a remotely-owned file: owner's memory shard first
        (hot bytes + carried CRC), the shared PFS tier second.

        Reads are idempotent, so the peer RPC retries freely under the
        read policy; once the schedule is spent (or the owner's circuit
        is open) the block degrades to the ``PFS_BYPASS`` cold path — a
        dead peer costs latency, never availability, because the durable
        copy is on the shared tier.
        """
        resp: dict | None = None
        payload = b""
        try:
            resp, payload = self._peer_request(
                info.owner, {"op": "read_block", "name": name, "idx": idx}
            )
        except (PeerUnreachable, CircuitOpen):
            with self._stats_lock:
                self.stats.cold_fallback_reads += 1
        if resp is not None and resp.get("ok") and resp.get("hot"):
            # CRC carried with the transfer — recorded, not recomputed
            # (no re-verify on the wire path; see DESIGN.md §11).
            with self._stats_lock:
                self.stats.peer_hot_blocks += 1
                self.stats.peer_hot_bytes += len(payload)
            if resp.get("enc") is not None:
                # Compressed wire payload: verify transport integrity over
                # the compressed bytes (the carried CRC covers those), then
                # decode locally — the decoder's framing checks catch any
                # deeper corruption (DESIGN.md §13).
                if zlib.crc32(payload) != resp["crc"]:
                    raise IntegrityError(f"peer wire CRC mismatch for {name}:{idx}")
                data, _ = blockcodec.decode(payload, int(resp.get("fb") or 256 * 1024))
                return data
            return payload
        data = self.store.get_range(
            name, idx * self.store.layout.block_size, blen, mode=ReadMode.PFS_BYPASS
        )
        with self._stats_lock:
            self.stats.peer_cold_blocks += 1
            self.stats.peer_cold_bytes += len(data)
        return data

    def _remote_size(self, info: LeaseInfo, name: str) -> int:
        try:
            resp, _ = self._peer_request(info.owner, {"op": "size", "name": name})
        except (PeerUnreachable, CircuitOpen):
            # Manifests live on the shared PFS tier: answer locally rather
            # than fail the read because the owner is unreachable.
            return self.store.file_size(name)
        if not resp.get("ok"):
            raise BlockNotFound(name)
        return int(resp["size"])

    def _cold_get(self, name: str) -> bytes:
        """Whole-file read straight off the shared PFS tier (read mode (e)
        — no promotion into this non-owner's shard)."""
        data = self.store.get(name, mode=ReadMode.PFS_BYPASS)
        with self._stats_lock:
            self.stats.peer_cold_blocks += 1
            self.stats.peer_cold_bytes += len(data)
        return data

    # --------------------------------------------------------- reclamation

    def _reclaim_loop(self) -> None:
        while not self._reclaim_stop.wait(self.reclaim_interval_s):
            try:
                self.reclaim_now()
            except Exception:
                with self._stats_lock:
                    self.stats.reclaim_errors += 1

    def reclaim_now(self) -> list[str]:
        """One reclamation tick (the background thread runs this every
        ``reclaim_interval_s``; tests and operators may call it directly).

        Scans the host registry for expired heartbeats; for each lease
        still naming a dead host, runs the normal takeover path
        (``_ensure_owned`` + ``adopt_cold``) so readers find an owner
        *before* they pay takeover latency inline.  Work is rate-limited
        to ``reclaim_max_files`` per tick and ordered hottest-first by
        the dead owner's last gossip report — the bytes most likely to be
        read next recover first.  Within ``reclaim_warm_bytes`` the
        adopted file is also pre-warmed (read through the local store,
        promoting it into this host's memory shard), which is what turns
        post-failure first reads from PFS-latency into memory-latency.

        Returns the names adopted this tick.  Losing a claim race to
        another live host is normal and silent — exactly one host wins
        each lease.
        """
        with self._stats_lock:
            self.stats.reclaim_ticks += 1
        now = time.time()
        dead: set[int] = set()
        for rec in self.registry.hosts():
            h = int(rec.get("host", -1))
            if h >= 0 and h != self.host_id and now >= rec.get("expires", 0.0):
                dead.add(h)
        if not dead:
            return []
        orphans: list[tuple[str, int]] = []
        for fn in os.listdir(self.leases.dir):
            if not fn.endswith(".lease"):
                continue
            rec = _read_json(os.path.join(self.leases.dir, fn))
            if rec is None:
                continue  # corrupt lease: the access path re-claims it
            owner = int(rec["owner"])
            if owner not in dead:
                continue
            name = fn[: -len(".lease")].replace("@", ":").replace("__", os.sep)
            info = LeaseInfo(name=name, owner=owner, epoch=int(rec["epoch"]))
            if not self.leases.valid(info):
                orphans.append((name, owner))
        if not orphans:
            return []
        hot = self.gossip.hot_bytes()
        orphans.sort(key=lambda it: (-hot.get(it[1], {}).get(it[0], 0), it[0]))
        reclaimed: list[str] = []
        warm_budget = self.reclaim_warm_bytes
        for name, owner in orphans[: self.reclaim_max_files]:
            t_start = time.monotonic()
            try:
                self._ensure_owned(name)
            except (NotOwner, TierError):
                continue  # raced: another live host adopted it
            warmed = 0
            if warm_budget > 0:
                try:
                    size = self.store.file_size(name)
                    if size <= warm_budget:
                        self.store.get(name)  # promotes into this shard
                        warmed = size
                        warm_budget -= size
                except (BlockNotFound, TierError):
                    pass  # durable copy unreadable right now: own it cold
            reclaimed.append(name)
            with self._stats_lock:
                self.stats.reclaimed_files += 1
                self.stats.reclaim_warmed_bytes += warmed
                self.stats.recovery_events.append(
                    {
                        "name": name,
                        "from_host": owner,
                        "warm_bytes": warmed,
                        "latency_s": time.monotonic() - t_start,
                    }
                )
        return reclaimed

    # --------------------------------------------------------------- scrub

    def _scrub_owns(self, key: str) -> bool:
        """Scrub-ownership partition: does *this* host scrub ``key``?

        Block keys derive from file names (``name:idx``), and files have
        exactly one valid lease — so the lease owner scrubs them, and the
        whole namespace is covered with no double work.  Files with no
        valid lease (never claimed, or orphaned mid-takeover) fall back to
        a deterministic hash partition over the live host set, so they are
        still scrubbed by exactly one host rather than by all or none.
        """
        name = key.rsplit(":", 1)[0]
        info = self.leases.read(name)
        if info is not None and self.leases.valid(info):
            return info.owner == self.host_id
        now = time.time()
        live = sorted(
            int(rec["host"]) for rec in self.registry.hosts()
            if now < rec.get("expires", 0.0)
        )
        if not live or self.host_id not in live:
            return True  # registry unreadable/raced: scrub rather than skip
        return live[zlib.crc32(name.encode()) % len(live)] == self.host_id

    def _on_scrub_repair(self, key: str, result: dict) -> None:
        """Scrubber repair hook: count it and stage a gossip repair event
        (published with the next heartbeat's gossip payload)."""
        event = {
            "key": key,
            "host": self.host_id,
            "units": int(result.get("repaired_units", 0)),
            "manifests": int(result.get("repaired_manifests", 0)),
            "time": time.time(),
        }
        with self._stats_lock:
            self.stats.scrub_repairs += 1
            self.stats.scrub_repaired_units += event["units"]
            self._repair_events.append(event)
            del self._repair_events[:-64]  # bounded: latest 64 events gossip

    def scrub_now(self) -> dict:
        """One synchronous scrub pass over this host's owned partition
        (tests/operators; the background thread runs the same pass)."""
        scrubber = self.store.scrubber
        if scrubber is None:
            raise RuntimeError("store was built without scrub_interval_s")
        return scrubber.scrub_once()

    def restart_peer_server(self) -> None:
        """Bounce the peer transport endpoint, keeping the same port and
        this host's leases (a transport blip, not a process restart — the
        registry epoch is unchanged).  Peers holding persistent sockets
        see a reset on their next send; test hook for the stale-connection
        recovery path."""
        _, port = self.server.addr.rsplit(":", 1)
        self.server.close()
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self.server = _PeerServer(self, port=int(port))
                break
            except OSError:
                # Old connection sockets can hold the port briefly while
                # their close handshakes drain.
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self.registry.publish(self.server.addr)

    # -------------------------------------------------------------- manage

    def claim(self, name: str) -> None:
        """Explicitly take ownership of ``name`` (placement pre-claims files
        on the host that will write/serve them)."""
        self._step()
        self._ensure_owned(name)

    def exists(self, name: str) -> bool:
        return self.store.exists(name)

    def file_size(self, name: str) -> int:
        info = self.owner_of(name)
        if info is not None and info.owner != self.host_id and self.leases.valid(info):
            try:
                return self._remote_size(info, name)
            except (PeerUnreachable, CircuitOpen):
                pass
        return self.store.file_size(name)

    def owned_files(self) -> list[str]:
        return sorted(self._owned)

    # ---------------------------------------------------------- federation

    def publish_gossip(self) -> None:
        """Publish this shard's estimates + hot map; ingest every peer's.

        With a controller attached the payload is its
        ``export_estimates()`` (live ν/q/f + per-class footprints) and
        ingest feeds ``note_peer`` — the controller's capacity plan then
        sees the whole federation.  Without one, tier ledgers stand in so
        placement planners still get a hot map.
        """
        ctrl = self.store.controller
        if ctrl is not None:
            payload = ctrl.export_estimates()
        else:
            mem = self.store.mem.stats
            pfs = self.store.pfs.stats
            payload = {
                "nu_mbps": mem.aggregate_read_mbps(),
                "q_read_mbps": pfs.aggregate_read_mbps(),
                "q_write_mbps": pfs.aggregate_write_mbps(),
                "f": self.store.resident_fraction(),
                "classes": {},
            }
        hot: dict[str, int] = {}
        for name in list(self._owned):
            try:
                size = self.store.file_size(name)
            except (BlockNotFound, TierError):
                continue
            resident = self.store.resident_fraction(name)
            if resident > 0:
                hot[name] = int(resident * size)
        payload = dict(payload, hot=hot, addr=self.server.addr)
        with self._stats_lock:
            if self._repair_events:
                # Repair events ride the gossip board (DESIGN.md §15): peers
                # see which keys were healed where, and the benchmarks can
                # assert cluster-wide repair visibility without new RPCs.
                payload["repairs"] = list(self._repair_events)
        self.gossip.publish(payload)
        if ctrl is not None:
            for host, rec in self.gossip.peers().items():
                ctrl.note_peer(host, rec)

    def cluster_hot_bytes(self) -> dict[int, dict[str, int]]:
        """host -> {file -> hot bytes} over the gossip board (placement input)."""
        return self.gossip.hot_bytes()

    def cluster_repairs(self) -> dict[int, list[dict]]:
        """host -> recent scrub-repair events over the gossip board."""
        return {
            host: list(rec.get("repairs", []))
            for host, rec in self.gossip.peers(include_self=True).items()
            if rec.get("repairs")
        }

    # --------------------------------------------------------------- stats

    def tier_stats(self) -> dict[str, dict]:
        out = self.store.tier_stats()
        with self._stats_lock:
            d = dataclasses.asdict(self.stats)
        with self._breakers_lock:
            d["circuit_states"] = {h: br.state for h, br in sorted(self._breakers.items())}
        out["dstore"] = d
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._reclaim_stop.set()
        if self._reclaim_thread is not None:
            self._reclaim_thread.join(timeout=5)
            self._reclaim_thread = None
        self.registry.stop()
        self.server.close()
        with self._peers_lock:
            for client in self._peers.values():
                client.close()
            self._peers.clear()
        self.store.close()

    def __enter__(self) -> "DistributedStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
