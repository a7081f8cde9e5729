"""Elastic bridge fleet: replicated servers, journal-backed job migration,
zero-downtime rolling restarts.

The port's copy of ``tensorframes_tpu/bridge/fleet.py``, with the same
routing (sha256 rendezvous scores, so both packages route every key to
the same replica), the same registry file layout and field names (so
each package's :func:`registry_live_pids` reads the other's heartbeats),
and the same router snapshot.  A single server is one failure domain;
this module assembles the serving layer's pieces (token-addressed
sessions and graceful drain, the SLO scheduler and warm pools, the
fenced job journal with ``SessionLost`` resume) into a horizontally
scaled service:

* :class:`FleetRouter` — rendezvous-hashes a session key over the
  healthy replicas (minimal disruption: removing a replica only remaps
  the keys it owned), polls each replica's ungated ``health`` RPC, and
  quarantines flappers the way the device pool quarantines devices
  (bounded hold).
* :class:`BridgeFleet` — runs N ``BridgeServer`` replicas, each its own
  OS process (``python -m tensorframes_tpu_torch.bridge.replica``)
  sharing the compile cache (``TFS_COMPILE_CACHE``: kernel libraries and
  exported programs), the planner calibration file, and the job journal
  (``TFS_JOURNAL_DIR``) — so a dead replica's durable jobs are adoptable
  by any peer.  ``device=`` is where every replica serves (None = the
  CUDA card; a replica never falls back to the CPU).  A
  ``mode="thread"`` fleet runs the replicas in-process for cheap
  router/drain tests (no real SIGKILL there; process mode is the chaos
  surface).
* :class:`FleetClient` — the failover-aware front end: a
  :class:`~tensorframes_tpu_torch.bridge.client.BridgeClient` bound to
  the routed replica with the router wired in, so ``Draining``, severed
  connections, and ``SessionLost`` reroute to a healthy peer instead of
  surfacing.  A re-issued durable request (``job_id=``) adopts the dead
  replica's journal fence on the new replica and resumes from the last
  window boundary — exactly-once by the journal's construction, counted
  in ``fleet_jobs_migrated``.
* the **fleet registry** — one heartbeat file per replica
  (``TFS_FLEET_REGISTRY``), written by the server and consulted by the
  recovery janitor so artifacts owned by a pid that is alive IN THE
  FLEET are never reclaimed on the word of a same-host ``os.kill(pid,
  0)`` (which cannot see across containers / pid namespaces).

Rolling restarts compose the existing drain: mark the replica draining
in the router (new sessions route elsewhere), drain it (in-flight
requests finish; durable stragglers hand off via the journal), restart
the process, wait for it to rejoin healthy.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import envutil, observability
from .protocol import connect, read_message, write_message

logger = logging.getLogger("tensorframes_tpu_torch.bridge.fleet")

ENV_FLEET_SIZE = "TFS_FLEET_SIZE"
ENV_FLEET_REGISTRY = "TFS_FLEET_REGISTRY"
ENV_FLEET_HEALTH_S = "TFS_FLEET_HEALTH_S"
ENV_FLEET_QUARANTINE_AFTER = "TFS_FLEET_QUARANTINE_AFTER"
ENV_FLEET_QUARANTINE_S = "TFS_FLEET_QUARANTINE_S"
# set per replica by the fleet spawner; the server stamps it into its
# health/hello replica identity so routers and logs name replicas
# stably across restarts (the EPOCH token is what changes)
ENV_FLEET_REPLICA = "TFS_FLEET_REPLICA"

DEFAULT_HEALTH_S = 0.5
DEFAULT_QUARANTINE_AFTER = 3
DEFAULT_QUARANTINE_S = 30.0
# flap window: DOWN transitions (and epoch changes = silent restarts)
# inside this many seconds count toward the quarantine threshold
FLAP_WINDOW_S = 60.0
# a registry heartbeat older than this marks its writer unknown-dead:
# generous against GC pauses / busy boxes, small enough that a truly
# dead replica's artifacts become reclaimable within a janitor sweep
REGISTRY_TTL_S = 15.0


# ---------------------------------------------------------------------------
# fleet registry (heartbeat files; the janitor's cross-process liveness)
# ---------------------------------------------------------------------------


def registry_dir() -> str:
    """The live fleet-registry root ('' = no registry configured)."""
    return envutil.env_raw(ENV_FLEET_REGISTRY)


def registry_write(
    name: str,
    host: str,
    port: int,
    pid: Optional[int] = None,
    epoch: str = "",
    root: Optional[str] = None,
) -> None:
    """Write/refresh one replica's heartbeat file (atomic replace; the
    file's mtime IS the heartbeat — no clock parsing on the read side).
    A no-op when no registry is configured."""
    r = registry_dir() if root is None else root
    if not r:
        return
    os.makedirs(r, exist_ok=True)
    doc = {
        "name": name,
        "host": host,
        "port": int(port),
        "pid": int(os.getpid() if pid is None else pid),
        "epoch": epoch,
        "time": time.time(),
    }
    path = os.path.join(r, f"replica-{name}.json")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(doc))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def registry_remove(name: str, root: Optional[str] = None) -> None:
    """Remove a replica's heartbeat (clean shutdown).  Best effort."""
    r = registry_dir() if root is None else root
    if not r:
        return
    try:
        os.remove(os.path.join(r, f"replica-{name}.json"))
    except OSError:
        pass


def registry_live_pids(
    root: Optional[str] = None, ttl_s: float = REGISTRY_TTL_S
) -> frozenset:
    """Pids with a FRESH heartbeat in the fleet registry — the janitor's
    cross-process liveness source: an artifact owned by one of these is
    never reclaimable, whatever the scanning process's ``os.kill(pid,
    0)`` says (a registry replica may live in another container or pid
    namespace where that probe lies)."""
    r = registry_dir() if root is None else root
    if not r:
        return frozenset()
    now = time.time()
    out = set()
    try:
        names = os.listdir(r)
    except OSError:
        return frozenset()
    for n in names:
        if not (n.startswith("replica-") and n.endswith(".json")):
            continue
        path = os.path.join(r, n)
        try:
            if now - os.path.getmtime(path) > ttl_s:
                continue
            with open(path) as f:
                doc = json.load(f)
            out.add(int(doc["pid"]))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return frozenset(out)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def _rendezvous_score(name: str, key: str) -> int:
    return int.from_bytes(
        hashlib.sha256(f"{name}|{key}".encode()).digest()[:8], "big"
    )


def _fetch_health(
    host: str, port: int, timeout_s: float = 2.0
) -> Dict[str, Any]:
    """One raw ``health`` round trip — no ``hello``, so a poll never
    creates (and TTL-leaks) a server-side session."""
    with connect(host, port, timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        w = s.makefile("wb")
        r = s.makefile("rb")
        write_message(w, {"id": 1, "method": "health", "params": {}})
        resp, _bins = read_message(r)
    if "error" in resp:
        raise ConnectionError(f"health refused: {resp['error']}")
    return resp["result"]


class _ReplicaState:
    __slots__ = (
        "name", "host", "port", "healthy", "draining", "pid", "epoch",
        "uptime_s", "p99_ms", "sessions", "flaps", "quarantined_until",
        "last_ok", "failures",
    )

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = int(port)
        self.healthy = False  # unknown until the first poll succeeds
        self.draining = False
        self.pid: Optional[int] = None
        self.epoch: str = ""
        self.uptime_s: float = 0.0
        self.p99_ms: Optional[float] = None
        self.sessions: int = 0
        # monotonic times of DOWN transitions + epoch changes (restarts)
        self.flaps: "collections.deque[float]" = collections.deque(
            maxlen=64
        )
        self.quarantined_until: float = 0.0
        self.last_ok: float = 0.0
        self.failures: int = 0

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)


# live routers, for tft.doctor()'s fleet rules (weakrefs so a dropped
# router never outlives its test)
_live_routers: "weakref.WeakSet" = weakref.WeakSet()


def doctor_snapshot() -> Optional[Dict[str, Any]]:
    """The newest live router's :meth:`FleetRouter.snapshot`, or None —
    the evidence surface the ``replica_flap`` / ``fleet_imbalance``
    doctor rules read."""
    snap = None
    for r in _live_routers:
        try:
            snap = r.snapshot()
        except Exception:  # noqa: BLE001 — doctor evidence is best effort
            continue
    return snap


class FleetRouter:
    """Rendezvous-hash router + health poller over bridge replicas.

    Routing is *rendezvous* (highest-random-weight): every (key,
    replica) pair gets a deterministic score and the eligible replica
    with the highest score owns the key — so adding or removing one
    replica remaps only that replica's keys, which is exactly the
    property a rolling restart wants (drained replica's keys spread
    over the peers; everyone else's sessions stay put).

    Eligibility excludes draining, quarantined, and known-unhealthy
    replicas; when nothing is eligible the router degrades gracefully
    (draining peers, then anything known) rather than refusing — a
    degraded route can still shed structured errors the client's retry
    loop understands, which beats routing nowhere.

    Health state comes from :meth:`poll_once` (a background thread via
    :meth:`start`, or called explicitly by tests with an injected
    ``fetch``) plus client feedback (:meth:`note_failed` /
    :meth:`note_draining`).  A replica whose identity EPOCH changes
    between polls restarted silently — that counts as a flap, same as a
    down transition; ``quarantine_after`` flaps inside
    ``FLAP_WINDOW_S`` quarantines it for ``quarantine_s`` (counted in
    ``fleet_quarantines``), mirroring the device pool's device
    quarantine."""

    def __init__(
        self,
        replicas: Optional[
            Sequence[Tuple[str, str, int]]
        ] = None,  # (name, host, port)
        health_s: Optional[float] = None,
        quarantine_after: Optional[int] = None,
        quarantine_s: Optional[float] = None,
        fetch: Optional[Callable[[str, int], Dict[str, Any]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.health_s = (
            envutil.env_float(ENV_FLEET_HEALTH_S, DEFAULT_HEALTH_S)
            if health_s is None
            else float(health_s)
        )
        self.quarantine_after = (
            envutil.env_int(
                ENV_FLEET_QUARANTINE_AFTER, DEFAULT_QUARANTINE_AFTER
            )
            if quarantine_after is None
            else int(quarantine_after)
        )
        self.quarantine_s = (
            envutil.env_float(ENV_FLEET_QUARANTINE_S, DEFAULT_QUARANTINE_S)
            if quarantine_s is None
            else float(quarantine_s)
        )
        self._fetch = fetch or _fetch_health
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaState] = {}
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._gauge_provider = self._gauges
        observability.register_gauge("tfs_fleet", self._gauge_provider)
        for name, host, port in replicas or ():
            self.add(name, host, port)
        _live_routers.add(self)

    # -- membership ----------------------------------------------------------

    def add(self, name: str, host: str, port: int) -> None:
        with self._lock:
            self._replicas[name] = _ReplicaState(name, host, port)

    def remove(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def set_addr(self, name: str, host: str, port: int) -> None:
        """Re-point a replica (restart on a new port) without losing its
        flap history."""
        with self._lock:
            st = self._replicas.get(name)
            if st is None:
                self._replicas[name] = _ReplicaState(name, host, port)
            else:
                st.host, st.port = host, int(port)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- routing -------------------------------------------------------------

    def _eligible_locked(self) -> List[_ReplicaState]:
        now = self._clock()
        all_ = list(self._replicas.values())
        best = [
            s for s in all_
            if s.healthy and not s.draining and s.quarantined_until <= now
        ]
        if best:
            return best
        # degrade: draining beats dead; anything beats nothing
        alive = [s for s in all_ if s.healthy]
        return alive or all_

    def route(self, key: str) -> _ReplicaState:
        """The replica that owns ``key`` right now."""
        with self._lock:
            cands = self._eligible_locked()
            if not cands:
                raise RuntimeError("fleet router has no replicas")
            return max(
                cands, key=lambda s: _rendezvous_score(s.name, key)
            )

    def pick(
        self,
        exclude: Optional[Tuple[str, int]] = None,
        key: Optional[str] = None,
    ) -> Optional[Tuple[str, int]]:
        """A healthy address for a failing-over client — the rendezvous
        choice for ``key`` among replicas other than ``exclude`` (the
        address the client is leaving).  None when no other replica is
        known."""
        with self._lock:
            cands = [
                s for s in self._eligible_locked() if s.addr != exclude
            ]
            if not cands:
                cands = [
                    s
                    for s in self._replicas.values()
                    if s.addr != exclude
                ]
            if not cands:
                return None
            k = key if key is not None else uuid.uuid4().hex
            return max(
                cands, key=lambda s: _rendezvous_score(s.name, k)
            ).addr

    def failover_budget(self) -> int:
        """How many reroutes a single client call may spend — one per
        known peer, so a call can walk the whole fleet once but a fully
        dead fleet still surfaces promptly."""
        return max(1, len(self))

    # -- health --------------------------------------------------------------

    def _record_flap_locked(self, st: _ReplicaState) -> None:
        now = self._clock()
        st.flaps.append(now)
        recent = [t for t in st.flaps if now - t <= FLAP_WINDOW_S]
        if (
            len(recent) >= self.quarantine_after
            and st.quarantined_until <= now
        ):
            st.quarantined_until = now + self.quarantine_s
            observability.note_fleet_quarantine()
            logger.warning(
                "fleet: quarantining replica %s for %.0fs (%d flaps "
                "in %.0fs)",
                st.name,
                self.quarantine_s,
                len(recent),
                FLAP_WINDOW_S,
            )

    def poll_once(self) -> None:
        """One health sweep over every replica (the poll thread's body;
        tests call it directly with an injected ``fetch``/``clock``)."""
        with self._lock:
            targets = list(self._replicas.values())
        for st in targets:
            try:
                h = self._fetch(st.host, st.port)
            except Exception:  # noqa: BLE001 — any failure = unhealthy
                with self._lock:
                    st.failures += 1
                    if st.healthy:
                        st.healthy = False
                        self._record_flap_locked(st)
                continue
            rep = h.get("replica") or {}
            sched = h.get("scheduler") or {}
            with self._lock:
                new_epoch = str(rep.get("epoch") or "")
                if st.epoch and new_epoch and new_epoch != st.epoch:
                    # same name, new life: a restart we never saw go
                    # down (the identity token is what makes this
                    # detectable without guessing from resets)
                    self._record_flap_locked(st)
                st.epoch = new_epoch or st.epoch
                st.pid = rep.get("pid") or st.pid
                st.uptime_s = float(rep.get("uptime_s") or 0.0)
                st.p99_ms = sched.get("p99_ms")
                st.sessions = int(h.get("sessions") or 0)
                st.draining = h.get("status") == "draining"
                st.last_ok = self._clock()
                st.failures = 0
                if not st.healthy:
                    st.healthy = True

    def start(self) -> "FleetRouter":
        """Start the background poll thread (idempotent)."""
        if self._poll_thread is None or not self._poll_thread.is_alive():
            self._poll_stop.clear()
            t = threading.Thread(
                target=self._poll_loop, name="tfs-fleet-poll", daemon=True
            )
            self._poll_thread = t
            t.start()
        return self

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.health_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poller must survive
                logger.warning("fleet: health poll failed", exc_info=True)

    def close(self) -> None:
        self._poll_stop.set()
        observability.unregister_gauge("tfs_fleet", self._gauge_provider)
        # a closed router is no doctor evidence (its bound gauge method
        # keeps it alive in the weak set until the cycle is collected)
        _live_routers.discard(self)

    # -- client feedback -----------------------------------------------------

    def _by_addr_locked(
        self, addr: Tuple[str, int]
    ) -> Optional[_ReplicaState]:
        for s in self._replicas.values():
            if s.addr == tuple(addr):
                return s
        return None

    def note_failed(self, addr: Tuple[str, int]) -> None:
        """A client's connection to ``addr`` died — mark it down now
        instead of waiting out a poll period."""
        with self._lock:
            st = self._by_addr_locked(addr)
            if st is not None and st.healthy:
                st.healthy = False
                self._record_flap_locked(st)

    def note_draining(self, addr: Tuple[str, int]) -> None:
        """A client got ``Draining`` from ``addr`` — route around it."""
        with self._lock:
            st = self._by_addr_locked(addr)
            if st is not None:
                st.draining = True

    def mark_draining(self, name: str, draining: bool = True) -> None:
        """Operator/rolling-restart lever: stop (or resume) routing new
        work to ``name`` ahead of the server's own drain status."""
        with self._lock:
            st = self._replicas.get(name)
            if st is not None:
                st.draining = draining

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            reps = {}
            for s in self._replicas.values():
                reps[s.name] = {
                    "host": s.host,
                    "port": s.port,
                    "healthy": s.healthy,
                    "draining": s.draining,
                    "quarantined": s.quarantined_until > now,
                    "pid": s.pid,
                    "epoch": s.epoch,
                    "uptime_s": round(s.uptime_s, 3),
                    "p99_ms": s.p99_ms,
                    "sessions": s.sessions,
                    "flaps_recent": len(
                        [t for t in s.flaps if now - t <= FLAP_WINDOW_S]
                    ),
                    "failures": s.failures,
                }
            return {
                "replicas": reps,
                "quarantine_after": self.quarantine_after,
                "quarantine_s": self.quarantine_s,
                "flap_window_s": FLAP_WINDOW_S,
            }

    def _gauges(self) -> Dict[str, Any]:
        snap = self.snapshot()["replicas"].values()
        return {
            "tfs_fleet_replicas": len(snap),
            "tfs_fleet_healthy": sum(1 for s in snap if s["healthy"]),
            "tfs_fleet_draining": sum(1 for s in snap if s["draining"]),
            "tfs_fleet_quarantined": sum(
                1 for s in snap if s["quarantined"]
            ),
        }


# ---------------------------------------------------------------------------
# fleet (replica lifecycle)
# ---------------------------------------------------------------------------


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


class _Replica:
    __slots__ = ("name", "host", "port", "proc", "server", "env", "log",
                 "spawned", "drained", "ready_s", "term_to_ready_s")

    def __init__(self, name, host, port):
        self.name = name
        self.host = host
        self.port = port
        self.proc = None  # subprocess.Popen (process mode)
        self.server = None  # BridgeServer (thread mode)
        self.env: Dict[str, str] = {}
        self.log = None
        # monotonic times of the latest spawn and drain, and the seconds
        # from each to healthy (BridgeFleet.timings)
        self.spawned: Optional[float] = None
        self.drained: Optional[float] = None
        self.ready_s: Optional[float] = None
        self.term_to_ready_s: Optional[float] = None


class BridgeFleet:
    """N bridge replicas with shared durable state, plus the levers the
    chaos/restart harnesses need (kill, drain, restart, rolling
    restart).

    ``device`` is where every replica serves: None = the CUDA card,
    which each replica resolves for itself and fails without (it never
    falls back to the CPU); ``"cpu"`` runs the plain path.

    ``mode="process"`` (the real topology): each replica is
    ``python -m tensorframes_tpu_torch.bridge.replica`` — its own
    interpreter, killable with a real SIGKILL, drained with SIGTERM.
    The spawn env is ``os.environ`` overlaid with ``base_env`` (where
    the caller puts the SHARED state: ``TFS_JOURNAL_DIR``,
    ``TFS_COMPILE_CACHE``, ``TFS_FLEET_REGISTRY``,
    ``TFS_BRIDGE_PIPELINE_PATHS``...) overlaid with ``fault_env[name]``
    (per-replica chaos, e.g. a ``replica_kill`` spec on exactly one
    replica).  Replica stdout/err
    go to ``<log_dir>/<name>.log`` when ``log_dir`` is given.

    ``mode="thread"``: the replicas are in-process ``BridgeServer``s
    (``server_kw`` forwarded) — no process isolation, no SIGKILL, but
    routing/drain/failover semantics are identical and tests stay
    cheap."""

    def __init__(
        self,
        size: Optional[int] = None,
        mode: str = "process",
        host: str = "127.0.0.1",
        base_env: Optional[Dict[str, str]] = None,
        fault_env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        name_prefix: str = "r",
        ready_timeout_s: float = 30.0,
        device: Optional[str] = None,
        **server_kw,
    ):
        if mode not in ("process", "thread"):
            raise ValueError(f"unknown fleet mode {mode!r}")
        self.size = (
            envutil.env_int(ENV_FLEET_SIZE, 0) if size is None else int(size)
        )
        if self.size <= 0:
            raise ValueError(
                f"fleet size must be positive (got {self.size}; set "
                f"{ENV_FLEET_SIZE} or pass size=)"
            )
        self.mode = mode
        self.host = host
        self.base_env = dict(base_env or {})
        self.fault_env = dict(fault_env or {})
        self.log_dir = log_dir
        self.ready_timeout_s = float(ready_timeout_s)
        self.device = None if device is None else str(device)
        self.server_kw = server_kw
        self._replicas: "collections.OrderedDict[str, _Replica]" = (
            collections.OrderedDict()
        )
        for i in range(self.size):
            name = f"{name_prefix}{i}"
            self._replicas[name] = _Replica(name, host, 0)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "BridgeFleet":
        for rep in self._replicas.values():
            self._spawn(rep)
        for rep in self._replicas.values():
            self._wait_ready(rep)
        return self

    def _spawn(self, rep: _Replica) -> None:
        rep.port = rep.port or _free_port(self.host)
        rep.spawned = time.monotonic()
        if self.mode == "thread":
            from .server import serve

            env_overlay = dict(self.base_env)
            env_overlay.update(self.fault_env.get(rep.name, {}) or {})
            if env_overlay:
                raise ValueError(
                    "thread-mode replicas share this process's env; "
                    "base_env/fault_env need mode='process'"
                )
            rep.server = serve(
                host=self.host, port=rep.port, device=self.device,
                **self.server_kw,
            )
            rep.port = rep.server.address[1]
            return
        env = dict(os.environ)
        env.update(self.base_env)
        fault = self.fault_env.get(rep.name)
        if fault is not None:
            env["TFS_FAULT_INJECT"] = fault
        env[ENV_FLEET_REPLICA] = rep.name
        # the replica module imports the tree under test even when the
        # package is not installed (tests, benches): repo root first
        env["PYTHONPATH"] = os.pathsep.join(
            p
            for p in (_repo_root(), env.get("PYTHONPATH", ""))
            if p
        )
        rep.env = env
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            rep.log = open(
                os.path.join(self.log_dir, f"{rep.name}.log"), "ab"
            )
        argv = [
            sys.executable,
            "-m",
            "tensorframes_tpu_torch.bridge.replica",
            "--host",
            self.host,
            "--port",
            str(rep.port),
            "--name",
            rep.name,
        ]
        if self.device is not None:
            argv += ["--device", self.device]
        rep.proc = subprocess.Popen(
            argv,
            env=env,
            stdout=rep.log or subprocess.DEVNULL,
            stderr=rep.log or subprocess.DEVNULL,
            cwd=_repo_root(),
        )

    def _wait_ready(self, rep: _Replica) -> Dict[str, Any]:
        deadline = time.monotonic() + self.ready_timeout_s
        last_exc: Optional[Exception] = None
        while time.monotonic() < deadline:
            if rep.proc is not None and rep.proc.poll() is not None:
                raise RuntimeError(
                    f"fleet replica {rep.name} exited rc="
                    f"{rep.proc.returncode} before becoming healthy"
                )
            try:
                h = _fetch_health(rep.host, rep.port, timeout_s=1.0)
            except Exception as exc:  # noqa: BLE001 — keep waiting
                last_exc = exc
                time.sleep(0.05)
                continue
            now = time.monotonic()
            rep.ready_s = now - rep.spawned
            rep.term_to_ready_s = (
                None if rep.drained is None else now - rep.drained
            )
            rep.drained = None
            return h
        raise RuntimeError(
            f"fleet replica {rep.name} not healthy after "
            f"{self.ready_timeout_s}s: {last_exc}"
        )

    def timings(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Per replica: seconds from its latest spawn to healthy
        (``ready_s``) and, when a drain preceded that spawn, from the
        drain's start (the SIGTERM, or the close in thread mode) to
        healthy again (``term_to_ready_s``)."""
        return {
            r.name: {
                "ready_s": r.ready_s, "term_to_ready_s": r.term_to_ready_s
            }
            for r in self._replicas.values()
        }

    def replicas(self) -> List[Tuple[str, str, int]]:
        """(name, host, port) triples — :class:`FleetRouter` input."""
        return [
            (r.name, r.host, r.port) for r in self._replicas.values()
        ]

    def router(self, **kw) -> FleetRouter:
        """A started router over this fleet's replicas."""
        r = FleetRouter(self.replicas(), **kw)
        r.poll_once()
        return r.start()

    # -- chaos / restart levers ----------------------------------------------

    def kill(self, name: str) -> None:
        """Real SIGKILL — no drain, no journal handoff, no goodbyes.
        The death the chaos acceptance test recovers from."""
        rep = self._replicas[name]
        if rep.proc is None:
            raise RuntimeError(
                "kill() needs a process-mode fleet (thread replicas "
                "share this process)"
            )
        rep.proc.send_signal(signal.SIGKILL)
        rep.proc.wait(timeout=10)

    def drain(self, name: str, timeout_s: float = 30.0) -> None:
        """Graceful drain: SIGTERM (process mode — the replica main
        runs ``server.close()`` with its ``TFS_BRIDGE_DRAIN_S`` and
        exits, waited for up to ``timeout_s``) or ``close(drain_s=
        timeout_s)`` (thread mode).  In-flight requests finish; durable
        stragglers hand off via the journal on their next adoption."""
        rep = self._replicas[name]
        if rep.server is not None:
            rep.drained = time.monotonic()
            rep.server.close(drain_s=timeout_s)
            rep.server = None
            return
        if rep.proc is None or rep.proc.poll() is not None:
            return
        rep.drained = time.monotonic()
        rep.proc.send_signal(signal.SIGTERM)
        rep.proc.wait(timeout=timeout_s)

    def restart(self, name: str) -> None:
        """Respawn a (dead or drained) replica on its OWN port and wait
        until it polls healthy — warm by construction when
        ``TFS_COMPILE_CACHE`` is shared.  Counted in
        ``fleet_replica_restarts``."""
        rep = self._replicas[name]
        if rep.proc is not None and rep.proc.poll() is None:
            raise RuntimeError(
                f"replica {name} is still running; drain or kill first"
            )
        self._spawn(rep)
        self._wait_ready(rep)
        observability.note_fleet_replica_restart()

    def rolling_restart(
        self,
        router: Optional[FleetRouter] = None,
        drain_timeout_s: float = 30.0,
    ) -> None:
        """Zero-downtime rolling restart: one replica at a time — route
        away, drain, restart, rejoin — so the fleet never loses more
        than one replica of capacity and rejoining replicas serve their
        first request from the shared compile cache."""
        for name in list(self._replicas):
            if router is not None:
                router.mark_draining(name)
            self.drain(name, timeout_s=drain_timeout_s)
            self.restart(name)
            if router is not None:
                router.set_addr(
                    name,
                    self._replicas[name].host,
                    self._replicas[name].port,
                )
                router.mark_draining(name, False)
                router.poll_once()

    def stop(self) -> None:
        for rep in self._replicas.values():
            try:
                if rep.server is not None:
                    rep.server.close(drain_s=0.5)
                    rep.server = None
                if rep.proc is not None and rep.proc.poll() is None:
                    rep.proc.terminate()
                    try:
                        rep.proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        rep.proc.kill()
                        rep.proc.wait(timeout=10)
            finally:
                if rep.log is not None:
                    rep.log.close()
                    rep.log = None

    def __enter__(self) -> "BridgeFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# failover client
# ---------------------------------------------------------------------------


class FleetClient:
    """A :class:`BridgeClient` bound to the replica that owns ``key``,
    with the router wired in: ``Draining``, dead connections, and
    ``SessionLost`` fail over to a healthy peer inside the client's own
    retry loop (``fleet_failovers``), and a durable ``run_pipeline``
    that comes back ``resumed`` from a different replica counts in
    ``fleet_jobs_migrated``.

    Failover reattaches a FRESH session: registered frames do not
    follow (re-upload them); durable jobs do — the journal is the
    migration medium, so a re-issued ``job_id`` resumes from its last
    window boundary on whichever replica answers."""

    def __init__(self, router: FleetRouter, key: Optional[str] = None,
                 **client_kw):
        from .client import BridgeClient

        self.router = router
        self.key = key if key is not None else uuid.uuid4().hex
        st = router.route(self.key)
        self.client = BridgeClient(
            st.host, st.port, router=router, **client_kw
        )

    def call(self, method: str, **params) -> Any:
        return self.client.call(method, **params)

    def ping(self) -> bool:
        return self.client.ping()

    def health(self) -> Dict[str, Any]:
        return self.client.health()

    def job_status(self, job_id: str) -> Dict[str, Any]:
        return self.client.job_status(job_id)

    def create_frame(self, *a, **kw):
        return self.client.create_frame(*a, **kw)

    def run_pipeline(self, *a, **kw) -> Dict[str, Any]:
        origin = (self.client._host, self.client._port)
        before = self.client.failovers
        r = self.client.run_pipeline(*a, **kw)
        if (
            kw.get("job_id") is not None
            and r.get("resumed")
            and (
                self.client.failovers > before
                or (self.client._host, self.client._port) != origin
            )
        ):
            observability.note_fleet_job_migrated()
        return r

    def close(self) -> None:
        self.client.close()

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
