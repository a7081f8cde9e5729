"""Bridge client: the reference-shaped front-end handle.

The port's copy of ``tensorframes_tpu/bridge/client.py``; it speaks the
same wire as the JAX package's server and client.

``RemoteFrame`` plays the role the JVM DataFrame handle plays for the
reference's Python API (``core.py``): a thin id-carrying proxy whose verbs
ship GraphDef bytes + builder state to the engine and return new handles.

Client-side resilience:

* **Thread safety**: one lock serialises each call's write+read pair, so
  threads sharing a client can no longer interleave frames on the socket
  and desync the protocol.  The lock makes the client correct, not
  parallel — concurrent callers queue on it (and on the server's
  admission gate behind it); for real client-side parallelism open one
  ``BridgeClient`` (= one connection, one session) per thread instead.
* **Deadlines**: ``deadline_ms`` (per call, or a client-wide default)
  rides the request envelope; the server cancels the verb at the next
  block boundary past it and returns a structured ``deadline_exceeded``
  error, raised here as :class:`DeadlineExceeded`.  The session and its
  frames remain fully usable afterwards.
* **Reconnect + safe retry**: a connection failure (dropped socket, read
  timeout) tears the connection down and retries with decorrelated-
  jitter backoff (``resilience.FailureDetector``) — transparently for
  cheap side-effect-free methods (``ping``/``schema``/``health``/
  ``release``), and for every gated method (``collect`` included) under
  an **idempotency token** the server dedups, so a retried request
  after a dropped *reply* is served the first execution's outcome and
  never double-executes (a retry racing its still-running original
  WAITS for that outcome instead of occupying a second admission slot).  Sessions are
  token-addressed server-side (``hello``), so the reconnected client
  reattaches to the same frames.
* **Structured refusals**: admission sheds raise :class:`ServerBusy`
  (carrying ``retry_after_ms``) or :class:`Draining`.  With
  ``busy_retries`` (``TFS_BRIDGE_CLIENT_BUSY_RETRIES``, default 0) set,
  the retry loop HONORS the server's ``retry_after_ms`` hint: a shed
  gated call sleeps the hinted backoff and re-sends — never past the
  call's deadline, and never for ``Draining`` (a draining server wants
  you gone, not back).  At 0 sheds surface immediately and routing is
  the caller's policy.  The hint is capped
  (``TFS_BRIDGE_CLIENT_BUSY_CAP_MS``) and decorrelated with jitter
  (:func:`busy_backoff_s`) so shed clients never re-arrive in lockstep.
* **Fleet failover**: with ``router=`` wired in (a
  :class:`~tensorframes_tpu_torch.bridge.fleet.FleetRouter`), connection
  failures, ``Draining``, and ``SessionLost`` re-route the call to a
  healthy peer instead of surfacing — a fresh session there (frames do
  not follow; re-upload), with durable jobs migrating via the journal
  when their re-sent request carries its ``job_id``.  Budget: one
  reroute per known peer per call.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .. import observability, resilience
from ..envutil import env_float, env_int, env_opt_float
from .protocol import connect, decode_value, encode_value, read_message, write_message

logger = logging.getLogger("tensorframes_tpu_torch.bridge.client")

ENV_CLIENT_TIMEOUT_S = "TFS_BRIDGE_CLIENT_TIMEOUT_S"
ENV_CLIENT_RETRIES = "TFS_BRIDGE_CLIENT_RETRIES"
ENV_CLIENT_BUSY_RETRIES = "TFS_BRIDGE_CLIENT_BUSY_RETRIES"
ENV_CLIENT_BUSY_CAP_MS = "TFS_BRIDGE_CLIENT_BUSY_CAP_MS"

DEFAULT_RECONNECT_RETRIES = 3
DEFAULT_BACKOFF_S = 0.05
DEFAULT_BUSY_CAP_MS = 1000.0

# when a call has a deadline but the client has NO configured socket
# timeout, the reply read is still bounded at deadline + a grace (the
# server legitimately replies a structured deadline_exceeded up to one
# block's compute AFTER the deadline — cutting the read exactly at the
# deadline would lose that reply).  The grace SCALES with the deadline
# (2x, floored/capped below) so a 100ms-SLO call never waits 30s for a
# wedged server, while a long-deadline call keeps room for a
# boundary-late reply; a wedged server costs at most deadline + grace.
DEADLINE_READ_GRACE_MIN_S = 1.0
DEADLINE_READ_GRACE_MAX_S = 30.0


def _read_grace_s(remaining_s: float) -> float:
    return min(
        DEADLINE_READ_GRACE_MAX_S,
        max(DEADLINE_READ_GRACE_MIN_S, 2.0 * remaining_s),
    )


def busy_backoff_s(
    hint_ms: float,
    cap_ms: float = DEFAULT_BUSY_CAP_MS,
    attempt: int = 0,
    rng=None,
) -> float:
    """The busy-retry sleep, in seconds.

    The server's ``retry_after_ms`` hint is deterministic per shed — so
    a fleet's worth of clients shed in the same overload wave would all
    re-arrive in lockstep, a thundering herd the admission gate sheds
    again, forever.  Cap the hint at ``cap_ms`` (a server under duress
    can hint arbitrarily far; the CLIENT owns how long it is willing to
    stall), grow it per ``attempt`` (2x, still capped), and draw
    uniformly from [half, full] of that target — decorrelated enough
    that re-arrivals spread across half a window, while every draw
    still respects at least half the server's hint."""
    capped = min(max(float(hint_ms), 1.0), float(cap_ms))
    target = min(capped * (2.0 ** max(0, int(attempt))), float(cap_ms))
    lo = target / 2.0
    draw = rng.random() if rng is not None else random.random()
    return (lo + draw * (target - lo)) / 1e3

# methods whose re-execution is harmless AND cheap: control-plane reads
# plus ``release`` (a pop that ignores unknown ids — naturally
# idempotent; the server's UNGATED surface never consults idem tokens,
# so every ungated method must be on this list or naturally idempotent).
# They retry without an idempotency token.  Every GATED method —
# including the read-only but EXPENSIVE ``collect`` — gets a token the
# server dedups: a retry never races a still-running original into a
# duplicate admission slot (it waits for the original's outcome).
_SAFE_METHODS = frozenset(
    {"ping", "schema", "health", "hello", "release", "metrics",
     "attribution", "check", "job_status"}
)


class BridgeError(RuntimeError):
    """A server-side failure, re-raised client-side with the remote type
    (and, when the server sent one, the structured ``code`` plus the
    full error payload)."""

    def __init__(
        self,
        type_name: str,
        message: str,
        code: Optional[str] = None,
        payload: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(f"{type_name}: {message}")
        self.remote_type = type_name
        self.code = code
        self.payload = dict(payload or {})


class DeadlineExceeded(BridgeError):
    """The verb exceeded its ``deadline_ms`` and was cancelled at a
    block boundary; the session's frames are intact and usable."""


class Cancelled(BridgeError):
    """The request was cooperatively cancelled (e.g. the server's
    graceful drain cancelled a straggler)."""


class ServerBusy(BridgeError):
    """Admission control shed this request; ``retry_after_ms`` is the
    server's deterministic backoff hint."""

    @property
    def retry_after_ms(self) -> int:
        return int(self.payload.get("retry_after_ms", 50))


class Draining(BridgeError):
    """The server is draining for shutdown; route elsewhere."""


class SessionLost(BridgeError):
    """The session token no longer names server-side state — the
    session TTL'd out, or the server RESTARTED.  Frames are
    gone; durable jobs are not: reattach with a fresh session, re-upload
    inputs, and re-issue durable requests with their ``job_id`` — the
    journal resumes them from the last completed window (and a job that
    already completed returns its journaled result without executing).
    ``job_status(job_id)`` shows what survives."""


class JobActive(BridgeError):
    """A resume raced the original request: the job is still executing
    server-side.  Never a concurrent duplicate — poll ``job_status``
    (or just retry after it finishes)."""


_CODED_ERRORS: Dict[str, type] = {
    "deadline_exceeded": DeadlineExceeded,
    "cancelled": Cancelled,
    "server_busy": ServerBusy,
    "draining": Draining,
    "unknown_session": SessionLost,
    "job_active": JobActive,
}


def _raise_remote(err: Dict[str, Any]) -> None:
    cls = _CODED_ERRORS.get(err.get("code") or "", BridgeError)
    raise cls(
        err.get("type", "Error"),
        err.get("message", ""),
        code=err.get("code"),
        payload=err,
    )


class BridgeClient:
    """Connects to a bridge server (either package's).

    One client = one connection = one server session (reattached across
    reconnects via the session token ``hello`` returns).  Thread-safe
    (calls serialise on an internal lock); use one client per thread for
    client-side parallelism.

    * ``timeout_s`` — socket read/connect timeout (default
      ``TFS_BRIDGE_CLIENT_TIMEOUT_S``, else None = block forever; set it
      for serving paths so a wedged server becomes a retryable failure).
    * ``deadline_ms`` — client-wide default request deadline (per-call
      ``deadline_ms=`` overrides).
    * ``reconnect_retries`` / ``backoff_s`` / ``jitter`` / ``rng`` —
      reconnect policy: decorrelated-jitter exponential backoff via
      ``resilience.FailureDetector`` (``jitter=0`` is the exact
      exponential sequence; ``rng`` injectable for deterministic tests).
    * ``router`` — a :class:`~tensorframes_tpu_torch.bridge.fleet.
      FleetRouter` for fleet failover (see the module docstring).
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        reconnect_retries: Optional[int] = None,
        backoff_s: float = DEFAULT_BACKOFF_S,
        jitter: float = 1.0,
        rng=None,
        tenant: Optional[str] = None,
        busy_retries: Optional[int] = None,
        router=None,
    ):
        self._host = host
        self._port = int(port)
        # fleet failover: with a router wired in, connection failures,
        # ``Draining``, and ``SessionLost`` re-route this client to a
        # healthy peer (fresh session there; durable jobs migrate via
        # the journal when their request is re-sent with its job_id).
        # ``failovers`` counts reroutes on this client;
        # ``server_replica`` is the identity dict the last successful
        # hello returned (None on servers that send none)
        self.router = router
        self.failovers = 0
        self.server_replica: Optional[Dict[str, Any]] = None
        # request-scoped telemetry: every GATED call is
        # stamped with a fresh correlation id (STABLE across that
        # call's reconnect retries, so a retried request attributes to
        # one request server-side; safe/ungated methods are never
        # attributed and carry none); ``tenant`` rides the envelope too
        # and labels the server's bounded-cardinality tfs_request_*
        # metrics.  ``last_correlation_id`` is the most recent GATED
        # call's cid — the handle ``attribution()`` looks up.
        self._tenant = tenant
        self.last_correlation_id: Optional[str] = None
        self._timeout_s = (
            timeout_s
            if timeout_s is not None
            else env_opt_float(ENV_CLIENT_TIMEOUT_S)
        )
        self._deadline_ms = deadline_ms
        if reconnect_retries is None:
            reconnect_retries = env_int(
                ENV_CLIENT_RETRIES, DEFAULT_RECONNECT_RETRIES
            )
        self._retries = int(reconnect_retries)
        if busy_retries is None:
            busy_retries = env_int(ENV_CLIENT_BUSY_RETRIES, 0)
        self._busy_retries = int(busy_retries)
        self._busy_cap_ms = env_float(
            ENV_CLIENT_BUSY_CAP_MS, DEFAULT_BUSY_CAP_MS
        )
        self._backoff_s = float(backoff_s)
        self._jitter = float(jitter)
        self._rng = rng
        self._lock = threading.Lock()
        self._next_id = 0
        self._client_id = uuid.uuid4().hex[:12]
        self.session_token: Optional[str] = None
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._wfile = None
        self._closed = False
        with self._lock:
            # the construction handshake honours the client deadline
            # too: a wedged server must not hang __init__ forever when
            # the caller expressed an SLO
            self._connect_locked(
                timeout_s=(
                    float(self._deadline_ms) / 1000.0
                    if self._deadline_ms is not None
                    else None
                )
            )

    # -- connection management (callers hold self._lock) ---------------------

    def _teardown_locked(self) -> None:
        # shutdown BEFORE closing the file objects: a reader blocked in
        # readline holds the buffer lock, so rfile.close() would block
        # behind it — shutdown is a plain syscall that forces that read
        # to return EOF first (this is what lets close() unblock a call
        # stuck on a wedged server instead of deadlocking on it)
        try:
            if self._sock is not None:
                self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for f in (self._rfile, self._wfile):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = self._rfile = self._wfile = None

    def _connect_locked(self, timeout_s: Optional[float] = None) -> None:
        """(Re)connect + hello.  ``timeout_s`` bounds the connect AND the
        handshake roundtrip (a deadline-bound call passes its remaining
        budget so reconnects cannot blow past the deadline); afterwards
        the socket reverts to the client's configured timeout."""
        self._teardown_locked()
        effective = self._timeout_s
        if timeout_s is not None and (
            effective is None or timeout_s < effective
        ):
            effective = timeout_s
        sock = connect(self._host, self._port, timeout=effective)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wfile = sock.makefile("wb")
        # session handshake: create on first connect, reattach after —
        # the server keeps the frame registry alive across the drop
        self._next_id += 1
        params: Dict[str, Any] = {}
        if self.session_token is not None:
            params["session"] = self.session_token
        resp = self._roundtrip_locked(
            {"id": self._next_id, "method": "hello", "params": params}
        )
        if "error" in resp:
            err = resp["error"]
            if (
                err.get("type") == "AttributeError"
                and self.session_token is None
            ):
                # a server without a ``hello`` method: degrade to
                # the legacy sessionless mode (no reattach after a drop;
                # only safe methods survive reconnects) instead of
                # refusing to talk — the envelope keys stay additive,
                # handshake included.
                logger.warning(
                    "bridge server does not speak hello; running "
                    "sessionless (no reattach across reconnects)"
                )
                sock.settimeout(self._timeout_s)
                return
            if err.get("code") == "unknown_session":
                # the session TTL'd out server-side: its frames are gone,
                # so silently starting a fresh session would turn every
                # handle stale — surface it (the token is cleared so a
                # NEW client call can start clean)
                self.session_token = None
            self._teardown_locked()
            _raise_remote(err)
        self.session_token = resp["result"]["session"]
        self.server_replica = resp["result"].get("replica")
        sock.settimeout(self._timeout_s)

    def _failover_locked(self, reason: str, failed: bool) -> bool:
        """Re-point this client at a healthy peer: tell the router what
        happened to the current address (``failed`` = dead connection,
        else draining/restarted-but-alive), pick the rendezvous choice
        among the OTHER replicas, and drop the session token — the
        reattach is a fresh session on the new replica (frames do not
        follow; durable jobs do, via the journal, when call() re-sends
        their request).  False when no router or no other replica is
        known."""
        if self.router is None:
            return False
        addr = (self._host, self._port)
        try:
            if failed:
                self.router.note_failed(addr)
            else:
                self.router.note_draining(addr)
            nxt = self.router.pick(exclude=addr)
        except Exception:  # noqa: BLE001 — a sick router must not mask
            logger.warning("bridge: fleet router errored", exc_info=True)
            return False
        if nxt is None or tuple(nxt) == addr:
            return False
        self._teardown_locked()
        self._host, self._port = nxt
        self.session_token = None
        self.failovers += 1
        observability.note_fleet_failover()
        logger.warning(
            "bridge: failing over to %s:%d (%s at %s:%d)",
            nxt[0], nxt[1], reason, addr[0], addr[1],
        )
        return True

    def _roundtrip_locked(self, msg: dict, bins: Optional[list] = None):
        write_message(self._wfile, msg, bins)
        try:
            resp, rbins = read_message(self._rfile)
        except ValueError as exc:
            # a ValueError from the READ side is a truncated/corrupt
            # reply line (server died mid-write, connection RST) — a
            # connection failure for retry purposes, unlike
            # write_message's size-cap ValueErrors, which are raised
            # before any bytes hit the socket and stay caller errors
            raise ConnectionError(
                f"corrupt or truncated bridge reply: {exc}"
            ) from exc
        return dict(resp, _bins=rbins)

    # -- plumbing ------------------------------------------------------------

    def call(
        self, method: str, deadline_ms: Optional[float] = None, **params
    ) -> Any:
        """One RPC round trip.  ``deadline_ms`` (or the client default)
        rides the envelope; connection failures reconnect + retry per
        the policy above; structured server errors raise their typed
        :class:`BridgeError` subclass."""
        deadline = (
            deadline_ms if deadline_ms is not None else self._deadline_ms
        )
        # the deadline bounds the CALL, not each attempt: pin the end
        # now and send only the REMAINING budget on every (re)send, so
        # retries cannot silently multiply an SLO-bound caller's wait
        deadline_end = (
            time.monotonic() + float(deadline) / 1000.0
            if deadline is not None
            else None
        )
        safe = method in _SAFE_METHODS
        detector: Optional[resilience.FailureDetector] = None
        # one correlation id per LOGICAL gated call: reconnect retries
        # re-send the same cid (like the idem token), so server-side
        # attribution and trace events string the whole call together.
        # Safe methods are ungated server-side — never attributed — so
        # minting/recording a cid for them would clobber
        # ``last_correlation_id`` with an id the ``attribution`` RPC
        # can never find (e.g. the attribution lookup itself)
        cid = None if safe else observability.new_correlation_id()
        busy_left = 0 if safe else self._busy_retries
        busy_attempt = 0
        # one reroute per known peer: a call may walk the fleet once,
        # but a fully-dead fleet still surfaces promptly
        failover_left = (
            self.router.failover_budget() if self.router is not None else 0
        )
        with self._lock:
            if cid is not None:
                self.last_correlation_id = cid
            self._next_id += 1
            mid = self._next_id
            idem = None if safe else f"{self._client_id}:{mid}"
            while True:
                if self._closed:
                    # close() ran (possibly force-closing under our
                    # feet): never silently reconnect a closed client
                    raise ConnectionError("bridge client is closed")
                remaining_s: Optional[float] = None
                if deadline_end is not None:
                    # checked BEFORE any reconnect work, and threaded
                    # into the connect/handshake as its timeout: the
                    # deadline bounds the whole call, reconnects
                    # included
                    remaining_s = deadline_end - time.monotonic()
                    if remaining_s <= 0:
                        raise DeadlineExceeded(
                            "DeadlineExceeded",
                            f"{method}: deadline exhausted across "
                            f"retries (never re-sent)",
                            code="deadline_exceeded",
                        )
                try:
                    if self._sock is None:
                        self._connect_locked(timeout_s=remaining_s)
                        if self._closed:
                            # close() ran while we were inside the
                            # connect (its force path found no socket to
                            # tear down) — drop the fresh connection
                            # instead of completing a call on a closed
                            # client and leaking it
                            self._teardown_locked()
                            raise ConnectionError(
                                "bridge client is closed"
                            )
                        self._next_id += 1
                        mid = self._next_id  # ids stay monotonic per wire
                    bins: list = []
                    msg: Dict[str, Any] = {
                        "id": mid,
                        "method": method,
                        "params": encode_value(params, bins),
                    }
                    if cid is not None:
                        msg["cid"] = cid
                        if self._tenant is not None:
                            msg["tenant"] = self._tenant
                    if deadline_end is not None:
                        # re-computed AFTER any reconnect work: the
                        # server must be granted only what truly remains
                        remaining_s = deadline_end - time.monotonic()
                        if remaining_s <= 0:
                            raise DeadlineExceeded(
                                "DeadlineExceeded",
                                f"{method}: deadline exhausted during "
                                f"reconnect (never re-sent)",
                                code="deadline_exceeded",
                            )
                        msg["deadline_ms"] = 1e3 * remaining_s
                        # bound the reply read too: a wedged server must
                        # not turn a deadline-bound call into a wait for
                        # the full (or absent) socket timeout; the grace
                        # covers the server's boundary-late structured
                        # reply
                        bound = remaining_s + _read_grace_s(remaining_s)
                        if self._timeout_s is not None:
                            bound = min(self._timeout_s, bound)
                        self._sock.settimeout(bound)
                    if idem is not None:
                        msg["idem"] = idem
                    resp = self._roundtrip_locked(msg, bins)
                    if deadline_end is not None and self._sock is not None:
                        self._sock.settimeout(self._timeout_s)
                except (OSError, ConnectionError, TimeoutError) as exc:
                    # the connection is in an unknown state: tear it
                    # down and resend — safe because every method is
                    # either side-effect-free (_SAFE_METHODS) or
                    # idempotency-tokened (the server dedups completed
                    # outcomes and makes a retry racing its
                    # still-running original WAIT for that outcome)
                    self._teardown_locked()
                    if self._closed:
                        raise ConnectionError(
                            "bridge client is closed"
                        ) from None
                    if self.session_token is None and (
                        not safe or "frame_id" in params
                    ):
                        # legacy sessionless server: no reattach, so a
                        # resent non-safe method could double-execute
                        # and a frame-addressed read (collect/schema)
                        # would hit a fresh empty session and fail with
                        # a misleading unknown-frame-id — surface the
                        # real connection failure instead
                        raise
                    if failover_left > 0 and self._failover_locked(
                        f"{type(exc).__name__}: {exc}", failed=True
                    ):
                        # a dead connection with a router configured
                        # reroutes NOW instead of burning the reconnect
                        # budget on a corpse; the new replica gets a
                        # fresh detector budget of its own
                        failover_left -= 1
                        detector = None
                        continue
                    if detector is None:
                        detector = resilience.FailureDetector(
                            max_restarts=self._retries,
                            backoff_s=self._backoff_s,
                            jitter=self._jitter,
                            rng=self._rng,
                        )
                    # every exception the tuple above catches IS a
                    # connection-phase failure worth the reconnect
                    # budget — but the detector classifies plain
                    # OSErrors (ENETUNREACH, EHOSTDOWN...) by message
                    # and would surface them with zero retries, so
                    # normalise to a ConnectionError carrying the
                    # original as its cause before metering
                    if not detector.is_transient(exc):
                        wrapped = ConnectionError(
                            f"{type(exc).__name__}: {exc}"
                        )
                        wrapped.__cause__ = exc
                        exc = wrapped
                    delay = detector.on_failure(exc)  # raises when spent
                    observability.note_bridge_retry()
                    logger.warning(
                        "bridge call %s failed (%s: %s); reconnecting "
                        "after %.3fs (retry %d/%d)",
                        method,
                        type(exc).__name__,
                        exc,
                        delay,
                        detector.restarts,
                        self._retries,
                    )
                    time.sleep(delay)
                    continue
                except SessionLost:
                    # the reattach found a restarted (or TTL-reaped)
                    # server: frames are gone either way.  With a
                    # router, reroute the reattach to a peer — the
                    # re-sent request runs on a fresh session there, and
                    # a durable ``job_id`` adopts its journal fence and
                    # resumes.  Without one, surface it.
                    if failover_left > 0 and self._failover_locked(
                        "session lost", failed=False
                    ):
                        failover_left -= 1
                        continue
                    raise
                rbins = resp.pop("_bins")
                if "error" in resp:
                    err = resp["error"]
                    if (
                        err.get("code") == "draining"
                        and failover_left > 0
                        and self._failover_locked(
                            "server draining", failed=False
                        )
                    ):
                        # Draining is a failover signal when a router is
                        # configured — the drained request was never
                        # executed or cached, so re-sending the SAME idem
                        # token + cid on a peer is still one logical call
                        failover_left -= 1
                        continue
                    if (
                        err.get("code") == "server_busy"
                        and busy_left > 0
                    ):
                        # honor the server's retry_after_ms hint — capped
                        # and decorrelated (raw deterministic hints
                        # synchronize shed clients into thundering
                        # herds): the shed was
                        # never executed or cached, so re-sending the
                        # SAME idem token + cid keeps the retry a
                        # continuation of this logical call.  Never
                        # sleep past the deadline — surfacing the shed
                        # beats converting it into a silent
                        # deadline_exceeded.
                        delay = busy_backoff_s(
                            float(err.get("retry_after_ms", 50)),
                            cap_ms=self._busy_cap_ms,
                            attempt=busy_attempt,
                            rng=self._rng,
                        )
                        busy_attempt += 1
                        if deadline_end is not None and (
                            time.monotonic() + delay >= deadline_end
                        ):
                            _raise_remote(err)
                        busy_left -= 1
                        logger.debug(
                            "bridge call %s shed (server_busy); "
                            "honoring retry_after_ms=%s (%d busy "
                            "retries left)",
                            method,
                            err.get("retry_after_ms"),
                            busy_left,
                        )
                        time.sleep(delay)
                        continue
                    _raise_remote(err)
                return decode_value(resp["result"], rbins)

    def close(self) -> None:
        """End the server session (best effort) and close the socket.

        The ``end_session`` round trip runs under a short socket
        timeout regardless of the client's configured ``timeout_s`` —
        ``close()``/``__exit__`` must never hang on a wedged server
        (teardown is best effort; the session TTL reaps it anyway)."""
        self._closed = True  # call()'s retry loop must never reconnect
        if not self._lock.acquire(timeout=2.0):
            # a stuck call() holds the lock (wedged server, no read
            # timeout): force-close the socket WITHOUT the lock — the
            # blocked read raises in the stuck thread, which sees
            # _closed and surfaces instead of reconnecting.  Skipping
            # end_session is fine; the server's session TTL reaps it.
            self._teardown_locked()
            return
        try:
            self._close_locked()
        finally:
            self._lock.release()

    def _close_locked(self) -> None:
        if self._wfile is not None and self.session_token is not None:
            try:
                self._sock.settimeout(1.0)
                self._next_id += 1
                self._roundtrip_locked(
                    {
                        "id": self._next_id,
                        "method": "end_session",
                        "params": {},
                    }
                )
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass
        self._teardown_locked()
        self.session_token = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- frontend API --------------------------------------------------------

    def ping(self) -> bool:
        return bool(self.call("ping")["pong"])

    def health(self) -> Dict[str, Any]:
        """The server's health snapshot: admission depth, drain state,
        quarantined devices, device-memory budget occupancy, and the
        gauge snapshot — live/peak host bytes, flight-recorder
        depth/drops (ungated — works on a saturated server)."""
        return self.call("health")

    def metrics(self) -> str:
        """The server's Prometheus text exposition: counters,
        gauges, and the verb/bridge-method latency histograms with
        p50/p95/p99 — the scrape surface for deployments without the
        ``TFS_METRICS_PORT`` HTTP endpoint (ungated, like ``health``)."""
        return self.call("metrics")["text"]

    def attribution(
        self, correlation_id: Optional[str] = None
    ) -> Dict[str, Any]:
        """Per-request cost attribution (ungated).  With a
        ``correlation_id`` (e.g. :attr:`last_correlation_id` after a
        verb call) returns that request's ledger snapshot — counters
        delta, blocks/rows per device, per-verb latency, wall time;
        without one returns the server's recent ledgers, newest last."""
        return self.call("attribution", correlation_id=correlation_id)

    def warm(
        self,
        graph: bytes,
        fetches: Sequence[str],
        columns: Mapping[str, Any],
        rows: Optional[Sequence[int]] = None,
        verb: str = "map_rows",
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        trim: bool = False,
        deadline_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Register + prime a program on the server: the warm pool keeps
        it resident and ``Executor.warmup`` primes its ``(bucket,
        device)`` grid for the given block row counts, so the first real
        request builds nothing.
        ``columns`` maps column name -> a small sample array (dtype +
        cell shape are read; values are ignored)."""
        return self.call(
            "warm",
            deadline_ms=deadline_ms,
            graph=graph,
            fetches=list(fetches),
            inputs=dict(inputs or {}),
            shapes=dict(shapes or {}),
            trim=trim,
            verb=verb,
            columns={k: np.asarray(v) for k, v in columns.items()},
            rows=[int(r) for r in (rows or [])],
        )

    def run_pipeline(
        self,
        source: Mapping[str, Any],
        stages: Sequence[Mapping[str, Any]],
        sink: Optional[Mapping[str, Any]] = None,
        deadline_ms: Optional[float] = None,
        job_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Execute a whole source -> map -> join -> aggregate -> sink
        streaming pipeline server-side as ONE gated request.
        ``source``/``stages``/``sink`` follow the
        ``relational/pipeline.py`` spec grammar (``graph`` values are
        GraphDef bytes; join stages reference registered frames by
        ``build_frame_id``).  The reply carries the result frame's id +
        schema (aggregate / collect sinks), the parquet sink summary,
        and one ledger snapshot PER WINDOW — per-window attribution
        that sums to this request's ``attribution()`` ledger (past 512
        windows the tail folds into one synthetic ``folded_windows``
        entry, so the sum stays exact).  Path-based parquet
        sources/sinks touch the SERVER's filesystem and are refused
        unless under a ``TFS_BRIDGE_PIPELINE_PATHS`` root; registered
        frames (``frame_id``) always work.  The request's
        ``deadline_ms`` cancels the pipeline at the next window
        boundary; complete windows (and a parquet sink's finalized
        file) survive.  ``job_id`` makes the pipeline DURABLE: the
        server journals every window boundary, a re-issued spec with
        the same id resumes from the last completed window (after a
        server restart too — catch :class:`SessionLost`, reattach,
        re-upload frames, re-issue), and a completed job replays its
        journaled result exactly once."""
        r = self.call(
            "pipeline",
            deadline_ms=deadline_ms,
            source=dict(source),
            stages=[dict(s) for s in stages],
            sink=dict(sink) if sink else None,
            job_id=job_id,
        )
        if "frame_id" in r:
            r["frame"] = RemoteFrame(self, r["frame_id"], r["schema"])
        return r

    def decode(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        speculative: bool = False,
        gamma: int = 4,
        stop_token: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Stream up to ``max_new`` greedy tokens continuing ``prompt``
        through the server's paged decode scheduler.  The
        request joins the RUNNING slot batch at the next step boundary
        and retires the moment its stream finishes (``max_new`` reached
        or ``stop_token`` emitted), freeing its KV pages immediately;
        ``deadline_ms`` cancels at a step boundary.  Per-request
        attribution applies: generated tokens bill this client's tenant.
        ``speculative=True`` opts into the draft/verify path (needs a
        draft model server-side; verified bit-exactly by the target
        model).  Page-pool or slot exhaustion raises
        :class:`ServerBusy` whose ``retry_after_ms`` says when to come
        back — admission is refused up front, never OOMed mid-stream.
        Returns ``{"tokens": [...], "generated": n, "speculative":
        bool}``."""
        return self.call(
            "decode",
            deadline_ms=deadline_ms,
            prompt=[int(t) for t in prompt],
            max_new=int(max_new),
            speculative=bool(speculative),
            gamma=int(gamma),
            stop_token=None if stop_token is None else int(stop_token),
        )

    def job_status(self, job_id: str) -> Dict[str, Any]:
        """Status of a durable job (ungated): whether the
        server's journal holds it, its completed-window boundary, and
        whether its owner is alive (``running``) or dead
        (``interrupted`` — resumable by re-issuing the request with the
        same ``job_id``).  ``complete`` jobs return their journaled
        result on resume without executing anything."""
        return self.call("job_status", job_id=job_id)

    def create_frame(
        self,
        columns: Mapping[str, Any],
        num_blocks: int = 1,
        deadline_ms: Optional[float] = None,
    ) -> "RemoteFrame":
        r = self.call(
            "create_frame",
            deadline_ms=deadline_ms,
            columns={k: np.asarray(v) if not isinstance(v, list) else v
                     for k, v in columns.items()},
            num_blocks=num_blocks,
        )
        return RemoteFrame(self, r["frame_id"], r["schema"])


class RemoteFrame:
    """Handle to a frame living in the bridge server.

    Every verb takes an optional ``deadline_ms``; a verb that exceeds it
    raises :class:`DeadlineExceeded` and leaves this frame (and the
    session) fully usable — re-running the same verb afterwards
    produces the undisturbed result."""

    def __init__(self, client: BridgeClient, frame_id: int, schema):
        self._c = client
        self.frame_id = frame_id
        self.schema = schema

    def analyze(self, deadline_ms: Optional[float] = None) -> "RemoteFrame":
        self.schema = self._c.call(
            "analyze", frame_id=self.frame_id, deadline_ms=deadline_ms
        )["schema"]
        return self

    def _df_verb(
        self, verb: str, graph: bytes, deadline_ms=None, **kw
    ) -> "RemoteFrame":
        r = self._c.call(
            verb,
            frame_id=self.frame_id,
            graph=graph,
            deadline_ms=deadline_ms,
            **kw,
        )
        return RemoteFrame(self._c, r["frame_id"], r["schema"])

    def map_blocks(
        self,
        graph: bytes,
        fetches: Sequence[str],
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        trim: bool = False,
        deadline_ms: Optional[float] = None,
    ) -> "RemoteFrame":
        return self._df_verb(
            "map_blocks", graph, fetches=list(fetches),
            inputs=dict(inputs or {}), shapes=dict(shapes or {}), trim=trim,
            deadline_ms=deadline_ms,
        )

    def map_rows(
        self,
        graph: bytes,
        fetches: Sequence[str],
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        deadline_ms: Optional[float] = None,
    ) -> "RemoteFrame":
        return self._df_verb(
            "map_rows", graph, fetches=list(fetches),
            inputs=dict(inputs or {}), shapes=dict(shapes or {}),
            deadline_ms=deadline_ms,
        )

    def aggregate(
        self,
        keys: Sequence[str],
        graph: bytes,
        fetches: Sequence[str],
        deadline_ms: Optional[float] = None,
    ) -> "RemoteFrame":
        return self._df_verb(
            "aggregate", graph, keys=list(keys), fetches=list(fetches),
            deadline_ms=deadline_ms,
        )

    def check(
        self,
        verb: str,
        graph: Optional[bytes] = None,
        fetches: Optional[Sequence[str]] = None,
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        keys: Optional[Sequence[str]] = None,
        trim: bool = False,
        right: Optional["RemoteFrame"] = None,
        how: str = "inner",
        deadline_ms: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Pre-dispatch contract verification: statically
        validate ``graph`` against this frame for ``verb`` and return
        the ``TFSxxx`` diagnostics — UNGATED server-side, so a tenant
        can validate while the server is saturated, before burning an
        admission slot (and a retry budget) on a request the verb would
        refuse.  ``verb`` may be ``join``/``shuffle`` (no
        graph; ``keys`` names the key column, ``right`` the build-side
        handle), returning the relational ``TFS14x`` contracts."""
        r = self._c.call(
            "check",
            frame_id=self.frame_id,
            verb=verb,
            graph=graph,
            fetches=list(fetches or []),
            inputs=dict(inputs or {}),
            shapes=dict(shapes or {}),
            keys=list(keys or []),
            trim=trim,
            right_frame_id=right.frame_id if right is not None else None,
            how=how,
            deadline_ms=deadline_ms,
        )
        return r["diagnostics"]

    def _row_verb(
        self, verb: str, graph: bytes, fetches, inputs=None, shapes=None,
        deadline_ms=None,
    ) -> Dict[str, Any]:
        # inputs=/shapes= ride through like the df verbs (the server's
        # _builder always accepted them), so remote reduces can rename
        # placeholders and hint shapes too
        r = self._c.call(
            verb,
            frame_id=self.frame_id,
            graph=graph,
            fetches=list(fetches),
            inputs=dict(inputs or {}),
            shapes=dict(shapes or {}),
            deadline_ms=deadline_ms,
        )
        return r["row"]

    def reduce_blocks(
        self,
        graph: bytes,
        fetches: Sequence[str],
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        deadline_ms: Optional[float] = None,
    ):
        return self._row_verb(
            "reduce_blocks", graph, fetches, inputs, shapes, deadline_ms
        )

    def reduce_rows(
        self,
        graph: bytes,
        fetches: Sequence[str],
        inputs: Optional[Mapping[str, str]] = None,
        shapes: Optional[Mapping[str, Sequence[int]]] = None,
        deadline_ms: Optional[float] = None,
    ):
        return self._row_verb(
            "reduce_rows", graph, fetches, inputs, shapes, deadline_ms
        )

    def collect(
        self,
        columns: Optional[List[str]] = None,
        deadline_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        return self._c.call(
            "collect",
            frame_id=self.frame_id,
            columns=columns,
            deadline_ms=deadline_ms,
        )["columns"]

    def release(self) -> None:
        self._c.call("release", frame_id=self.frame_id)
