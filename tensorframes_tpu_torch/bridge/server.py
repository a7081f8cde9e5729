"""Bridge server: executes the verb protocol against in-process frames.

The port's copy of ``tensorframes_tpu/bridge/server.py``: the same method
surface, allowlists, error codes and fields, so a client of either
package drives it.  ``BridgeServer(device=...)`` (None = the CUDA card)
builds every program on that device; results are copied to the host
before they are encoded.  With ``TFS_FLEET_REGISTRY`` set the server
heartbeats its replica file there (``bridge/fleet.py``).

The method surface mirrors the reference's builder factories
(``PythonInterface.scala:46-68``: ``map_blocks / map_rows / reduce_blocks /
reduce_rows / aggregate_blocks`` + graph/fetches/inputs/shape accessors) as
one-shot RPCs: each verb call carries the accumulated builder state
(GraphDef bytes, fetches, feed map, shape hints) in a single message.
Frames stay server-side (only ids cross the wire) — the analog of DataFrames
staying in the JVM while Python holds handles.

Serving-grade resilience — the reference's Py4J gateway simply
blocks the driver thread per call; a front-end for real traffic cannot:

* **Per-request deadlines**: a request's ``deadline_ms`` becomes a
  ``cancellation.CancelScope`` active for the whole verb execution; the
  engine checks it at every block boundary and retry attempt, so an
  over-deadline verb raises a structured ``deadline_exceeded`` error at
  the next boundary — completed blocks are intact, the session's frames
  stay fully usable, and no worker thread is left stuck.
* **Admission control + backpressure** (:class:`AdmissionGate`): at most
  ``TFS_BRIDGE_MAX_INFLIGHT`` gated requests execute concurrently and at
  most ``TFS_BRIDGE_QUEUE_DEPTH`` wait; past that the server sheds with
  ``server_busy`` + ``retry_after_ms`` instead of queueing unboundedly.
* **Sessions survive connections**: a client that says ``hello`` gets a
  reattachable session token, so a dropped connection does not destroy
  its frames; verb requests carry an idempotency token the session
  dedups (bounded LRU), so a retried request after a dropped reply is
  served the original outcome and never double-executes.
* **Graceful drain**: :meth:`BridgeServer.close` rejects new admissions
  with ``draining``, waits up to ``TFS_BRIDGE_DRAIN_S`` for in-flight
  verbs, then cooperatively cancels stragglers through their cancel
  scopes before releasing the socket.
* **Health**: an ungated ``health`` RPC reports admission depth,
  quarantined devices (``ops/device_pool`` history), and device-memory
  budget occupancy (``ops/frame_cache``) so clients can route around a
  sick server.
* **Chaos**: ``TFS_FAULT_INJECT`` bridge kinds (``bridge_stall`` /
  ``bridge_delay`` / ``bridge_drop``) exercise all of the above
  deterministically (``faults.maybe_inject_bridge``).
* **Telemetry**: every request records its end-to-end wall
  time (admission wait included) into the per-method latency
  histograms (``observability.latency_snapshot`` / ``metrics_text``);
  an ungated ``metrics`` RPC serves the Prometheus text exposition;
  ``health`` carries the gauge snapshot (host-byte high-water,
  flight-recorder depth/drops); with ``TFS_TRACE=1`` each request
  leaves ``request``/``admit``/``execute`` events on its handler
  thread's flight-recorder track (``docs/OBSERVABILITY.md``).
"""

from __future__ import annotations

import collections
import logging
import os
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from .. import cancellation, faults, observability
from ..device import DeviceLike, resolve_device
from ..envutil import (
    env_float as _env_float,
    env_int as _env_int,
    env_raw as _env_raw,
)
from ..analyze import analyze as _analyze
from ..builder import OpBuilder
from ..frame import TensorFrame, host_value
from ..ops import bucketing, device_pool, frame_cache
from ..ops import engine as _engine_mod
from ..ops.engine import GroupedFrame
from ..ops.validation import ValidationError
from . import coalescer as _coalescer
from . import fleet as _fleet
from .protocol import (
    PROTOCOL_VERSION,
    decode_value,
    encode_value,
    read_message,
    write_message,
)

logger = logging.getLogger("tensorframes_tpu_torch.bridge")

# -- knobs (env defaults; per-server constructor overrides win) --------------

ENV_MAX_INFLIGHT = "TFS_BRIDGE_MAX_INFLIGHT"
ENV_QUEUE_DEPTH = "TFS_BRIDGE_QUEUE_DEPTH"
ENV_DRAIN_S = "TFS_BRIDGE_DRAIN_S"
ENV_MAX_FRAMES = "TFS_BRIDGE_MAX_FRAMES"
ENV_SESSION_TTL_S = "TFS_BRIDGE_SESSION_TTL_S"
# the replica name a fleet pins (``bridge/fleet.py``'s constant)
ENV_FLEET_REPLICA = _fleet.ENV_FLEET_REPLICA
# colon-separated directory roots a pipeline RPC's path-based
# parquet source/sink may touch; unset = path access refused (frame_id
# sources and frame/collect sinks are always allowed)
ENV_PIPELINE_PATHS = "TFS_BRIDGE_PIPELINE_PATHS"
# per-reply cap on pipeline window-ledger snapshots; the tail past the
# cap folds into one synthetic entry so counter sums stay exact
_PIPELINE_WINDOW_SNAPS = 512

DEFAULT_MAX_INFLIGHT = 8  # 0 = unlimited (admission gate off)
DEFAULT_QUEUE_DEPTH = 16  # waiters allowed while inflight is full
DEFAULT_DRAIN_S = 5.0
DEFAULT_MAX_FRAMES = 0  # 0 = unlimited
DEFAULT_SESSION_TTL_S = 300.0
_IDEM_CACHE_CAP = 128  # replies remembered per session for dedup
# ...bounded by BYTES too: cached replies pin full result payloads
# (binary attachments included), so a count-only cap would let 128
# multi-MB reduce results per session pile up on exactly the saturated
# host admission control protects.  Oversized single results are not
# retained — a retry of one gets a structured marker instead.
_IDEM_CACHE_MAX_BYTES = 32 * 1024 * 1024
_IDEM_ENTRY_MAX_BYTES = 8 * 1024 * 1024


# methods that execute programs / move bulk data: these pass the
# admission gate and run under a cancel scope.  Cheap control-plane
# methods (ping, schema, release, hello, health, end_session) stay
# ungated so clients can health-check and clean up even when the server
# is saturated or draining.
_GATED_METHODS = frozenset(
    {
        "create_frame",
        "analyze",
        "map_blocks",
        "map_rows",
        "aggregate",
        "reduce_blocks",
        "reduce_rows",
        "collect",
        # registers + primes a program's (bucket, device) grid — it
        # builds kernels, so it pays admission like a verb
        "warm",
        # a whole source -> map -> join -> aggregate -> sink
        # streaming pipeline as ONE gated request — it compiles and
        # dispatches per window, so it pays admission, runs under the
        # request's cancel scope (checkpointed at every window
        # boundary), and attributes per window through nested ledgers
        "pipeline",
        # paged continuous decode — joins the running slot
        # batch at a step boundary, bills generated tokens per tenant,
        # honours deadline/cancel at step boundaries, and surfaces
        # page-pool exhaustion as a typed server_busy refusal
        "decode",
    }
)

# the complete ungated RPC surface, as an ALLOWLIST: anything not named
# here or in _GATED_METHODS is refused, so a future public helper on
# _Session can never silently become a remotely callable method (or
# bypass the admission gate under its raw name, as run_df_verb would).
# CONTRACT: ungated methods skip the idempotency dedup, so each must be
# NATURALLY idempotent (release is a pop that ignores unknown ids;
# check is pure — static analysis, nothing compiled or dispatched) —
# an ungated method with one-shot side effects would double-execute on
# a client retry.  ``check`` is DELIBERATELY ungated: its
# whole point is that a tenant validates a program BEFORE burning an
# admission slot on a request the verb would refuse.
# ``job_status`` is a pure journal read (no compile, no
# dispatch, naturally idempotent), ungated for the same reason as
# ``check``: a client deciding whether to resume must be able to ask
# even when the server is saturated or draining.
_UNGATED_METHODS = frozenset(
    {"ping", "schema", "release", "check", "job_status"}
)

# how long a retried request waits for its still-running original
# execution's outcome before giving up with ``retry_conflict``
_IDEM_WAIT_CAP_S = 600.0

# the complete method surface, for latency-histogram labelling: series
# are keyed by method name, so a client-supplied UNKNOWN name must not
# mint a new series per request (unbounded label cardinality = memory
# growth + metrics bloat on a long-lived server) — everything outside
# this set records under one "unknown" label
_ALL_METHODS = (
    _GATED_METHODS
    | _UNGATED_METHODS
    | frozenset({"hello", "health", "metrics", "attribution",
                 "end_session"})
)

# ledger snapshots retained for the ``attribution`` RPC, per server:
# bounded (LRU by arrival) so a long-lived server's attribution window
# is a sliding recent-history, not unbounded growth
_ATTRIBUTION_CAP = 256
_ATTRIBUTION_RECENT = 32  # returned by a no-cid attribution query


class BridgeServerError(RuntimeError):
    """A structured server-side refusal: carried to the client as
    ``{type, message, code, ...extra}`` so front-ends can branch on
    ``code`` instead of parsing prose."""

    code = "error"

    def __init__(self, message: str, code: Optional[str] = None, **extra):
        super().__init__(message)
        if code is not None:
            self.code = code  # instance override of the class default
        self.extra = extra


class ServerBusy(BridgeServerError):
    """Admission gate full: shed instead of queueing unboundedly.  The
    payload carries ``retry_after_ms`` — a deterministic backoff hint
    scaled by the current queue depth."""

    code = "server_busy"


class Draining(BridgeServerError):
    """The server is draining for shutdown; no new work is admitted."""

    code = "draining"


class FrameCapExceeded(BridgeServerError):
    """The per-session frame registry hit ``TFS_BRIDGE_MAX_FRAMES`` —
    almost always a client loop that never calls ``release``.  The
    payload names the leaked frame ids."""

    code = "frame_cap_exceeded"


class ResultEncodingError(BridgeServerError):
    """The verb EXECUTED but its result could not be serialized; the
    message preserves that context."""

    code = "result_encoding"


class AdmissionGate:
    """Bounded concurrent-execution gate for the serving path.

    ``max_inflight`` gated requests execute at once; up to
    ``queue_depth`` more wait — a waiter's deadline keeps ticking and
    expires in place, and a NEW arrival never barges past waiters (the
    fast path requires an empty queue, so freed slots go to the queue
    first; wakeup order among waiters is the condition variable's).
    Anything past both bounds is shed immediately with
    :class:`ServerBusy`.  ``max_inflight=0`` disables the gate (every
    request admits instantly — the single-tenant / test default pinned
    by conftest)."""

    def __init__(self, max_inflight: int, queue_depth: int):
        self.max_inflight = max(0, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self._cond = threading.Condition()
        # FIFO tickets: freed slots are granted strictly in queue-arrival
        # order, so a deadline-carrying waiter cannot be starved by later
        # arrivals repeatedly winning the condition-wakeup race
        self._waiters: "collections.deque" = collections.deque()
        self.inflight = 0
        self.queued = 0
        self.draining = False
        self.shed = 0

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "inflight": self.inflight,
                "queued": self.queued,
                "max_inflight": self.max_inflight,
                "queue_depth": self.queue_depth,
                "draining": self.draining,
                "shed_total": self.shed,
            }

    def _shed(self, exc: BridgeServerError) -> None:
        self.shed += 1
        observability.note_bridge_shed()
        raise exc

    def admit(self, scope: Optional[cancellation.CancelScope]) -> None:
        """Admit the calling request or raise: :class:`Draining` while
        draining, :class:`ServerBusy` when both the inflight and queue
        bounds are full, ``DeadlineExceeded`` when the request's
        deadline expires while queued."""
        with self._cond:
            if self.draining:
                self._shed(Draining("server is draining; not admitting"))
            # fast path only with an EMPTY queue: a new arrival taking a
            # freed slot ahead of parked waiters would starve them (a
            # deadline-carrying waiter could expire despite capacity
            # turning over many times)
            if self.max_inflight <= 0 or (
                self.inflight < self.max_inflight and not self._waiters
            ):
                self.inflight += 1
                return
            if self.queued >= self.queue_depth:
                self._shed(
                    ServerBusy(
                        f"admission gate full ({self.inflight} in flight, "
                        f"{self.queued} queued; {ENV_MAX_INFLIGHT}="
                        f"{self.max_inflight} {ENV_QUEUE_DEPTH}="
                        f"{self.queue_depth})",
                        retry_after_ms=25 * (self.queued + 1),
                    )
                )
            ticket = object()
            self._waiters.append(ticket)
            self.queued += 1
            try:
                while True:
                    if self.draining:
                        self._shed(
                            Draining("server began draining while queued")
                        )
                    if (
                        self.inflight < self.max_inflight
                        and self._waiters[0] is ticket
                    ):
                        # strictly FIFO: only the HEAD ticket may take a
                        # freed slot, so later queuers cannot win the
                        # wakeup race over an earlier deadline-bound one
                        self.inflight += 1
                        return
                    remaining = (
                        scope.time_remaining() if scope is not None else None
                    )
                    if remaining is not None and remaining <= 0:
                        raise cancellation.DeadlineExceeded(
                            "request deadline expired while queued for "
                            "admission (never executed)"
                        )
                    self._cond.wait(timeout=remaining)
            finally:
                self.queued -= 1
                try:
                    self._waiters.remove(ticket)
                except ValueError:  # pragma: no cover - defensive
                    pass
                # whatever removed us from the head (grant, shed,
                # expiry), the next ticket must get a look
                self._cond.notify_all()

    def release(self) -> None:
        with self._cond:
            self.inflight -= 1
            self._cond.notify_all()

    def start_draining(self) -> None:
        with self._cond:
            self.draining = True
            self._cond.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until no gated request is in flight (True) or
        ``timeout_s`` elapsed (False)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


class _Session:
    """Server-side session state: the frame registry, the idempotency
    dedup cache, and the per-method call counters fault injection keys
    on.  Addressed by a ``hello`` token, so it survives its TCP
    connection (reattach after a drop); no-``hello`` legacy connections
    get an implicit session that dies with the connection."""

    def __init__(
        self,
        engine=None,
        token: str = "",
        max_frames: int = 0,
        device: DeviceLike = None,
    ):
        self.engine = engine
        self.device = device
        self.frames: Dict[int, TensorFrame] = {}
        self._next = 0
        self.token = token
        self.max_frames = int(max_frames)
        self.lock = threading.Lock()
        self.idem: "collections.OrderedDict[str, tuple]" = (
            collections.OrderedDict()
        )
        self._idem_bytes = 0
        # tokens whose FIRST execution is still running: a client whose
        # read timed out mid-verb retries while the original handler
        # thread is still executing — the retry must wait for that
        # outcome, not start a concurrent second execution
        self.idem_inflight: Dict[str, threading.Event] = {}
        self.method_calls: Dict[str, int] = {}
        self.explicit = False  # attached via hello (reattachable)
        self.refs = 0  # connections currently attached
        self.last_active = time.monotonic()

    def register(self, frame: TensorFrame) -> int:
        with self.lock:
            if self.max_frames and len(self.frames) >= self.max_frames:
                ids = sorted(self.frames)
                shown = ", ".join(map(str, ids[:16]))
                if len(ids) > 16:
                    shown += f", ... ({len(ids) - 16} more)"
                raise FrameCapExceeded(
                    f"session holds {len(self.frames)} frames — the "
                    f"{ENV_MAX_FRAMES}={self.max_frames} cap; release "
                    f"leaked frame ids [{shown}] (a loop that never "
                    f"calls release() grows the registry for the life "
                    f"of the session)",
                    leaked_frame_ids=ids[:64],
                )
            self._next += 1
            self.frames[self._next] = frame
            return self._next

    def frame(self, fid: int) -> TensorFrame:
        if fid not in self.frames:
            raise KeyError(f"unknown frame id {fid}")
        return self.frames[fid]

    # -- idempotency dedup ---------------------------------------------------

    def idem_lookup(self, token: str):
        with self.lock:
            entry = self.idem.get(token)
            if entry is not None:
                self.idem.move_to_end(token)
            return entry

    def idem_begin(self, token: str):
        """-> ``("hit", entry)`` (outcome already recorded),
        ``("wait", event)`` (first execution still running — wait for
        its outcome instead of double-executing), or ``("own", None)``
        (this request executes and must call :meth:`idem_finish`)."""
        with self.lock:
            entry = self.idem.get(token)
            if entry is not None:
                self.idem.move_to_end(token)
                return "hit", entry
            ev = self.idem_inflight.get(token)
            if ev is not None:
                return "wait", ev
            ev = threading.Event()
            self.idem_inflight[token] = ev
            return "own", None

    def idem_finish(self, token: str, entry) -> None:
        """Record the owner's outcome (``entry`` may be None when the
        request was refused before executing, e.g. shed) and wake any
        retries waiting on it.  The cache is bounded by entry count AND
        bytes; a single result past ``_IDEM_ENTRY_MAX_BYTES`` is
        replaced with a replay-unavailable marker (the execution still
        happened exactly once — only the replay is withheld)."""
        if entry is not None:
            kind, payload, bins = entry
            nbytes = sum(len(b) for b in bins) + _approx_payload_bytes(
                payload
            )
            if nbytes > _IDEM_ENTRY_MAX_BYTES:
                entry = (
                    "error",
                    {
                        "type": "IdemReplayUnavailable",
                        "message": (
                            "the original request executed exactly once, "
                            "but its result was too large to retain for "
                            "idempotent replay; re-issue as a NEW request"
                        ),
                        "code": "retry_conflict",
                    },
                    [],
                )
                nbytes = 512
            entry = entry + (nbytes,)
        with self.lock:
            if entry is not None:
                self.idem[token] = entry
                self._idem_bytes += entry[3]
                while self.idem and (
                    len(self.idem) > _IDEM_CACHE_CAP
                    or self._idem_bytes > _IDEM_CACHE_MAX_BYTES
                ):
                    _, old = self.idem.popitem(last=False)
                    self._idem_bytes -= old[3]
            ev = self.idem_inflight.pop(token, None)
        if ev is not None:
            ev.set()

    def next_call_index(self, method: str) -> int:
        with self.lock:
            i = self.method_calls.get(method, 0)
            self.method_calls[method] = i + 1
            return i

    # -- methods (the RPC surface) ------------------------------------------

    def create_frame(self, columns: Dict[str, Any], num_blocks: int = 1):
        frame = TensorFrame.from_arrays(dict(columns), num_blocks=num_blocks)
        fid = self.register(frame)
        return {"frame_id": fid, "schema": self._schema(frame)}

    def analyze(self, frame_id: int):
        frame = _analyze(self.frame(frame_id))
        self.frames[frame_id] = frame
        return {"schema": self._schema(frame)}

    def schema(self, frame_id: int):
        return {"schema": self._schema(self.frame(frame_id))}

    def _schema(self, frame: TensorFrame):
        return [
            {
                "name": c.name,
                "dtype": c.scalar_type.name,
                "block_shape": list(c.block_shape),
            }
            for c in frame.schema
        ]

    def _builder(self, verb: str, target, params: Dict[str, Any]) -> OpBuilder:
        factory = {
            "map_blocks": lambda: OpBuilder.map_blocks(
                target, trim=bool(params.get("trim", False)),
                device=self.device,
            ),
            "map_rows": lambda: OpBuilder.map_rows(target, device=self.device),
            "reduce_blocks": lambda: OpBuilder.reduce_blocks(
                target, device=self.device
            ),
            "reduce_rows": lambda: OpBuilder.reduce_rows(
                target, device=self.device
            ),
            "aggregate": lambda: OpBuilder.aggregate_blocks(
                target, device=self.device
            ),
        }[verb]
        b = factory()
        b.graph(params["graph"])  # GraphDef bytes — the reference transport
        if params.get("fetches"):
            b.fetches(params["fetches"])
        if params.get("inputs"):
            b.inputs(params["inputs"])
        for name, shape in (params.get("shapes") or {}).items():
            b.shape(name, shape)
        return b

    def run_df_verb(self, verb: str, frame_id: int, **params):
        frame = self.frame(frame_id)
        target: Any = frame
        if verb == "aggregate":
            target = GroupedFrame(frame, params.pop("keys"))
        b = self._builder(verb, target, params)
        if self.engine is not None:
            # an explicit executor runs the verb eagerly, as the JAX
            # builder's ``engine_`` does
            out = self.engine.aggregate(b._program(), target)
        else:
            out = b.build_df()
        fid = self.register(out)
        return {"frame_id": fid, "schema": self._schema(out)}

    def run_row_verb(self, verb: str, frame_id: int, **params):
        frame = self.frame(frame_id)
        b = self._builder(verb, frame, params)
        if self.engine is not None:
            out = getattr(self.engine, verb)(b._program(), frame)
        else:
            out = b.build_row()
        # host values: the handler's single encode_value(result, bins)
        # routes bulk payloads to the binary attachments — pre-encoding
        # here would pin them to inline base64
        return {"row": {k: host_value(v) for k, v in out.items()}}

    def collect(self, frame_id: int, columns=None):
        frame = self.frame(frame_id)
        names = columns or frame.column_names
        out = {}
        for n in names:
            col = frame.column(n)
            if col.is_ragged or not col.info.scalar_type.device_ok:
                out[n] = list(col.cells())
            else:
                # a card tensor reaches the host here, before encode_value
                # (bf16 stays a CPU tensor: numpy has no bfloat16)
                out[n] = host_value(col.data)
        return {"columns": out, "num_rows": frame.num_rows}

    def release(self, frame_id: int):
        self.frames.pop(frame_id, None)
        return {}

    @staticmethod
    def _check_pipeline_paths(source, sink) -> None:
        """Path-based pipeline sources/sinks touch the SERVER's
        filesystem — the only bridge surface that does — so they are
        refused unless the path falls under one of the operator-
        configured ``TFS_BRIDGE_PIPELINE_PATHS`` roots (colon-
        separated).  Registered frames (``frame_id`` sources, frame /
        collect sinks) need no filesystem access and are always
        allowed."""
        wants = []
        if isinstance(source, dict) and "parquet" in source:
            wants.append(("source", source["parquet"]))
        if isinstance(sink, dict) and sink.get("kind") == "parquet":
            wants.append(("sink", sink.get("path")))
        if not wants:
            return
        roots = [
            os.path.realpath(r)
            for r in _env_raw(ENV_PIPELINE_PATHS, "").split(":")
            if r
        ]
        for what, p in wants:
            rp = os.path.realpath(str(p))
            if not any(
                rp == root or rp.startswith(root.rstrip("/") + "/")
                for root in roots
            ):
                raise ValidationError(
                    f"bridge pipeline {what} path {str(p)!r} is not "
                    f"under any {ENV_PIPELINE_PATHS} root "
                    f"({roots or 'none configured'}); path-based "
                    f"sources/sinks read/write the server's "
                    f"filesystem — register a frame and use frame_id "
                    f"(or a collect sink) instead, or have the "
                    f"operator allow the directory"
                )

    def pipeline(self, source=None, stages=None, sink=None, job_id=None):
        """The gated ``pipeline`` RPC: execute a declarative
        source -> map -> join -> aggregate -> sink streaming pipeline
        (``relational/pipeline.py``) against this session's frames.
        Key-column contracts are verified BEFORE the first window
        dispatches (the ``tfs.check`` TFS14x codes ride the refusal);
        per-window ledgers nest under this request's ledger, so the
        returned window attributions sum to the request's counters
        delta.  The result frame (aggregate / collect sinks) registers
        in the session like any verb output.

        ``job_id`` makes the pipeline durable: the journal
        (``TFS_JOURNAL_DIR``) records every window boundary, so a
        client that lost its server (``SessionLost``) reattaches,
        re-registers its frames, and re-issues the SAME spec + job_id —
        the server resumes from the last journaled window, and a job
        that already completed returns its journaled result WITHOUT
        executing (exactly-once, composing with — not relying on — the
        per-session idempotency tokens, which cannot survive a server
        restart).  A resume racing the still-running original is
        refused with the typed ``job_active`` error, never executed
        concurrently."""
        from ..recovery import JobActive
        from ..relational import run_stream_pipeline

        self._check_pipeline_paths(source, sink)
        try:
            out = run_stream_pipeline(
                source,
                stages=stages,
                sink=sink,
                frames=self.frames,
                engine=self.engine,
                job_id=job_id,
                device=self.device,
            )
        except JobActive as exc:
            raise BridgeServerError(
                str(exc), code="job_active", retry_after_ms=250
            ) from exc
        snaps = out["windows"]
        if len(snaps) > _PIPELINE_WINDOW_SNAPS:
            # bound the reply without breaking the exact-sum contract:
            # the tail's snapshots FOLD into one synthetic entry, so
            # summing the returned windows' counters still equals the
            # request's attribution ledger
            head = snaps[: _PIPELINE_WINDOW_SNAPS - 1]
            tail = snaps[_PIPELINE_WINDOW_SNAPS - 1 :]
            folded: Dict[str, Any] = {
                "correlation_id": (
                    tail[0]["correlation_id"] + "+"
                ),
                "tenant": tail[0]["tenant"],
                "method": tail[0]["method"],
                "folded_windows": len(tail),
                "wall_s": round(sum(s["wall_s"] for s in tail), 6),
                "rows": sum(s["rows"] for s in tail),
                "counters": {},
                "blocks_per_device": {},
                "latency": {},
            }
            for s in tail:
                for k, n in s["counters"].items():
                    folded["counters"][k] = (
                        folded["counters"].get(k, 0) + n
                    )
                for d, n in s["blocks_per_device"].items():
                    folded["blocks_per_device"][d] = (
                        folded["blocks_per_device"].get(d, 0) + n
                    )
            snaps = head + [folded]
        reply: Dict[str, Any] = {
            "rows": out["rows"],
            "windows": snaps,
            "window_count": len(out["windows"]),
            "diagnostics": out["diagnostics"],
            "sink": out["sink"],
        }
        if out.get("resumed"):
            reply["resumed"] = True
        frame = out.get("frame")
        if frame is not None:
            fid = self.register(frame)
            reply["frame_id"] = fid
            reply["schema"] = self._schema(frame)
        return reply

    def check(
        self,
        frame_id: int,
        verb: str,
        graph=None,
        fetches=None,
        inputs=None,
        shapes=None,
        keys=None,
        trim: bool = False,
        right_frame_id=None,
        how: str = "inner",
    ):
        """Pre-dispatch contract verification (``tfs.check``):
        validate a program against a registered frame WITHOUT paying
        admission, idempotency, or compile costs — returns the
        structured ``TFSxxx`` diagnostics instead of the late refusal
        the matching verb request would earn.

        Deliberately ungated, with a known tradeoff: unlike the other
        ungated methods (all O(1)), a check runs abstract traces
        (``program.analyze`` on fake tensors + the classifier's canonical
        probes) on the server thread, outside admission/deadline/
        fair-share scope and unmemoized across RPCs (each call builds a
        fresh Program).  That is the point —
        tenants must be able to validate BEFORE burning admission
        budget — but it means a tenant looping ``check()`` with large
        graphs consumes server CPU the shed machinery cannot see.
        Acceptable while traces are ms-scale; if it bites, the fix is a
        server-side (graph fingerprint, schema) -> diagnostics LRU, not
        gating."""
        frame = self.frame(frame_id)
        from .. import analysis

        v = "map_blocks_trimmed" if (verb == "map_blocks" and trim) else verb
        diags = analysis.check(
            frame,
            graph,
            v,
            device=self.device,
            fetches=list(fetches) if fetches else None,
            inputs=dict(inputs) if inputs else None,
            shapes=dict(shapes) if shapes else None,
            keys=list(keys) if keys else None,
            # the relational verbs (join/shuffle) validate
            # key contracts against a second registered frame
            right=(
                self.frame(right_frame_id)
                if right_frame_id is not None
                else None
            ),
            how=how,
        )
        return {"diagnostics": [d.as_dict() for d in diags]}

    def job_status(self, job_id: str = ""):
        """Durable-job status (ungated): the journal's view
        of ``job_id`` — present/running/interrupted/complete, completed
        boundary, owner liveness.  The resume decision surface: a
        client that caught ``SessionLost`` asks here what survived the
        restart before re-issuing work."""
        from .. import recovery

        return recovery.job_status(str(job_id))

    def ping(self):
        return {"pong": True}


def _approx_payload_bytes(v, _depth: int = 0) -> int:
    """Cheap size estimate of an already-ENCODED (JSON-safe) payload for
    the idem-cache byte bound: strings (inline base64 tensors included)
    dominate real payload size, so summing their lengths approximates
    the wire cost without paying a second full ``json.dumps`` on the
    serving hot path."""
    if isinstance(v, str):
        return len(v)
    if _depth < 16:
        if isinstance(v, dict):
            return sum(
                len(k) + _approx_payload_bytes(x, _depth + 1)
                for k, x in v.items()
            )
        if isinstance(v, (list, tuple)):
            return sum(
                _approx_payload_bytes(x, _depth + 1) for x in v
            )
    return 8


def _error_payload(e: BaseException) -> Dict[str, Any]:
    """Exception -> structured wire error (and the matching evidence
    counter — bumped here, at payload CREATION, so a dedup-served cached
    error never double-counts)."""
    payload: Dict[str, Any] = {"type": type(e).__name__, "message": str(e)}
    if isinstance(e, cancellation.DeadlineExceeded):
        payload["code"] = "deadline_exceeded"
        observability.note_bridge_deadline_exceeded()
    elif isinstance(e, cancellation.Cancelled):
        payload["code"] = "cancelled"
        observability.note_bridge_cancel()
    elif isinstance(e, BridgeServerError):
        payload["code"] = e.code
        for k, v in e.extra.items():
            payload[k] = v
    elif isinstance(getattr(e, "code", None), str):
        # dispatch-time TFSxxx codes (ValidationError / GraphImportError
        # / UnsupportedOpError) ride the wire too, so a
        # front-end can branch on the same code whether it validated
        # early (the check RPC) or failed late
        payload["code"] = e.code
    return payload


def _sliced_sleep(
    ms: float, scope: Optional[cancellation.CancelScope]
) -> None:
    """An injected stall that still cooperates with cancellation: sleep
    in small slices, checking the scope between them."""
    end = time.monotonic() + ms / 1000.0
    while True:
        if scope is not None:
            scope.check()
        remaining = end - time.monotonic()
        if remaining <= 0:
            return
        time.sleep(min(0.01, remaining))


class _DropReply(Exception):
    """Internal: injected ``bridge_drop`` — sever the connection
    instead of writing the (already computed and dedup-cached) reply."""


class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        # keepalive: a client host that dies without FIN/RST (power
        # loss, silent partition) would otherwise block this handler in
        # readline forever with the session pinned at refs=1 — beyond
        # the TTL reaper's reach.  OS keepalive eventually surfaces the
        # dead peer as a read error, which detaches and frees it.
        try:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1
            )
        except OSError:  # pragma: no cover - exotic socket types
            pass
        self._session: Optional[_Session] = None
        self._err_logged = False
        self._req_cid: Optional[str] = None

    def finish(self):
        if self._session is not None:
            self.server._detach(self._session)  # type: ignore[attr-defined]
            self._session = None
        super().finish()

    def _log_once(self, what: str, exc: BaseException) -> None:
        """Once-per-connection error-path log (a handler whose error reply
        itself fails must not die silently); repeated failures on one
        connection stay one line."""
        if not self._err_logged:
            self._err_logged = True
            logger.warning(
                "bridge connection %s: %s: %s: %s",
                self.client_address,
                what,
                type(exc).__name__,
                exc,
            )

    def handle(self):
        while True:
            try:
                msg, rbins = read_message(self.rfile)
            except (ConnectionError, ValueError):
                return
            mid = msg.get("id")
            try:
                reply, bins = self._run_method(msg, rbins)
            except _DropReply:
                return  # injected dropped reply: sever without writing
            except ConnectionError:
                return
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                reply, bins = {"error": _error_payload(e)}, []
            try:
                write_message(self.wfile, dict(reply, id=mid), bins)
            except ConnectionError:
                # BrokenPipe AND reset-by-peer: an ordinary client
                # disconnect mid-write (e.g. its read-timeout teardown),
                # not a serialization failure — no fallback, no log spam
                return
            except Exception as we:  # noqa: BLE001 — degrade, don't die
                # the reply write itself failed (result payload past a
                # wire cap, serialization bug): fall back to a minimal
                # error so the client is never left waiting on a
                # silently dead loop
                self._log_once("reply write failed", we)
                try:
                    write_message(
                        self.wfile,
                        {
                            "id": mid,
                            "error": {
                                "type": type(we).__name__,
                                "message": str(we),
                            },
                        },
                    )
                except Exception as we2:  # noqa: BLE001
                    self._log_once(
                        "minimal error reply failed; closing", we2
                    )
                    return

    # -- per-request processing ---------------------------------------------

    def _run_method(self, msg: dict, rbins: list):
        """Latency/trace envelope around :meth:`_dispatch`:
        every bridge method — gated or not, success or refusal — records
        its END-TO-END wall time (admission wait included) into the
        ``bridge`` latency-histogram family, and with the flight
        recorder on, a ``request <method>`` event on this handler
        thread's track."""
        method = msg.get("method")
        label = method if method in _ALL_METHODS else "unknown"
        track = (
            f"bridge/{threading.current_thread().name.split(' ')[0]}"
        )
        t0 = time.perf_counter()
        t_tr = t0 if observability.trace_enabled() else None
        self._req_cid = None  # set by _dispatch for gated requests
        try:
            return self._dispatch(msg, rbins, method, track)
        finally:
            observability.record_latency(
                "bridge", label, time.perf_counter() - t0
            )
            # the request event closes AFTER the ledger context is
            # reset, so the cid is passed explicitly
            if self._req_cid is not None:
                observability.trace_complete(
                    f"request {label}", track, t_tr, cid=self._req_cid
                )
            else:
                observability.trace_complete(
                    f"request {label}", track, t_tr
                )

    def _dispatch(self, msg: dict, rbins: list, method, track: str):
        """-> ``(reply_without_id, bins)``; raises ``_DropReply`` for an
        injected dropped reply and structured exceptions for refusals."""
        server = self.server  # type: ignore[attr-defined]
        if not isinstance(method, str) or method.startswith("_"):
            raise AttributeError(f"unknown method {method!r}")

        # connection-scoped control plane (no session state touched)
        if method == "hello":
            params = decode_value(msg.get("params") or {}, rbins)
            sess = server._attach(params.get("session"))
            # ALWAYS balance the previous attach — a repeated hello with
            # the same token would otherwise leak a ref (attach bumps
            # refs every time; finish() only decrements once), pinning
            # the session past its TTL forever
            if self._session is not None:
                server._detach(self._session)
            self._session = sess
            return {
                "result": {
                    "session": sess.token,
                    "pv": PROTOCOL_VERSION,
                    # which replica answered (additive), so a failover
                    # client can tell whether its reattach landed
                    # somewhere new
                    "replica": server.replica_identity(),
                }
            }, []
        if method == "health":
            bins: list = []
            return {
                "result": encode_value(server.health_snapshot(), bins)
            }, bins
        if method == "metrics":
            # ungated like health: a saturated or draining server must
            # still be scrapeable — that is when the metrics matter
            return {"result": {"text": server.metrics_text()}}, []
        if method == "attribution":
            # ungated like metrics: per-request cost attribution must be
            # readable from a saturated server (that is when a tenant's
            # spend matters most)
            params = decode_value(msg.get("params") or {}, rbins)
            bins = []
            return {
                "result": encode_value(
                    server.attribution_snapshot(
                        params.get("correlation_id")
                    ),
                    bins,
                )
            }, bins

        sess = self._session
        if sess is None:
            # legacy no-hello path: an implicit session that dies with
            # the connection (nothing to reattach to without a token)
            sess = self._session = server._attach(None)
            sess.explicit = False
        if method == "end_session":
            server._drop_session(sess)
            # unbind: the next request on this connection re-attaches a
            # fresh REGISTERED session instead of executing against a
            # zombie the reaper and health can no longer see
            self._session = None
            return {"result": {}}, []

        call_i = sess.next_call_index(method)
        fplan = (
            faults.maybe_inject_bridge(method, call_i)
            if faults.bridge_active()
            else None
        )
        if fplan is not None and fplan.kill_after_ms is not None:
            # chaos: arm a real SIGKILL on a daemon timer and
            # keep executing — the process dies MID-request, exactly the
            # death the fleet failover + journal migration must survive
            faults.schedule_replica_kill(fplan.kill_after_ms)
        gated = method in _GATED_METHODS
        if not gated:
            if method not in _UNGATED_METHODS:
                raise AttributeError(f"unknown method {method!r}")
            if fplan is not None and fplan.stall_ms:
                # ungated methods have no cancel scope; the stall still
                # applies (chaos on ping/schema/release exercises client
                # timeouts), just uncancellable
                _sliced_sleep(fplan.stall_ms, None)
            params = decode_value(msg.get("params") or {}, rbins)
            result = getattr(sess, method)(**params)
            return self._finish_reply(
                *self._encode_result(method, result), fplan
            )

        deadline_ms = msg.get("deadline_ms")
        scope = cancellation.CancelScope(
            deadline_s=(
                float(deadline_ms) / 1000.0
                if deadline_ms is not None
                else None
            ),
            label=f"bridge:{method}",
        )

        # request-scoped telemetry: the client-stamped
        # correlation id (or a server-minted one) becomes a RequestLedger
        # on the contextvar — alongside the cancel scope — for the whole
        # gated request: admission wait, execution, every engine /
        # staging-lane / fault counter bump and trace event attribute to
        # it.  The envelope keys are additive (old clients simply get
        # server-minted cids).
        cid = msg.get("cid")
        cid = cid if isinstance(cid, str) and cid else (
            observability.new_correlation_id()
        )
        tenant = msg.get("tenant")
        tenant = tenant if isinstance(tenant, str) and tenant else None
        self._req_cid = cid
        ledger = observability.RequestLedger(
            cid, tenant=tenant, method=f"bridge:{method}"
        )
        ledger_token = observability.activate_request(ledger)
        try:
            return self._dispatch_gated(
                msg, rbins, method, track, sess, scope, fplan
            )
        finally:
            observability.deactivate_request(ledger_token)
            ledger.finish()
            server._record_attribution(ledger)

    def _dispatch_gated(
        self, msg, rbins, method, track, sess, scope, fplan
    ):
        """The admission-gated request body (factored out so the
        request-ledger install/finish wraps it cleanly)."""
        server = self.server  # type: ignore[attr-defined]

        # idempotency dedup BEFORE admission: a retried request whose
        # first run already recorded an outcome is served that outcome
        # without costing an admission slot; a retry racing its ORIGINAL
        # (client read-timeout while the verb still runs) waits for the
        # original's outcome instead of double-executing
        idem = msg.get("idem")
        owner = False
        if isinstance(idem, str):
            state, val = sess.idem_begin(idem)
            if state == "hit":
                observability.note_bridge_idem_hit()
                kind, payload, bins = val[:3]
                return self._finish_reply(
                    {("result" if kind == "result" else "error"): payload},
                    bins,
                    fplan,
                )
            if state == "wait":
                remaining = scope.time_remaining()
                val.wait(
                    _IDEM_WAIT_CAP_S
                    if remaining is None
                    else max(0.0, min(remaining, _IDEM_WAIT_CAP_S))
                )
                hit = sess.idem_lookup(idem)
                if hit is not None:
                    observability.note_bridge_idem_hit()
                    kind, payload, bins = hit[:3]
                    return self._finish_reply(
                        {
                            ("result" if kind == "result" else "error"):
                            payload
                        },
                        bins,
                        fplan,
                    )
                # an expired deadline while waiting is a deadline, not a
                # conflict — clients branch on deadline_exceeded to stop
                # retrying a dead request
                scope.check()
                raise BridgeServerError(
                    f"idempotent retry of {method} raced its original "
                    f"execution and no outcome was recorded within the "
                    f"wait window; retry again later",
                    code="retry_conflict",
                )
            owner = True
        else:
            idem = None

        # gated: admission -> cancel scope -> execute -> encode; every
        # outcome (success or error) is dedup-cached under the idem
        # token, and waiters are woken even when admission refuses
        entry = None
        try:
            # SLO-aware admission policy BEFORE the gate: an
            # over-budget tenant (or the dominant consumer under tail
            # pressure) is shed with a structured hint instead of
            # queueing into the very backlog that blows p99.  Only the
            # BILLED compute verbs are subject to it — shedding a cheap
            # metadata call (create_frame/analyze) frees nothing and
            # just burns the tenant's retries.
            decision = (
                server.scheduler.check(
                    getattr(
                        observability.current_request(), "tenant", None
                    ),
                    contention=(
                        server.gate.max_inflight > 0
                        and (
                            server.gate.queued > 0
                            or server.gate.inflight
                            >= server.gate.max_inflight
                        )
                    ),
                )
                if method in server._BILLED_METHODS
                else None
            )
            if decision is not None:
                observability.note_bridge_shed()
                raise ServerBusy(
                    f"{method} shed by the SLO scheduler "
                    f"({decision['reason']}: tenant "
                    f"{decision['tenant']!r} used "
                    f"{decision.get('rows_used', 0)} rows in the "
                    f"window)",
                    **decision,
                )
            # flight recorder: admission wait and execution are separate
            # events on this handler's track, so queueing-vs-compute time
            # is visible per request in the Perfetto view
            t_admit = observability.trace_now()
            server.gate.admit(scope)
            observability.trace_complete(f"admit {method}", track, t_admit)
            server._register_scope(scope)
            t_exec = observability.trace_now()
            try:
                with observability.verb_span(
                    f"bridge:{method}", 0, 0
                ) as span:
                    span.annotate("admission", server.gate.snapshot())
                    try:
                        # decode AFTER admission: a shed request must not
                        # pay the base64/ndarray materialization CPU the
                        # gate exists to protect admitted requests from
                        params = decode_value(
                            msg.get("params") or {}, rbins
                        )
                        if fplan is not None and fplan.stall_ms:
                            _sliced_sleep(fplan.stall_ms, scope)
                        with cancellation.activate(scope):
                            scope.check()  # deadline may have passed queued
                            observability.note_bridge_verb_executed()
                            if method in ("map_blocks", "map_rows"):
                                # map verbs route through the
                                # coalescer (warm program pool + micro-
                                # batching); solo when coalescing is off
                                result = server.coalescer.run_map_verb(
                                    sess, method, scope=scope, **params
                                )
                            elif method == "aggregate":
                                result = sess.run_df_verb(method, **params)
                            elif method in ("reduce_blocks", "reduce_rows"):
                                result = sess.run_row_verb(method, **params)
                            elif method == "warm":
                                result = server.warm_program(**params)
                            elif method == "decode":
                                result = server.run_decode(**params)
                            else:  # create_frame / analyze / collect
                                result = getattr(sess, method)(**params)
                            server._note_usage(sess, method, params)
                        reply, bins = self._encode_result(method, result)
                        entry = ("result", reply["result"], bins)
                    except Exception as e:  # noqa: BLE001 — structured
                        span.annotate("failed", True)
                        payload = _error_payload(e)
                        reply, bins = {"error": payload}, []
                        entry = ("error", payload, [])
            finally:
                observability.trace_complete(
                    f"execute {method}", track, t_exec
                )
                server._unregister_scope(scope)
                server.gate.release()
        finally:
            if owner:
                sess.idem_finish(idem, entry)
        return self._finish_reply(reply, bins, fplan)

    def _encode_result(self, method: str, result):
        """Encode a successful result, preserving execution context when
        serialization itself fails (a bare encoding error would read as
        if the verb had failed)."""
        bins: list = []
        try:
            return {"result": encode_value(result, bins)}, bins
        except Exception as enc_exc:  # noqa: BLE001
            self._log_once("result serialization failed", enc_exc)
            raise ResultEncodingError(
                f"{method} executed, but its result could not be "
                f"serialized: {type(enc_exc).__name__}: {enc_exc}"
            ) from enc_exc

    def _finish_reply(self, reply, bins, fplan):
        """Apply injected reply-path chaos: delay, then drop.  The drop
        counts in ``faults_injected`` HERE — at the point the
        connection is actually severed — so a request refused before
        its reply (shed, draining) never reads as a fired fault."""
        if fplan is not None:
            if fplan.delay_ms:
                time.sleep(fplan.delay_ms / 1000.0)
            if fplan.drop:
                observability.note_fault_injected()
                logger.warning(
                    "bridge: injected dropped reply (bridge_drop); "
                    "severing %s",
                    self.client_address,
                )
                raise _DropReply()
        return reply, bins


class BridgeServer(socketserver.ThreadingTCPServer):
    """Localhost TCP bridge server; sessions are token-addressed and
    survive their connections (``hello`` reattaches).

    The protocol executes client-supplied programs and is UNauthenticated —
    it is a local IPC seam (the analog of the reference's in-process Py4J
    gateway), not a network service.  Binding a non-loopback address
    therefore requires ``allow_remote=True``, an explicit statement that
    the network path is trusted (e.g. inside a pod's private fabric)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        engine=None,
        allow_remote: bool = False,
        device: DeviceLike = None,
        max_inflight: Optional[int] = None,
        queue_depth: Optional[int] = None,
        drain_s: Optional[float] = None,
        max_frames: Optional[int] = None,
        session_ttl_s: Optional[float] = None,
        coalesce_us: Optional[float] = None,
        coalesce_rows: Optional[int] = None,
        warm_spec: Optional[str] = None,
        fair_rows: Optional[int] = None,
        fair_window_s: Optional[float] = None,
        slo_ms: Optional[float] = None,
        decode_model: Optional[Dict[str, Any]] = None,
    ):
        if not allow_remote and host not in ("127.0.0.1", "::1", "localhost"):
            raise ValueError(
                f"refusing to bind the unauthenticated bridge to {host!r}; "
                f"pass allow_remote=True only on a trusted network"
            )
        # where every program this server builds places its params and
        # runs (None = the CUDA card, which must exist); resolved before
        # the socket binds.  The decode model runs where its params live.
        self.device = resolve_device(device)
        super().__init__((host, port), _Handler)
        self.engine = engine
        self.gate = AdmissionGate(
            _env_int(ENV_MAX_INFLIGHT, DEFAULT_MAX_INFLIGHT)
            if max_inflight is None
            else max_inflight,
            _env_int(ENV_QUEUE_DEPTH, DEFAULT_QUEUE_DEPTH)
            if queue_depth is None
            else queue_depth,
        )
        self.drain_s = (
            _env_float(ENV_DRAIN_S, DEFAULT_DRAIN_S)
            if drain_s is None
            else float(drain_s)
        )
        self.max_frames = (
            _env_int(ENV_MAX_FRAMES, DEFAULT_MAX_FRAMES)
            if max_frames is None
            else int(max_frames)
        )
        self.session_ttl_s = (
            _env_float(ENV_SESSION_TTL_S, DEFAULT_SESSION_TTL_S)
            if session_ttl_s is None
            else float(session_ttl_s)
        )
        # the serving throughput layer: request coalescing
        # over a warm program pool, and the SLO-aware admission policy
        # consulted BEFORE the gate (fair-share row budgets + proactive
        # tail shedding).  Knobs come from the env unless constructor
        # overrides are passed (like every other bridge knob).
        self.coalescer = _coalescer.Coalescer(
            engine=engine,
            wait_us=coalesce_us,
            max_rows=coalesce_rows,
            warm=_coalescer.WarmPool(
                _coalescer.WarmSpec.from_env(warm_spec)
                if warm_spec is not None
                else None,
                device=device,
            ),
            register_scope=self._register_scope,
            unregister_scope=self._unregister_scope,
        )
        self.scheduler = _coalescer.SloScheduler(
            fair_rows=fair_rows, window_s=fair_window_s, slo_ms=slo_ms
        )
        # paged continuous decode: a server given a model
        # (``decode_model={"params": ..., "cfg": ..., [draft_params,
        # draft_cfg, max_slots, tokens_per_page, max_seq, pool_pages]}``)
        # serves the gated ``decode`` RPC through a DecodeScheduler
        # whose slots hold page tables into one shared PagePool; no
        # model configured = the method refuses with a typed error
        self.decode_scheduler = None
        if decode_model is not None:
            dm = dict(decode_model)
            self.decode_scheduler = _coalescer.DecodeScheduler(
                dm.pop("params"), dm.pop("cfg"), **dm
            )
        # stable replica identity: pid + a start-time epoch token.  The
        # NAME is stable across restarts (a fleet spawner pins it via
        # TFS_FLEET_REPLICA); the EPOCH changes every start,
        # which is how a router tells "same replica recovered" from
        # "replica restarted" without guessing from connection resets.
        self._started_mono = time.monotonic()
        self._replica_name = _env_raw(ENV_FLEET_REPLICA, "")
        self._replica_epoch = f"{os.getpid():x}-{uuid.uuid4().hex[:12]}"
        self._sessions: Dict[str, _Session] = {}
        self._sessions_lock = threading.Lock()
        # per-request attribution history: ledger snapshots
        # keyed by correlation id, bounded LRU-by-arrival
        self._attribution: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self._attribution_lock = threading.Lock()
        self._scopes: set = set()
        self._scopes_lock = threading.Lock()
        self._closed = False
        # periodic reaper: attach/detach/health also reap
        # opportunistically, but only a timer guarantees an idle host
        # (no further connections, no health polls) releases a crashed
        # client's frames once their session passes the TTL
        self._reaper_stop = threading.Event()
        if self.session_ttl_s > 0:
            t = threading.Thread(
                target=self._reap_loop, name="tfs-bridge-reaper", daemon=True
            )
            t.start()
        # fleet registry heartbeat: one atomic JSON file per replica
        # whose mtime is the liveness signal the janitor and peers trust
        # ACROSS processes (a same-host ``os.kill(pid, 0)`` cannot see
        # into another container or pid namespace).  No registry
        # configured (TFS_FLEET_REGISTRY unset) = no-op.
        self._registry_dir = _fleet.registry_dir()
        if self._registry_dir:
            self._registry_beat()
            threading.Thread(
                target=self._registry_loop,
                name="tfs-fleet-heartbeat",
                daemon=True,
            ).start()
        # metrics exposition: the admission gauges register as
        # providers so the standalone TFS_METRICS_PORT endpoint (started
        # here from the env when set) scrapes them alongside the process
        # counters/histograms; close() unregisters exactly these
        # closures, so a replacement server's providers survive
        # ONE grouped provider, not three: the gauges come from a single
        # gate.snapshot() per scrape, so inflight/queued/draining are
        # mutually consistent (three independent lambdas could read
        # three different gate states mid-load).  No shed gauge: the
        # process-wide ``bridge_shed`` counter already exposes sheds as
        # tfs_bridge_shed_total — a same-named gauge would emit a
        # duplicate TYPE family.
        self._gauge_providers = {
            "tfs_bridge_admission": self._admission_gauges,
            # coalescer queue depth / open programs / warm-pool
            # residency — ONE grouped provider
            # (one snapshot per scrape, no counter-name collisions)
            "tfs_bridge_coalescer": self.coalescer.gauges,
        }
        if self.decode_scheduler is not None:
            # the tfs_kv_pages gauge family (pool occupancy +
            # slot population) — grouped, one snapshot per scrape
            self._gauge_providers["tfs_kv_pages"] = (
                self.decode_scheduler.gauges
            )
        for name, fn in self._gauge_providers.items():
            observability.register_gauge(name, fn)
        observability.maybe_start_metrics_server()
        # durable-execution startup recovery: a restarted
        # server inherits the journal's view of the world — reclaim
        # dead processes' spill/journal leftovers (the orphan janitor)
        # and inventory the interrupted jobs a reattaching client can
        # resume (surfaced via health + the job_status RPC).  Never
        # blocks or fails server start.
        self._journal_recovery: Dict[str, Any] = {"configured": False}
        try:
            from .. import recovery as _recovery

            if _recovery.configured():
                arts = _recovery.janitor.scan()
                reclaimed = _recovery.janitor.reclaim(artifacts=arts)
                interrupted = sorted(
                    _recovery.janitor.summary(arts)["interrupted_jobs"]
                )
                self._journal_recovery = {
                    "configured": True,
                    "interrupted_jobs": interrupted,
                    "reclaimed_count": reclaimed["count"],
                    "reclaimed_bytes": reclaimed["bytes"],
                }
                if interrupted:
                    logger.info(
                        "bridge: journal holds %d resumable job(s) "
                        "from dead processes: %s",
                        len(interrupted),
                        interrupted,
                    )
        except Exception:  # noqa: BLE001 — recovery must not block start
            logger.warning(
                "bridge: journal startup recovery failed", exc_info=True
            )

    def _registry_name(self) -> str:
        return self._replica_name or f"pid{os.getpid()}"

    def _registry_beat(self) -> None:
        try:
            _fleet.registry_write(
                self._registry_name(),
                self.address[0],
                self.address[1],
                epoch=self._replica_epoch,
                root=self._registry_dir,
            )
        except OSError:
            logger.warning(
                "bridge: fleet-registry heartbeat failed", exc_info=True
            )

    def _registry_loop(self) -> None:
        # 3 beats per TTL: one missed write (busy box, slow fs) never
        # reads as death
        interval = max(0.5, _fleet.REGISTRY_TTL_S / 3.0)
        while not self._reaper_stop.wait(interval):
            self._registry_beat()

    def _admission_gauges(self) -> Dict[str, Any]:
        s = self.gate.snapshot()
        return {
            "tfs_bridge_inflight": s["inflight"],
            "tfs_bridge_queued": s["queued"],
            "tfs_bridge_draining": int(s["draining"]),
        }

    @property
    def address(self):
        return self.server_address

    # -- session registry ----------------------------------------------------

    def _attach(self, token: Optional[str]) -> _Session:
        now = time.monotonic()
        with self._sessions_lock:
            self._reap_locked(now)
            if token is not None:
                sess = self._sessions.get(token)
                if sess is None:
                    raise BridgeServerError(
                        f"unknown or expired session {token!r} (frames do "
                        f"not survive a session's TTL; create a new one)",
                        code="unknown_session",
                    )
                sess.refs += 1
                sess.last_active = now
                return sess
            tok = uuid.uuid4().hex
            sess = _Session(
                engine=self.engine,
                token=tok,
                max_frames=self.max_frames,
                device=self.device,
            )
            sess.explicit = True
            sess.refs = 1
            self._sessions[tok] = sess
            return sess

    def _detach(self, sess: _Session) -> None:
        now = time.monotonic()
        with self._sessions_lock:
            sess.refs -= 1
            sess.last_active = now
            if sess.refs <= 0 and not sess.explicit:
                self._sessions.pop(sess.token, None)
            # reap on every disconnect too (not just new attaches), so a
            # host whose clients all left does not retain their frames
            # past the TTL waiting for a connection that never comes
            self._reap_locked(now)

    def _drop_session(self, sess: _Session) -> None:
        with self._sessions_lock:
            self._sessions.pop(sess.token, None)
            sess.frames.clear()

    def _reap_loop(self) -> None:
        interval = max(1.0, min(self.session_ttl_s / 2.0, 60.0))
        while not self._reaper_stop.wait(interval):
            with self._sessions_lock:
                self._reap_locked(time.monotonic())

    def _reap_locked(self, now: float) -> None:
        if self.session_ttl_s <= 0:
            return
        dead = [
            tok
            for tok, s in self._sessions.items()
            if s.refs <= 0 and now - s.last_active > self.session_ttl_s
        ]
        for tok in dead:
            s = self._sessions.pop(tok)
            logger.info(
                "bridge: reaped idle session %s (%d frames)",
                tok[:8],
                len(s.frames),
            )

    # -- in-flight scope registry (drain cancellation) -----------------------

    def _register_scope(self, scope: cancellation.CancelScope) -> None:
        with self._scopes_lock:
            self._scopes.add(scope)

    def _unregister_scope(self, scope: cancellation.CancelScope) -> None:
        with self._scopes_lock:
            self._scopes.discard(scope)

    # -- serving throughput layer --------------------------------------------

    # methods whose rows bill the tenant's fair-share window: the
    # compute/data-moving verbs.  Metadata ops (create_frame, analyze,
    # warm) are not usage — billing them would charge a tenant for
    # DESCRIBING work it never ran.
    _BILLED_METHODS = frozenset(
        {
            "map_blocks",
            "map_rows",
            "aggregate",
            "reduce_blocks",
            "reduce_rows",
            "collect",
            # decode bills GENERATED TOKENS (not frame rows)
            # to the tenant's fair-share window — the billing happens in
            # run_decode once the count is known; membership here puts
            # decode under the SLO scheduler's shed policy like every
            # other compute verb
            "decode",
        }
    )

    def _note_usage(self, sess: _Session, method: str, params) -> None:
        """Bill an executed gated request's rows to its tenant's
        fair-share window (frame-addressed compute verbs only; the rows
        are the INPUT frame's — the work the request put on the
        machine)."""
        if not self.scheduler.enabled():
            return
        if method not in self._BILLED_METHODS:
            return
        fid = params.get("frame_id") if isinstance(params, dict) else None
        if fid is None:
            return
        frame = sess.frames.get(fid)
        if frame is None:
            return
        led = observability.current_request()
        self.scheduler.note(
            led.tenant if led is not None else None, frame.num_rows
        )

    def warm_program(
        self,
        graph=None,
        fetches=None,
        inputs=None,
        shapes=None,
        verb: str = "map_rows",
        trim: bool = False,
        columns=None,
        rows=None,
    ) -> Dict[str, Any]:
        """The gated ``warm`` RPC: register the program in the warm pool
        and prime its ``(bucket, device)`` grid via ``Executor.warmup``
        (with ``TFS_COMPILE_CACHE`` the kernel libraries load from disk),
        so the first real request pays neither the GraphDef import nor a
        kernel build.

        ``columns`` maps column name -> a small sample array (>= 0 rows;
        only dtype + cell shape are read); ``rows`` lists the block row
        counts to prime (default: the ``TFS_BRIDGE_WARM`` spec's
        ``buckets``)."""
        if verb not in ("map_rows", "map_blocks"):
            raise BridgeServerError(
                f"warm supports the map verbs, not {verb!r}",
                code="bad_request",
            )
        if not columns:
            raise BridgeServerError(
                "warm needs columns={name: sample array} to learn the "
                "schema it should prime",
                code="bad_request",
            )
        sizes = [int(r) for r in (rows or []) if int(r) > 0]
        if not sizes:
            sizes = [
                b for b in self.coalescer.warm.spec.buckets if b > 0
            ]
        if not sizes:
            raise BridgeServerError(
                f"warm needs rows=[...] (or buckets in {_coalescer.ENV_WARM})",
                code="bad_request",
            )
        _, ent, hit = self.coalescer.warm.entry(
            verb, graph, fetches, inputs, shapes, trim
        )
        ex = _engine_mod._resolve(self.engine)
        n_lanes = (
            len(device_pool.pool_devices())
            if device_pool.enabled()
            else 1
        )
        fps = []
        for r in sizes:
            cols = {}
            for name, sample in columns.items():
                arr = np.asarray(sample)
                cols[name] = np.zeros(
                    (r * max(1, n_lanes),) + arr.shape[1:], arr.dtype
                )
            frame = TensorFrame.from_arrays(
                cols, num_blocks=max(1, n_lanes)
            )
            fps.extend(
                ex.warmup(
                    ent.program, frame, rows_level=(verb == "map_rows")
                )
            )
            # Executor.warmup primes the (bucket, device) grid; one real
            # execution over zeros also seeds what the verb's own path
            # touches (the host staging, the allocator) — programs are
            # pure by contract, so a zeros dispatch has no effect beyond
            # the caches, and trace counting is suppressed (warmup is
            # analysis, not traffic)
            with observability.suppress_trace_count():
                warm_frame = TensorFrame.from_arrays(
                    {
                        name: np.zeros(
                            (r,) + np.asarray(s).shape[1:],
                            np.asarray(s).dtype,
                        )
                        for name, s in columns.items()
                    },
                    num_blocks=1,
                )
                if verb == "map_rows":
                    ex.map_rows(ent.program, warm_frame)
                else:
                    ex.map_blocks(ent.program, warm_frame, trim=trim)
        return {
            "primed_rows": sizes,
            "buckets": sorted(
                {bucketing.bucket_for(r) for r in sizes}
            ),
            "executables": len(set(fps)),
            "devices": max(1, n_lanes),
            "warm_hit": hit,
            "resident": len(self.coalescer.warm),
        }

    def run_decode(
        self,
        prompt=None,
        max_new: int = 16,
        speculative: bool = False,
        gamma: int = 4,
        stop_token: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The gated ``decode`` RPC: stream ``max_new``
        greedy tokens continuing ``prompt`` through the paged decode
        scheduler.  The request joins the running slot batch at the
        next step boundary; its cancel scope (deadline/cancel/drain) is
        honoured at step boundaries, where retirement frees the
        sequence's KV pages.  ``speculative=True`` opts this request
        into the draft/verify path (needs a draft model configured;
        runs solo — B=1 by its contract — and is verified bit-exactly
        by the target model).  Generated tokens bill the tenant's
        fair-share window; page-pool/slot exhaustion surfaces as
        ``server_busy`` with ``retry_after_ms``."""
        sched = self.decode_scheduler
        if sched is None:
            raise BridgeServerError(
                "this server has no decode model configured "
                "(BridgeServer(decode_model={'params': ..., 'cfg': ...}))",
                code="decode_unavailable",
            )
        prompt = np.asarray(prompt if prompt is not None else [], np.int64)
        if prompt.ndim != 1 or prompt.size < 1:
            raise BridgeServerError(
                "decode needs prompt=[t0, t1, ...] (a non-empty 1-D "
                "token list)",
                code="bad_request",
            )
        led = observability.current_request()
        tenant = led.tenant if led is not None else None
        until = (
            (lambda t, s=int(stop_token): t == s)
            if stop_token is not None
            else None
        )
        try:
            if speculative:
                toks = sched.speculative(
                    prompt, int(max_new), gamma=int(gamma), tenant=tenant
                )
                if until is not None:
                    for i, t in enumerate(toks):
                        if until(t):
                            toks = toks[: i + 1]
                            break
            else:
                toks = sched.submit(
                    prompt, int(max_new), until=until, tenant=tenant
                )
        except _coalescer.DecodeRefused as e:
            raise ServerBusy(
                str(e),
                retry_after_ms=e.retry_after_ms,
                reason=e.reason,
            ) from e
        # tokens are the work decode put on the machine — the billing
        # unit for its fair-share window (frame verbs bill rows)
        if self.scheduler.enabled():
            self.scheduler.note(tenant, len(toks))
        return {
            "tokens": [int(t) for t in toks],
            "generated": len(toks),
            "speculative": bool(speculative),
        }

    # -- health --------------------------------------------------------------

    def replica_identity(self) -> Dict[str, Any]:
        """Stable replica identity: fleet-assigned name
        (stable across restarts; '' outside a fleet), pid, start-time
        EPOCH token (new every start — a router seeing a new epoch
        under an old name knows the replica RESTARTED rather than
        recovered, without guessing from connection resets), uptime."""
        return {
            "name": self._replica_name,
            "pid": os.getpid(),
            "epoch": self._replica_epoch,
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
        }

    def health_snapshot(self) -> Dict[str, Any]:
        """The ``health`` RPC body: admission depth, drain state,
        session/frame counts, device-quarantine history, and device-memory
        budget occupancy — enough for a client-side balancer to
        route around a sick or saturated server."""
        gate = self.gate.snapshot()
        with self._sessions_lock:
            # health polls double as the idle-host reaper tick
            self._reap_locked(time.monotonic())
            n_sessions = len(self._sessions)
            n_frames = sum(len(s.frames) for s in self._sessions.values())
        c = observability.counters()
        return {
            "status": "draining" if gate["draining"] else "ok",
            **gate,
            # who answered — a fleet router keys flap/restart detection
            # off the epoch token in here
            "replica": self.replica_identity(),
            "sessions": n_sessions,
            "frames": n_frames,
            "quarantined_devices": device_pool.recently_quarantined(),
            "hbm": {
                "budget_bytes": frame_cache.hbm_budget(),
                "resident_bytes": frame_cache.budget_bytes_resident(),
            },
            # coalescer + SLO-scheduler state (queue depth per
            # program, batch-size histogram, warm-pool residency,
            # per-tenant window usage) for serving dashboards/balancers
            "coalescer": self.coalescer.snapshot(),
            "scheduler": self.scheduler.snapshot(),
            # paged-decode population + page-pool occupancy
            # (None when no decode model is configured)
            "decode": (
                self.decode_scheduler.snapshot()
                if self.decode_scheduler is not None
                else None
            ),
            # what the startup janitor found — whether a
            # journal is configured, the resumable jobs dead processes
            # left, and the stale bytes reclaimed at start
            "journal": self._journal_recovery,
            "counters": {
                k: c[k]
                for k in (
                    "bridge_deadline_exceeded",
                    "bridge_shed",
                    "bridge_cancels",
                    "bridge_idem_hits",
                    "bridge_verbs_executed",
                    "devices_quarantined",
                    "coalesced_batches",
                    "coalesced_requests",
                    "coalesce_solo_requests",
                    "warm_program_hits",
                    "fair_share_sheds",
                    "slo_sheds",
                    # the fleet acceptance evidence — journal
                    # exactly-once accounting, the compile cache's
                    # hits and misses and the port's one compile (an
                    # nvcc run: the zero-recompile proof on warm
                    # rejoin), and the fleet lifecycle counters
                    "stream_windows",
                    "journal_appends",
                    "journal_windows_skipped",
                    "journal_resumes",
                    "journal_fence_rejections",
                    "backend_compiles",
                    "persistent_cache_hits",
                    "persistent_cache_misses",
                    "fleet_failovers",
                    "fleet_jobs_migrated",
                    "fleet_quarantines",
                    "fleet_replica_restarts",
                    # paged-decode acceptance evidence —
                    # tokens served, page churn, prefill batching
                    "decode_tokens",
                    "kv_pages_allocated",
                    "kv_pages_freed",
                    "decode_prefill_batches",
                )
            },
            # the gauge snapshot serving operators need
            # without scraping the metrics endpoint — host-byte
            # high-water and flight-recorder depth/drop state
            "gauges": {
                "live_host_bytes": observability.live_host_bytes(),
                "peak_host_bytes": c["peak_host_bytes"],
                "trace_enabled": observability.trace_enabled(),
                "trace_events": observability.trace_depth(),
                "trace_drops": observability.trace_drops(),
            },
        }

    def metrics_text(self) -> str:
        """The ``metrics`` RPC body: the process-wide Prometheus text
        (counters, gauges, verb + bridge latency histograms) with THIS
        server's admission gauges merged in — a multi-server process's
        RPC always reflects the server that answered it."""
        return observability.metrics_text(
            extra_gauges=self._admission_gauges()
        )

    # -- per-request attribution ---------------------------------------------

    def _record_attribution(self, ledger) -> None:
        """Retain one finished request ledger's snapshot for the
        ``attribution`` RPC (bounded history).  A retry served from the
        idempotency dedup cache arrives under the SAME correlation id
        as its original execution (the client keeps the cid stable
        across reconnects, like the idem token) with a near-empty
        ledger — it must never REPLACE the original's attribution, so a
        non-executing snapshot yields to an existing executed one."""
        snap = ledger.snapshot()
        cid = ledger.correlation_id
        with self._attribution_lock:
            old = self._attribution.get(cid)
            if (
                old is not None
                and old["counters"].get("bridge_verbs_executed")
                and not snap["counters"].get("bridge_verbs_executed")
            ):
                self._attribution.move_to_end(cid)
                return
            self._attribution[cid] = snap
            self._attribution.move_to_end(cid)
            while len(self._attribution) > _ATTRIBUTION_CAP:
                self._attribution.popitem(last=False)

    def attribution_snapshot(
        self, correlation_id: Optional[str] = None
    ) -> Dict[str, Any]:
        """The ``attribution`` RPC body: one request's ledger (by
        correlation id) or the recent-request history, newest last —
        counters-delta resource usage, blocks/rows per device, per-verb
        latency, and wall time, each stamped with its correlation id and
        tenant."""
        with self._attribution_lock:
            if correlation_id is not None:
                snap = self._attribution.get(correlation_id)
                return {
                    "found": snap is not None,
                    "ledger": snap,
                    "retained": len(self._attribution),
                }
            recent = list(self._attribution.values())[-_ATTRIBUTION_RECENT:]
            return {"recent": recent, "retained": len(self._attribution)}

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain_s: Optional[float] = None) -> None:
        """Graceful drain, then stop serving and release the socket.

        Phases: (1) reject new admissions with ``draining``; (2) wait up
        to ``drain_s`` (default ``TFS_BRIDGE_DRAIN_S``) for in-flight
        gated requests to finish; (3) cooperatively cancel stragglers
        through their cancel scopes (they surface a structured
        ``cancelled`` error at their next block boundary) and give them
        a short grace period; (4) shutdown + server_close."""
        if self._closed:
            return
        self._closed = True
        self._reaper_stop.set()
        if self._registry_dir:
            # leave no heartbeat behind: a cleanly-closed replica's pid
            # must not pin journal artifacts against the janitor
            _fleet.registry_remove(
                self._registry_name(), root=self._registry_dir
            )
        for name, fn in self._gauge_providers.items():
            observability.unregister_gauge(name, fn)
        budget = self.drain_s if drain_s is None else float(drain_s)
        self.gate.start_draining()
        if not self.gate.wait_idle(budget):
            with self._scopes_lock:
                stragglers = list(self._scopes)
            logger.warning(
                "bridge: drain window (%.1fs) expired with %d request(s) "
                "in flight; cancelling cooperatively",
                budget,
                len(stragglers),
            )
            for scope in stragglers:
                scope.cancel("server draining")
            # short FIXED grace: cancellation lands at the next block
            # boundary, which does not scale with the drain budget —
            # close() is bounded by budget + 1s, not 2x budget
            self.gate.wait_idle(1.0)
        if self.decode_scheduler is not None:
            # after the gate drained/cancelled: in-flight decode
            # requests' scopes were cancelled above, so the driver
            # retires them (freeing their pages) at its next boundary
            self.decode_scheduler.close()
        self.shutdown()
        self.server_close()


def serve(
    host: str = "127.0.0.1",
    port: int = 0,
    engine=None,
    background: bool = True,
    allow_remote: bool = False,
    device: DeviceLike = None,
    **server_kw,
) -> BridgeServer:
    """Start a bridge server on ``device`` (None = the CUDA card);
    ``background=True`` runs it on a daemon thread and returns
    immediately (``server.address`` has the bound port).  ``server_kw``
    forwards the resilience knobs (``max_inflight``, ``queue_depth``,
    ``drain_s``, ``max_frames``, ``session_ttl_s``), the serving knobs
    (``coalesce_us``, ``coalesce_rows``, ``warm_spec``, ``fair_rows``,
    ``fair_window_s``, ``slo_ms``), and the paged-decode model
    (``decode_model``) past their env defaults."""
    server = BridgeServer(
        host, port, engine=engine, allow_remote=allow_remote, device=device,
        **server_kw,
    )
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    else:
        server.serve_forever()
    return server
