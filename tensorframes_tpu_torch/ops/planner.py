"""The lazy verb-graph planner: fuse, prune, share, auto-cache (``TFS_PLAN``).

PyTorch counterpart of ``tensorframes_tpu/ops/planner.py``, with its
surface, knob grammar, decision records, reasons and ``explain`` layout.

``frame.lazy()`` (or ``TFS_PLAN=1`` for the module-level verbs) switches a
frame into *planned* mode: map verbs append :class:`PlanStep` s to a
logical plan instead of dispatching, and the plan is optimized and
executed on first materialisation (``collect``/``to_arrays``/..., a reduce
verb, or ``aggregate``).  The optimizer:

* **fuses** maximal runs of adjacent map stages into ONE chained
  dispatch: each block is staged once (pruned), and the stages run back to
  back on the block's device, each through its own call, every
  intermediate left on the device.  Deliberately not one traced graph (no
  ``torch.compile``): a fused graph would round differently from the
  eager per-verb calls, and per-stage calls make the bit-identity of
  planned and eager verbs structural;
* **prunes dead columns before staging**: the chain stages exactly the
  source columns some stage reads; the others ride into a non-trimmed
  output as untouched host passthroughs;
* **folds a terminal reduce** (``reduce_rows``/``reduce_blocks``) into the
  chain: each block's partial is computed by the engine's own
  ``_reduce_*_setup`` call on the block's device, and the engine's
  ``_combine_partials`` finishes, the eager verbs' fold shape; a terminal
  ``aggregate`` (:class:`LazyGroupedFrame`) fetches only the key and
  reduced columns, then runs the unchanged eager aggregate;
* **shares identical subplans across plans** (``_PlanRegistry``): the
  same source frame, step programs at the same ``_params_version`` and
  the same terminal run once; concurrent requests rendezvous, the owner
  runs under a private root ledger and every consumer absorbs an exact
  integer share (``RequestLedger.absorb``);
* **auto-inserts a cache** when a subplan has two or more consumers, and
  adopts pooled chain outputs as the result's shards
  (``frame_cache.adopt``); a ``weakref.finalize`` refunds
  ``TFS_HBM_BUDGET`` when the planned frame is collected;
* **chooses pool vs fused-serial per group** (``_choose_dispatch``), with
  JAX's record keys, decisions and reasons, in JAX's order: affinity,
  pool availability, chunked streaming, calibration, warm state, then
  intensity.

Two JAX notions have port counterparts:

* **warm** (``_chain_warm``): JAX means "the stage's jit entry exists".
  Here it means "this ``Program``'s block (or row) entry has been
  dispatched once", by the eager verbs, by ``warmup`` or by a plan
  (``Program.note_entry``).  The same sequence of calls yields JAX's
  decisions.
* **intensity** (``_fused_intensity``): JAX reads the XLA cost model.  The
  port takes FLOPs and bytes from its own roofline walk on fake tensors
  (``roofline.cost``: ``make_fx`` and the ATen walk), at the largest
  bucketed block signature, memoized per chain and signature.  It never
  raises: a failure gives ``None`` and the reason ``no_cost_model``.  The
  walk counts unfused eager bytes, so intensities near the threshold may
  decide differently from JAX's (ROADMAP.md Queue 3).

Where the port goes past JAX, on purpose (ROADMAP.md Queue 3):

* on the **serial** decision a terminal reduce folds each block's partial
  inside the serial chain dispatch (``_run_serial_fold``), on the chain's
  device, where JAX materializes the chain and reduces it eagerly; the
  calls and the fold shape are the same, so the bytes are;
* on ONE card, where no pool resolves, the auto-cache is a one-device
  ``FrameCache`` on that card (JAX needs two shard devices): a loop over a
  planned frame stages its entry columns once and later passes read them
  in place.  It is charged to ``TFS_HBM_BUDGET`` and refunded at
  collection like any planner cache.

Knobs: ``TFS_PLAN`` (``1``/``true`` routes the module-level verbs through
the planner for plain frames), ``TFS_PLAN_POOL_MIN_INTENSITY`` (flops/byte
below which a COLD fused group prefers the serial dispatch, default
``1.0``), ``TFS_PLAN_CSE`` (cross-plan sharing, default on, ``0``
disables), ``TFS_PLAN_CALIBRATE`` (measured rows/s feed back into the
decision, default off; with ``TFS_COMPILE_CACHE`` the table persists as
``<dir>/tfs-calibration-v1.json``).

The streamed map chains (``streaming/verbs.py``, ``MappedStream``) run each
window through :func:`run_window_chain` under ``TFS_PLAN``; a block past
the engine's chunked-streaming threshold (``TFS_STREAM_CHUNK_BYTES``) keeps
the serial per-stage dispatch (``stream_chunked_blocks``); and
``iterate_epochs(job_id=...)`` journals each epoch's result through
``recovery/``.
"""

from __future__ import annotations

import collections
import functools
import logging
import threading
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import analysis, cancellation, dtypes, envutil, observability
from .. import roofline as _roofline
from ..frame import TensorFrame
from ..program import Program
from ..schema import ColumnInfo, Schema
from . import (
    bucketing,
    device_pool,
    engine,
    fault_tolerance,
    frame_cache,
    prefetch,
)
from .engine import Executor, GroupedFrame, _check_shape_hints, _host
from .pipeline import analyzed_outputs
from .validation import ValidationError

_log = logging.getLogger("tensorframes_tpu_torch.planner")

ENV_PLAN = "TFS_PLAN"
ENV_POOL_INTENSITY = "TFS_PLAN_POOL_MIN_INTENSITY"
ENV_CSE = "TFS_PLAN_CSE"
ENV_CALIBRATE = "TFS_PLAN_CALIBRATE"
_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")

# device types a one-device auto-cache may use when no pool resolves: the
# card (a "cache" on the host itself would only copy host memory)
_ONE_DEVICE_CACHE_TYPES: Tuple[str, ...] = ("cuda",)


def planning_enabled() -> bool:
    """Whether ``TFS_PLAN`` routes the module-level verbs through the
    planner for plain frames (read per call)."""
    return envutil.env_raw(ENV_PLAN).lower() in _TRUTHY


def cse_enabled() -> bool:
    """Cross-plan sharing (``TFS_PLAN_CSE``): on unless ``0``."""
    return envutil.env_raw(ENV_CSE).lower() not in _FALSY


def calibrate_enabled() -> bool:
    """Measured-throughput feedback (``TFS_PLAN_CALIBRATE``, default off)."""
    return envutil.env_raw(ENV_CALIBRATE).lower() in _TRUTHY


def pool_min_intensity() -> float:
    raw = envutil.env_raw(ENV_POOL_INTENSITY)
    if not raw:
        return 1.0
    try:
        return float(raw)
    except ValueError:
        return 1.0


class _SerialExecutor(Executor):
    """The fused-serial dispatch target: the default engine with the
    device pool opted out, so no dispatch-loop code forks."""

    supports_device_pool = False


_DEFAULT = engine._DEFAULT
_SERIAL = _SerialExecutor()


# ---------------------------------------------------------------------------
# plan steps + fusion metadata
# ---------------------------------------------------------------------------


class PlanStep:
    """One recorded map verb (reduce/aggregate are materialisation points,
    not steps)."""

    __slots__ = ("kind", "program", "trim", "host_stage")

    def __init__(
        self,
        kind: str,
        program: Program,
        trim: bool = False,
        host_stage: Optional[Mapping[str, Any]] = None,
    ):
        self.kind = kind  # "map_blocks" | "map_rows"
        self.program = program
        self.trim = trim
        self.host_stage = host_stage

    @property
    def label(self) -> str:
        if self.kind == "map_blocks" and self.trim:
            return "map_blocks_trimmed"
        return self.kind

    @property
    def stage_bound(self) -> bool:
        """Whether this step must run eagerly because it carries host
        preprocessing (``host_stage`` or an importer ``host_prelude``)."""
        return bool(self.host_stage) or bool(getattr(self.program, "host_prelude", None))


def _device_infos(frame: TensorFrame) -> Dict[str, ColumnInfo]:
    """Device-feedable uniform columns of a concrete frame: the columns a
    fused chain may consume."""
    return {
        c.info.name: c.info
        for c in frame.columns
        if c.info.scalar_type.device_ok and not c.is_ragged
    }


# per-stage shape inference runs the program on meta tensors (~ms); an
# epochs loop rebuilding one chain would pay it per stage per epoch
_ANALYSIS_CACHE: "collections.OrderedDict[Any, Tuple[Any, Dict]]" = collections.OrderedDict()
_ANALYSIS_CACHE_CAP = 256


def _analyzed_outputs_cached(
    program: Program, infos: Mapping[str, ColumnInfo], cell: bool
) -> Dict[str, ColumnInfo]:
    key = (
        id(program),
        cell,
        tuple(sorted((n, ci.scalar_type.name, tuple(ci.block_shape)) for n, ci in infos.items())),
    )
    hit = _ANALYSIS_CACHE.get(key)
    if hit is not None:
        ref, outs = hit
        if ref() is program:
            _ANALYSIS_CACHE.move_to_end(key)
            return outs
        del _ANALYSIS_CACHE[key]
    outs = analyzed_outputs(program, infos, cell=cell, verb="plan")
    _ANALYSIS_CACHE[key] = (weakref.ref(program), outs)
    while len(_ANALYSIS_CACHE) > _ANALYSIS_CACHE_CAP:
        _ANALYSIS_CACHE.popitem(last=False)
    return outs


def _fusable_run(
    steps: Sequence[PlanStep], visible: Dict[str, ColumnInfo]
) -> Tuple[int, Optional[str], Dict[str, ColumnInfo]]:
    """Length of the maximal fusable prefix of ``steps`` given the
    ``visible`` device-feedable columns at entry, the reason the run
    stopped (None when it covered every step), and the visible columns
    after the prefix.  A step fuses when it has no host stage, every input
    resolves to a visible column, and shape inference succeeds."""
    visible = dict(visible)
    n = 0
    why = None
    for st in steps:
        if st.stage_bound:
            why = "host_stage"
            break
        infos: Dict[str, ColumnInfo] = {}
        bad = None
        for name in st.program.input_names:
            col = st.program.column_for_input(name)
            ci = visible.get(col)
            if ci is None:
                bad = col
                break
            infos[name] = ci
        if bad is not None:
            why = f"column {bad!r} is host-only/ragged or absent"
            break
        try:
            outs = _analyzed_outputs_cached(st.program, infos, cell=st.kind == "map_rows")
        except Exception as e:  # noqa: BLE001 - analysis failure: run eagerly
            why = f"shape inference failed ({type(e).__name__})"
            break
        if st.trim:
            visible = dict(outs)
        else:
            visible.update(outs)
        n += 1
    return n, why, visible


class _FusedMeta:
    """One fused group's facts: the staged entry columns (pruned), final
    fetches, per-stage bucket-proof specs, per-stage liveness (columns
    still needed after each stage: the frees between stages), the inferred
    output infos, and the memoized intensity and calibration
    fingerprints."""

    __slots__ = (
        "fetches", "src_inputs", "pruned", "trim", "steps", "stage_specs",
        "stage_infos", "final_infos", "live_after", "_intensity", "_calib_fps",
    )


# fusion metadata is cached process-wide, keyed by program ids with
# weakrefs, so a rebuilt chain over the same programs skips re-analysis
_FUSED_CACHE: "collections.OrderedDict[Any, Tuple[Any, _FusedMeta]]" = collections.OrderedDict()
_FUSED_CACHE_CAP = 64


def _entry_signature(frame: TensorFrame) -> Tuple:
    sig = []
    for c in frame.columns:
        if c.info.scalar_type.device_ok and not c.is_ragged:
            sig.append((c.info.name, tuple(c.data.shape[1:]), c.info.scalar_type.name))
    return tuple(sorted(sig))


def _compose(
    steps: Sequence[PlanStep],
    frame: TensorFrame,
    keep: Optional[Set[str]] = None,
) -> _FusedMeta:
    """Analyse ``steps`` as one fused chain over ``frame``'s entry columns
    (cached).  ``keep``: restrict the fetches to the derived columns a
    terminal consumer reads, so liveness frees every other intermediate
    and nothing unread is read back."""
    key = (
        tuple((st.kind, id(st.program), st.trim) for st in steps),
        _entry_signature(frame),
        None if keep is None else tuple(sorted(keep)),
    )
    hit = _FUSED_CACHE.get(key)
    if hit is not None:
        refs, meta = hit
        if all(r() is st.program for r, st in zip(refs, steps)):
            _FUSED_CACHE.move_to_end(key)
            return meta
        del _FUSED_CACHE[key]

    src_infos = _device_infos(frame)
    origin: Dict[str, str] = {n: "source" for n in src_infos}
    infos_now: Dict[str, ColumnInfo] = dict(src_infos)
    src_inputs: List[str] = []
    stage_specs: List[Optional[Dict[str, Any]]] = []
    stage_infos: List[Dict[str, ColumnInfo]] = []
    for st in steps:
        step_infos: Dict[str, ColumnInfo] = {}
        for name in st.program.input_names:
            col = st.program.column_for_input(name)
            if col not in origin:
                raise ValidationError(
                    f"plan.{st.label}: program input {name!r} requests "
                    f"column {col!r}, which is not available at this "
                    f"point in the chain. Available: {sorted(origin)}."
                )
            if origin[col] == "source" and col not in src_inputs:
                src_inputs.append(col)
            step_infos[name] = infos_now[col]
        stage_specs.append(analysis.input_specs_for(st.program, step_infos))
        stage_infos.append(dict(step_infos))
        outs = _analyzed_outputs_cached(st.program, step_infos, cell=st.kind == "map_rows")
        if st.trim:
            origin = {n: "derived" for n in outs}
            infos_now = dict(outs)
        else:
            origin.update({n: "derived" for n in outs})
            infos_now.update(outs)
    fetches = sorted(n for n, kind in origin.items() if kind == "derived")
    if keep is not None:
        fetches = [f for f in fetches if f in keep]
    if not fetches:
        raise ValidationError(
            "plan: the fused chain produces no derived outputs"
            + (" the terminal consumer reads" if keep is not None else "")
        )
    steps_t = tuple(steps)
    # liveness: columns still needed AFTER stage k (later stages' inputs +
    # the final fetches): the frees between stages
    live = set(fetches)
    live_after: List[Set[str]] = [set() for _ in steps_t]
    for k in range(len(steps_t) - 1, -1, -1):
        live_after[k] = set(live)
        live |= {steps_t[k].program.column_for_input(n) for n in steps_t[k].program.input_names}

    meta = _FusedMeta()
    meta.fetches = fetches
    meta.src_inputs = list(src_inputs)
    meta.pruned = sorted(set(src_infos) - set(src_inputs))
    meta.trim = any(st.trim for st in steps_t)
    meta.steps = steps_t
    meta.stage_specs = stage_specs
    meta.stage_infos = stage_infos
    meta.final_infos = dict(infos_now)
    meta.live_after = live_after
    meta._intensity = {}
    meta._calib_fps = {}
    refs = tuple(weakref.ref(st.program) for st in steps_t)
    _FUSED_CACHE[key] = (refs, meta)
    while len(_FUSED_CACHE) > _FUSED_CACHE_CAP:
        _FUSED_CACHE.popitem(last=False)
    return meta


def _chain_device(meta: _FusedMeta) -> torch.device:
    """The device a serial chain runs on: its first stage program's."""
    return meta.steps[0].program.device


# ---------------------------------------------------------------------------
# measured-throughput calibration (TFS_PLAN_CALIBRATE)
# ---------------------------------------------------------------------------
#
# Every plan execution measures itself (``_measured``, the substance of
# ``explain(analyze=True)``).  With the knob on, the best rows/s per
# dispatch kind is kept per chain signature, and once both kinds have been
# measured the faster one wins over the static intensity threshold.  With
# TFS_COMPILE_CACHE configured too, measurements persist under a stable
# fingerprint (no ids) in ``<dir>/tfs-calibration-v1.json``, versioned and
# atomically replaced; the live entry wins over the persisted one.

_CALIBRATION: "collections.OrderedDict[Any, Dict[str, Any]]" = collections.OrderedDict()
_CALIBRATION_CAP = 256
_CALIBRATION_LOCK = threading.Lock()

_CALIB_PERSIST_FORMAT = "tfs-calibration-v1"
_calib_persist: Optional[Dict[str, Dict[str, float]]] = None
_calib_persist_dir: Optional[str] = None


def _calib_persist_path(cache_dir: str) -> str:
    import os

    return os.path.join(cache_dir, f"{_CALIB_PERSIST_FORMAT}.json")


def _calib_persist_table() -> Optional[Dict[str, Dict[str, float]]]:
    """The persisted fingerprint table (lock held by caller), loaded
    lazily from the compile-cache dir; None when none is configured."""
    global _calib_persist, _calib_persist_dir
    from .. import compile_cache

    d = compile_cache.cache_dir()
    if not d:
        return None
    if _calib_persist is not None and _calib_persist_dir == d:
        return _calib_persist
    import json

    table: Dict[str, Dict[str, float]] = {}
    try:
        with open(_calib_persist_path(d), "rb") as f:
            doc = json.loads(f.read().decode())
        if isinstance(doc, dict) and doc.get("format") == _CALIB_PERSIST_FORMAT:
            for fp, rec in (doc.get("entries") or {}).items():
                table[str(fp)] = {
                    k: float(v) for k, v in rec.items() if k in ("pool", "serial")
                }
    except (OSError, ValueError):
        pass  # absent / torn / old format: start fresh
    _calib_persist = table
    _calib_persist_dir = d
    return table


def _calib_persist_save() -> None:
    """Atomic-replace write of the persisted table (lock held by caller)."""
    import json
    import os

    if _calib_persist is None or not _calib_persist_dir:
        return
    while len(_calib_persist) > _CALIBRATION_CAP:
        _calib_persist.pop(next(iter(_calib_persist)))
    path = _calib_persist_path(_calib_persist_dir)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(json.dumps(
                {"format": _CALIB_PERSIST_FORMAT, "entries": _calib_persist}
            ).encode())
        os.replace(tmp, path)
    except OSError:
        _log.warning("planner: calibration persistence write failed", exc_info=True)


def _calib_fingerprint(meta: _FusedMeta, frame: TensorFrame) -> str:
    """A stable, cross-process fingerprint of the calibration workload:
    everything ``_calib_key`` holds except object identity (memoized)."""
    import hashlib
    import json

    memo_key = (frame.num_rows, frame.num_blocks, _entry_signature(frame))
    hit = meta._calib_fps.get(memo_key)
    if hit is not None:
        return hit
    doc = {
        "steps": [
            {
                "kind": st.kind,
                "trim": bool(st.trim),
                "inputs": list(st.program._input_names),
                "fetches": st.program._declared_fetches or [],
                "feed": sorted(st.program._feed.items()),
            }
            for st in meta.steps
        ],
        "entry": _entry_signature(frame),
        "fetches": list(meta.fetches),
        "rows": frame.num_rows,
        "blocks": frame.num_blocks,
    }
    fp = hashlib.sha256(json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()[:24]
    if len(meta._calib_fps) < 64:
        meta._calib_fps[memo_key] = fp
    return fp


def _calib_key(meta: _FusedMeta, frame: TensorFrame) -> Tuple:
    # fetches tell a keep-pruned terminal chain from the full chain, and
    # the frame's size is part of the workload: the crossover moves with it
    return (
        tuple((st.kind, id(st.program), st.trim) for st in meta.steps),
        _entry_signature(frame),
        tuple(meta.fetches),
        frame.num_rows,
        frame.num_blocks,
    )


def _calib_entry(key: Tuple, meta: _FusedMeta) -> Optional[Dict]:
    """The live entry for a chain (lock held); weakref-guarded like the
    fusion cache, so a recycled id never aliases a dead chain's data."""
    rec = _CALIBRATION.get(key)
    if rec is None:
        return None
    if not all(r() is st.program for r, st in zip(rec["_refs"], meta.steps)):
        del _CALIBRATION[key]
        return None
    return rec


def _calib_note(meta: _FusedMeta, frame: TensorFrame, dispatch: str, rows_per_s) -> None:
    """Record one measured pool/serial execution (affinity runs and CSE
    reuses measure nothing the decision could use)."""
    if rows_per_s is None or dispatch not in ("pool", "serial"):
        return
    key = _calib_key(meta, frame)
    with _CALIBRATION_LOCK:
        rec = _calib_entry(key, meta)
        if rec is None:
            rec = _CALIBRATION[key] = {
                "_refs": tuple(weakref.ref(st.program) for st in meta.steps)
            }
        rec[dispatch] = max(rec.get(dispatch, 0.0), float(rows_per_s))
        _CALIBRATION.move_to_end(key)
        while len(_CALIBRATION) > _CALIBRATION_CAP:
            _CALIBRATION.popitem(last=False)
        persisted = _calib_persist_table()
        if persisted is not None:
            prec = persisted.setdefault(_calib_fingerprint(meta, frame), {})
            if float(rows_per_s) > prec.get(dispatch, 0.0):
                prec[dispatch] = float(rows_per_s)
                _calib_persist_save()


def _calib_lookup(meta: _FusedMeta, frame: TensorFrame) -> Optional[Dict[str, float]]:
    key = _calib_key(meta, frame)
    with _CALIBRATION_LOCK:
        rec = _calib_entry(key, meta)
        live = {k: v for k, v in rec.items() if not k.startswith("_")} if rec else {}
        persisted = _calib_persist_table()
        if persisted is not None:
            for k, v in persisted.get(_calib_fingerprint(meta, frame), {}).items():
                live.setdefault(k, float(v))
        return live or None


def reset_calibration(persisted: bool = False) -> None:
    """Clear the in-memory table; ``persisted=True`` also forgets the loaded
    fingerprint table, so the next lookup re-reads the file."""
    global _calib_persist, _calib_persist_dir
    with _CALIBRATION_LOCK:
        _CALIBRATION.clear()
        if persisted:
            _calib_persist = None
            _calib_persist_dir = None


def calibration_snapshot() -> List[Dict[str, Any]]:
    """One record per measured chain signature: the best rows/s per
    dispatch kind."""
    with _CALIBRATION_LOCK:
        return [
            {"stages": len(k[0]), **{kk: vv for kk, vv in v.items() if not kk.startswith("_")}}
            for k, v in _CALIBRATION.items()
        ]


# ---------------------------------------------------------------------------
# pool-vs-serial decision
# ---------------------------------------------------------------------------


def _composed(meta: _FusedMeta):
    """The chain as one function of its entry columns, for the roofline
    walk only: execution runs each stage's own call."""

    def chain(blk):
        for st in meta.steps:
            prog = st.program
            inputs = {n: blk[prog.column_for_input(n)] for n in prog.input_names}
            outs = prog.vmapped()(inputs) if st.kind == "map_rows" else prog.call(inputs)
            blk = dict(outs) if st.trim else {**blk, **outs}
        return {f: blk[f] for f in meta.fetches}

    return chain


def _fused_intensity(meta: _FusedMeta, frame: TensorFrame) -> Optional[float]:
    """Arithmetic intensity (flops/byte) of the fused chain at the frame's
    largest (bucketed) block signature, from the roofline walk on fake
    tensors (``roofline.cost``), memoized per signature.  None when the
    walk fails or counts no FLOPs or bytes."""
    rows = max(frame.block_sizes or [0])
    if rows <= 0:
        return None
    if bucketing.enabled():
        rows = bucketing.bucket_for(rows)
    specs = {}
    for n in meta.src_inputs:
        ci = frame.column(n).info
        specs[n] = (dtypes.coerce(ci.scalar_type).torch_dtype,
                    (rows,) + tuple(np.shape(frame.column(n).data)[1:]))
    sig = tuple(sorted((n, s, str(d)) for n, (d, s) in specs.items()))
    if sig in meta._intensity:
        return meta._intensity[sig]
    try:
        args = {n: torch.empty(s, dtype=d, device="meta") for n, (d, s) in specs.items()}
        flops, nbytes = _roofline.cost(_composed(meta), [args], device=_chain_device(meta))
        intensity = flops / nbytes if flops and nbytes else None
    except Exception:  # noqa: BLE001 - the decision degrades, never fails
        intensity = None
    meta._intensity[sig] = intensity
    return intensity


def _chain_warm(steps: Sequence[PlanStep]) -> bool:
    """Whether every stage's entry has been dispatched once (by the eager
    verbs, warmup or a plan): the port's counterpart of JAX's "the jit
    entry exists"."""
    return all(st.program.entry_warm(st.kind == "map_rows") for st in steps)


def _choose_dispatch(meta: _FusedMeta, frame: TensorFrame, warm: bool) -> Dict[str, Any]:
    """The per-group decision record: ``affinity`` (a cache is resident),
    ``pool`` (warm entries, or compute-bound per the roofline walk), or
    ``serial`` (pool unavailable, or a cold transfer-bound chain)."""
    rec: Dict[str, Any] = {"warm": bool(warm)}
    if frame_cache.active_cache(frame) is not None:
        rec.update(decision="affinity", reason="sharded_cache_resident")
        return rec
    devs = device_pool.pool_devices()
    rec["devices"] = len(devs)
    if (
        len(devs) < 2
        or frame.num_blocks < 2
        or frame.num_rows == 0
        or not engine._frame_fresh(frame)
    ):
        rec.update(decision="serial", reason="pool_unavailable")
        return rec
    # blocks past the engine's chunked-streaming threshold keep the serial
    # per-stage dispatch (bounded memory, OOM splits)
    chunk = _DEFAULT.stream_chunk_bytes
    if chunk:
        per_row = 0
        for name in meta.src_inputs:
            col = frame.column(name)
            per_row += int(np.prod(np.shape(col.data)[1:], dtype=np.int64)) * np.dtype(
                dtypes.coerce(col.info.scalar_type).host_dtype()
            ).itemsize
        if max(frame.block_sizes) * per_row >= 2 * chunk:
            rec.update(decision="serial", reason="stream_chunked_blocks")
            return rec
    if calibrate_enabled():
        measured = _calib_lookup(meta, frame)
        if measured and "pool" in measured and "serial" in measured:
            if measured["pool"] >= measured["serial"]:
                rec.update(decision="pool", reason="calibrated_pool")
            else:
                rec.update(decision="serial", reason="calibrated_serial")
            rec["calibration_rows_s"] = {k: round(v, 1) for k, v in measured.items()}
            return rec
    if warm:
        rec.update(decision="pool", reason="warm_executables")
        return rec
    intensity = _fused_intensity(meta, frame)
    rec["intensity_flops_per_byte"] = round(intensity, 4) if intensity is not None else None
    threshold = pool_min_intensity()
    rec["threshold"] = threshold
    if intensity is None or intensity >= threshold:
        rec.update(
            decision="pool",
            reason="no_cost_model" if intensity is None else "compute_bound",
        )
        return rec
    rec.update(decision="serial", reason="transfer_bound_cold")
    return rec


# ---------------------------------------------------------------------------
# fused-chain execution
# ---------------------------------------------------------------------------


class _StageCalls:
    """Each stage's call on one device (its params copied there once a
    chain run, as the pooled verbs' ``device_pool.program_on``)."""

    __slots__ = ("device", "calls")

    def __init__(self, meta: _FusedMeta, device: torch.device):
        self.device = device
        self.calls = []
        for st in meta.steps:
            prog = device_pool.program_on(st.program, device)
            self.calls.append(prog.vmapped() if st.kind == "map_rows" else prog.call)
            st.program.note_entry(st.kind == "map_rows")


def _apply_stages(meta: _FusedMeta, calls: _StageCalls, staged: Dict[str, Any]) -> Dict[str, Any]:
    """Apply the chain's stages to ONE block's staged inputs, each through
    its own call, every intermediate kept on the block's device.  Shape
    hints are checked per stage as the eager verbs check them; a buffer no
    later stage (nor the fetches) reads is dropped after each stage, so
    the allocator reuses it for the next stage's outputs."""
    blk = dict(staged)
    for k, st in enumerate(meta.steps):
        prog = st.program
        inputs = {n: blk[prog.column_for_input(n)] for n in prog.input_names}
        outs = calls.calls[k](inputs)
        del inputs
        _check_shape_hints(prog, outs, f"plan.{st.label}", cell_level=st.kind == "map_rows")
        if st.trim:
            blk = dict(outs)
        else:
            blk.update(outs)
            live = meta.live_after[k]
            blk = {c: v for c, v in blk.items() if c in live}
    return {f: blk[f] for f in meta.fetches}


def _check_chain_outputs(meta: _FusedMeta, outs: Dict[str, Any], n_rows: int) -> None:
    if not meta.trim:
        for name, v in outs.items():
            if v.ndim == 0 or v.shape[0] != n_rows:
                raise ValidationError(
                    f"plan: fused output {name!r} has shape {tuple(v.shape)} but "
                    f"the input block has {n_rows} rows; a non-trimmed "
                    f"chain must preserve the row count."
                )
    else:
        counts = {v.shape[0] if v.ndim else None for v in outs.values()}
        if len(counts) != 1 or None in counts:
            raise ValidationError(
                f"plan: trimmed chain outputs disagree on row count: "
                f"{ {k: tuple(v.shape) for k, v in outs.items()} }"
            )


def _chain_pads(meta: _FusedMeta, frame: TensorFrame) -> List[Optional[int]]:
    """Bucket targets for a fused chain (the engine's ``_bucket_plan``
    analog): each block's entry pads to its bucket when EVERY block-level
    stage passes ``analysis.rows_independent`` at the exact (real, padded)
    sizes (map_rows stages are independent by construction).  Trimmed
    chains keep exact shapes."""
    nb = frame.num_blocks
    none: List[Optional[int]] = [None] * nb
    if meta.trim or not bucketing.enabled():
        return none
    sizes = frame.block_sizes
    targets = [bucketing.bucket_for(s) if s > 0 else None for s in sizes]
    targets = [t if t is not None and t != sizes[i] else None for i, t in enumerate(targets)]
    if all(t is None for t in targets):
        return none
    proof_sizes = sorted(
        {sizes[i] for i, t in enumerate(targets) if t is not None}
        | {t for t in targets if t is not None}
    )
    for st, specs in zip(meta.steps, meta.stage_specs):
        if st.kind == "map_rows":
            continue
        if specs is None or not analysis.rows_independent(st.program, specs, proof_sizes):
            return none
    return targets


def _run_padded(meta, calls, staged, pad, n_rows) -> Dict[str, Any]:
    """The chain over one block, its entry padded to ``pad`` on the device
    and the outputs sliced back to the ``n_rows`` real rows."""
    if pad is not None:
        staged = {k: bucketing.pad_rows(v, pad) for k, v in staged.items()}
    outs = _apply_stages(meta, calls, staged)
    if pad is not None:
        outs = {k: v[:n_rows] for k, v in outs.items()}
    _check_chain_outputs(meta, outs, n_rows)
    return outs


def _entry_values(meta: _FusedMeta, frame: TensorFrame, bi: int, shard=None) -> Dict[str, tuple]:
    """Block ``bi``'s pruned entry columns as ``_stage_values`` takes them:
    name -> (value, scalar type), a resident shard's tensor in place of the
    host slice where ``shard`` has one."""
    block = frame.block(bi)
    out = {}
    for name in meta.src_inputs:
        v = (shard or {}).get(name)
        out[name] = (block[name] if v is None else v,
                     dtypes.coerce(frame.column(name).info.scalar_type))
    return out


class _TerminalReduce:
    """The fused terminal fold: the engine-built reduce (``run_for`` of
    ``_reduce_rows_setup`` / ``_reduce_blocks_setup``, the call the eager
    verbs make), the reduce program, and the base -> chain-output column
    map, applied per block inside the chain dispatch."""

    __slots__ = ("run_for", "program", "bases", "cols", "sts", "verb", "_runs")

    def __init__(self, run_for, program, bases, cols, sts, verb: str):
        self.run_for = run_for
        self.program = program
        self.bases = bases
        self.cols = cols
        self.sts = sts
        self.verb = verb
        self._runs: Dict[Any, Any] = {}

    def run_on(self, device: torch.device):
        if device not in self._runs:
            self._runs[device] = self.run_for(device_pool.program_on(self.program, device))
        return self._runs[device]


def _chain_fold(meta, terminal: _TerminalReduce, calls: _StageCalls, staged, pad, n_rows):
    """One block's chain + terminal fold, device-resident end to end.
    None for a block whose output has no rows (the eager reduce skips
    those; the fold shape must match it)."""
    outs = _run_padded(meta, calls, staged, pad, n_rows)
    first = outs[meta.fetches[0]]
    if first.ndim == 0 or first.shape[0] == 0:
        return None
    arrays = {}
    for b in terminal.bases:
        v = outs[terminal.cols[b]]
        dt = terminal.sts[b].torch_dtype
        arrays[b] = v if v.dtype == dt else v.to(dt)  # the eager staging's cast
    return terminal.run_on(calls.device)(arrays)


def _run_serial_chain(steps: Sequence[PlanStep], frame: TensorFrame) -> TensorFrame:
    """The fused-serial leg: each stage runs through the pool-opted-out
    engine, every intermediate left on the device, only the first stage's
    inputs staged.  Every engine contract (bucketing, donation, retries,
    empty frames) is the eager serial path's, because it is that path."""
    cur = frame
    for st in steps:
        if st.kind == "map_rows":
            cur = _SERIAL.map_rows(st.program, cur, host_stage=st.host_stage)
        else:
            cur = _SERIAL.map_blocks(st.program, cur, trim=st.trim, host_stage=st.host_stage)
    return cur


def _run_serial_fold(
    meta: _FusedMeta, frame: TensorFrame, terminal: _TerminalReduce
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The serial decision's terminal fold (a port extension: JAX
    materializes then reduces): blocks run in order on the chain's device,
    each staged once (prefetched when its entry is on the host), chained,
    and folded to its partial there; retries re-stage from the host.
    Returns ``(partials, record)`` for the caller's ``_combine_partials``."""
    device = _chain_device(meta)
    sizes = frame.block_sizes
    nonempty = [bi for bi in range(frame.num_blocks) if sizes[bi]]
    pads = _chain_pads(meta, frame)
    session = fault_tolerance.frame_session(frame.num_blocks, verb="plan")
    calls = _StageCalls(meta, device)

    def stage(j):
        return _DEFAULT._stage_values(_entry_values(meta, frame, nonempty[j]), device)

    fresh = not any(frame.column(n).is_device for n in meta.src_inputs)
    pf = prefetch.Prefetcher(stage, len(nonempty)) if fresh else None
    items = pf if pf is not None else (None for _ in nonempty)
    partials: List[Dict[str, Any]] = []
    track = str(device)
    with torch.no_grad():
        for j, staged in enumerate(items):
            cancellation.checkpoint()  # block boundary (serial fold)
            t_blk = observability.trace_now()
            bi = nonempty[j]

            def run(ins, _bi=bi):
                return _chain_fold(meta, terminal, calls, ins, pads[_bi], sizes[_bi])

            attempt = engine._attempt(staged, functools.partial(stage, j), run)
            del staged
            p = attempt(0, 0) if session is None else session.run(bi, sizes[bi], attempt, device=0)
            observability.note_request_block(0, sizes[bi])
            if t_blk is not None:
                observability.trace_complete(
                    f"plan+{terminal.verb} b{bi}", track, t_blk, block=bi, rows=sizes[bi]
                )
            if p is not None:
                partials.append(p)
    stage_s = pf.stats["stage_s"] if pf is not None else 0.0
    wait_s = pf.stats["wait_s"] if pf is not None else 0.0
    rec: Dict[str, Any] = {
        "prefetch": {
            "items": pf.stats["items"] if pf is not None else 0,
            "stage_s": stage_s,
            "wait_s": wait_s,
            "overlap_ratio": prefetch.overlap_ratio(stage_s, wait_s),
        }
    }
    if session is not None and session.events():
        rec["fault_tolerance"] = session.record()
    return partials, rec


def _run_pooled_chain(
    meta: _FusedMeta,
    frame: TensorFrame,
    cache,
    devices: Sequence[Any],
    terminal: Optional[_TerminalReduce] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """The pooled (or cache-affinity) fused chain: each block stages ONCE
    (pruned entry columns, per-device lanes, or resident shards when the
    entry frame is cached), the whole chain runs on the block's device, and
    one overlapped readback assembles the outputs in block order.  Retries
    re-stage from the host on the current effective device; quarantine
    redirects follow ``PoolRun``.  Outputs are adopted as the result's
    shards when sharding resolves, with a finalizer refunding the budget.

    ``terminal``: fold each block's partial on its device instead; empty
    blocks are skipped, partials move to the reduce program's device in
    block order, and ``(partials, record)`` returns for the caller's
    ``_combine_partials``: the eager reduce's fold shape."""
    sizes = frame.block_sizes
    nb = frame.num_blocks
    assignment = (
        list(cache.assignment) if cache is not None else device_pool.assign(sizes, len(devices))
    )
    pool = device_pool.PoolRun(
        devices, assignment, prefetch.prefetch_depth() or 1, affinity=cache is not None
    )
    session = fault_tolerance.frame_session(nb, verb="plan", pool=pool)
    pads = _chain_pads(meta, frame)
    calls: Dict[int, _StageCalls] = {}

    def calls_on(di):
        if di not in calls:
            calls[di] = _StageCalls(meta, devices[di])
        return calls[di]

    def stage_block(bi, dev):
        return _DEFAULT._stage_values(_entry_values(meta, frame, bi), dev)

    lanes: List[Any] = []
    lane_iters: List[Any] = []
    if cache is None:
        lanes = device_pool.lanes(devices, assignment, stage_block, name="tfs-plan")
        lane_iters = [iter(ln) for ln in lanes]
    out_blocks: List[Optional[Dict[str, Any]]] = [None] * nb
    adopt_outs = (
        [None] * nb
        if terminal is None and (cache is not None or len(frame_cache.shard_devices(None)) >= 2)
        else None
    )
    partials: List[Dict[str, Any]] = []
    combine = terminal.program.device if terminal is not None else None
    eff_assign: List[int] = []
    shard_hits = 0
    with torch.no_grad():
        for bi in range(nb):
            cancellation.checkpoint()  # block boundary (pooled chain)
            t_blk = observability.trace_now()
            di = assignment[bi]
            if terminal is not None and sizes[bi] == 0:
                # the eager reduce never dispatches empty blocks; consume
                # the lane's entry so later blocks stay aligned
                if cache is None:
                    next(lane_iters[di])
                eff_assign.append(di)
                continue
            di_eff = pool.effective_device(di) if session is not None else di
            if cache is not None:
                shard = cache.shard(bi) if di_eff == di else None
                used = bool(shard) and any(n in shard for n in meta.src_inputs)
                if used:
                    shard_hits += 1
                    observability.note_cache_shard_hit()
                elif session is not None and di_eff != di:
                    session.note_cache_restage()
                staged = _DEFAULT._stage_values(
                    _entry_values(meta, frame, bi, shard if used else None), devices[di_eff]
                )
            else:
                staged = next(lane_iters[di])
            holder = {"v": staged}
            del staged

            def attempt(a, dev_i, _bi=bi, _h=holder, _di=di_eff):
                # attempt 0 consumes the staged entry; every retry (and any
                # quarantine redirect) re-stages from the host
                ins = _h.pop("v", None) if (a == 0 and dev_i == _di) else None
                _h.clear()
                if ins is None:
                    ins = stage_block(_bi, devices[dev_i])
                with device_pool.device_scope(devices[dev_i]):
                    if terminal is not None:
                        return _chain_fold(meta, terminal, calls_on(dev_i), ins.ready(),
                                           pads[_bi], sizes[_bi])
                    return _run_padded(meta, calls_on(dev_i), ins.ready(), pads[_bi], sizes[_bi])

            if session is None:
                res = attempt(0, di)
            else:
                res = session.run(
                    bi, sizes[bi], attempt, device=lambda _di=di: pool.effective_device(_di)
                )
                di_eff = pool.effective_device(di)
            eff_assign.append(di_eff)
            if terminal is not None:
                if res is not None:
                    partials.append({b: res[b].to(combine) for b in terminal.bases})
                pool.note_dispatch(di_eff, sizes[bi])
                if t_blk is not None:
                    observability.trace_complete(
                        f"plan+{terminal.verb} b{bi}", pool.tracks[di_eff], t_blk,
                        block=bi, rows=sizes[bi], device=di_eff,
                    )
                continue
            if adopt_outs is not None:
                adopt_outs[bi] = res
            pool.submit(bi, di_eff, sizes[bi], res, out_blocks)
            if t_blk is not None:
                observability.trace_complete(
                    f"plan b{bi}", pool.tracks[di_eff], t_blk, block=bi, rows=sizes[bi],
                    device=di_eff,
                )
            del res
        pool.finish(out_blocks)
    rec: Dict[str, Any] = {
        "device_pool": pool.record(
            sum(ln.stats["stage_s"] for ln in lanes), sum(ln.stats["wait_s"] for ln in lanes)
        )
    }
    if cache is not None:
        fc = cache.record()
        fc["shard_hits"] = shard_hits
        rec["frame_cache"] = fc
    if session is not None and session.events():
        rec["fault_tolerance"] = session.record()
    if terminal is not None:
        return partials, rec
    out_frame = TensorFrame.from_blocks(out_blocks)
    if not meta.trim:
        # source columns not shadowed by chain outputs pass through
        # unchanged, the pruned ones included: host-side, zero staging
        extra = [c for c in frame.columns if c.info.name not in out_frame.column_names]
        if extra:
            out_frame = TensorFrame(list(out_frame.columns) + extra, out_frame.offsets)
    adopted = (
        frame_cache.adopt(out_frame, devices, eff_assign, adopt_outs)
        if adopt_outs is not None
        else None
    )
    if adopted is not None:
        weakref.finalize(out_frame, _release_cache, adopted)
        observability.note_plan_cache_insert()
        rec["adopted_blocks"] = adopted.resident_blocks()
    return out_frame, rec


# ---------------------------------------------------------------------------
# cross-plan common-subexpression sharing
# ---------------------------------------------------------------------------
#
# A process-wide plan-signature registry: two planned executions of an
# IDENTICAL subplan (same source frame object, same step Program objects
# at the same params generation, same terminal pruning) execute it once.
# Concurrent requests rendezvous on an in-flight entry: the first claimant
# (the owner) runs the segment under a PRIVATE root ledger, and at
# completion every consumer registered so far absorbs an exact integer
# share of the measured counters, blocks and rows, so per-request ledgers
# still sum to the global counters delta bit for bit.  Later identical
# chains reuse the shared result while it is alive (``plan_cse_hits``);
# entries hold weakrefs, so a recycled id never aliases stale results.


def _apportion_even(total: int, k: int) -> List[int]:
    """``total`` split into ``k`` equal integer shares that sum exactly
    (``observability.apportion`` with unit weights)."""
    return observability.apportion(int(total), [1] * k)


def _plan_signature(nodes: Sequence["LazyFrame"], frame: TensorFrame,
                    keep: Optional[Set[str]]) -> Optional[Tuple]:
    steps = []
    for nd in nodes:
        st = nd._step
        if st is None or st.stage_bound:
            return None  # host stages run arbitrary python: never shared
        prog = st.program
        steps.append((st.kind, st.trim, id(prog), prog._params_version))
    return (
        id(frame),
        frame.num_rows,
        frame.num_blocks,
        _entry_signature(frame),
        tuple(steps),
        None if keep is None else tuple(sorted(keep)),
    )


class _ReduceResult(dict):
    """A reduce-terminal shared result: a ``{base: array}`` dict that can
    be held by weakref (the registry never pins results)."""

    __slots__ = ("__weakref__",)


class _CseEntry:
    __slots__ = ("event", "consumers", "done", "failed", "frame_wr", "guards")

    def __init__(self, frame, nodes):
        self.event = threading.Event()
        # (ledger-or-None, slot) per consumer registered before completion;
        # the owner's pair is consumers[0]
        self.consumers: List[Tuple[Any, Dict[str, Any]]] = []
        self.done = False
        self.failed = False
        self.frame_wr = None
        self.guards = [weakref.ref(frame)] + [weakref.ref(nd._step.program) for nd in nodes]

    def valid(self) -> bool:
        return all(g() is not None for g in self.guards)


class _PlanRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, _CseEntry]" = collections.OrderedDict()
        # signature -> {"executions", "hits", "stages"}; survives result GC
        # so the doctor's cse_miss rule sees repeat executions
        self._stats: "collections.OrderedDict[Tuple, Dict[str, int]]" = collections.OrderedDict()
        self._cap = 256
        # notified when a consumer registers on an in-flight entry
        self._registered = threading.Condition(self._lock)
        # test hook: called by the owner inside its execution, after the
        # claim and before the run (holds an owner until consumers queue)
        self._owner_hook = None

    def _stat(self, sig: Tuple, stages: int) -> Dict[str, int]:
        rec = self._stats.setdefault(sig, {"executions": 0, "hits": 0, "stages": stages})
        self._stats.move_to_end(sig)
        while len(self._stats) > self._cap:
            self._stats.popitem(last=False)
        return rec

    def wait_for_waiters(self, sig: Tuple, n: int, timeout: float) -> bool:
        """Block until ``n`` consumers wait on the in-flight entry of
        ``sig`` (the owner excluded); False on timeout."""

        def count():
            ent = self._entries.get(sig)
            return len(ent.consumers) - 1 if ent is not None and not ent.done else 0

        with self._registered:
            return self._registered.wait_for(lambda: count() >= n, timeout)

    def lookup_or_claim(self, sig: Tuple, frame: TensorFrame, nodes) -> Tuple:
        """("hit", result) | ("wait", slot, event) | ("own", entry)."""
        with self._lock:
            for key in [k for k, e in self._entries.items() if not e.valid()]:
                del self._entries[key]
            ent = self._entries.get(sig)
            if ent is not None:
                if ent.done and not ent.failed:
                    out = ent.frame_wr() if ent.frame_wr else None
                    if out is not None:
                        self._stat(sig, len(nodes))["hits"] += 1
                        self._entries.move_to_end(sig)
                        return ("hit", out)
                    # the result was collected: execute afresh
                elif not ent.done:
                    slot: Dict[str, Any] = {}
                    ent.consumers.append((observability.current_request(), slot))
                    # a rendezvous IS a share: count it here so cse_miss
                    # cannot fire on always-concurrent sharing
                    self._stat(sig, len(nodes))["hits"] += 1
                    self._registered.notify_all()
                    return ("wait", slot, ent.event)
            ent = _CseEntry(frame, nodes)
            ent.consumers.append((observability.current_request(), {}))
            self._entries[sig] = ent
            self._stat(sig, len(nodes))["executions"] += 1
            while len(self._entries) > self._cap:
                _, old = self._entries.popitem(last=False)
                if not old.done:
                    old.failed = True
                    old.done = True
                    old.event.set()
            return ("own", ent)

    def complete(self, sig: Tuple, ent: _CseEntry, out, led) -> None:
        """Owner finished: deliver the result to every waiter, apportion
        the private ledger's exact delta across all consumers registered by
        now (abandoned waiters excluded: they paid their own way), and
        downgrade the entry to a weakref.  Lock order is registry ->
        ledger only; ledger locks are leaves."""
        counters = {k: v for k, v in led.counters.items() if v}
        blocks = dict(led.blocks_per_device)
        with self._lock:
            consumers = [c for c in ent.consumers if not c[1].get("abandoned")]
            ent.frame_wr = weakref.ref(out)
            ent.done = True
            k = len(consumers)
            shares = {key: _apportion_even(v, k) for key, v in counters.items()}
            block_shares = {d: _apportion_even(v, k) for d, v in blocks.items()}
            row_shares = _apportion_even(led.rows, k)
            for i, (consumer_led, slot) in enumerate(consumers):
                if consumer_led is not None:
                    consumer_led.absorb(
                        {key: s[i] for key, s in shares.items()},
                        {d: s[i] for d, s in block_shares.items()},
                        row_shares[i],
                    )
                slot["frame"] = out
            ent.consumers = []
        ent.event.set()

    def fail(self, sig: Tuple, ent: _CseEntry) -> None:
        with self._lock:
            ent.failed = True
            ent.done = True
            if self._entries.get(sig) is ent:
                del self._entries[sig]
        ent.event.set()

    def stats(self) -> List[Dict[str, int]]:
        with self._lock:
            return [dict(v) for v in self._stats.values()]


_REGISTRY = _PlanRegistry()


def recent_plan_stats() -> List[Dict[str, int]]:
    """Per-signature execution/hit counts from the sharing registry: the
    evidence of ``tft.doctor()``'s ``cse_miss`` rule (``plans=``)."""
    return _REGISTRY.stats()


def _wait_share(slot, event):
    """A consumer's wait on an in-flight owner: the result, or None when
    the owner failed (the share is then renounced under the registry lock,
    so a late completion cannot bill this request)."""
    try:
        while not event.wait(0.05):
            cancellation.checkpoint()  # deadlines cut the wait too
    except BaseException:
        with _REGISTRY._lock:
            if slot.get("frame") is None:
                slot["abandoned"] = True
        raise
    out = slot.get("frame")
    if out is None:
        with _REGISTRY._lock:
            if slot.get("frame") is None:
                slot["abandoned"] = True
        out = slot.get("frame")
    return out


def _own_share(sig, ent, fn):
    """Run ``fn()`` as the owner of ``ent``: under a PRIVATE root ledger,
    whose exact delta is then apportioned across every consumer (the
    suspended request context gets its share back through ``absorb``).
    ``fn`` returning None (a pre-dispatch bail) fails the entry."""
    tok0 = observability.activate_request(None)
    led = observability.RequestLedger(method="plan_cse")
    tok1 = observability.activate_request(led)
    try:
        hook = _REGISTRY._owner_hook
        if hook is not None:
            hook(sig)
        out = fn()
    except BaseException:
        observability.deactivate_request(tok1)
        observability.deactivate_request(tok0)
        _REGISTRY.fail(sig, ent)
        raise
    observability.deactivate_request(tok1)
    observability.deactivate_request(tok0)
    if out is None:
        _REGISTRY.fail(sig, ent)
        return None
    _REGISTRY.complete(sig, ent, out, led)
    return out


def _cse_execute(
    nodes: List["LazyFrame"],
    frame: TensorFrame,
    records: List[Dict],
    start_idx: int,
    cse: bool = True,
    keep: Optional[Set[str]] = None,
) -> TensorFrame:
    """Execute one flush segment through the registry: reuse a live
    identical result, rendezvous with an in-flight execution, or own the
    execution and apportion its exact cost across every consumer."""
    sig = _plan_signature(nodes, frame, keep) if (cse and cse_enabled()) else None
    if sig is None:
        return _flush(nodes, frame, records, start_idx, keep=keep)
    claim = _REGISTRY.lookup_or_claim(sig, frame, nodes)
    verb = "+".join(nd._step.label for nd in nodes)

    def shared(out, reason):
        observability.note_plan_cse_hit()
        records.append({
            "stage": start_idx, "verb": verb, "fused": len(nodes), "dispatch": "cse",
            "reason": reason, "rows": out.num_rows,
        })
        return out

    if claim[0] == "hit":
        return shared(claim[1], "registry_hit")
    if claim[0] == "wait":
        out = _wait_share(claim[1], claim[2])
        if out is not None:
            return shared(out, "shared_inflight")
        # the owner failed (or was evicted mid-flight): pay our own way
        return _flush(nodes, frame, records, start_idx, keep=keep)
    return _own_share(sig, claim[1], lambda: _flush(nodes, frame, records, start_idx, keep=keep))


# ---------------------------------------------------------------------------
# the lazy frame
# ---------------------------------------------------------------------------


class LazyFrame:
    """A frame whose verbs build a logical plan (``frame.lazy()``).

    Nodes form a DAG: each derived LazyFrame holds its parent strongly and
    parents hold children weakly.  Materialisation memoizes the executed
    frame on the node, so a shared subplan executes once; a node with two
    or more consumers becomes a barrier and gets an auto-inserted cache
    over the columns its consumers read.

    Any TensorFrame attribute not defined here (``collect``, ``to_arrays``,
    ``column``, ``schema``, ...) materialises the plan and delegates."""

    _tfs_lazy = True

    # guards shared plan-tree bookkeeping (root get-or-create, child
    # registration, consumer counts) across concurrent requests
    _TREE_LOCK = threading.Lock()
    # serializes auto-cache insertion, so two requests never build two
    # caches for one frame
    _AUTOCACHE_LOCK = threading.Lock()

    def __init__(
        self,
        source: Optional[TensorFrame] = None,
        parent: Optional["LazyFrame"] = None,
        step: Optional[PlanStep] = None,
    ):
        if (source is None) == (parent is None):
            raise ValidationError("LazyFrame: exactly one of source/parent is required")
        self._source = source
        self._parent = parent
        self._step = step
        self._child_refs: List[Any] = []
        self._children = 0  # registered consumers (derived + terminal)
        self._materialized: Optional[TensorFrame] = source if step is None else None
        self._mat_uses = 0  # dispatch-consumptions of the memoized frame
        self._auto_cached = False
        self._finalizer = None
        self._last_records: List[Dict[str, Any]] = []
        self._last_ledger: Optional[Dict[str, Any]] = None
        self._runs = 0  # times this node's step has executed

    # -- plan building -----------------------------------------------------

    def lazy(self) -> "LazyFrame":
        return self

    def _bump(self, attr: str) -> int:
        with LazyFrame._TREE_LOCK:
            v = getattr(self, attr) + 1
            setattr(self, attr, v)
            return v

    def _append(self, kind: str, program: Program, trim: bool = False,
                host_stage: Optional[Mapping[str, Any]] = None) -> "LazyFrame":
        child = LazyFrame(parent=self, step=PlanStep(kind, program, trim=trim,
                                                     host_stage=host_stage))
        with LazyFrame._TREE_LOCK:
            if len(self._child_refs) >= 32:
                # epochs loops re-derive from one root every pass: keep the
                # list bounded by the LIVE fan-out
                self._child_refs = [r for r in self._child_refs if r() is not None]
            self._child_refs.append(weakref.ref(child))
            self._children += 1
        return child

    def group_by(self, *keys: str) -> GroupedFrame:
        """Group for ``aggregate``.  An unmaterialised plan defers its
        materialisation to the aggregate, which then fetches only the key
        and reduced columns; key contracts are still checked here whenever
        the chain's schema is statically known."""
        self._bump("_children")
        if self._materialized is not None:
            return GroupedFrame(self._materialized, keys)
        if keys:
            self._check_group_keys(keys)
        return LazyGroupedFrame(self, keys)

    def _pending(self) -> Tuple["LazyFrame", List["LazyFrame"]]:
        """The nearest materialised ancestor (or root) and the
        unmaterialised chain below it, in order."""
        chain: List[LazyFrame] = []
        cur = self
        while cur._materialized is None:
            chain.append(cur)
            cur = cur._parent
        chain.reverse()
        return cur, chain

    def _check_group_keys(self, keys: Sequence[str]) -> None:
        """The eager ``GroupedFrame`` key checks, against the chain's
        statically inferred output schema; an opaque chain defers."""
        entry, chain = self._pending()
        src = entry._materialized
        if src is None or not chain:
            return
        steps = [nd._step for nd in chain]
        n, _, _ = _fusable_run(steps, _device_infos(src))
        if n != len(steps):
            return
        meta = _compose(steps, src)
        shim = _SchemaShim(src, meta.final_infos, trim=meta.trim)
        for k in keys:
            ci = shim.schema[k]  # raises SchemaError exactly like eager
            if ci.cell_shape.rank != 0:
                raise ValidationError(
                    f"group_by: key column {k!r} must be scalar, has cell "
                    f"shape {ci.cell_shape}"
                )

    def frame(self) -> TensorFrame:
        """Force execution and return the materialised TensorFrame."""
        return self._materialize(count_use=False)

    # -- execution ---------------------------------------------------------

    def _materialize(
        self,
        needed_hint: Optional[Set[str]] = None,
        count_use: bool = True,
        keep: Optional[Set[str]] = None,
        cse: bool = True,
    ) -> TensorFrame:
        """Execute the plan.  ``keep``: prune the final fused group's
        fetches to the named derived columns (a terminal consumer's read
        set); the partial result is then not memoized.  ``cse=False``
        bypasses the cross-plan registry (per-window plans)."""
        if self._materialized is not None:
            if count_use and self._bump("_mat_uses") >= 2:
                self._ensure_auto_cache(needed_hint)
            return self._materialized
        entry, chain = self._pending()
        frame = entry._materialized
        # one more dispatch reads the shared entry: promote it to an auto
        # cache on its second consumption (the epochs pattern)
        if entry._bump("_mat_uses") >= 2:
            entry._ensure_auto_cache(_first_step_cols(chain) or needed_hint,
                                     home=_home(chain))
        records: List[Dict[str, Any]] = []
        with observability.verb_span("plan", frame.num_rows, frame.num_blocks) as span:
            pending: List[LazyFrame] = []
            done = 0
            for nd in chain:
                pending.append(nd)
                if nd._children >= 2 and nd is not chain[-1]:
                    # shared subplan: materialisation barrier + cache
                    frame = _cse_execute(pending, frame, records, done, cse=cse)
                    done += len(pending)
                    pending = []
                    nd._materialized = frame
                    nd._mat_uses = 1
                    nd._ensure_auto_cache(None)
                    frame = nd._materialized
            if pending:
                frame = _cse_execute(pending, frame, records, done, cse=cse, keep=keep)
            _annotate_plan(span, records)
        if keep is None:
            self._materialized = frame
            self._mat_uses = 1
        self._last_records = records
        return frame

    # -- auto cache --------------------------------------------------------

    def _ensure_auto_cache(self, needed_hint: Optional[Set[str]] = None,
                           home: Optional[torch.device] = None) -> None:
        """Insert a cache on this node's materialised frame, over the
        columns downstream consumers read: sharded over the pool when
        shard placement resolves (``TFS_CACHE_SHARDED``'s auto rule), else
        on the one card the consumers run on (``home``).  A
        ``weakref.finalize`` on the frame releases it and refunds
        ``TFS_HBM_BUDGET`` when the frame is collected."""
        mat = self._materialized
        if mat is None or self._auto_cached:
            return
        with LazyFrame._AUTOCACHE_LOCK:
            if self._auto_cached:
                return
            if frame_cache.active_cache(mat) is not None:
                self._auto_cached = True  # adopted / user-cached already
                return
            devs = frame_cache.shard_devices(None)
            if len(devs) < 2:
                home = home or self._home_below()
                devs = [home] if home is not None and home.type in _ONE_DEVICE_CACHE_TYPES else []
            if not devs:
                return
            needed, everything = self._needed_below()
            if needed_hint:
                needed |= set(needed_hint)
            cacheable = sorted(
                name for name in _device_infos(mat)
                if not mat.column(name).is_device and (everything or name in needed)
            )
            if not cacheable:
                return
            cache = frame_cache.build(mat, cacheable, devices=devs, min_devices=1)
            if cache is None:
                return
            frame_cache.attach(mat, cache)
            self._finalizer = weakref.finalize(mat, _release_cache, cache)
            self._auto_cached = True
        observability.note_plan_cache_insert()
        _log.info("planner: auto-inserted cache over %s on %d device(s) (%d consumers)",
                  cacheable, len(devs), max(self._children, self._mat_uses))

    def _needed_below(self) -> Tuple[Set[str], bool]:
        """Columns of this node's frame that registered downstream stages
        consume (transitively), and whether a host-staged descendant makes
        the set unknowable.  Over-approximation is safe: extra shards are
        only bytes."""
        needed: Set[str] = set()
        everything = False
        for ref in self._child_refs:
            child = ref()
            if child is None or child._step is None:
                continue
            st = child._step
            if st.stage_bound:
                everything = True
            needed.update(st.program.column_for_input(n) for n in st.program.input_names)
            sub, all_flag = child._needed_below()
            needed |= sub
            everything = everything or all_flag
        return needed, everything

    def _home_below(self) -> Optional[torch.device]:
        """The device the first live consumer's program runs on."""
        for ref in self._child_refs:
            child = ref()
            if child is not None and child._step is not None:
                return child._step.program.device
        return None

    # -- terminal verbs ----------------------------------------------------

    def _reduce(self, verb: str, program: Program, mode: str = "tree"):
        self._bump("_children")
        if self._materialized is None:
            out = self._cse_reduce(verb, program, mode)
            if out is not None:
                return out
        mat = self._materialize(needed_hint=_reduce_cols(program))
        if verb == "reduce_rows":
            return _DEFAULT.reduce_rows(program, mat, mode=mode)
        return _DEFAULT.reduce_blocks(program, mat)

    def _cse_reduce(self, verb: str, program: Program, mode):
        """The fused terminal reduce through the sharing registry: the
        chain's plan signature extended with the reduce's identity (verb,
        mode, program, params generation).  Falls back to a solo
        ``_fused_terminal_reduce`` when no signature can be built; a None
        from it (a pre-dispatch bail) fails the entry so waiters pay their
        own way, and the caller materializes then reduces."""
        if not cse_enabled():
            return self._fused_terminal_reduce(verb, program, mode)
        tc = self._terminal_chain()
        if tc is None:
            return self._fused_terminal_reduce(verb, program, mode)
        _entry, chain, _steps, frame = tc
        base_sig = _plan_signature(chain, frame, None)
        if base_sig is None:
            return self._fused_terminal_reduce(verb, program, mode)
        sig = base_sig + (("reduce", verb, mode, id(program), program._params_version),)
        claim = _REGISTRY.lookup_or_claim(sig, frame, chain)
        label = "+".join(nd._step.label for nd in chain) + f"+{verb}"

        def shared(out, reason):
            observability.note_plan_cse_hit()
            self._last_records = [{
                "stage": 0, "verb": label, "fused": len(chain) + 1, "dispatch": "cse",
                "reason": reason, "terminal": verb,
            }]
            return out

        if claim[0] == "hit":
            return shared(claim[1], "registry_hit")
        if claim[0] == "wait":
            out = _wait_share(claim[1], claim[2])
            if out is not None:
                return shared(out, "shared_inflight")
            return self._fused_terminal_reduce(verb, program, mode)
        ent = claim[1]
        # the reduce program's lifetime guards the entry too (its id is in
        # the signature: a new program reusing the id must not hit)
        ent.guards.append(weakref.ref(program))

        def run():
            out = self._fused_terminal_reduce(verb, program, mode)
            return None if out is None else _ReduceResult(out)

        return _own_share(sig, ent, run)

    def _terminal_chain(self):
        """``(entry, chain, steps, frame)`` of the pending chain, or None
        when a terminal fusion cannot apply: no steps, an interior shared
        subplan, or an unfusable run."""
        entry, chain = self._pending()
        frame = entry._materialized
        if not chain or frame.num_rows == 0:
            return None
        if any(nd._children >= 2 for nd in chain[:-1]):
            return None
        steps = [nd._step for nd in chain]
        n, _, _ = _fusable_run(steps, _device_infos(frame))
        if n != len(steps):
            return None
        return entry, chain, steps, frame

    def _fused_terminal_reduce(self, verb: str, program: Program, mode):
        """Fold the reduce into the chain dispatch when the whole pending
        chain is one fusable run and every reduce base is a chain output:
        each block's partial on its device, then the engine's own
        ``_combine_partials``.  Pooled/affinity decisions fold inside the
        pooled chain (JAX's path); the serial decision folds inside the
        serial chain (``_run_serial_fold``).  None when the eager
        materialize-then-reduce path runs instead (a trimmed chain, a base
        the chain does not produce)."""
        tc = self._terminal_chain()
        if tc is None:
            return None
        entry, chain, steps, frame = tc
        meta0 = _compose(steps, frame)
        if meta0.trim:
            return None  # trimmed chains keep the materialized path's checks
        shim = _SchemaShim(frame, meta0.final_infos)
        if verb == "reduce_rows":
            bases, reduced, run_for = _DEFAULT._reduce_rows_setup(program, shim, mode)
        else:
            bases, reduced, run_for = _DEFAULT._reduce_blocks_setup(program, shim)
        cols = {b: reduced[b].name for b in bases}
        if not all(cols[b] in set(meta0.fetches) for b in bases):
            return None  # a source/passthrough column: materialize
        meta = _compose(steps, frame, keep=set(cols.values()))
        warm = any(nd._runs > 0 for nd in chain) or _chain_warm(steps)
        rec = _choose_dispatch(meta, frame, warm)
        decision = rec.pop("decision")
        reason = rec.pop("reason")
        sts = {b: dtypes.coerce(reduced[b].scalar_type) for b in bases}
        terminal = _TerminalReduce(run_for, program, bases, cols, sts, verb)
        # one more consumption of the shared entry (epochs promotion)
        if entry._bump("_mat_uses") >= 2:
            entry._ensure_auto_cache(_first_step_cols(chain), home=_home(chain))
            if decision == "serial" and frame_cache.active_cache(frame) is not None:
                # the one-card auto-cache just landed: read it in place
                rec = _choose_dispatch(meta, frame, warm)
                decision, reason = rec.pop("decision"), rec.pop("reason")
        records: List[Dict[str, Any]] = []
        with observability.verb_span("plan", frame.num_rows, frame.num_blocks) as span:
            if decision in ("pool", "affinity"):
                cache = frame_cache.active_cache(frame)
                devices = cache.devices if cache is not None else device_pool.pool_devices()
                (partials, run_rec), measured = _measured(
                    lambda: _run_pooled_chain(meta, frame, cache, devices, terminal=terminal),
                    frame.num_rows,
                )
            else:
                (partials, run_rec), measured = _measured(
                    lambda: _run_serial_fold(meta, frame, terminal), frame.num_rows
                )
            rec.update(run_rec)
            rec.update(measured)
            _calib_note(meta, frame, decision, measured.get("rows_per_s"))
            if len(steps) >= 2:
                observability.note_plan_fused_dispatch()
            observability.note_plan_fused_reduce()
            if meta.pruned:
                observability.note_plan_columns_pruned(len(meta.pruned))
            records.append({
                "stage": 0,
                "verb": "+".join(st.label for st in steps) + f"+{verb}",
                "fused": len(steps) + 1,
                "dispatch": decision,
                "reason": reason,
                "terminal": verb,
                "pruned": list(meta.pruned),
                **rec,
            })
            with torch.no_grad():
                final = _DEFAULT._combine_partials(terminal.run_on(program.device), bases, partials)
            out = {b: _host(final[b]) for b in bases}
            span.annotate("planner", {"stages": records, "fused_groups": 1,
                                      "fused_terminal": verb})
        for nd in chain:
            nd._runs += 1
        self._last_records = records
        return out

    def _aggregate_terminal(self, program: Program, keys: Sequence[str],
                            grouped: Optional["LazyGroupedFrame"] = None) -> TensorFrame:
        """Terminal-pruned aggregate: materialise the chain fetching ONLY
        the key and reduced columns, then run the unchanged eager
        aggregate.  Repeat aggregates over one ``grouped`` handle stay
        materialize-once: a pruned result is memoized per read set, and a
        second, different read set switches to one full (node-memoized)
        materialisation."""
        from .validation import check_reduce_blocks

        tc = self._terminal_chain()
        if tc is None or self._materialized is not None:
            mat = self._materialize(needed_hint=set(keys))
            return _DEFAULT.aggregate(program, GroupedFrame(mat, keys))
        _entry, _chain, steps, frame = tc
        meta0 = _compose(steps, frame)
        shim = _SchemaShim(frame, meta0.final_infos, trim=meta0.trim)
        reduced = check_reduce_blocks(program, shim, verb="aggregate")
        needed = set(keys) | {ci.name for ci in reduced.values()}
        keep = needed & set(meta0.fetches)
        fz = frozenset(keep) if keep else None
        if grouped is not None:
            hit = grouped._pruned.get(fz)
            if hit is not None:
                return _DEFAULT.aggregate(program, GroupedFrame(hit, keys))
            if grouped._agg_count >= 1:
                mat = self._materialize(needed_hint=needed)
                grouped._agg_count += 1
                return _DEFAULT.aggregate(program, GroupedFrame(mat, keys))
        mat = self._materialize(needed_hint=needed, count_use=False, keep=keep or None)
        # the counter tracks ACTUAL fetch pruning: keep applies only to a
        # fused tail group dispatched pooled/affinity
        if keep and any(
            r.get("fused", 0) >= 2 and r.get("dispatch") in ("pool", "affinity")
            for r in self._last_records
        ):
            observability.note_plan_fused_reduce()
        if grouped is not None:
            grouped._pruned[fz] = mat
            grouped._agg_count += 1
        return _DEFAULT.aggregate(program, GroupedFrame(mat, keys))

    # -- surface -----------------------------------------------------------

    @property
    def is_materialized(self) -> bool:
        return self._materialized is not None

    def warmup(self) -> List[str]:
        """Prime what this plan will dispatch, without executing it
        (:func:`warm_plan`)."""
        return warm_plan(self)

    def explain_plan(self) -> str:
        return explain_plan(self)

    def explain_analyze(self) -> str:
        """Execute the plan under a request ledger and render the measured
        report (``tft.explain(frame, analyze=True)``)."""
        return explain_analyze(self)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._materialize(count_use=False), name)

    def __repr__(self):
        return self.explain_plan()


class _SchemaShim:
    """Schema-only stand-in for a chain's (never materialised) output
    frame: ``schema``, ``num_rows``, ``block_sizes``, what the engine's
    reduce/aggregate setup and validation read.  A trimmed chain carries
    only its derived columns."""

    __slots__ = ("schema", "num_rows", "block_sizes")

    def __init__(self, entry: TensorFrame, final_infos: Mapping[str, ColumnInfo],
                 trim: bool = False):
        cols: Dict[str, ColumnInfo] = {} if trim else {ci.name: ci for ci in entry.schema}
        cols.update(final_infos)
        self.schema = Schema(list(cols.values()))
        self.num_rows = entry.num_rows
        self.block_sizes = list(entry.block_sizes)


class LazyGroupedFrame(GroupedFrame):
    """``lazy.group_by(...)`` over an unmaterialised plan: grouping waits
    for ``aggregate``, which prunes the chain's fetches to the keys and
    reduced columns (:meth:`LazyFrame._aggregate_terminal`).  ``.frame``
    materialises the full plan."""

    def __init__(self, lazy: LazyFrame, keys: Sequence[str]):
        if not keys:
            raise ValidationError("group_by needs at least one key column")
        self.lazy = lazy
        self.keys = list(keys)
        self._pruned: Dict[Optional[frozenset], TensorFrame] = {}
        self._agg_count = 0

    @property
    def frame(self) -> TensorFrame:
        return self.lazy._materialize(count_use=False)


def _release_cache(cache) -> None:
    """``weakref.finalize`` body of planner-made caches: drop the shards
    and refund the budget when the frame is collected."""
    cache.release()


def _first_step_cols(chain: Sequence[LazyFrame]) -> Optional[Set[str]]:
    if not chain:
        return None
    st = chain[0]._step
    return {st.program.column_for_input(n) for n in st.program.input_names}


def _home(chain: Sequence[LazyFrame]) -> Optional[torch.device]:
    return chain[0]._step.program.device if chain else None


def _reduce_cols(program: Program) -> Set[str]:
    """Frame columns a reduce program consumes (the auto-cache hint):
    feed-dict renames resolve to the fed column, unrenamed inputs strip
    the reduce suffix (``x_input`` / ``x_1`` / ``x_2`` -> ``x``)."""
    cols: Set[str] = set()
    for n in program.input_names:
        col = program.column_for_input(n)
        if col != n:
            cols.add(col)
            continue
        for suf in ("_input", "_1", "_2"):
            if n.endswith(suf):
                cols.add(n[: -len(suf)])
                break
        else:
            cols.add(n)
    return cols


def _annotate_plan(span, records) -> None:
    """The ``plan`` span annotation: every group's record with its
    decision and reason."""
    span.annotate("planner", {
        "stages": records,
        "fused_groups": sum(1 for r in records if r.get("fused", 0) >= 2),
        "pruned_columns": sorted({c for r in records for c in r.get("pruned", ())}),
    })


# ---------------------------------------------------------------------------
# group dispatch
# ---------------------------------------------------------------------------


def _flush(nodes: List[LazyFrame], frame: TensorFrame, records: List[Dict],
           start_idx: int, keep: Optional[Set[str]] = None) -> TensorFrame:
    """Execute ``nodes``' steps over ``frame``: maximal fusable runs
    dispatch as ONE chained pass; everything else (host-staged,
    ragged-input, lone stages) runs the plain eager verb.  ``keep`` prunes
    the fetches of a fused group that ENDS the segment."""
    i = 0
    while i < len(nodes):
        steps = [nd._step for nd in nodes[i:]]
        n, why, _ = _fusable_run(steps, _device_infos(frame))
        if n >= 2:
            frame = _dispatch_fused(nodes[i: i + n], frame, records, start_idx + i,
                                    keep=keep if i + n == len(nodes) else None)
            i += n
        else:
            frame = _dispatch_single(nodes[i], frame, records, start_idx + i,
                                     why if n == 0 else "single_stage")
            i += 1
    return frame


def _measured(fn, rows: int) -> Tuple[Any, Dict[str, Any]]:
    """``(fn(), measurement)``: wall time and the resource deltas every
    plan record carries (the substance of ``explain(analyze=True)``),
    metered through a nested ``RequestLedger`` (exact per thread; staging
    lanes inherit the context).  The ledger is never finished: internal
    metering must not fold into the per-tenant request aggregates."""
    led = observability.RequestLedger(method="plan_stage")
    token = observability.activate_request(led)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        observability.deactivate_request(token)
    wall = time.perf_counter() - t0
    c = led.snapshot()["counters"]
    m: Dict[str, Any] = {
        "wall_s": round(wall, 6),
        "h2d_bytes": c.get("h2d_bytes_staged", 0),
        "traces": c.get("program_traces", 0),
        "rows": rows,
        "rows_per_s": round(rows / wall, 1) if wall > 0 else None,
    }
    if c.get("pool_blocks"):
        m["pool_blocks"] = c["pool_blocks"]
    if c.get("cache_shard_hits"):
        m["shard_hits"] = c["cache_shard_hits"]
    if c.get("block_retries"):
        m["retries"] = c["block_retries"]
    return out, m


def _dispatch_single(node: LazyFrame, frame: TensorFrame, records: List[Dict],
                     idx: int, reason: str) -> TensorFrame:
    st = node._step

    def run():
        if st.kind == "map_rows":
            return _DEFAULT.map_rows(st.program, frame, host_stage=st.host_stage)
        return _DEFAULT.map_blocks(st.program, frame, trim=st.trim, host_stage=st.host_stage)

    out, measured = _measured(run, frame.num_rows)
    node._runs += 1
    records.append({"stage": idx, "verb": st.label, "fused": 1, "dispatch": "eager",
                    "reason": reason, **measured})
    return out


def _dispatch_fused(group: List[LazyFrame], frame: TensorFrame, records: List[Dict],
                    idx: int, keep: Optional[Set[str]] = None) -> TensorFrame:
    steps = [nd._step for nd in group]
    try:
        meta = _compose(steps, frame, keep=keep)
    except ValidationError:
        if keep is None:
            raise
        meta = _compose(steps, frame)  # the terminal reads no derived column
    warm = any(nd._runs > 0 for nd in group) or _chain_warm(steps)
    rec = _choose_dispatch(meta, frame, warm)
    decision = rec.pop("decision")
    reason = rec.pop("reason")
    if decision in ("pool", "affinity") and frame.num_rows > 0:
        cache = frame_cache.active_cache(frame)
        devices = cache.devices if cache is not None else device_pool.pool_devices()
        (out, run_rec), measured = _measured(
            lambda: _run_pooled_chain(meta, frame, cache, devices), frame.num_rows
        )
        rec.update(run_rec)
        # the pool decision's observed payoff: per-device occupancy as one
        # effective-parallelism scalar
        occ = run_rec.get("device_pool", {}).get("occupancy")
        if occ:
            measured["effective_parallelism"] = round(sum(occ), 2)
    else:
        out, measured = _measured(lambda: _run_serial_chain(steps, frame), frame.num_rows)
    rec.update(measured)
    _calib_note(meta, frame, decision, measured.get("rows_per_s"))
    observability.note_plan_fused_dispatch()
    if meta.pruned:
        observability.note_plan_columns_pruned(len(meta.pruned))
    records.append({
        "stage": idx,
        "verb": "+".join(st.label for st in steps),
        "fused": len(group),
        "dispatch": decision,
        "reason": reason,
        "pruned": list(meta.pruned),
        **rec,
    })
    for nd in group:
        nd._runs += 1
    return out


# ---------------------------------------------------------------------------
# routing + explain
# ---------------------------------------------------------------------------


def root_for(frame: TensorFrame) -> LazyFrame:
    """The ONE shared plan root of a TensorFrame object (get-or-create),
    for ``frame.lazy()`` and the ``TFS_PLAN`` routing alike, so chains from
    either count as consumers of the same subplan."""
    root = getattr(frame, "_tfs_lazy_root", None)
    if root is None:
        with LazyFrame._TREE_LOCK:
            root = getattr(frame, "_tfs_lazy_root", None)
            if root is None:
                root = LazyFrame(source=frame)
                frame._tfs_lazy_root = root
    return root


def maybe_lazy(frame) -> Optional[LazyFrame]:
    """The LazyFrame a module-level map verb appends to, or None for the
    eager path: the frame is already lazy, or ``TFS_PLAN`` is on and it is
    a plain TensorFrame."""
    if isinstance(frame, LazyFrame):
        return frame
    if planning_enabled() and isinstance(frame, TensorFrame):
        return root_for(frame)
    return None


def ensure_frame(frame):
    """A concrete TensorFrame for surfaces that cannot stay lazy
    (pipelines, warmup)."""
    if isinstance(frame, LazyFrame):
        return frame._materialize(count_use=False)
    return frame


# ---------------------------------------------------------------------------
# plan warmup
# ---------------------------------------------------------------------------


def warm_plan(frame: LazyFrame) -> List[str]:
    """Prime what the optimizer will dispatch for this plan, without
    executing it: the fused group's stages at every bucketed size on every
    device they will run on (a zeros block through the exact
    ``_apply_stages`` path, under ``suppress_trace_count``: the kernels the
    stages launch are built or loaded, the allocator seeded, the entries
    marked warm), plus the intensity walk and the bucket-pad proofs.  A
    single-stage plan delegates to ``Executor.warmup`` and returns its
    fingerprints; a chain returns the primed ``chain[n]xROWS@DEVICE``
    labels."""
    if not isinstance(frame, LazyFrame):
        raise ValidationError("warm_plan: takes a LazyFrame")
    entry, chain = frame._pending()
    src = entry._materialized
    if src is None or not chain or src.num_rows == 0:
        return []
    steps = [nd._step for nd in chain]
    n, _, _ = _fusable_run(steps, _device_infos(src))
    if n < 2:
        st = steps[0]
        if st.stage_bound or st.kind not in ("map_blocks", "map_rows"):
            return []
        return list(_DEFAULT.warmup(st.program, src, rows_level=st.kind == "map_rows",
                                    host_stage=st.host_stage))
    meta = _compose(steps[:n], src)
    pads = _chain_pads(meta, src)
    exec_sizes = sorted({
        pads[bi] if pads[bi] is not None else s
        for bi, s in enumerate(src.block_sizes) if s > 0
    })
    if not exec_sizes:
        return []
    cache = frame_cache.active_cache(src)
    if cache is not None:
        devs = [cache.devices[di] for di in sorted(set(cache.assignment))]
    else:
        pool = device_pool.pool_devices()
        devs = pool if len(pool) >= 2 else [_chain_device(meta)]
    _fused_intensity(meta, src)
    primed: List[str] = []
    with torch.no_grad(), observability.suppress_trace_count():
        for n_rows in exec_sizes:
            for dev in devs:
                zeros = {}
                for name in meta.src_inputs:
                    col = src.column(name)
                    st_ = dtypes.coerce(col.info.scalar_type)
                    zeros[name] = torch.zeros((n_rows,) + tuple(np.shape(col.data)[1:]),
                                              dtype=st_.torch_dtype, device=dev)
                with device_pool.device_scope(dev):
                    _apply_stages(meta, _StageCalls(meta, dev), zeros)
                primed.append(f"chain[{len(meta.steps)}]x{n_rows}@{dev}")
    return primed


# ---------------------------------------------------------------------------
# the planner-aware epochs loop
# ---------------------------------------------------------------------------


def _prime_blocks(frame, cache, missing: List[int]) -> None:
    """Best-effort background re-staging of evicted entry shards between
    epochs: spill-backed shards restore from disk, plain shards re-stage
    from the host columns through ``prefetch.stage_arrays`` (pinned
    buffers, the device's copy stream).  Before a shard is published the
    compute stream waits on the copy's event and every tensor is recorded
    as used by it (``Staged.ready`` on this thread's current stream, the
    device's default stream), so a later read can neither see a
    half-copied shard nor have its memory reused under it.  Any failure
    leaves the block to the dispatch path's inline re-staging."""
    names = None
    for b in cache.blocks:
        if b is not None:
            names = list(b)
            break
    for bi in missing:
        try:
            if cache.shard(bi) is not None:  # spill restore / raced in
                continue
            if names is None:
                return
            dev = cache.devices[cache.assignment[bi]]
            block = frame.block(bi)
            staged = prefetch.stage_arrays(
                {n: (block[n], dtypes.coerce(frame.column(n).info.scalar_type).host_dtype())
                 for n in names},
                dev,
            )
            with device_pool.device_scope(dev):
                shard = staged.ready()
            if not cache.insert(bi, shard):
                return  # budget full: stop, the dispatch re-stages inline
        except Exception:  # noqa: BLE001 - priming must never fail a run
            return


def _start_epoch_primer(root: LazyFrame):
    mat = root._materialized
    if mat is None:
        return None
    cache = frame_cache.active_cache(mat)
    if cache is None:
        return None
    missing = [bi for bi, b in enumerate(cache.blocks) if b is None]
    if not missing:
        return None
    t = threading.Thread(target=_prime_blocks, args=(mat, cache, missing),
                         daemon=True, name="tfs-plan-epoch-primer")
    t.start()
    return t


def iterate_epochs(frame, step, epochs: int, job_id: Optional[str] = None) -> List[Any]:
    """The planner-aware epochs loop (``tft.iterate_epochs``): run
    ``step(lazy_root, epoch)`` ``epochs`` times over one shared plan root
    and return the per-epoch results.

    The loop declares its consumptions up front, so the entry's cache is
    inserted on the FIRST consumption and every later epoch reads resident
    entry columns (0 H2D bytes in steady state); between epochs a
    background primer re-stages shards the ``TFS_HBM_BUDGET`` LRU evicted,
    so epoch N+1's blocks are resident while epoch N's host work runs.
    ``step`` derives chains and reduces/aggregates off the root as a
    hand-written loop would; params may change between epochs
    (``update_params``).

    ``job_id`` makes the loop durable (``recovery/``, ``TFS_JOURNAL_DIR``):
    each epoch's result (arrays, tensors, scalars, nested containers) is
    journaled at the epoch boundary, a resumed loop replays the journaled
    epochs' results without running ``step`` for them, and a completed
    loop returns its journaled results.  ``step`` must derive carried
    state (the params it updates) from the journaled results, not from
    process-local mutation, for the resumed epochs to be bit-identical."""
    if epochs < 1:
        raise ValidationError("iterate_epochs: epochs must be >= 1")
    if isinstance(frame, LazyFrame):
        root = frame
    elif isinstance(frame, TensorFrame):
        root = root_for(frame)
    else:
        raise ValidationError("iterate_epochs: takes a TensorFrame or LazyFrame")
    writer = None
    start_epoch = 0
    results: List[Any] = []
    if job_id is not None:
        from .. import recovery

        writer = recovery.adopt(
            job_id, "iterate_epochs",
            recovery.job_fingerprint("iterate_epochs", epochs=epochs),
        )
        # completed and interrupted loops replay the journaled epochs from
        # their boundary states (kept past complete for this)
        with recovery.durable.closing_on_error(writer):
            start_epoch = min(writer.boundary, epochs)
            for e in range(start_epoch):
                results.append(recovery.unpack_tree(
                    writer.load_state(e) or {}, writer.extras()[e]
                ))
                # an epoch journaled, replayed, never re-executed
                observability.note_journal_window_skipped()
        if writer.completed:
            writer.close()
            return results
    if epochs >= 2 and root._materialized is not None:
        # declare the loop's >= 2 consumptions: the entry cache inserts on
        # the FIRST consumption instead of the second
        root._mat_uses = max(root._mat_uses, 1)
    primer = None
    try:
        for e in range(start_epoch, epochs):
            cancellation.checkpoint()  # epoch boundary
            results.append(step(root, e))
            if writer is not None:
                from .. import recovery

                arrays, extra = recovery.pack_tree(results[-1])
                writer.append(arrays=arrays, extra=extra)
            # the primer runs CONCURRENTLY with the next epoch; at most one
            # is in flight
            if e + 1 < epochs and (primer is None or not primer.is_alive()):
                primer = _start_epoch_primer(root)
    except BaseException:
        if writer is not None:
            writer.close()  # stays resumable from the journal
        raise
    finally:
        if primer is not None:
            primer.join()
    if writer is not None:
        from .. import recovery

        with recovery.durable.closing_on_error(writer):
            writer.complete(keep_states=True)
    return results


# ---------------------------------------------------------------------------
# per-window plans for the streaming verbs
# ---------------------------------------------------------------------------


def run_window_chain(frame: TensorFrame,
                     steps: Sequence[Tuple[str, Program, bool]]) -> TensorFrame:
    """Execute a stacked map chain over ONE streaming window through plan
    construction: fusion, dead-column pruning and the bucket pads apply,
    and the fusion metadata is shared across windows (the stage Programs
    are the cache keys).  The sharing registry is bypassed: windows never
    repeat.  Bit-identical to the stages dispatched eagerly per window.
    The streamed map chains (``streaming.verbs.MappedStream``) call it per
    window under ``TFS_PLAN``."""
    cur = LazyFrame(source=frame)
    for kind, program, trim in steps:
        cur = cur._append(kind, program, trim=trim)
    out = cur._materialize(count_use=False, cse=False)
    observability.note_plan_stream_window()
    return out


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def explain_plan(frame: LazyFrame) -> str:
    """Render the optimized logical plan WITHOUT executing it: the stages,
    the fused groups (the executor's own grouping walk), pruned columns,
    cache barriers and, after a run, each group's decision."""
    chain: List[LazyFrame] = []
    cur = frame
    while cur._step is not None:
        chain.append(cur)
        cur = cur._parent
    chain.reverse()
    src = cur._materialized if cur._materialized is not None else cur._source
    lines = ["== logical plan (lazy) =="]
    lines.append(
        f"source: {src.num_rows} rows x {len(src.columns)} cols x "
        f"{src.num_blocks} block(s) [{', '.join(src.column_names)}]"
    )
    if not chain:
        lines.append("(no stages: materialises to the source frame)")
        return "\n".join(lines)
    gid_of: Dict[int, Tuple[Optional[int], Optional[str]]] = {}
    visible: Optional[Dict[str, ColumnInfo]] = _device_infos(src)
    consumed: Set[str] = set()
    barrier_idx = {k for k, nd in enumerate(chain) if nd._children >= 2}
    gid = 0
    i = 0
    while i < len(chain):
        stop = next((b for b in sorted(barrier_idx) if b >= i), None)
        seg_end = len(chain) if stop is None else stop + 1
        steps = [nd._step for nd in chain[i:seg_end]]
        if visible is None:
            n, why, after = 0, "schema opaque after host stage", None
        else:
            n, why, after = _fusable_run(steps, visible)
        if n >= 2:
            for k in range(i, i + n):
                gid_of[k] = (gid, None)
            gid += 1
            visible = after if n == len(steps) else None
            i += n
        else:
            gid_of[i] = (None, why if n == 0 else "single_stage")
            visible = None if n == 0 else after
            i += 1
    for k, nd in enumerate(chain):
        st = nd._step
        g, why = gid_of[k]
        cols = ", ".join(dict.fromkeys(st.program.column_for_input(n) for n in st.program.input_names))
        consumed.update(st.program.column_for_input(n) for n in st.program.input_names)
        tag = f"fused group {g}" if g is not None else f"eager ({why})"
        mark = "  [barrier: >=2 consumers -> auto-cache]" if k in barrier_idx else ""
        lines.append(f" stage {k:<2} {st.label:<20} reads [{cols}]  {tag}{mark}")
    dead = sorted(set(_device_infos(src)) - consumed)
    lines.append(
        "pruned columns (never staged by fused groups): " + (", ".join(dead) if dead else "none")
    )
    inserted = [f"stage {k} (inserted)" for k, nd in enumerate(chain) if nd._auto_cached]
    pendings = [
        f"stage {k} ({chain[k]._children} consumers)"
        for k in sorted(barrier_idx) if not chain[k]._auto_cached
    ]
    lines.append(
        "cache insertions: " + (", ".join(inserted + pendings) if (inserted or pendings) else "none")
    )
    recs = frame._last_records
    if recs:
        lines.append("last run:")
        for r in recs:
            extra = ""
            if r.get("intensity_flops_per_byte") is not None:
                extra = f", intensity={r['intensity_flops_per_byte']}"
            lines.append(
                f"  stage {r['stage']}: {r['verb']} -> {r['dispatch']} "
                f"(reason={r['reason']}{extra})"
            )
    return "\n".join(lines)


def _render_analyze(frame: LazyFrame, executed_now: bool) -> str:
    """The measured half of ``explain(analyze=True)``: per-group wall time,
    bytes staged, pool occupancy, and each decision with its observed
    payoff."""
    recs = frame._last_records
    lines = ["== analyze (measured) =="]
    if not executed_now:
        lines.append(
            "(plan was already materialized; measurements are from its last execution)"
        )
    if not recs:
        lines.append("(no recorded execution — the plan has no stages)")
    tot_wall = 0.0
    tot_h2d = 0
    for r in recs:
        wall = r.get("wall_s")
        tot_wall += wall or 0.0
        tot_h2d += r.get("h2d_bytes") or 0
        kind = "fused x" + str(r["fused"]) if r.get("fused", 1) >= 2 else "eager"
        lines.append(f" group stage {r['stage']}: {r['verb']} [{kind}]")
        lines.append(
            f"   dispatch={r.get('dispatch')} (reason={r.get('reason')})"
            + (f" intensity={r['intensity_flops_per_byte']}"
               if r.get("intensity_flops_per_byte") is not None else "")
        )
        lines.append(
            f"   wall={wall}s  h2d_bytes={r.get('h2d_bytes')}  "
            f"traces={r.get('traces')}  rows/s={r.get('rows_per_s')}"
        )
        dp = r.get("device_pool")
        if dp:
            payoff = r.get("effective_parallelism")
            lines.append(
                f"   pool: blocks={dp.get('blocks_per_device')} "
                f"occupancy={dp.get('occupancy')}"
                + (f" -> observed payoff: {payoff}x effective parallelism across "
                   f"{dp.get('devices')} device(s)" if payoff is not None else "")
            )
        if r.get("retries"):
            lines.append(f"   retries={r['retries']}")
        if r.get("pruned"):
            lines.append(f"   pruned={r['pruned']}")
    lines.append(f" totals: wall={round(tot_wall, 6)}s  h2d_bytes={tot_h2d}")
    led = frame._last_ledger
    if led:
        c = led.get("counters", {})
        lines.append(
            f" request: cid={led.get('correlation_id')} "
            f"wall={led.get('wall_s')}s "
            f"h2d={c.get('h2d_bytes_staged', 0)} "
            f"traces={c.get('program_traces', 0)} "
            f"retries={c.get('block_retries', 0)} "
            f"blocks_per_device={led.get('blocks_per_device')}"
        )
    return "\n".join(lines)


def explain_analyze(frame: LazyFrame) -> str:
    """``EXPLAIN ANALYZE`` of a planned frame: execute the plan under a
    ``request_ledger`` (nesting inside any active request's) and render
    the logical plan plus the measured per-group report.  A plan that
    already materialized renders its last execution's measurements."""
    executed_now = frame._materialized is None
    with observability.request_ledger(method="explain_analyze") as led:
        frame._materialize(count_use=False)
    if executed_now:
        frame._last_ledger = led.snapshot()
    return explain_plan(frame) + "\n" + _render_analyze(frame, executed_now)
