"""The execution engine: the six verbs, on one device or across a pool.

PyTorch counterpart of ``tensorframes_tpu/ops/engine.py``:

* ``map_blocks`` / ``map_blocks_trimmed``: input staging
  (``_stage_inputs``), the per-block program call, the per-block output
  and shape-hint checks (same messages), the output frame with passthrough
  columns shadowed by outputs, and the empty-frame contract;
* ``map_rows``: the cell-level program under ``torch.func.vmap`` over each
  block's rows; ragged columns run one vmapped call per bucket: the
  geometric bucket of the ragged length when the cell program is proven
  elementwise along it (``_ragged_pad_ok``), else each exact shape;
* ``reduce_rows``: a balanced tree of vmapped pairwise calls per block
  (``mode="tree"``), or the reference's left fold in row order
  (``mode="sequential"``);
* ``reduce_blocks``: the block program once per block, then once over the
  stacked partials (``_combine_partials``, the one final-combine shape of
  both reduce verbs);
* ``aggregate``: the device segment path when ``segment_compile``
  recognizes the program (``_aggregate_segment``: one stable key sort and
  one segmented reduction a reduce, no float atomics), else a host group
  index and the block program vmapped over all groups of one size (at
  most 8 distinct sizes), or a pairwise combine tree over row partials
  (skewed sizes).

Blocks run under the block dispatch stack, as the JAX package's do:

* bucket padding (``ops/bucketing.py``, ``_bucket_plan``): ``map_rows``
  blocks, and ``map_blocks`` blocks whose program ``analysis.rows_independent``
  proves row-independent, pad to a geometric bucket on the device after
  their real rows are staged, and slice back;
* a cancellation checkpoint at every block boundary
  (``cancellation.py``: a ``CancelScope``'s deadline or cancel raises
  there, never mid-block);
* a ``prefetch.Prefetcher`` over host-fresh blocks: one staging thread
  casts each block (and runs ``host_stage``) in block order and, on CUDA,
  copies it from pinned buffers on a copy stream while earlier blocks
  compute; a ``cache()``d frame's columns are read in place and stage 0
  host bytes;
* the device pool (``ops/device_pool.py``) when two or more devices
  resolve: a host-fresh multi-block frame's blocks spread over per-device
  lanes with overlapped readback, and a sharded-cached frame
  (``ops/frame_cache.py``) runs each block on the device holding it; the
  reduce partials fold back on one device;
* the retry session of ``ops/fault_tolerance.py`` when
  ``TFS_BLOCK_RETRIES`` > 0 or ``TFS_FAULT_INJECT`` is set: transient
  failures re-stage and retry (under the pool, a device that keeps
  failing is quarantined), a device OOM splits a provably row-independent
  block (``analysis.rows_independent``), on the same device and kernels.

Map outputs stay on the device as tensors until ``collect``/``to_arrays``
(the pooled loops read them back to the host, in block order); the reduce
verbs return host arrays.  Every verb stages host arrays one way, through
``prefetch.stage_arrays``, which bumps ``observability.note_h2d_bytes``
(each staging once, a retry's included).  ``last_verb_stats`` gives the
last loop's record.

Each verb runs under ``observability.verb_span`` (its phases, the loop's
record as annotations, the always-on latency histogram); every block
leaves a flight-recorder event on its device's track (``cuda:0``) and is
attributed to the active request's ledger, as JAX's loops do.

``Executor.warmup`` (and the module-level :func:`warmup`) mirrors the
bucket plan the map verbs will run: it exports the program once per
executed size (``Program.aot_compile_raw``, one fingerprint each) and
primes every (size, device) pair by running the entry once on zero-filled
blocks, which builds or loads the kernels the program launches and seeds
the allocator.  The module-level verbs route through the planner
(``ops/planner.py``): a ``frame.lazy()`` frame, or any frame under
``TFS_PLAN=1``, records map verbs on a plan (``_lazy_target``), and the
reduce verbs and ``aggregate`` are its materialisation points
(``_lazy_frame``, ``LazyGroupedFrame``); an explicit ``engine=`` stays
eager.  Not ported (ROADMAP.md Queue 1): chunk-level streamed plans (item
11).
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import analysis, cancellation, dtypes, faults, observability
from ..device import DeviceLike, resolve_device
from ..frame import Column, TensorFrame, _column_from_cells, to_host
from ..program import Program
from ..schema import ColumnInfo
from ..shape import Shape, ShapeError, UNKNOWN
from . import (
    bucketing,
    device_pool,
    fault_tolerance,
    frame_cache,
    prefetch,
    segment_compile,
    validation,
)
from .validation import ValidationError

# the last verb's block-loop record on this thread (``last_verb_stats``)
_LAST = threading.local()


def last_verb_stats() -> Optional[Dict[str, Any]]:
    """The block-loop record of the last map verb or reduce this thread
    ran (the JAX package annotates its verb span with the same fields):
    ``verb``, ``blocks``, ``prefetch`` (``items``, ``depth``, ``stage_s``,
    ``wait_s``, ``overlap_ratio``, ``donate``) and, when a retry session
    ran, ``fault_tolerance`` (``retries``, ``oom_splits``,
    ``retry_budget_per_block``)."""
    return getattr(_LAST, "stats", None)


def _attempt(staged, restage, run):
    """One block's attempt fn for the retry session (and the single call
    without one): attempt 0 takes the prefetched ``staged`` inputs, or
    stages them, and every later attempt RE-STAGES from the host frame;
    each runs ``run`` on the program's device."""
    holder = {"staged": staged}

    def attempt(a: int, dev_i) -> Dict[str, torch.Tensor]:
        first = holder.pop("staged", None)  # at most once, ever
        if a > 0 or first is None:
            first = restage()
        return run(first.ready())

    return attempt


def _runner(program: Program, rows_level: bool):
    """The block call of a map verb: the program, or its vmapped row call."""
    return program.vmapped() if rows_level else program.call


def _padded(run, n_rows: int, pad_to: Optional[int]):
    """``run`` on a block padded to its bucket ``pad_to``: the staged real
    rows pad on their device (``bucketing.pad_rows``, so the host copies
    and the bytes staged are the real rows') and the outputs slice back to
    the ``n_rows`` real rows (row independence makes them the exact-shape
    rows, bit for bit)."""
    if pad_to is None:
        return run

    def padded(inputs):
        outs = run({k: bucketing.pad_rows(v, pad_to) for k, v in inputs.items()})
        return {k: v[:n_rows] for k, v in outs.items()}

    return padded


def _frame_fresh(frame: TensorFrame) -> bool:
    """Every column host-resident: the one freshness rule behind the
    device pool (a device-resident column stays on its device)."""
    return all(not c.is_device for c in frame.columns)


def _torch_dtype_of(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return dtypes.coerce(dtypes.from_numpy(np.asarray(a).dtype)).torch_dtype


def _annotate(span) -> None:
    """The block loop's record, just made, as annotations of the verb's
    span (JAX's loops annotate the span with the same fields)."""
    rec = _LAST.stats
    for key in ("prefetch", "device_pool", "fault_tolerance", "frame_cache"):
        if key in rec:
            span.annotate(key, rec[key])


def _record_stats(verb: str, n_blocks: int, pf, donate: bool, session) -> None:
    stage_s = pf.stats["stage_s"] if pf is not None else 0.0
    wait_s = pf.stats["wait_s"] if pf is not None else 0.0
    rec: Dict[str, Any] = {
        "verb": verb,
        "blocks": n_blocks,
        "prefetch": {
            "items": pf.stats["items"] if pf is not None else 0,
            "depth": pf.stats["depth"] if pf is not None else 0,
            "stage_s": stage_s,
            "wait_s": wait_s,
            "overlap_ratio": prefetch.overlap_ratio(stage_s, wait_s),
            "donate": donate,
        },
    }
    if session is not None:
        rec["fault_tolerance"] = session.record()
    _LAST.stats = rec


def _check_shape_hints(
    program: Program, outs: Mapping[str, Any], verb: str, cell_level: bool
) -> None:
    """Check real outputs against the program's shape hints (the run-time
    half of the ``ShapeDescription`` contract: a hint the outputs do not
    satisfy is an error).  ``cell_level``: map_rows hints describe per-row
    cell shapes; block-verb hints whole block shapes."""
    hints = program.shape_hints
    if not hints:
        return
    for name, hint in hints.items():
        if name not in outs:
            raise ValidationError(
                f"{verb}: shape hint given for {name!r}, which is not a "
                f"program output; outputs are {sorted(outs)}."
            )
        actual = Shape(tuple(outs[name].shape))
        if cell_level:
            actual = actual.tail() if actual.rank else actual
        try:
            actual.check_more_precise_than(hint, f"{verb} output {name!r}")
        except ShapeError as e:
            raise ValidationError(
                f"{verb}: output {name!r} has shape {actual}, which "
                f"contradicts the declared shape hint {hint}."
            ) from e


def _host(x: torch.Tensor):
    """A verb result on the host: a numpy array, or a CPU tensor for bf16,
    which has no numpy dtype here."""
    if x.dtype == torch.bfloat16:
        return x.detach().cpu()
    return to_host(x)


class GroupedFrame:
    """Result of ``group_by``: the ``RelationalGroupedDataset`` analog."""

    def __init__(self, frame: TensorFrame, keys: Sequence[str]):
        if not keys:
            raise ValidationError("group_by needs at least one key column")
        for k in keys:
            ci = frame.schema[k]
            if ci.cell_shape.rank != 0:
                raise ValidationError(
                    f"group_by: key column {k!r} must be scalar, has cell "
                    f"shape {ci.cell_shape}"
                )
        self.frame = frame
        self.keys = list(keys)


def group_by(frame: TensorFrame, *keys: str) -> GroupedFrame:
    if getattr(frame, "_tfs_lazy", False):
        # a LazyFrame defers its grouping to aggregate (ops/planner.py),
        # counting the grouping as one consumer
        return frame.group_by(*keys)
    return GroupedFrame(frame, keys)


def _with_prelude(program: Program, host_stage):
    """Merge the program's ``host_prelude`` (e.g. the GraphDef importer's
    in-graph Decode* stages) under any caller-supplied ``host_stage`` —
    an explicit stage wins per input."""
    prelude = getattr(program, "host_prelude", None)
    if not prelude:
        return host_stage
    merged = dict(prelude)
    merged.update(host_stage or {})
    return merged


class Executor:
    """Verb executor: blocks run one after another on the program's device
    (where its params live), or across the device pool when one resolves
    (``ops/device_pool.py``)."""

    # the device segment path of ``aggregate`` (``_aggregate_segment``);
    # an executor with it off runs the general paths for every program
    supports_segment_aggregate = True
    # the device pool (``ops/device_pool.py``); an executor with it off
    # (the planner's fused-serial target) runs host-fresh frames serially
    supports_device_pool = True

    # ---------------------------------------------------------------- map --

    def _staged_value(self, stage_fn, value, input_name: str) -> np.ndarray:
        """Run one host_stage fn over a block's cells and shape-check the
        result — the host half of the reference's binary-feed contract
        (``read_image.py:164-167`` feeds encoded bytes to an in-graph
        decoder; a device tensor cannot hold strings, so the decode runs
        here)."""
        n_rows = len(value)
        if isinstance(value, np.ndarray) and value.dtype == object:
            value = list(value)
        out = np.asarray(stage_fn(value))
        if out.ndim == 0 or out.shape[0] != n_rows:
            raise ValidationError(
                f"host_stage for input {input_name!r} returned shape "
                f"{out.shape}; expected lead dimension {n_rows} (one "
                f"preprocessed cell per input row)."
            )
        if out.dtype == object:
            raise ValidationError(
                f"host_stage for input {input_name!r} must return a uniform "
                f"numeric array, got dtype=object (ragged cells)."
            )
        return out

    def _stage_values(
        self, values: Mapping[str, tuple], device: torch.device
    ) -> prefetch.Staged:
        """Stage ``values`` (name -> ``(value, scalar type)``) on
        ``device``: host arrays through ``prefetch.stage_arrays`` (pinned
        buffers and the copy stream on CUDA), tensors (cached columns,
        chained verb outputs) in place -- at most a cast, 0 host bytes."""
        host, resident = {}, {}
        for n, (value, st) in values.items():
            if isinstance(value, torch.Tensor):
                resident[n] = value.to(device=device, dtype=st.torch_dtype)
            else:
                host[n] = (value, st.host_dtype())
        staged = (
            prefetch.stage_arrays(host, device) if host else prefetch.Staged({})
        )
        staged.tensors.update(resident)
        return staged

    def _stage_inputs(
        self,
        program: Program,
        block: Mapping[str, Any],
        infos: Mapping[str, ColumnInfo],
        device: torch.device,
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> prefetch.Staged:
        """One block's program inputs staged on ``device``; an input with a
        ``host_stage`` fn takes that fn's output over the block's cells."""
        values = {}
        for n in program.input_names:
            value = block[program.column_for_input(n)]
            if host_stage and n in host_stage:
                value = self._staged_value(host_stage[n], value, n)
                st = dtypes.coerce(dtypes.from_numpy(value.dtype))
            else:
                st = dtypes.coerce(infos[n].scalar_type)
            values[n] = (value, st)
        return self._stage_values(values, device)

    def _device_inputs(
        self,
        program: Program,
        block: Mapping[str, Any],
        infos: Mapping[str, ColumnInfo],
        device: torch.device,
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One block's program inputs on ``device``, ready to read."""
        return self._stage_inputs(program, block, infos, device, host_stage).ready()

    def map_blocks(
        self,
        program: Program,
        frame: TensorFrame,
        trim: bool = False,
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> TensorFrame:
        """``mapBlocks`` / ``mapBlocksTrimmed`` (trim=True: output row count
        may differ, no passthrough columns).  ``host_stage``: input name ->
        host fn(cells) -> [rows, *cell] array, run per block before the
        program (binary decode); the program's ``host_prelude`` is merged
        under it."""
        host_stage = _with_prelude(program, host_stage)
        with observability.verb_span("map_blocks", frame.num_rows, frame.num_blocks) as span:
            infos = validation.check_map_inputs(
                program, frame, "map_blocks", host_staged=host_stage or ()
            )
            span.mark("validate")
            if frame.num_rows == 0 and not trim:
                # empty-frame contract: a non-trimmed map of an empty frame
                # is an empty frame with the program's inferred output
                # schema — no program execution.  (A TRIMMED map still
                # applies the program to the empty block: its output row
                # count is program-defined.)
                out_blocks = [self._empty_map_outputs(program, infos, False)]
            else:
                out_blocks = self._map_dispatch(
                    program, frame, infos, False, trim, host_stage
                )
                _annotate(span)
            span.mark("dispatch")
            return self._build_map_output(frame, out_blocks, trim)

    def _map_dispatch(self, program, frame, infos, rows_level, trim,
                      host_stage=None, keep=None):
        """Run the block program (or the vmapped row program) over every
        block, checking each block's outputs: the map verbs' block loop
        (the JAX package's ``_map_dispatch``).

        Each block boundary is a cancellation checkpoint.  Blocks pad to
        their bucket (``_bucket_plan``) and the outputs slice back.  A
        sharded-cached frame runs each block on the device holding it, and
        a host-fresh multi-block frame spreads over the device pool when
        one resolves (``_map_dispatch_pooled``).  Otherwise blocks run on
        the program's device: when no program input is device-resident
        they are staged ahead by a ``prefetch.Prefetcher``
        (``TFS_PREFETCH_BLOCKS``; ``host_stage`` runs on its thread, in
        block order); a ``cache()``d frame's blocks are read in place.
        With ``TFS_BLOCK_RETRIES`` > 0 or a fault plan, each block runs
        under the frame's retry session (``ops/fault_tolerance.py``):
        transient failures re-stage and retry, a device OOM splits the
        block when that is provably safe.  ``keep``: a list a pooled run
        fills with each block's ``(device index, device outputs)``."""
        verb = "map_rows" if rows_level else "map_blocks"
        sizes = frame.block_sizes
        pads = self._bucket_plan(program, frame, infos, host_stage, rows_level, trim)
        program.note_entry(rows_level)
        cache = frame_cache.active_cache(frame)
        if cache is not None:
            return self._map_dispatch_pooled(
                program, frame, infos, rows_level, trim, host_stage, pads,
                cache.devices, cache.assignment, cache, keep,
            )
        pool_devs = (
            device_pool.pool_devices()
            if self.supports_device_pool and _frame_fresh(frame) and frame.num_blocks > 1
            else []
        )
        if len(pool_devs) >= 2:
            return self._map_dispatch_pooled(
                program, frame, infos, rows_level, trim, host_stage, pads,
                pool_devs, device_pool.assign(sizes, len(pool_devs)), None, keep,
            )
        device = program.device
        fresh = not any(
            frame.column(program.column_for_input(n)).is_device
            for n in program.input_names
        )
        session = fault_tolerance.frame_session(frame.num_blocks, verb=verb)
        donate = prefetch.donate_inputs()
        call = _runner(program, rows_level)

        def stage(bi):
            return self._stage_inputs(program, frame.block(bi), infos, device, host_stage)

        pf = prefetch.Prefetcher(stage, frame.num_blocks) if fresh else None
        items = pf if pf is not None else (None for _ in sizes)
        out_blocks = []
        track = str(device)
        with torch.no_grad():
            for bi, staged in enumerate(items):
                cancellation.checkpoint()  # block boundary
                t_blk = observability.trace_now()
                run = _padded(call, sizes[bi], pads[bi])
                attempt = _attempt(staged, functools.partial(stage, bi), run)
                if donate:
                    staged = None  # the block's inputs go back to the allocator
                if session is None:
                    outs = attempt(0, 0)
                else:
                    split = self._oom_split_closure(
                        session, program, frame, bi, infos, host_stage,
                        rows_level, trim, lambda: (device, call),
                    )
                    outs = session.run(bi, sizes[bi], attempt, device=0, oom_split=split)
                del attempt
                self._check_block_outputs(program, outs, sizes[bi], rows_level, trim)
                # the ledger-off cost: one contextvar read a block
                observability.note_request_block(0, sizes[bi])
                if t_blk is not None:
                    observability.trace_complete(
                        f"{verb} b{bi}", track, t_blk, block=bi, rows=sizes[bi]
                    )
                out_blocks.append(outs)
                del staged
        _record_stats(verb, frame.num_blocks, pf, donate, session)
        return out_blocks

    def _bucket_plan(self, program, frame, infos, host_stage, rows_level, trim):
        """Per-block bucket targets, or None per block to run the exact
        shape (the JAX package's ``_bucket_plan``).  ``map_rows`` blocks
        pad freely (the vmapped cell program makes rows independent);
        ``map_blocks`` padding needs ``analysis.rows_independent`` at every
        (real, padded) size the frame will run.  Trimmed maps and
        host-staged ``map_blocks`` inputs keep exact shapes."""
        sizes = frame.block_sizes
        none_plan: List[Optional[int]] = [None] * frame.num_blocks
        if trim or not bucketing.enabled() or (host_stage and not rows_level):
            return none_plan
        targets = [bucketing.bucket_for(n) if n > 0 else None for n in sizes]
        targets = [t if t is not None and t != sizes[bi] else None
                   for bi, t in enumerate(targets)]
        if all(t is None for t in targets):
            return none_plan
        if not rows_level:
            proof_sizes = sorted(
                {sizes[bi] for bi, t in enumerate(targets) if t is not None}
                | {t for t in targets if t is not None}
            )
            specs = analysis.input_specs_for(program, infos)
            if specs is None or not analysis.rows_independent(program, specs, proof_sizes):
                return none_plan
        return targets

    def _map_dispatch_pooled(self, program, frame, infos, rows_level, trim,
                             host_stage, pads, devices, assignment, cache, keep=None):
        """The map loop across several devices (the JAX package's
        ``_map_dispatch_pool`` and ``_map_dispatch_sharded``): block ``bi``
        runs on ``devices[assignment[bi]]``, its outputs read back to the
        host through the pool's bounded windows and reassembled by block
        index (``device_pool.PoolRun``).

        Host-fresh frames (``cache`` None) stage on one lane a device, or
        on one lane in block order when a ``host_stage`` fn runs.  A
        sharded-cached frame reads each block's shard in place on its
        device: no lanes, no host bytes for resident blocks; an evicted
        block re-stages from the host copy.  Retries and quarantine
        redirects always re-stage from the host copy, on the current
        effective device."""
        verb = "map_rows" if rows_level else "map_blocks"
        nb = frame.num_blocks
        sizes = frame.block_sizes
        pool = device_pool.PoolRun(
            devices, assignment, prefetch.prefetch_depth() or 1, affinity=cache is not None
        )
        session = fault_tolerance.frame_session(nb, verb=verb, pool=pool)
        calls: Dict[int, Any] = {}

        def call_on(di):
            if di not in calls:
                calls[di] = _runner(device_pool.program_on(program, devices[di]), rows_level)
            return calls[di]

        def stage_block(bi, dev):
            return self._stage_inputs(program, frame.block(bi), infos, dev, host_stage)

        lane_iters: List[Any] = []
        lanes: List[Any] = []
        if cache is None:
            if host_stage:
                lanes = [prefetch.Prefetcher(
                    lambda bi: stage_block(bi, devices[assignment[bi]]), nb,
                    name="tfs-pool-stage",
                )]
            else:
                lanes = device_pool.lanes(devices, assignment, stage_block)
            lane_iters = [iter(ln) for ln in lanes]
        staged_cols = {program.column_for_input(n) for n in (host_stage or {})}
        out_blocks: List[Optional[Dict[str, Any]]] = [None] * nb
        with torch.no_grad():
            for bi in range(nb):
                cancellation.checkpoint()  # block boundary (pooled loop)
                t_blk = observability.trace_now()
                di = assignment[bi]
                di_eff = pool.effective_device(di) if session is not None else di
                if cache is not None:
                    shard = cache.shard(bi) if di_eff == di else None
                    block = dict(frame.block(bi))
                    used = False
                    for cname, v in (shard or {}).items():
                        if cname not in staged_cols:
                            block[cname] = v
                            used = True
                    if used:
                        observability.note_cache_shard_hit()
                    elif session is not None and di_eff != di:
                        session.note_cache_restage()
                    staged = self._stage_inputs(program, block, infos, devices[di_eff], host_stage)
                else:
                    staged = next(lane_iters[0 if host_stage else di])
                holder = {"staged": staged}
                del staged

                def attempt(a, dev_i, _bi=bi, _di=di_eff, _h=holder):
                    ins = _h.pop("staged", None) if (a == 0 and dev_i == _di) else None
                    _h.clear()
                    if ins is None:  # a retry or a redirect: fresh host bytes
                        ins = stage_block(_bi, devices[dev_i])
                    with device_pool.device_scope(devices[dev_i]):
                        return _padded(call_on(dev_i), sizes[_bi], pads[_bi])(ins.ready())

                if session is None:
                    outs = attempt(0, di)
                else:
                    def dev_run(_di=di):
                        e = pool.effective_device(_di)
                        return devices[e], call_on(e)

                    split = self._oom_split_closure(
                        session, program, frame, bi, infos, host_stage,
                        rows_level, trim, dev_run,
                    )
                    outs = session.run(
                        bi, sizes[bi], attempt,
                        device=lambda _di=di: pool.effective_device(_di),
                        oom_split=split,
                    )
                    di_eff = pool.effective_device(di)
                self._check_block_outputs(program, outs, sizes[bi], rows_level, trim)
                if t_blk is not None:
                    observability.trace_complete(
                        f"{verb} b{bi}", pool.tracks[di_eff], t_blk, block=bi,
                        rows=sizes[bi], device=di_eff,
                    )
                if keep is not None:
                    keep[bi] = (di_eff, outs)
                pool.submit(bi, di_eff, sizes[bi], outs, out_blocks)
                del outs
            pool.finish(out_blocks)
        stage_s = sum(ln.stats["stage_s"] for ln in lanes)
        wait_s = sum(ln.stats["wait_s"] for ln in lanes)
        _LAST.stats = {
            "verb": verb,
            "blocks": nb,
            "device_pool": pool.record(stage_s, wait_s),
            **({"fault_tolerance": session.record()} if session is not None else {}),
            **({"frame_cache": cache.record()} if cache is not None else {}),
        }
        return out_blocks

    def _oom_split_closure(
        self, session, program, frame, bi, infos, host_stage, rows_level, trim,
        dev_run,
    ):
        """The OOM-degradation policy for one map-verb block: split the
        block in half and re-dispatch (recursively, floor
        ``TFS_MIN_SPLIT_ROWS``) when that is provably safe -- ``map_rows``
        is row-independent by construction, ``map_blocks`` must pass
        ``analysis.rows_independent`` at every size the split can reach.
        Trimmed maps, host-staged blocks and cross-row programs surface a
        ``BlockExecutionError`` naming the block and row range instead.
        ``dev_run()`` gives the device and the block call the halves run
        with: the program's own, or the pool's current effective one."""
        n_rows = frame.block_sizes[bi]
        verb = "map_rows" if rows_level else "map_blocks"

        def refuse(exc: BaseException, why: str):
            raise fault_tolerance.BlockExecutionError(
                f"{verb}: block {bi} rows [0, {n_rows}) exhausted device "
                f"memory and cannot degrade by splitting: {why}"
            ) from exc

        def split(exc: BaseException) -> Dict[str, torch.Tensor]:
            floor = fault_tolerance.min_split_rows()
            if trim:
                refuse(exc, "trimmed maps define their own output row count, "
                            "so half-block outputs cannot be reassembled")
            if host_stage:
                refuse(exc, "host-staged blocks stage as one unit")
            if n_rows < 2 * floor:
                refuse(exc, f"the block is already at the split floor "
                            f"(TFS_MIN_SPLIT_ROWS={floor})")
            if not rows_level:
                sizes, stack = set(), [(0, n_rows)]
                while stack:
                    lo, hi = stack.pop()
                    sizes.add(hi - lo)
                    if hi - lo >= 2 * floor:
                        mid = (lo + hi) // 2
                        stack += [(lo, mid), (mid, hi)]
                specs = analysis.input_specs_for(program, infos)
                if specs is None or not analysis.rows_independent(
                    program, specs, sorted(sizes)
                ):
                    refuse(exc, "the program is not provably row-independent "
                                "(cross-row outputs cannot be recomputed from "
                                "half blocks)")
            device, run = dev_run()
            mid = n_rows // 2
            with device_pool.device_scope(device):
                left = self._split_range(session, program, frame, bi, infos, device, run, 0, mid)
                right = self._split_range(session, program, frame, bi, infos, device, run, mid, n_rows)
            session.note_split(bi)
            return {k: torch.cat([left[k], right[k]]) for k in left}

        return split

    def _split_range(
        self, session, program, frame, bi, infos, device, run, lo: int, hi: int
    ) -> Dict[str, torch.Tensor]:
        """Dispatch rows ``[lo, hi)`` of block ``bi`` on ``device``,
        splitting again on a further OOM down to ``TFS_MIN_SPLIT_ROWS``.
        The injected-fault site is ``"split"``, so attempt-selected specs
        never re-fire on recovery work."""
        floor = fault_tolerance.min_split_rows()
        try:
            faults.maybe_inject(bi, 0, 0, hi - lo, site="split")
            sub = {k: v[lo:hi] for k, v in frame.block(bi).items()}
            return run(self._device_inputs(program, sub, infos, device))
        except BaseException as exc:  # noqa: BLE001 - OOM-only recovery
            if not faults.is_oom(exc):
                raise
            if hi - lo < 2 * floor:
                raise fault_tolerance.BlockExecutionError(
                    f"block {bi} rows [{lo}, {hi}) exhausted device memory at "
                    f"the split floor (TFS_MIN_SPLIT_ROWS={floor}); this row "
                    f"range does not fit on the device"
                ) from exc
            mid = (lo + hi) // 2
            left = self._split_range(session, program, frame, bi, infos, device, run, lo, mid)
            right = self._split_range(session, program, frame, bi, infos, device, run, mid, hi)
            session.note_split(bi)
            return {k: torch.cat([left[k], right[k]]) for k in left}

    def _check_block_outputs(
        self, program: Program, outs, n_rows: int, rows_level: bool, trim: bool
    ) -> None:
        """The non-trimmed row-count contract, the trimmed agreement
        contract (shapes print as tuples, as in the JAX package) and the
        shape-hint check."""
        verb = "map_rows" if rows_level else "map_blocks"
        if rows_level:
            pass  # row programs are per-cell; no block row-count check
        elif not trim:
            for name, v in outs.items():
                if v.ndim == 0 or v.shape[0] != n_rows:
                    raise ValidationError(
                        f"map_blocks: output {name!r} has shape "
                        f"{tuple(v.shape)} but the input block has {n_rows} "
                        f"rows; a non-trimmed map must preserve the "
                        f"row count (use map_blocks_trimmed to "
                        f"change it)."
                    )
        else:
            counts = {
                v.shape[0] if v.ndim else None for v in outs.values()
            }
            if len(counts) != 1 or None in counts:
                raise ValidationError(
                    f"map_blocks_trimmed: outputs disagree on row "
                    f"count: { {k: tuple(v.shape) for k, v in outs.items()} }"
                )
        _check_shape_hints(program, outs, verb, cell_level=rows_level)

    def _empty_map_outputs(
        self, program: Program, infos, rows_level: bool
    ) -> Dict[str, np.ndarray]:
        """Zero-row output block for the empty-frame map contract, shaped
        by ``Program.analyze`` (meta tensors: nothing runs).  A row-level
        program is analyzed at its cell shapes."""
        specs = {}
        for n in program.input_names:
            cell = tuple(infos[n].cell_shape)
            specs[n] = (
                dtypes.coerce(infos[n].scalar_type),
                cell if rows_level else (0,) + cell,
            )
        outs: Dict[str, np.ndarray] = {}
        for s in program.analyze(specs):
            if not s.is_output:
                continue
            shape = tuple(s.shape)
            if rows_level:
                shape = (0,) + shape
            elif not shape or shape[0] != 0:
                raise ValidationError(
                    f"map_blocks: output {s.name!r} has inferred shape "
                    f"{shape} for an empty block; a non-trimmed map must "
                    f"preserve the row count (use map_blocks_trimmed to "
                    f"change it)."
                )
            outs[s.name] = np.zeros(shape, dtype=s.scalar_type.host_dtype(s.name))
        return outs

    def _build_map_output(
        self,
        frame: TensorFrame,
        out_blocks: List[Dict[str, Any]],
        trim: bool,
    ) -> TensorFrame:
        out_frame = TensorFrame.from_blocks(out_blocks)
        if trim:
            return out_frame
        return self._with_passthrough(frame, list(out_frame.columns), out_frame.offsets)

    def _with_passthrough(self, frame, cols, offsets) -> TensorFrame:
        # non-trimmed: append original columns not shadowed by outputs
        # (outputs ++ original, DebugRowOps.scala:349-372; the schema
        # forbids duplicate names, so an output shadows its namesake)
        shadowed = {c.info.name for c in cols}
        for cname in frame.column_names:
            if cname not in shadowed:
                cols.append(frame.column(cname))
        return TensorFrame(cols, offsets)

    def map_rows(
        self,
        program: Program,
        frame: TensorFrame,
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> TensorFrame:
        """``mapRows`` (``DebugRowOps.scala:396-477``): the program is written
        at *cell* level and vmapped over each block's rows.  Ragged input
        columns run one vmapped call per distinct row shape
        (``_map_rows_ragged``).  ``host_stage`` as for :meth:`map_blocks`."""
        host_stage = _with_prelude(program, host_stage)
        with observability.verb_span("map_rows", frame.num_rows, frame.num_blocks) as span:
            infos = validation.check_map_inputs(
                program, frame, "map_rows", host_staged=host_stage or (),
                allow_ragged=True,
            )
            span.mark("validate")
            ragged = [
                n for n in program.input_names
                if not (host_stage and n in host_stage)
                and frame.column(program.column_for_input(n)).is_ragged
            ]
            if ragged:
                out = self._map_rows_ragged(program, frame, infos, ragged, host_stage)
                span.mark("dispatch")
                return out
            if frame.num_rows == 0:
                out_blocks = [self._empty_map_outputs(program, infos, True)]
            else:
                out_blocks = self._map_dispatch(
                    program, frame, infos, True, False, host_stage
                )
                _annotate(span)
            span.mark("dispatch")
            return self._build_map_output(frame, out_blocks, trim=False)

    def _ragged_pad_ok(self, program, ragged_name, rcells, uniform, sizes) -> bool:
        """Whether the single ragged input's cells may pad along their lead
        (ragged) axis: the shared gate ``analysis.rows_independent`` posed
        on the CELL program, the ragged axis as the lead dim, at the exact
        (real, bucketed) lengths, with every uniform input bound as a param
        (constant within a row).  A program that reduces, sorts or flips
        along the ragged axis fails and keeps exact per-shape buckets."""
        rest = {c.shape[1:] for c in rcells}
        if len(rest) != 1:
            return False  # trailing dims ragged too: exact buckets
        cell_rest = rest.pop()
        dt = dtypes.coerce(dtypes.from_numpy(np.asarray(rcells[0]).dtype)).torch_dtype
        key = (
            "ragged-pad", ragged_name, tuple(sorted(sizes)), cell_rest, str(dt),
            tuple(sorted((u, tuple(np.shape(a)[1:]), str(a.dtype)) for u, a in uniform.items())),
        )
        memo = segment_compile.derived(program)
        if key in memo:
            return memo[key]
        try:
            dummies = {
                u: torch.zeros(tuple(np.shape(a)[1:]), dtype=_torch_dtype_of(a))
                for u, a in uniform.items()
            }
            probe = Program(
                program._fn, program.input_names + list(program.params),
                program._declared_fetches, None, {**program.params, **dummies},
                device=program.device,
            )
            ok = analysis.rows_independent(probe, {ragged_name: (dt, cell_rest)}, sizes)
        except analysis.AnalysisXCheckError:
            raise
        except Exception:  # noqa: BLE001 - an unposable proof proves nothing
            ok = False
        memo[key] = ok
        return ok

    def _map_rows_ragged(
        self,
        program: Program,
        frame: TensorFrame,
        infos: Mapping[str, ColumnInfo],
        ragged_names: Sequence[str],
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> TensorFrame:
        """Ragged ``map_rows`` by shape-bucketing: rows are grouped by their
        concrete cell shapes and each group runs as ONE vmapped call, in
        sorted shape order.  When the program is provably elementwise along
        the ragged axis (``_ragged_pad_ok``, one ragged input), rows group
        by the geometric bucket of their ragged length instead
        (``bucketing.bucket_for``): each cell pads to the bucket by edge
        repetition and each output row slices back to its own length, so
        O(log max length) calls replace one a distinct length."""
        n = frame.num_rows
        device = program.device
        cells: Dict[str, List[np.ndarray]] = {}
        uniform: Dict[str, Any] = {}
        for in_name in program.input_names:
            col = frame.column(program.column_for_input(in_name))
            st = dtypes.coerce(infos[in_name].scalar_type)
            if host_stage and in_name in host_stage:
                staged = self._staged_value(host_stage[in_name], col.cells(), in_name)
                uniform[in_name] = (
                    staged, dtypes.coerce(dtypes.from_numpy(staged.dtype))
                )
            elif in_name in ragged_names:
                cells[in_name] = [
                    np.asarray(c).astype(st.host_dtype(), copy=False)
                    for c in col.cells()
                ]
            else:
                uniform[in_name] = (col.data, st)
        # cell-axis bucket padding: one ragged input, pads proven safe
        pad_lengths: Dict[int, int] = {}
        if bucketing.enabled() and len(ragged_names) == 1:
            r = ragged_names[0]
            lengths = sorted({c.shape[0] for c in cells[r] if c.shape[0] > 0})
            targets = {d: bucketing.bucket_for(d) for d in lengths}
            if any(t != d for d, t in targets.items()):
                proof_sizes = sorted(set(lengths) | set(targets.values()))
                if self._ragged_pad_ok(
                    program, r, cells[r], {u: v for u, (v, _st) in uniform.items()},
                    proof_sizes,
                ):
                    pad_lengths = {d: t for d, t in targets.items() if t != d}
        buckets: Dict[tuple, List[int]] = {}
        for i in range(n):
            key = tuple(
                (pad_lengths.get(cells[r][i].shape[0], cells[r][i].shape[0]),)
                + cells[r][i].shape[1:]
                for r in ragged_names
            )
            buckets.setdefault(key, []).append(i)
        run = program.vmapped()
        out_cells: Dict[str, List[Any]] = {}
        with torch.no_grad():
            for key in sorted(buckets):
                idxs = np.asarray(buckets[key])
                target = key[0][0] if pad_lengths else None
                values = {
                    r: (np.stack([
                        bucketing.pad_rows(cells[r][i], target) if target is not None
                        else cells[r][i] for i in idxs
                    ]), dtypes.coerce(infos[r].scalar_type))
                    for r in ragged_names
                }
                for u, (data, st) in uniform.items():
                    rows = (data[torch.as_tensor(idxs, device=data.device)]
                            if isinstance(data, torch.Tensor) else data[idxs])
                    values[u] = (rows, st)
                outs = run(self._stage_values(values, device).ready())
                hosts = {name: to_host(v, name) for name, v in outs.items()}
                for name in hosts:
                    if name not in out_cells:
                        out_cells[name] = [None] * n
                if not pad_lengths:
                    _check_shape_hints(program, outs, "map_rows", cell_level=True)
                    for name, host in hosts.items():
                        col_cells = out_cells[name]
                        for j, i in enumerate(idxs):
                            col_cells[i] = host[j]
                    continue
                # a padded bucket: every output tracks the ragged axis on
                # dim 0 (the proof guarantees it); slice each row back to
                # its own length and hint-check once per distinct length
                checked: set = set()
                for j, i in enumerate(idxs):
                    d = cells[ragged_names[0]][i].shape[0]
                    row = {name: host[j][:d] if d < host[j].shape[0] else host[j]
                           for name, host in hosts.items()}
                    if program.shape_hints and d not in checked:
                        _check_shape_hints(
                            program, {name: torch.as_tensor(c)[None] for name, c in row.items()},
                            "map_rows", cell_level=True,
                        )
                        checked.add(d)
                    for name, c in row.items():
                        out_cells[name][i] = c
        _LAST.stats = {"verb": "map_rows", "blocks": frame.num_blocks,
                       "ragged_buckets": len(buckets), "padded": bool(pad_lengths)}
        cols = [
            _column_from_cells(name, out_cells[name]) for name in sorted(out_cells)
        ]
        return self._with_passthrough(frame, cols, frame.offsets)

    # ------------------------------------------------------------- warmup --

    def warmup(
        self,
        program: Program,
        frame: TensorFrame,
        rows_level: bool = False,
        host_stage: Optional[Mapping[str, Any]] = None,
    ) -> List[str]:
        """Export and prime what the map verbs will actually run over
        ``frame``, returning one fingerprint per executed size (the JAX
        package's ``Executor.warmup``).

        "Actually": the sizes come from the same :meth:`_bucket_plan` the
        verbs use, so a row-independent program gives one fingerprint per
        bucketed size and a cross-row one one per distinct block size.  Each
        size is exported once (``Program.aot_compile_raw``: the graph and
        its fingerprint; with ``TFS_COMPILE_CACHE`` the artifact is saved
        there).  Then every (size, device) pair runs the entry once on
        zero-filled blocks, under ``suppress_trace_count``: that builds or
        loads every kernel the program launches (``nvcc``, or a library
        from the compile cache) and seeds the caching allocator, so the
        first real block pays neither.  The devices are the sharded
        cache's, or the pool's for a host-fresh multi-block frame, else the
        program's.  ``host_stage`` inputs are probed on one row to learn
        the staged cell shape; ragged ``map_rows`` inputs raise (their
        shapes depend on the data)."""
        host_stage = _with_prelude(program, host_stage)
        verb = "map_rows" if rows_level else "map_blocks"
        if rows_level and any(
            frame.column(program.column_for_input(n)).is_ragged
            and not (host_stage and n in host_stage)
            for n in program.input_names
        ):
            raise ValidationError(
                "warmup: ragged columns are not supported; ragged map_rows "
                "calls are keyed by the data's cell shapes, so they build "
                "at first use."
            )
        infos = validation.check_map_inputs(
            program, frame, verb, host_staged=host_stage or ()
        )
        staged_specs: Dict[str, Tuple[Any, Tuple[int, ...]]] = {}
        if host_stage:
            block0 = frame.block(0)
            for n in program.input_names:
                if n in host_stage:
                    value = block0[program.column_for_input(n)][:1]
                    arr = self._staged_value(host_stage[n], value, n)
                    staged_specs[n] = (
                        dtypes.coerce(dtypes.from_numpy(arr.dtype)), arr.shape[1:]
                    )
        pads = self._bucket_plan(program, frame, infos, host_stage, rows_level, False)
        exec_sizes = sorted({
            pads[bi] if pads[bi] is not None else n
            for bi, n in enumerate(frame.block_sizes) if n > 0
        })

        def specs_at(n_rows):
            out = {}
            for n in program.input_names:
                if n in staged_specs:
                    st, cell = staged_specs[n]
                else:
                    st, cell = dtypes.coerce(infos[n].scalar_type), tuple(infos[n].cell_shape)
                out[n] = (st, (n_rows,) + tuple(cell))
            return out

        raw = program._raw_entry(rows_level)
        fps = [
            program.aot_compile_raw(raw, specs_at(n), ("aot", bool(rows_level))).fingerprint
            for n in exec_sizes
        ]
        cache = frame_cache.active_cache(frame)
        if cache is not None:
            devices = [cache.devices[di] for di in sorted(set(cache.assignment))]
        else:
            pool = (
                device_pool.pool_devices()
                if self.supports_device_pool and _frame_fresh(frame) and frame.num_blocks > 1
                else []
            )
            devices = pool if len(pool) >= 2 else [program.device]
        with torch.no_grad(), observability.suppress_trace_count():
            for n_rows in exec_sizes:
                for dev in devices:
                    call = _runner(device_pool.program_on(program, dev), rows_level)
                    zeros = {
                        n: torch.zeros(shape, dtype=st.torch_dtype, device=dev)
                        for n, (st, shape) in specs_at(n_rows).items()
                    }
                    with device_pool.device_scope(dev):
                        call(zeros)
        program.note_entry(rows_level)
        return fps

    # ------------------------------------------------------------- reduce --

    def _pair_call(self, program: Program, bases: Sequence[str]):
        def pairfn(left: Dict[str, Any], right: Dict[str, Any], params):
            inputs = {}
            for b in bases:
                inputs[f"{b}_1"] = left[b]
                inputs[f"{b}_2"] = right[b]
            return program.call(inputs, params)

        return pairfn

    def _tree_fold(
        self, pairfn, arrays: Dict[str, torch.Tensor], params
    ) -> Dict[str, torch.Tensor]:
        """Balanced deterministic tree fold over the lead axis: each level
        combines the first half with the second in one vmapped call, the
        odd last row appended unchanged (JAX's fold shape)."""
        vpair = torch.func.vmap(pairfn, in_dims=(0, 0, None))
        n = next(iter(arrays.values())).shape[0]
        while n > 1:
            half = n // 2
            left = {k: v[:half] for k, v in arrays.items()}
            right = {k: v[half : 2 * half] for k, v in arrays.items()}
            combined = vpair(left, right, params)
            if n % 2:
                combined = {
                    k: torch.cat([v, arrays[k][2 * half :]])
                    for k, v in combined.items()
                }
            arrays, n = combined, n - half
        if n == 0:
            raise ValidationError("cannot pairwise-fold zero rows")
        return {k: v[0] for k, v in arrays.items()}

    def _seq_fold(
        self, pairfn, arrays: Dict[str, torch.Tensor], params
    ) -> Dict[str, torch.Tensor]:
        """Left fold in row order: the reference's sequential pairwise
        reduction (``performReducePairwise``, ``DebugRowOps.scala:930-969``);
        JAX runs it as a ``lax.scan``, here one call per row."""
        n = next(iter(arrays.values())).shape[0]
        carry = {k: v[0] for k, v in arrays.items()}
        for i in range(1, n):
            carry = pairfn(carry, {k: v[i] for k, v in arrays.items()}, params)
        return carry

    def _reduce_rows_setup(self, program: Program, frame: TensorFrame, mode: str):
        """Pre-flight of reduce_rows: checks the pairwise contract and
        returns ``(bases, reduced, run_for)``, where ``run_for(program)``
        folds a dict of block arrays down to one cell each with that
        program (the verb's own, or its copy on a pool device)."""
        if frame.num_rows == 0:
            raise ValidationError(
                "reduce_rows: cannot reduce an empty frame (no identity "
                "element is available for an arbitrary pairwise program)"
            )
        reduced = validation.check_reduce_rows(program, frame)
        bases = sorted(reduced)
        summaries = program.analyze(
            {
                f"{b}_{i}": (
                    dtypes.coerce(reduced[b].scalar_type),
                    tuple(reduced[b].cell_shape),
                )
                for b in bases
                for i in (1, 2)
            }
        )
        validation.check_reduce_rows_outputs(reduced, summaries)
        if mode not in ("tree", "sequential"):
            raise ValidationError(
                f"reduce_rows: unknown mode {mode!r}; use 'tree' or "
                f"'sequential'"
            )
        fold = self._tree_fold if mode == "tree" else self._seq_fold

        def run_for(prog):
            pairfn = self._pair_call(prog, bases)
            return lambda arrs: fold(pairfn, arrs, prog.params)

        return bases, reduced, run_for

    def reduce_rows(
        self, program: Program, frame: TensorFrame, mode: str = "tree"
    ) -> Dict[str, Any]:
        """``reduceRows`` (``DebugRowOps.scala:479-501``): pairwise-fold all
        rows of the named columns down to one row."""
        with observability.verb_span("reduce_rows", frame.num_rows, frame.num_blocks) as span:
            bases, reduced, run_for = self._reduce_rows_setup(program, frame, mode)
            span.mark("validate")
            return self._reduce(program, run_for, bases, reduced, frame, span)

    def _reduce(self, program, run_for, bases, reduced, frame, span) -> Dict[str, Any]:
        """The reduce verbs' body after validation: the partials (phase
        ``dispatch_partials``), the one combine (``dispatch``) and the host
        readback (``sync``)."""
        with torch.no_grad():
            partials = self._reduce_partials(program, run_for, bases, reduced, frame)
            _annotate(span)
            span.mark("dispatch_partials")
            final = self._combine_partials(run_for(program), bases, partials)
            span.mark("dispatch")
        out = {b: _host(final[b]) for b in bases}
        span.mark("sync")
        return out

    def _combine_partials(
        self, run, bases, partials: List[Dict[str, torch.Tensor]]
    ) -> Dict[str, torch.Tensor]:
        """The ONE final-combine shape of the reduce verbs: stack every
        per-block partial in block order and apply ``run`` once.  So a
        reduce over a frame is the same fold for any execution of its
        blocks, bit for bit."""
        if len(partials) == 1:
            return partials[0]
        stacked = {b: torch.stack([p[b] for p in partials]) for b in bases}
        return run(stacked)

    def _reduce_partials(
        self, program, run_for, bases, reduced, frame: TensorFrame
    ) -> List[Dict[str, torch.Tensor]]:
        """Per-block partials for the reduce verbs, in block order; empty
        blocks are skipped (``DebugRowOps.scala:489-499``).  The block loop
        of the map verbs without the split: host blocks are prefetched,
        each boundary is a cancellation checkpoint, and a retry session
        re-stages and retries transient failures (a partial is cross-row
        by definition, so an OOM surfaces with the block's row range).  A
        sharded-cached frame, or a host-fresh one under the device pool,
        folds each block on its device (``_reduce_partials_pooled``)."""
        sts = {b: dtypes.coerce(reduced[b].scalar_type) for b in bases}
        # base -> the RESOLVED source column (a feed-dict rename)
        cols = {b: reduced[b].name for b in bases}
        sizes = frame.block_sizes
        nonempty = [bi for bi in range(frame.num_blocks) if sizes[bi]]
        cache = frame_cache.active_cache(frame)
        if cache is not None and len(nonempty) > 1:
            return self._reduce_partials_pooled(
                program, run_for, bases, sts, cols, frame, nonempty,
                cache.devices, [cache.assignment[bi] for bi in nonempty], cache,
            )
        pool_devs = (
            device_pool.pool_devices()
            if self.supports_device_pool and len(nonempty) > 1 and _frame_fresh(frame)
            else []
        )
        if len(pool_devs) >= 2:
            return self._reduce_partials_pooled(
                program, run_for, bases, sts, cols, frame, nonempty, pool_devs,
                device_pool.assign([sizes[bi] for bi in nonempty], len(pool_devs)),
                None,
            )
        run = run_for(program)
        device = program.device
        session = fault_tolerance.frame_session(frame.num_blocks, verb="reduce")
        donate = prefetch.donate_inputs()

        def stage(j):
            block = frame.block(nonempty[j])
            return self._stage_values(
                {b: (block[cols[b]], sts[b]) for b in bases}, device
            )

        fresh = not any(frame.column(cols[b]).is_device for b in bases)
        pf = prefetch.Prefetcher(stage, len(nonempty)) if fresh else None
        items = pf if pf is not None else (None for _ in nonempty)
        partials = []
        track = str(device)
        for j, staged in enumerate(items):
            cancellation.checkpoint()  # block boundary (partials)
            t_blk = observability.trace_now()
            bi = nonempty[j]
            attempt = _attempt(staged, functools.partial(stage, j), run)
            del staged
            if session is None:
                partials.append(attempt(0, 0))
            else:
                partials.append(session.run(bi, sizes[bi], attempt, device=0))
            observability.note_request_block(0, sizes[bi])
            if t_blk is not None:
                observability.trace_complete(
                    f"reduce b{bi}", track, t_blk, block=bi, rows=sizes[bi]
                )
        _record_stats("reduce", frame.num_blocks, pf, donate, session)
        return partials

    def _reduce_partials_pooled(
        self, program, run_for, bases, sts, cols, frame, nonempty, devices,
        assignment, cache,
    ) -> List[Dict[str, torch.Tensor]]:
        """Partials folded on several devices (the JAX package's pooled and
        sharded partials): the ``k``-th nonempty block folds on
        ``devices[assignment[k]]``, from its cached shard in place when it
        has one there, else staged on that device's lane (host-fresh) or
        inline from the host copy (an evicted block).  Every partial then
        moves, in block order, to the program's device, so the caller's one
        ``_combine_partials`` fold is the serial fold bit for bit.  Retries
        and quarantine redirects re-stage from the host copy on the current
        effective device."""
        sizes = frame.block_sizes
        pool = device_pool.PoolRun(
            devices, assignment, prefetch.prefetch_depth() or 1, affinity=cache is not None
        )
        session = fault_tolerance.frame_session(frame.num_blocks, verb="reduce", pool=pool)
        runs: Dict[int, Any] = {}

        def run_on(di, arrs):
            if di not in runs:
                runs[di] = run_for(device_pool.program_on(program, devices[di]))
            with device_pool.device_scope(devices[di]):
                return runs[di](arrs.ready())

        def stage_block(k, dev, shard=None):
            block = frame.block(nonempty[k])
            return self._stage_values(
                {b: ((shard or {}).get(cols[b], block[cols[b]]), sts[b]) for b in bases}, dev
            )

        lanes = [] if cache is not None else device_pool.lanes(devices, assignment, stage_block)
        lane_iters = [iter(ln) for ln in lanes]
        combine = program.device
        partials = []
        with torch.no_grad():
            for k, bi in enumerate(nonempty):
                cancellation.checkpoint()  # block boundary (pooled partials)
                t_blk = observability.trace_now()
                di = assignment[k]
                if cache is not None:
                    shard = cache.shard(bi)
                    used = shard is not None and any(cols[b] in shard for b in bases)
                    staged = stage_block(k, devices[di], shard if used else None)
                else:
                    used, staged = False, next(lane_iters[di])
                holder = {"staged": staged}
                del staged
                hit = {"v": False}

                def attempt(a, dev_i, _k=k, _h=holder, _di=di, _used=used, _hit=hit):
                    arrs = _h.pop("staged", None) if (a == 0 and dev_i == _di) else None
                    _h.clear()
                    _hit["v"] = arrs is not None and _used
                    if arrs is None:
                        arrs = stage_block(_k, devices[dev_i])
                    return run_on(dev_i, arrs)

                if session is None:
                    p = attempt(0, di)
                    di_eff = di
                else:
                    p = session.run(bi, sizes[bi], attempt,
                                    device=lambda _di=di: pool.effective_device(_di))
                    di_eff = pool.effective_device(di)
                    if used and not hit["v"]:
                        session.note_cache_restage()
                if hit["v"]:
                    observability.note_cache_shard_hit()
                pool.note_dispatch(di_eff, sizes[bi])
                if t_blk is not None:
                    observability.trace_complete(
                        f"reduce b{bi}", pool.tracks[di_eff], t_blk, block=bi,
                        rows=sizes[bi], device=di_eff, shard_hit=hit["v"],
                    )
                partials.append({b: p[b].to(combine) for b in bases})
        _LAST.stats = {
            "verb": "reduce",
            "blocks": frame.num_blocks,
            "device_pool": pool.record(
                sum(ln.stats["stage_s"] for ln in lanes), sum(ln.stats["wait_s"] for ln in lanes)
            ),
            **({"fault_tolerance": session.record()} if session is not None else {}),
            **({"frame_cache": cache.record()} if cache is not None else {}),
        }
        return partials

    def _reduce_blocks_setup(
        self, program: Program, frame: TensorFrame, verb: str = "reduce_blocks"
    ):
        """Pre-flight of reduce_blocks: checks the x_input contract and
        returns ``(bases, reduced, run_for)``, where ``run_for(program)``
        applies that program to a dict of block arrays keyed by base
        column name."""
        if frame.num_rows == 0:
            raise ValidationError(
                f"{verb}: cannot reduce an empty frame (no identity "
                f"element is available for an arbitrary block program)"
            )
        reduced = validation.check_reduce_blocks(program, frame, verb=verb)
        bases = sorted(reduced)
        # analyze at an arbitrary static block size to validate the contract
        probe = max(frame.block_sizes) or 1
        summaries = program.analyze(
            {
                f"{b}_input": (
                    dtypes.coerce(reduced[b].scalar_type),
                    (probe,) + tuple(reduced[b].cell_shape),
                )
                for b in bases
            }
        )
        validation.check_reduce_blocks_outputs(reduced, summaries, verb=verb)

        def run_for(prog):
            return lambda arrs: prog.call({f"{b}_input": arrs[b] for b in bases})

        return bases, reduced, run_for

    def reduce_blocks(
        self, program: Program, frame: TensorFrame
    ) -> Dict[str, Any]:
        """``reduceBlocks`` (``DebugRowOps.scala:503-526``): phase 1 reduces
        each block to one row with the user's block program; phase 2 applies
        the same program once to the stacked per-block partials."""
        with observability.verb_span("reduce_blocks", frame.num_rows, frame.num_blocks) as span:
            bases, reduced, run_for = self._reduce_blocks_setup(program, frame)
            span.mark("validate")
            return self._reduce(program, run_for, bases, reduced, frame, span)

    # ---------------------------------------------------------- aggregate --

    def _run_groups(self, vrun, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run the vmapped block program over one [groups, size, *cell]
        bucket (one device dispatch)."""
        return vrun(batch)

    def aggregate(self, program: Program, grouped: GroupedFrame) -> TensorFrame:
        """``aggregate`` (``DebugRowOps.scala:547-592`` + ``TensorFlowUDAF``
        L601-695): apply the x_input block program once per key group.

        The group index is built on the host; groups are bucketed by
        cardinality and each bucket runs as ONE vmapped call over all its
        groups (at most 8 distinct sizes), or, for skewed sizes, a pairwise
        combine tree over row partials runs in O(log max size) calls.  The
        result has one row per group, keys in sorted order, then the
        reduced columns."""
        with observability.verb_span(
            "aggregate", grouped.frame.num_rows, grouped.frame.num_blocks
        ) as span:
            return self._aggregate_impl(program, grouped, span)

    def _aggregate_impl(self, program: Program, grouped: GroupedFrame, span) -> TensorFrame:
        """The body of :meth:`aggregate`, phases ``validate_and_group_index``
        and ``execute`` (the segment path: ``group_index_device`` and
        ``execute``)."""
        frame = grouped.frame
        reduced = validation.check_reduce_blocks(program, frame, verb="aggregate")
        bases = sorted(reduced)
        for k in grouped.keys:
            if k in reduced:
                raise ValidationError(
                    f"aggregate: column {k!r} is both a grouping key and a "
                    f"reduced column"
                )
        if frame.num_rows == 0:
            out = self._aggregate_empty(program, grouped, reduced, bases)
            span.mark("validate_and_group_index")
            return out

        # --- the device segment path (a recognized plan) ---
        seg = self._aggregate_segment(program, grouped, reduced, bases, span)
        if seg is not None:
            return seg

        # --- host-side group index (the shuffle replacement) ---
        key_cells = list(frame.select(grouped.keys).to_arrays().values())
        if len(key_cells) == 1:
            uniq, inverse = np.unique(key_cells[0], return_inverse=True)
            uniq_cols = [uniq]
        else:
            stacked = np.rec.fromarrays(key_cells)
            uniq, inverse = np.unique(stacked, return_inverse=True)
            uniq_cols = [np.asarray(uniq[name]) for name in uniq.dtype.names]
        inverse = inverse.reshape(-1)
        num_groups = len(uniq_cols[0])
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse, minlength=num_groups)
        starts = np.zeros(num_groups, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])

        # validate the block-reduction contract at the largest group size
        probe = int(counts.max())
        summaries = program.analyze(
            {
                f"{b}_input": (
                    dtypes.coerce(reduced[b].scalar_type),
                    (probe,) + tuple(reduced[b].cell_shape),
                )
                for b in bases
            }
        )
        validation.check_reduce_blocks_outputs(reduced, summaries, verb="aggregate")
        span.mark("validate_and_group_index")

        # --- data columns on the device, reordered so groups are contiguous
        device = program.device
        staged = self._stage_values(
            {
                b: (frame.column(reduced[b].name).data,
                    dtypes.coerce(reduced[b].scalar_type))
                for b in bases
            },
            device,
        ).ready()
        order_t = torch.as_tensor(order, device=device)
        data = {b: staged[b][order_t] for b in bases}

        def vrun(arrs):
            return torch.func.vmap(
                lambda a: program.call({f"{b}_input": a[b] for b in bases})
            )(arrs)

        by_size = {int(size): np.nonzero(counts == size)[0] for size in np.unique(counts)}
        with torch.no_grad():
            if len(by_size) <= 8:
                results = self._aggregate_bucketed(
                    vrun, bases, data, starts, by_size, num_groups
                )
            else:
                results = self._aggregate_tree(
                    vrun, bases, data,
                    np.repeat(np.arange(num_groups, dtype=np.int64), counts),
                    num_groups,
                )
        span.mark("execute")

        # --- one-block result: keys ++ outputs, one row per group ---
        cols: List[Column] = []
        for kname, kvals in zip(grouped.keys, uniq_cols):
            st = dtypes.from_numpy(kvals.dtype)
            info = ColumnInfo(kname, st, Shape(kvals.shape).with_lead(UNKNOWN))
            cols.append(Column(info, kvals))
        for b in bases:
            arr = results[b]
            st = dtypes.from_torch(arr.dtype)
            info = ColumnInfo(b, st, Shape(tuple(arr.shape)).with_lead(UNKNOWN))
            cols.append(Column(info, arr))
        return TensorFrame(cols)

    def _aggregate_segment(self, program, grouped, reduced, bases, span) -> Optional[TensorFrame]:
        """The device segment path (the JAX package's ``_aggregate_segment``):
        when ``segment_compile.recognize`` compiles the program into a
        :class:`~.segment_compile.SegmentPlan`, the whole keyed reduction
        runs on the program's device:

        * one stable lexicographic sort over the key columns (a stable
          sort a key, last key first), float keys canonicalised first
          (-0.0 -> +0.0, every NaN -> one NaN) and compared by bit pattern,
          so the groups and their order are ``np.unique``'s, NaN last;
        * the plan's row stage over the columns, gathered into key order;
        * one segmented reduction a reduce over the contiguous runs
          (``torch.segment_reduce`` on lengths for floats, exact integer
          ``scatter_reduce`` for ints): no float atomics, so the result is
          the same bits on every run;
        * the plan's group stage, vmapped over the groups.

        The one host sync is the group count.  Returns None (the general
        paths run) for programs the recognizer refuses, ragged or
        host-only columns, and key types other than int, bool and float;
        an executor with ``supports_segment_aggregate = False`` skips it."""
        if not self.supports_segment_aggregate:
            return None
        frame = grouped.frame
        n = frame.num_rows
        if n == 0 or n >= np.iinfo(np.int32).max:
            return None
        for kname in grouped.keys:
            kcol = frame.column(kname)
            kst = kcol.info.scalar_type
            if (kcol.is_ragged or not kst.device_ok or kst.torch_dtype is None
                    or kst.torch_dtype.is_complex or dtypes.coerce(kst) is not kst):
                return None
        for b in bases:
            col = frame.column(reduced[b].name)
            if col.is_ragged or not col.info.scalar_type.device_ok:
                return None
        specs = {
            f"{b}_input": (dtypes.coerce(reduced[b].scalar_type).torch_dtype,
                           tuple(reduced[b].cell_shape))
            for b in bases
        }
        plan = _recognize_segment_plan(program, specs, bases)
        if plan is None:
            return None
        device = program.device
        values = {
            f"key:{k}": (frame.column(k).data, frame.column(k).info.scalar_type)
            for k in grouped.keys
        }
        values.update({
            f"{b}_input": (frame.column(reduced[b].name).data, dtypes.coerce(reduced[b].scalar_type))
            for b in bases
        })
        with torch.no_grad():
            staged = self._stage_values(values, device).ready()
            uniq, order, counts = _segment_index([staged[f"key:{k}"] for k in grouped.keys])
            span.mark("group_index_device")
            pre = plan.pre({f"{b}_input": staged[f"{b}_input"] for b in bases}, program.params)
            segs = [_segment_reduce(pc[order], kind, counts)
                    for pc, kind in zip(pre, plan.reduce_kinds)]
            outs = plan.post(segs, counts, program.params)
        span.mark("execute")
        cols: List[Column] = []
        for kname, kvals in zip(grouped.keys, uniq):
            kinfo = frame.column(kname).info
            cols.append(Column(
                ColumnInfo(kname, kinfo.scalar_type, Shape(tuple(kvals.shape)).with_lead(UNKNOWN)),
                kvals,
            ))
        for b in bases:
            arr = outs[b]
            info = ColumnInfo(b, dtypes.from_torch(arr.dtype),
                              Shape(tuple(arr.shape)).with_lead(UNKNOWN))
            cols.append(Column(info, arr))
        return TensorFrame(cols)

    def _aggregate_empty(self, program, grouped, reduced, bases) -> TensorFrame:
        """Empty-frame contract: zero groups, so an empty result frame with
        the key columns and the program's inferred output cells; the
        block-reduction contract is still validated (a broken program fails
        the same way on 0 rows as on N)."""
        frame = grouped.frame
        summaries = program.analyze(
            {
                f"{b}_input": (
                    dtypes.coerce(reduced[b].scalar_type),
                    (1,) + tuple(reduced[b].cell_shape),
                )
                for b in bases
            }
        )
        validation.check_reduce_blocks_outputs(reduced, summaries, verb="aggregate")
        cols = []
        for kname in grouped.keys:
            kst = frame.schema[kname].scalar_type
            kdata = np.zeros((0,), dtype=kst.host_dtype(kname))
            cols.append(Column(ColumnInfo(kname, kst, Shape((UNKNOWN,))), kdata))
        for s in summaries:
            if not s.is_output:
                continue
            arr = np.zeros((0,) + tuple(s.shape), dtype=s.scalar_type.host_dtype(s.name))
            info = ColumnInfo(s.name, s.scalar_type, Shape(arr.shape).with_lead(UNKNOWN))
            cols.append(Column(info, arr))
        return TensorFrame(cols)

    def _aggregate_bucketed(
        self, vrun, bases, data, starts, by_size, num_groups
    ) -> Dict[str, torch.Tensor]:
        """One vmapped call per distinct group size; the gather indices of a
        bucket are one broadcast add."""
        out: Dict[str, Optional[torch.Tensor]] = {b: None for b in bases}
        for size, gids in sorted(by_size.items()):
            gather = starts[gids][:, None] + np.arange(size, dtype=np.int64)
            gather_t = torch.as_tensor(gather, device=next(iter(data.values())).device)
            outs = self._run_groups(vrun, {b: data[b][gather_t] for b in bases})
            for b in bases:
                v = outs[b]
                if out[b] is None:
                    out[b] = torch.empty(
                        (num_groups,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device
                    )
                out[b][torch.as_tensor(gids, device=v.device)] = v
        return out

    def _aggregate_tree(
        self, vrun, bases, data, gid, num_groups
    ) -> Dict[str, torch.Tensor]:
        """Pairwise combine tree over row partials: each level pairs adjacent
        same-group partials and runs ONE vmapped 2-row reduction over all
        pairs (the pair count padded to a power of two; pad pairs are
        computed and dropped).  Level 0 seeds every row as ``f([x])``, so
        partials are always program outputs (the reference UDAF's
        init-then-merge contract, ``DebugRowOps.scala:658-676``)."""
        dev = next(iter(data.values())).device
        parts = self._run_groups(vrun, {b: data[b][:, None] for b in bases})
        while len(gid) > num_groups:
            new_seg = np.nonzero(np.diff(gid))[0] + 1
            starts_at = np.zeros(len(gid), dtype=np.int64)
            starts_at[new_seg] = new_seg
            np.maximum.accumulate(starts_at, out=starts_at)
            pos = np.arange(len(gid), dtype=np.int64) - starts_at
            counts = np.bincount(gid, minlength=num_groups)[gid]
            left = np.nonzero((pos % 2 == 0) & (pos + 1 < counts))[0]
            right = left + 1
            passthrough = np.nonzero((pos % 2 == 0) & (pos + 1 >= counts))[0]
            p = len(left)
            p_pad = 1 << max(p - 1, 0).bit_length() if p else 0
            li = torch.as_tensor(np.concatenate([left, np.repeat(left[-1:], p_pad - p)]), device=dev)
            ri = torch.as_tensor(np.concatenate([right, np.repeat(right[-1:], p_pad - p)]), device=dev)
            pt = torch.as_tensor(passthrough, device=dev)
            outs = self._run_groups(
                vrun, {b: torch.stack([parts[b][li], parts[b][ri]], dim=1) for b in bases}
            )
            new_gid = np.concatenate([gid[left], gid[passthrough]])
            order = np.argsort(new_gid, kind="stable")
            order_t = torch.as_tensor(order, device=dev)
            parts = {
                b: torch.cat([outs[b][:p], parts[b][pt]])[order_t] for b in bases
            }
            gid = new_gid[order]
        # gid is sorted and exactly one partial per group remains
        return parts


def _recognize_segment_plan(program: Program, specs, bases):
    """The program's :class:`~.segment_compile.SegmentPlan`, or None,
    memoized on the program by input signature."""
    key = ("segplan", tuple(sorted((n, str(d), tuple(c)) for n, (d, c) in specs.items())))
    memo = segment_compile.derived(program)
    if key not in memo:
        memo[key] = segment_compile.recognize(program, specs, bases)
    return memo[key]


def _canonical_key(k: torch.Tensor) -> torch.Tensor:
    """Float keys grouped as ``np.unique`` groups them: -0.0 folds into
    +0.0 and every NaN becomes one NaN."""
    if k.dtype.is_floating_point:
        k = torch.where(k == 0, torch.zeros((), dtype=k.dtype, device=k.device), k)
        k = torch.where(torch.isnan(k), torch.full((), float("nan"), dtype=k.dtype, device=k.device), k)
    return k


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _boundary(k: torch.Tensor) -> torch.Tensor:
    """True where a sorted key column changes value (floats by bit
    pattern, so the canonical NaNs form one group)."""
    if k.dtype.is_floating_point:
        k = k.view(_BITS[k.element_size()])
    return k[1:] != k[:-1]


def _segment_index(keys: Sequence[torch.Tensor]):
    """``(unique key columns, row order, group counts)`` of the stable
    lexicographic sort over ``keys``; the group count is the one host
    sync."""
    keys = [_canonical_key(k) for k in keys]
    n = keys[0].shape[0]
    dev = keys[0].device
    order = torch.arange(n, device=dev)
    for k in reversed(keys):  # stable sorts, least significant key first
        kk = k[order]
        if kk.dtype == torch.bool:
            kk = kk.to(torch.uint8)
        order = order[torch.sort(kk, stable=True).indices]
    sk = [k[order] for k in keys]
    neq = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
    for k in sk:
        neq |= _boundary(k)
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    gid = torch.cumsum(newseg.to(torch.int64), 0) - 1
    num_groups = int(gid[-1]) + 1  # the one host sync
    rows = torch.arange(n, device=dev)
    starts = torch.full((num_groups,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, gid, rows, reduce="amin"
    )
    counts = torch.zeros(num_groups, dtype=torch.int64, device=dev).index_add_(
        0, gid, torch.ones(n, dtype=torch.int64, device=dev)
    )
    return [k[starts] for k in sk], order, counts


_SCATTER = {"sum": "sum", "prod": "prod", "min": "amin", "max": "amax"}


def _segment_reduce(v: torch.Tensor, kind: str, counts: torch.Tensor) -> torch.Tensor:
    """One segmented reduction over contiguous runs of ``counts`` rows:
    ``torch.segment_reduce`` for floats (a sequential reduction a segment,
    no atomics), an exact integer ``scatter_reduce`` otherwise."""
    if v.dtype.is_floating_point:
        return torch.segment_reduce(v, kind, lengths=counts, axis=0)
    gid = torch.repeat_interleave(torch.arange(counts.shape[0], device=v.device), counts)
    gid = gid.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    out = torch.zeros((counts.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, gid, v, reduce=_SCATTER[kind], include_self=False)


# ---------------------------------------------------------------------------
# public verb API
# ---------------------------------------------------------------------------


def _wrap(fn, verb, fetches=None, feed_dict=None, shapes=None, device=None) -> Program:
    """``fn`` as a Program on ``device`` (None = the CUDA card), with the
    shape hints.  Passing ``device=`` with a Program that lives on another
    device raises."""
    if isinstance(fn, Program):
        program = Program.wrap(fn, fetches, feed_dict)
        if device is not None and resolve_device(device) != program.device:
            raise ValueError(
                f"{verb}(device={str(device)!r}) but the program's params "
                f"live on {program.device}"
            )
    else:
        program = Program.wrap(fn, fetches, feed_dict, device=device)
    if shapes:
        program = program.with_shape_hints(shapes)
    return program


_DEFAULT = Executor()


def _resolve(engine: Optional[Executor]) -> Executor:
    return engine if engine is not None else _DEFAULT


def _lazy_target(frame, engine):
    """The LazyFrame a map verb appends to instead of dispatching, or None
    for the eager path (``ops/planner.py``: the frame is lazy via
    ``frame.lazy()``, or ``TFS_PLAN=1`` routes plain frames).  An explicit
    ``engine=`` always stays eager: a plan targets the default engine."""
    if engine is not None:
        return None
    from . import planner

    return planner.maybe_lazy(frame)


def _lazy_frame(frame):
    """A LazyFrame argument materialised, for the verbs that are
    materialisation points over plain frames (and warmup)."""
    if getattr(frame, "_tfs_lazy", False):
        from . import planner

        return planner.ensure_frame(frame)
    return frame


def map_blocks(
    fn,
    frame: TensorFrame,
    trim: bool = False,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    host_stage: Optional[Mapping[str, Any]] = None,
    engine: Optional[Executor] = None,
) -> TensorFrame:
    """Apply a block-level program to every block.

    ``fn``: a :class:`Program` or a callable (wrapped on ``device``; None =
    the CUDA card).  ``shapes``: output name -> block-shape hint.
    ``host_stage``: input name -> host preprocessing fn (binary decode).
    Planned mode (``ops/planner.py``): on a ``frame.lazy()`` frame, or any
    frame under ``TFS_PLAN=1``, the verb is recorded on the plan and a
    LazyFrame returned; ``engine=`` dispatches eagerly on that executor."""
    program = _wrap(fn, "map_blocks", fetches, feed_dict, shapes, device)
    lazy = _lazy_target(frame, engine)
    if lazy is not None:
        return lazy._append("map_blocks", program, trim=trim, host_stage=host_stage)
    return _resolve(engine).map_blocks(program, frame, trim=trim, host_stage=host_stage)


def map_blocks_trimmed(fn, frame: TensorFrame, **kw) -> TensorFrame:
    """``map_blocks(..., trim=True)``: the output row count may differ."""
    return map_blocks(fn, frame, trim=True, **kw)


def map_rows(
    fn,
    frame: TensorFrame,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    host_stage: Optional[Mapping[str, Any]] = None,
    engine: Optional[Executor] = None,
) -> TensorFrame:
    """Apply a row-level program to every row (``tfs.map_rows``, reference
    ``core.py:175-211``).  ``shapes`` hints are per-row cell shapes;
    ``host_stage``, planned mode and ``engine`` as for :func:`map_blocks`."""
    program = _wrap(fn, "map_rows", fetches, feed_dict, shapes, device)
    lazy = _lazy_target(frame, engine)
    if lazy is not None:
        return lazy._append("map_rows", program, host_stage=host_stage)
    return _resolve(engine).map_rows(program, frame, host_stage=host_stage)


def reduce_rows(
    fn,
    frame: TensorFrame,
    fetches: Optional[Sequence[str]] = None,
    mode: str = "tree",
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    engine: Optional[Executor] = None,
) -> Dict[str, Any]:
    """Pairwise-reduce all rows to one (``tfs.reduce_rows``, reference
    ``core.py:138-173``).  Returns column -> host array (bf16: a CPU
    tensor).  A LazyFrame argument is a materialisation point: the plan
    executes, folding the reduce into its chain where it can."""
    program = _wrap(fn, "reduce_rows", fetches, shapes=shapes, device=device)
    if engine is None and getattr(frame, "_tfs_lazy", False):
        return frame._reduce("reduce_rows", program, mode=mode)
    return _resolve(engine).reduce_rows(program, _lazy_frame(frame), mode=mode)


def reduce_blocks(
    fn,
    frame: TensorFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    engine: Optional[Executor] = None,
) -> Dict[str, Any]:
    """Block-reduce then combine across blocks (``tfs.reduce_blocks``,
    reference ``core.py:255-291``).  Returns column -> host array (bf16: a
    CPU tensor).  A LazyFrame argument is a materialisation point (see
    :func:`reduce_rows`)."""
    program = _wrap(fn, "reduce_blocks", fetches, shapes=shapes, device=device)
    if engine is None and getattr(frame, "_tfs_lazy", False):
        return frame._reduce("reduce_blocks", program)
    return _resolve(engine).reduce_blocks(program, _lazy_frame(frame))


def aggregate(
    fn,
    grouped: GroupedFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    engine: Optional[Executor] = None,
) -> TensorFrame:
    """Keyed algebraic aggregation (``tfs.aggregate``, reference
    ``core.py:319-336``).  Grouping a LazyFrame defers its one
    materialisation to this call, which fetches only the key and reduced
    columns of the chain (``ops/planner.py``); the aggregate itself always
    runs the eager engine, so grouping numerics cannot drift."""
    program = _wrap(fn, "aggregate", fetches, shapes=shapes, device=device)
    from . import planner

    if isinstance(grouped, planner.LazyGroupedFrame):
        if engine is None:
            return grouped.lazy._aggregate_terminal(program, grouped.keys, grouped=grouped)
        grouped = GroupedFrame(grouped.frame, grouped.keys)
    if getattr(grouped.frame, "_tfs_lazy", False):
        grouped = GroupedFrame(_lazy_frame(grouped.frame), grouped.keys)
    return _resolve(engine).aggregate(program, grouped)


def warmup(
    fn,
    frame: TensorFrame,
    rows_level: bool = False,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    host_stage: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
    engine: Optional[Executor] = None,
) -> List[str]:
    """Export and prime the map-verb entry ``fn`` will run over ``frame``
    (see :meth:`Executor.warmup`); returns the fingerprints.  A LazyFrame
    argument first primes the plan's own chain (``planner.warm_plan``),
    then materialises and warms ``fn`` over the result."""
    program = _wrap(fn, "warmup", fetches, feed_dict, device=device)
    if engine is None and getattr(frame, "_tfs_lazy", False):
        from . import planner

        planner.warm_plan(frame)
    frame = _lazy_frame(frame)
    return _resolve(engine).warmup(program, frame, rows_level=rows_level, host_stage=host_stage)
