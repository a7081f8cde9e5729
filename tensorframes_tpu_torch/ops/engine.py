"""The execution engine: the six verbs, serial and single-device.

PyTorch counterpart of ``tensorframes_tpu/ops/engine.py``:

* ``map_blocks`` / ``map_blocks_trimmed``: input staging
  (``_device_inputs``), the per-block program call, the per-block output
  and shape-hint checks (same messages), the output frame with passthrough
  columns shadowed by outputs, and the empty-frame contract;
* ``map_rows``: the cell-level program under ``torch.func.vmap`` over each
  block's rows; ragged columns run one vmapped call per distinct row shape
  (exact-shape buckets);
* ``reduce_rows``: a balanced tree of vmapped pairwise calls per block
  (``mode="tree"``), or the reference's left fold in row order
  (``mode="sequential"``);
* ``reduce_blocks``: the block program once per block, then once over the
  stacked partials (``_combine_partials``, the one final-combine shape of
  both reduce verbs);
* ``aggregate``: a host group index, then the block program vmapped over
  all groups of one size (at most 8 distinct sizes), or a pairwise combine
  tree over row partials (skewed sizes).

Blocks run one after another on the program's device, under the block
dispatch stack of ROADMAP.md item 9, as the JAX package's are:

* a cancellation checkpoint at every block boundary
  (``cancellation.py``: a ``CancelScope``'s deadline or cancel raises
  there, never mid-block);
* a ``prefetch.Prefetcher`` over host-fresh blocks: one staging thread
  casts each block (and runs ``host_stage``) in block order and, on CUDA,
  copies it from pinned buffers on a copy stream while earlier blocks
  compute; a ``cache()``d frame's columns are read in place and stage 0
  host bytes;
* the retry session of ``ops/fault_tolerance.py`` when
  ``TFS_BLOCK_RETRIES`` > 0 or ``TFS_FAULT_INJECT`` is set: transient
  failures re-stage and retry, a device OOM splits a provably
  row-independent block (``rowdep.py``), on the same device and kernels.

Map outputs stay on the device as tensors until ``collect``/``to_arrays``;
the reduce verbs return host arrays.  Every verb stages host arrays one
way, through ``prefetch.stage_arrays`` (``aggregate``'s columns and the
ragged ``map_rows`` buckets too), which bumps
``observability.note_h2d_bytes`` (each staging once, a retry's included).
``last_verb_stats`` gives the last loop's prefetch and retry record.  Not
ported yet (ROADMAP.md, Queue 1 item 9): bucketing, the device pool, the
sharded frame cache, chunk-level streaming plans and spans; JAX's padded
ragged ``map_rows`` buckets (``_ragged_pad_ok``) and its device segment
aggregate (``_aggregate_segment``), which need the rest of the program
analysis -- their absence changes speed, not results.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import cancellation, dtypes, faults
from ..device import DeviceLike, resolve_device
from ..frame import Column, TensorFrame, _column_from_cells, to_host
from ..program import Program
from ..schema import ColumnInfo
from ..shape import Shape, ShapeError, UNKNOWN
from . import fault_tolerance, prefetch, rowdep, validation
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
    """Serial verb executor: blocks run one after another on the program's
    device (where its params live)."""

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
        infos = validation.check_map_inputs(
            program, frame, "map_blocks", host_staged=host_stage or ()
        )
        if frame.num_rows == 0 and not trim:
            # empty-frame contract: a non-trimmed map of an empty frame is
            # an empty frame with the program's inferred output schema — no
            # program execution.  (A TRIMMED map still applies the program
            # to the empty block: its output row count is program-defined.)
            out_blocks = [self._empty_map_outputs(program, infos, False)]
        else:
            out_blocks = self._map_dispatch(
                program, frame, infos, program.call, False, trim, host_stage
            )
        return self._build_map_output(frame, out_blocks, trim)

    def _map_dispatch(self, program, frame, infos, run, rows_level, trim,
                      host_stage=None):
        """Run ``run`` (the block call, or the vmapped row call) over every
        block, checking each block's outputs: the map verbs' block loop
        (the JAX package's ``_map_dispatch``).

        Each block boundary is a cancellation checkpoint.  When no program
        input is device-resident, blocks are staged ahead by a
        ``prefetch.Prefetcher`` (``TFS_PREFETCH_BLOCKS``; ``host_stage``
        runs on its thread, in block order); a ``cache()``d frame's blocks
        are read in place.  With ``TFS_BLOCK_RETRIES`` > 0 or a fault plan,
        each block runs under the frame's retry session
        (``ops/fault_tolerance.py``): transient failures re-stage and retry,
        a device OOM splits the block when that is provably safe."""
        verb = "map_rows" if rows_level else "map_blocks"
        device = program.device
        sizes = frame.block_sizes
        fresh = not any(
            frame.column(program.column_for_input(n)).is_device
            for n in program.input_names
        )
        session = fault_tolerance.frame_session(frame.num_blocks, verb=verb)
        donate = prefetch.donate_inputs()

        def stage(bi):
            return self._stage_inputs(program, frame.block(bi), infos, device, host_stage)

        pf = prefetch.Prefetcher(stage, frame.num_blocks) if fresh else None
        items = pf if pf is not None else (None for _ in sizes)
        out_blocks = []
        with torch.no_grad():
            for bi, staged in enumerate(items):
                cancellation.checkpoint()  # block boundary
                attempt = _attempt(staged, functools.partial(stage, bi), run)
                if donate:
                    staged = None  # the block's inputs go back to the allocator
                if session is None:
                    outs = attempt(0, 0)
                else:
                    split = self._oom_split_closure(
                        session, program, frame, bi, infos, host_stage, run,
                        rows_level, trim,
                    )
                    outs = session.run(bi, sizes[bi], attempt, device=0, oom_split=split)
                del attempt
                self._check_block_outputs(program, outs, sizes[bi], rows_level, trim)
                out_blocks.append(outs)
                del staged
        _record_stats(verb, frame.num_blocks, pf, donate, session)
        return out_blocks

    def _oom_split_closure(
        self, session, program, frame, bi, infos, host_stage, run, rows_level, trim
    ):
        """The OOM-degradation policy for one map-verb block: split the
        block in half and re-dispatch (recursively, floor
        ``TFS_MIN_SPLIT_ROWS``) when that is provably safe -- ``map_rows``
        is row-independent by construction, ``map_blocks`` must pass
        ``rowdep.rows_independent`` at every size the split can reach.
        Trimmed maps, host-staged blocks and cross-row programs surface a
        ``BlockExecutionError`` naming the block and row range instead."""
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
                block = frame.block(bi)
                specs = {
                    n: (
                        dtypes.coerce(infos[n].scalar_type).torch_dtype,
                        tuple(np.shape(block[program.column_for_input(n)])[1:]),
                    )
                    for n in program.input_names
                }
                if not rowdep.rows_independent(program, specs, sorted(sizes)):
                    refuse(exc, "the program is not provably row-independent "
                                "(cross-row outputs cannot be recomputed from "
                                "half blocks)")
            mid = n_rows // 2
            left = self._split_range(session, program, frame, bi, infos, run, 0, mid)
            right = self._split_range(session, program, frame, bi, infos, run, mid, n_rows)
            session.note_split(bi)
            return {k: torch.cat([left[k], right[k]]) for k in left}

        return split

    def _split_range(
        self, session, program, frame, bi, infos, run, lo: int, hi: int
    ) -> Dict[str, torch.Tensor]:
        """Dispatch rows ``[lo, hi)`` of block ``bi`` on the program's
        device, splitting again on a further OOM down to
        ``TFS_MIN_SPLIT_ROWS``.  The injected-fault site is ``"split"``, so
        attempt-selected specs never re-fire on recovery work."""
        floor = fault_tolerance.min_split_rows()
        try:
            faults.maybe_inject(bi, 0, 0, hi - lo, site="split")
            sub = {k: v[lo:hi] for k, v in frame.block(bi).items()}
            return run(self._device_inputs(program, sub, infos, program.device))
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
            left = self._split_range(session, program, frame, bi, infos, run, lo, mid)
            right = self._split_range(session, program, frame, bi, infos, run, mid, hi)
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
        infos = validation.check_map_inputs(
            program, frame, "map_rows", host_staged=host_stage or (),
            allow_ragged=True,
        )
        ragged = [
            n for n in program.input_names
            if not (host_stage and n in host_stage)
            and frame.column(program.column_for_input(n)).is_ragged
        ]
        if ragged:
            return self._map_rows_ragged(program, frame, infos, ragged, host_stage)
        if frame.num_rows == 0:
            out_blocks = [self._empty_map_outputs(program, infos, True)]
        else:
            out_blocks = self._map_dispatch(
                program, frame, infos, program.vmapped(), True, False, host_stage
            )
        return self._build_map_output(frame, out_blocks, trim=False)

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
        sorted shape order.  (JAX also pads a provably elementwise program's
        cells up to geometric buckets, ``_ragged_pad_ok``; that proof needs
        the program analysis of ROADMAP item 9, so here every bucket is an
        exact shape.)"""
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
        buckets: Dict[tuple, List[int]] = {}
        for i in range(n):
            key = tuple(cells[r][i].shape for r in ragged_names)
            buckets.setdefault(key, []).append(i)
        run = program.vmapped()
        out_cells: Dict[str, List[Any]] = {}
        with torch.no_grad():
            for key in sorted(buckets):
                idxs = np.asarray(buckets[key])
                values = {
                    r: (np.stack([cells[r][i] for i in idxs]),
                        dtypes.coerce(infos[r].scalar_type))
                    for r in ragged_names
                }
                for u, (data, st) in uniform.items():
                    rows = (data[torch.as_tensor(idxs, device=data.device)]
                            if isinstance(data, torch.Tensor) else data[idxs])
                    values[u] = (rows, st)
                outs = run(self._stage_values(values, device).ready())
                _check_shape_hints(program, outs, "map_rows", cell_level=True)
                for name, v in outs.items():
                    host = to_host(v, name)
                    col_cells = out_cells.setdefault(name, [None] * n)
                    for j, i in enumerate(idxs):
                        col_cells[i] = host[j]
        cols = [
            _column_from_cells(name, out_cells[name]) for name in sorted(out_cells)
        ]
        return self._with_passthrough(frame, cols, frame.offsets)

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
        returns ``(bases, reduced, run)``, where ``run`` folds a dict of
        block arrays down to one cell each."""
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
        pairfn = self._pair_call(program, bases)
        fold = self._tree_fold if mode == "tree" else self._seq_fold

        def run(arrs):
            return fold(pairfn, arrs, program.params)

        return bases, reduced, run

    def reduce_rows(
        self, program: Program, frame: TensorFrame, mode: str = "tree"
    ) -> Dict[str, Any]:
        """``reduceRows`` (``DebugRowOps.scala:479-501``): pairwise-fold all
        rows of the named columns down to one row."""
        bases, reduced, run = self._reduce_rows_setup(program, frame, mode)
        return self._reduce(program, run, bases, reduced, frame)

    def _reduce(self, program, run, bases, reduced, frame) -> Dict[str, Any]:
        with torch.no_grad():
            partials = self._reduce_partials(program, run, bases, reduced, frame)
            final = self._combine_partials(run, bases, partials)
        return {b: _host(final[b]) for b in bases}

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
        self, program, run, bases, reduced, frame: TensorFrame
    ) -> List[Dict[str, torch.Tensor]]:
        """Per-block partials for the reduce verbs, in block order; empty
        blocks are skipped (``DebugRowOps.scala:489-499``).  The block loop
        of the map verbs without the split: host blocks are prefetched,
        each boundary is a cancellation checkpoint, and a retry session
        re-stages and retries transient failures (a partial is cross-row
        by definition, so an OOM surfaces with the block's row range)."""
        sts = {b: dtypes.coerce(reduced[b].scalar_type) for b in bases}
        # base -> the RESOLVED source column (a feed-dict rename)
        cols = {b: reduced[b].name for b in bases}
        sizes = frame.block_sizes
        nonempty = [bi for bi in range(frame.num_blocks) if sizes[bi]]
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
        for j, staged in enumerate(items):
            cancellation.checkpoint()  # block boundary (partials)
            attempt = _attempt(staged, functools.partial(stage, j), run)
            del staged
            if session is None:
                partials.append(attempt(0, 0))
            else:
                bi = nonempty[j]
                partials.append(session.run(bi, sizes[bi], attempt, device=0))
        _record_stats("reduce", frame.num_blocks, pf, donate, session)
        return partials

    def _reduce_blocks_setup(
        self, program: Program, frame: TensorFrame, verb: str = "reduce_blocks"
    ):
        """Pre-flight of reduce_blocks: checks the x_input contract and
        returns ``(bases, reduced, run)``, where ``run`` applies the block
        program to a dict of block arrays keyed by base column name."""
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

        def run(arrs):
            return program.call({f"{b}_input": arrs[b] for b in bases})

        return bases, reduced, run

    def reduce_blocks(
        self, program: Program, frame: TensorFrame
    ) -> Dict[str, Any]:
        """``reduceBlocks`` (``DebugRowOps.scala:503-526``): phase 1 reduces
        each block to one row with the user's block program; phase 2 applies
        the same program once to the stacked per-block partials."""
        bases, reduced, run = self._reduce_blocks_setup(program, frame)
        return self._reduce(program, run, bases, reduced, frame)

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
            return self._aggregate_empty(program, grouped, reduced, bases)

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


def map_blocks(
    fn,
    frame: TensorFrame,
    trim: bool = False,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
    host_stage: Optional[Mapping[str, Any]] = None,
) -> TensorFrame:
    """Apply a block-level program to every block.

    ``fn``: a :class:`Program` or a callable (wrapped on ``device``; None =
    the CUDA card).  ``shapes``: output name -> block-shape hint.
    ``host_stage``: input name -> host preprocessing fn (binary decode)."""
    program = _wrap(fn, "map_blocks", fetches, feed_dict, shapes, device)
    return Executor().map_blocks(program, frame, trim=trim, host_stage=host_stage)


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
) -> TensorFrame:
    """Apply a row-level program to every row (``tfs.map_rows``, reference
    ``core.py:175-211``).  ``shapes`` hints are per-row cell shapes;
    ``host_stage`` as for :func:`map_blocks`."""
    program = _wrap(fn, "map_rows", fetches, feed_dict, shapes, device)
    return Executor().map_rows(program, frame, host_stage=host_stage)


def reduce_rows(
    fn,
    frame: TensorFrame,
    fetches: Optional[Sequence[str]] = None,
    mode: str = "tree",
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Pairwise-reduce all rows to one (``tfs.reduce_rows``, reference
    ``core.py:138-173``).  Returns column -> host array (bf16: a CPU
    tensor)."""
    program = _wrap(fn, "reduce_rows", fetches, shapes=shapes, device=device)
    return Executor().reduce_rows(program, frame, mode=mode)


def reduce_blocks(
    fn,
    frame: TensorFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Block-reduce then combine across blocks (``tfs.reduce_blocks``,
    reference ``core.py:255-291``).  Returns column -> host array (bf16: a
    CPU tensor)."""
    program = _wrap(fn, "reduce_blocks", fetches, shapes=shapes, device=device)
    return Executor().reduce_blocks(program, frame)


def aggregate(
    fn,
    grouped: GroupedFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Keyed algebraic aggregation (``tfs.aggregate``, reference
    ``core.py:319-336``)."""
    program = _wrap(fn, "aggregate", fetches, shapes=shapes, device=device)
    return Executor().aggregate(program, grouped)
