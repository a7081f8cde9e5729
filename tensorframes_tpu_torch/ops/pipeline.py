"""Verb pipelines: a chain of verbs run back to back on the device.

PyTorch counterpart of ``tensorframes_tpu/ops/pipeline.py``.  A chained
``map_blocks_trimmed -> reduce_blocks`` step is the body of every iterative
driver (logistic regression, k-means)::

    pipe = (tft.pipeline(frame)
            .map_blocks(grad_prog, trim=True)     # block -> 1-row partials
            .reduce_blocks(sum_prog)              # cross-block sum
            .then(sgd_update))                    # post-processing
    row  = pipe.run()                             # device dict, no readback
    out  = pipe.collect()                         # run + one readback

    # iterative driver: K steps, params carried on the device
    finals, hist = pipe.iterate(50, carry={"w": "w", "b": "b"},
                                collect=("loss",))

The JAX package traces the whole chain into one XLA program.  The port
does not fuse: each stage runs its own eager calls, block by block, on the
device, with the entry columns staged once and every intermediate left on
the device.  A chain is therefore **bit-identical** to the same eager verbs
(``tests/test_torch_pipeline.py``), and the gain is what the chain does
not do: no host round trip between stages, no re-staging of intermediates,
and in ``iterate`` no readback at all until the caller asks for the
results (one readback for K steps; :attr:`Pipeline.readbacks` counts them).
Do not ``torch.compile`` a chain: a fused graph rounds differently from
the eager verbs.

Build-time validation is the JAX package's, with its messages: host-only
(binary/string) and ragged columns cannot flow through a chain (the error
points at the eager verbs); untouched host columns of the source frame are
re-attached to map-terminal outputs; ``aggregate`` is not a chain stage.

Map-terminal chains over a host-fresh multi-block frame run per block under
the device pool (``ops/device_pool.py``) when one resolves, and over a
sharded-cached frame on the devices holding the blocks: the map stages
over one block are one Program, run by the eager map verbs' own loop;
row-terminal chains always run on the programs' device.  A ``MeshExecutor`` engine (the
JAX package's mesh-global chains) waits for ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cancellation, dtypes, observability
from ..device import DeviceLike, resolve_device
from ..frame import TensorFrame, is_device_array
from ..program import Program
from ..schema import ColumnInfo, Schema
from ..shape import Shape, UNKNOWN
from . import device_pool, frame_cache, validation
from .engine import _DEFAULT, _host
from .validation import ValidationError

# the param of a pooled chain's Program that carries every stage's params
_CHAIN_PARAMS = "__chain_params"


@dataclasses.dataclass(frozen=True)
class _Stage:
    kind: str  # map_blocks | map_rows | reduce_blocks | reduce_rows | then
    program: Optional[Program] = None
    trim: bool = False
    mode: str = "tree"
    fn: Optional[Callable] = None
    reduced_bases: Tuple[str, ...] = ()


class _SchemaView:
    """A stand-in for a TensorFrame in the validation helpers (they read
    ``.schema`` only)."""

    def __init__(self, infos: Mapping[str, ColumnInfo]):
        self.schema = Schema(list(infos.values()))


def analyzed_outputs(
    program: Program,
    infos: Mapping[str, ColumnInfo],
    cell: bool,
    verb: str = "pipeline",
) -> Dict[str, ColumnInfo]:
    """Shape-infer a map stage's outputs from its input ColumnInfos (the
    schema tracking of the chain builders).  ``cell``: the program is
    row-level (map_rows), so specs and output shapes are per cell."""
    specs = {}
    for n, ci in infos.items():
        st = dtypes.coerce(ci.scalar_type)
        shape = tuple(ci.cell_shape) if cell else (UNKNOWN,) + tuple(ci.cell_shape)
        specs[n] = (st, Shape(shape))
    outs: Dict[str, ColumnInfo] = {}
    for s in program.analyze(specs):
        if s.is_output:
            block_shape = s.shape.prepend(UNKNOWN) if cell else s.shape
            if not cell and block_shape.rank == 0:
                raise ValidationError(
                    f"{verb}.map_blocks: output {s.name!r} is a scalar; "
                    f"block outputs need a lead row axis."
                )
            outs[s.name] = ColumnInfo(s.name, s.scalar_type, block_shape)
    return outs


def _reduce_src_cols(program, bases, suffix: str) -> Dict[str, str]:
    """base -> source chain column of a terminal reduce stage, honouring
    feed-dict renames."""
    out = {}
    for b in bases:
        n = f"{b}{suffix}"
        col = program.column_for_input(n)
        out[b] = b if col == n else col
    return out


def _rows(blk: Mapping[str, Any]) -> int:
    return next(iter(blk.values())).shape[0]


class Pipeline:
    """A lazy verb chain over one frame; built by :func:`pipeline`.

    Builder methods return a NEW Pipeline (the receiver stays valid), so
    chains can fork.  Stages hold the caller's ``Program`` objects by
    reference, and ``iterate`` updates their params in place, so a
    caller's handle (and any fork) continues from the trained state."""

    def __init__(self, frame: TensorFrame, stages: Tuple[_Stage, ...] = (),
                 visible: Optional[Dict[str, ColumnInfo]] = None,
                 from_source: Optional[Dict[str, bool]] = None,
                 row_stage: bool = False, device: DeviceLike = None):
        self._frame = frame
        self._stages = stages
        self._device = device
        if visible is None:
            visible, from_source = {}, {}
            for c in frame.columns:
                if c.info.scalar_type.device_ok and not c.is_ragged:
                    visible[c.info.name] = c.info
                    from_source[c.info.name] = True
        self._visible = visible
        self._from_source = from_source or {}
        self._row_stage = row_stage
        #: host readbacks this chain made (``collect``, ``readback``)
        self.readbacks = 0

    # ------------------------------------------------------------ builders --

    def _derive(self, stage: _Stage, visible=None, from_source=None,
                row_stage: bool = False) -> "Pipeline":
        return Pipeline(
            self._frame, self._stages + (stage,),
            self._visible if visible is None else visible,
            self._from_source if from_source is None else from_source,
            row_stage, self._device,
        )

    def _wrap(self, fn, kw) -> Program:
        if isinstance(fn, Program):
            program = Program.wrap(fn, **kw)
        else:
            program = Program.wrap(fn, device=kw.pop("device", self._device), **kw)
        for st in self._stages:
            if st.program is not None and st.program.device != program.device:
                raise ValidationError(
                    f"pipeline: every stage runs on one device; this stage's "
                    f"program lives on {program.device}, an earlier one on "
                    f"{st.program.device}"
                )
        return program

    def _require_frame_stage(self, verb: str) -> None:
        if self._row_stage:
            raise ValidationError(
                f"pipeline.{verb}: the chain already ended in a row-producing "
                f"stage (reduce/then); only then/run/collect/iterate may "
                f"follow."
            )

    def _check_inputs(self, program: Program, verb: str) -> Dict[str, ColumnInfo]:
        infos: Dict[str, ColumnInfo] = {}
        source_schema = self._frame.schema
        for n in program.input_names:
            col = program.column_for_input(n)
            if col in self._visible:
                infos[n] = self._visible[col]
                continue
            if col in source_schema:
                ci = source_schema[col]
                fcol = self._frame.column(col)
                if not ci.scalar_type.device_ok or fcol.is_ragged:
                    why = (
                        "is host-only (binary/string)"
                        if not ci.scalar_type.device_ok
                        else "is ragged/un-analyzed"
                    )
                    raise ValidationError(
                        f"pipeline.{verb}: column {col!r} {why} and cannot "
                        f"flow through a fused device trace. Use the eager "
                        f"verb (tfs.{verb}) with host_stage/analyze for "
                        f"this column."
                    )
                raise ValidationError(
                    f"pipeline.{verb}: column {col!r} was dropped by an "
                    f"earlier trim stage (trim=True replaces the block with "
                    f"the program outputs only). Available here: "
                    f"{sorted(self._visible)}."
                )
            raise ValidationError(
                f"pipeline.{verb}: program input {n!r} requests column "
                f"{col!r}, which is not available at this point in the "
                f"chain. Available: {sorted(self._visible)}."
            )
        return infos

    def map_blocks(self, fn, trim: bool = False, **kw) -> "Pipeline":
        """Append a block-level map (``tft.map_blocks``; trim=True for
        ``map_blocks_trimmed``)."""
        self._require_frame_stage("map_blocks")
        program = self._wrap(fn, kw)
        infos = self._check_inputs(program, "map_blocks")
        outs = analyzed_outputs(program, infos, cell=False)
        visible = dict(outs) if trim else {**self._visible, **outs}
        from_source = (
            {k: False for k in outs} if trim
            else {**self._from_source, **{k: False for k in outs}}
        )
        return self._derive(_Stage("map_blocks", program, trim=trim), visible, from_source)

    def map_blocks_trimmed(self, fn, **kw) -> "Pipeline":
        return self.map_blocks(fn, trim=True, **kw)

    def map_rows(self, fn, **kw) -> "Pipeline":
        """Append a row-level map (``tft.map_rows``, vmapped over rows)."""
        self._require_frame_stage("map_rows")
        program = self._wrap(fn, kw)
        infos = self._check_inputs(program, "map_rows")
        outs = analyzed_outputs(program, infos, cell=True)
        return self._derive(
            _Stage("map_rows", program), {**self._visible, **outs},
            {**self._from_source, **{k: False for k in outs}},
        )

    def reduce_blocks(self, fn, **kw) -> "Pipeline":
        """Append the terminal block reduction (``tft.reduce_blocks``)."""
        self._require_frame_stage("reduce_blocks")
        if self._frame.num_rows == 0:
            raise ValidationError(
                "pipeline.reduce_blocks: cannot reduce an empty frame (no "
                "identity element is available for an arbitrary block "
                "program)"
            )
        program = self._wrap(fn, kw)
        reduced = validation.check_reduce_blocks(
            program, _SchemaView(self._visible), verb="pipeline.reduce_blocks"
        )
        bases = tuple(sorted(reduced))
        probe = max(self._frame.block_sizes) or 1
        summaries = program.analyze({
            f"{b}_input": (dtypes.coerce(reduced[b].scalar_type),
                           (probe,) + tuple(reduced[b].cell_shape))
            for b in bases
        })
        validation.check_reduce_blocks_outputs(
            reduced, summaries, verb="pipeline.reduce_blocks"
        )
        return self._derive(
            _Stage("reduce_blocks", program, reduced_bases=bases), row_stage=True
        )

    def reduce_rows(self, fn, mode: str = "tree", **kw) -> "Pipeline":
        """Append the terminal pairwise reduction (``tft.reduce_rows``)."""
        self._require_frame_stage("reduce_rows")
        if self._frame.num_rows == 0:
            raise ValidationError(
                "pipeline.reduce_rows: cannot reduce an empty frame (no "
                "identity element is available for an arbitrary pairwise "
                "program)"
            )
        if mode not in ("tree", "sequential"):
            raise ValidationError(
                f"pipeline.reduce_rows: unknown mode {mode!r}; use 'tree' or "
                f"'sequential'"
            )
        program = self._wrap(fn, kw)
        reduced = validation.check_reduce_rows(program, _SchemaView(self._visible))
        bases = tuple(sorted(reduced))
        summaries = program.analyze({
            f"{b}_{i}": (dtypes.coerce(reduced[b].scalar_type), tuple(reduced[b].cell_shape))
            for b in bases for i in (1, 2)
        })
        validation.check_reduce_rows_outputs(reduced, summaries)
        return self._derive(
            _Stage("reduce_rows", program, mode=mode, reduced_bases=bases), row_stage=True
        )

    def then(self, fn: Callable) -> "Pipeline":
        """Append post-processing of the reduced row: ``fn(row, params)``
        gets the reduced outputs and the union of every stage program's
        params and returns a dict of named outputs (parameter updates,
        derived scalars)."""
        if not self._row_stage:
            raise ValidationError(
                "pipeline.then: requires a reduce stage first (then() "
                "post-processes the reduced row)."
            )
        seen: Dict[str, int] = {}
        for i, st in enumerate(self._stages):
            if st.program is not None:
                for pname in st.program.params:
                    if pname in seen and seen[pname] != i:
                        raise ValidationError(
                            f"pipeline.then: param name {pname!r} exists on "
                            f"multiple stages; rename one to disambiguate."
                        )
                    seen[pname] = i
        return self._derive(_Stage("then", fn=fn), row_stage=True)

    def with_frame(self, frame: TensorFrame) -> "Pipeline":
        """This chain over a new source frame with the same columns; the
        stages (and their programs) are shared by reference."""
        if frame.column_names != self._frame.column_names:
            raise ValidationError(
                f"pipeline.with_frame: the new frame's columns "
                f"{frame.column_names} do not match the chain's source "
                f"columns {self._frame.column_names}"
            )
        return Pipeline(frame, self._stages, dict(self._visible),
                        dict(self._from_source), self._row_stage, self._device)

    # --------------------------------------------------------------- body --

    @property
    def device(self) -> torch.device:
        """The device every stage runs on (the stage programs')."""
        for st in self._stages:
            if st.program is not None:
                return st.program.device
        return resolve_device(self._device)

    def _needed_source_cols(self) -> List[str]:
        """Source columns the chain reads, plus, for map-terminal chains,
        every still-visible source column (they pass through)."""
        needed = set()
        for st in self._stages:
            if st.program is None:
                continue
            if st.kind in ("map_blocks", "map_rows"):
                refs = [st.program.column_for_input(n) for n in st.program.input_names]
            else:
                suffix = "_input" if st.kind == "reduce_blocks" else "_1"
                refs = list(_reduce_src_cols(st.program, st.reduced_bases, suffix).values())
            needed.update(refs)
        if not self._row_stage:
            needed.update(k for k, src in self._from_source.items() if src)
        src_names = {
            c.info.name for c in self._frame.columns
            if c.info.scalar_type.device_ok and not c.is_ragged
        }
        return sorted(needed & src_names)

    def _params_list(self) -> List[Dict[str, Any]]:
        return [st.program.params if st.program is not None else {} for st in self._stages]

    def _map_stage_block(self, st: _Stage, blk: Dict[str, Any], params) -> Dict[str, Any]:
        """One map stage applied to one block dict, with the eager verbs'
        row-count contracts."""
        program = st.program
        inputs = {n: blk[program.column_for_input(n)] for n in program.input_names}
        if st.kind == "map_rows":
            outs = program.vmapped()(inputs, params)
            return {**{k: v for k, v in blk.items() if k not in outs}, **outs}
        n_rows = _rows(blk)
        outs = program.call(inputs, params)
        if not st.trim:
            for name, v in outs.items():
                if v.ndim == 0 or v.shape[0] != n_rows:
                    raise ValidationError(
                        f"pipeline.map_blocks: output {name!r} has shape "
                        f"{tuple(v.shape)} but the block has {n_rows} rows; "
                        f"use trim=True to change the row count."
                    )
            return {**{k: v for k, v in blk.items() if k not in outs}, **outs}
        counts = {v.shape[0] if v.ndim else None for v in outs.values()}
        if len(counts) != 1 or None in counts:
            raise ValidationError(
                f"pipeline.map_blocks_trimmed: outputs disagree on row count: "
                f"{ {k: tuple(v.shape) for k, v in outs.items()} }"
            )
        return dict(outs)

    def _block_chain(self, blk: Dict[str, Any], params_list) -> Dict[str, Any]:
        """The map stages over one block (the pooled per-block body)."""
        for st, params in zip(self._stages, params_list):
            blk = self._map_stage_block(st, blk, params)
        return {k: blk[k] for k in sorted(blk)}

    def _body(self, cols: Dict[str, Any], params_list: List[Dict]) -> Any:
        """The chain over the staged source columns: the final row dict,
        or the list of per-block column dicts.  The same calls, block by
        block, as the eager verbs make."""
        frame = self._frame
        blocks = [
            {name: arr[frame.offsets[i]:frame.offsets[i + 1]] for name, arr in cols.items()}
            for i in range(frame.num_blocks)
        ]
        row: Optional[Dict[str, Any]] = None
        for st, params in zip(self._stages, params_list):
            if st.kind in ("map_blocks", "map_rows"):
                blocks = [self._map_stage_block(st, blk, params) for blk in blocks]
            elif st.kind in ("reduce_blocks", "reduce_rows"):
                program, bases = st.program, list(st.reduced_bases)
                if st.kind == "reduce_blocks":
                    srcs = _reduce_src_cols(program, bases, "_input")
                    run = lambda a, p=params, pr=program, bs=bases: pr.call(  # noqa: E731
                        {f"{b}_input": a[b] for b in bs}, p)
                else:
                    srcs = _reduce_src_cols(program, bases, "_1")
                    pairfn = _DEFAULT._pair_call(program, bases)
                    fold = _DEFAULT._tree_fold if st.mode == "tree" else _DEFAULT._seq_fold
                    run = lambda a, p=params, f=fold, pf=pairfn: f(pf, a, p)  # noqa: E731
                partials = [run({b: blk[srcs[b]] for b in bases})
                            for blk in blocks if _rows(blk) > 0]
                if not partials:
                    raise ValidationError(
                        f"pipeline.{st.kind}: every block is empty at the "
                        f"reduce stage; nothing to reduce."
                    )
                row = _DEFAULT._combine_partials(run, bases, partials)
            else:  # then
                merged: Dict[str, Any] = {}
                for stg, p in zip(self._stages, params_list):
                    if stg.program is not None:
                        merged.update(p)
                out = st.fn(row, merged)
                if not isinstance(out, Mapping):
                    raise ValidationError(
                        "pipeline.then: fn must return a dict of named "
                        f"outputs, got {type(out).__name__}"
                    )
                row = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=self.device)
                       for k, v in out.items()}
        if self._row_stage:
            return row
        # columns in name order, as a jitted chain returns its dict outputs
        return [{k: blk[k] for k in sorted(blk)} for blk in blocks]

    # ----------------------------------------------------------- execution --

    def _entry_layout(self) -> Tuple[Dict[str, Any], bool]:
        """``name -> (column data, scalar type)`` of the entry columns, and
        whether every one of them is host-resident."""
        layout: Dict[str, Any] = {}
        all_host = True
        for name in self._needed_source_cols():
            c = self._frame.column(name)
            all_host = all_host and not is_device_array(c.data)
            layout[name] = (c.data, dtypes.coerce(c.info.scalar_type))
        return layout, all_host

    def _entry_cols(self) -> Dict[str, torch.Tensor]:
        """The entry columns on the device: host columns staged once
        (``prefetch.stage_arrays``, counted in ``h2d_bytes_staged``),
        device columns read in place."""
        layout, _ = self._entry_layout()
        return _DEFAULT._stage_values(layout, self.device).ready()

    def run(self):
        """Run the chain once: a dict of device tensors for a row-terminal
        chain, a TensorFrame with device columns for a map-terminal one (no
        readback either way).  A map-terminal chain under the device pool,
        or over a sharded-cached frame, runs per block across the devices
        and returns host columns assembled in block order."""
        if not self._stages:
            raise ValidationError("pipeline.run: empty pipeline (no stages)")
        with observability.verb_span(
            "pipeline", self._frame.num_rows, self._frame.num_blocks
        ) as span:
            plan = self._pool_plan()
            span.mark("validate")
            if plan is not None:
                out_frame = self._run_pooled(*plan)
                span.mark("dispatch")
                return out_frame
            with torch.no_grad():
                out = self._body(self._entry_cols(), self._params_list())
            span.mark("dispatch")
            if self._row_stage:
                return out
            return self._with_passthrough(TensorFrame.from_blocks(out))

    def _with_passthrough(self, frame: TensorFrame) -> TensorFrame:
        """Host-only and ragged source columns ride along when the chain
        keeps row identity (no trim stage)."""
        if any(s.trim for s in self._stages):
            return frame
        extra = [
            c for c in self._frame.columns
            if c.info.name not in frame.column_names and c.info.name not in self._visible
        ]
        return TensorFrame(list(frame.columns) + extra, frame.offsets) if extra else frame

    def _pool_plan(self):
        """``(devices, layout, cache)`` for a pooled run, or None: pooling
        needs a map-terminal chain, >= 2 blocks, host-resident entry
        columns, and either a sharded cache on the frame or >= 2 pool
        devices."""
        if (self._row_stage or self._frame.num_blocks < 2
                or any(st.kind not in ("map_blocks", "map_rows") for st in self._stages)):
            return None
        cache = frame_cache.active_cache(self._frame)
        devices = cache.devices if cache is not None else device_pool.pool_devices()
        if len(devices) < 2:
            return None
        layout, all_host = self._entry_layout()
        if not layout or not all_host:
            return None
        return devices, layout, cache

    def _run_pooled(self, devices, layout, cache=None) -> TensorFrame:
        """A map-terminal chain per block across ``devices``: the map
        stages over one block are one Program, run by the eager map verbs'
        own loop (``Executor._map_dispatch``), so the lanes, the bucket
        padding, the retries and the quarantine are theirs.  With sharding
        on, each block's device outputs are adopted as the result frame's
        shards, so the next epoch of an iterative chain reads them in
        place."""
        frame = self._frame
        names = sorted(layout)
        sub = TensorFrame([frame.column(n) for n in names], frame.offsets)
        if cache is not None:
            frame_cache.attach(sub, cache)
        chain = Program(
            lambda **kw: self._block_chain({n: kw[n] for n in names}, kw[_CHAIN_PARAMS]),
            names + [_CHAIN_PARAMS], params={_CHAIN_PARAMS: self._params_list()},
            device=self.device,
        )
        keep = (
            [None] * frame.num_blocks
            if cache is not None or len(frame_cache.shard_devices(None)) >= 2 else None
        )
        out_blocks = _DEFAULT._map_dispatch(
            chain, sub, {n: frame.schema[n] for n in names}, False,
            any(st.trim for st in self._stages), keep=keep,
        )
        out_frame = self._with_passthrough(TensorFrame.from_blocks(out_blocks))
        if keep is not None:
            frame_cache.adopt(out_frame, devices, [di for di, _ in keep], [o for _, o in keep])
        return out_frame

    def warmup(self) -> "Pipeline":
        """Run the chain once on ``meta`` tensors at the frame's entry
        shapes: every stage's shapes and contracts are checked and nothing
        runs on a device.  (The JAX package compiles the fused executable
        here; eager torch has nothing to compile.)"""
        if not self._stages:
            raise ValidationError("pipeline.warmup: empty pipeline")
        from ..program import tree_map

        layout, _ = self._entry_layout()
        cols = {
            name: torch.empty(tuple(np.shape(data)), dtype=st.torch_dtype, device="meta")
            for name, (data, st) in layout.items()
        }
        params = [
            {k: tree_map(lambda a: a.to("meta"), v) for k, v in p.items()}
            for p in self._params_list()
        ]
        with torch.no_grad(), observability.suppress_trace_count():
            self._body(cols, params)
        return self

    def readback(self, tree):
        """``tree`` (dicts/lists of device tensors) on the host as numpy
        (bf16 as CPU tensors): the chain's one counted readback."""
        self.readbacks += 1

        def host(v):
            if isinstance(v, torch.Tensor):
                return _host(v)
            if isinstance(v, Mapping):
                return {k: host(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(host(x) for x in v)
            return v

        return host(tree)

    def collect(self):
        """``run()`` and one readback: host arrays for a row-terminal
        chain, a host frame for a map-terminal one."""
        out = self.run()
        if self._row_stage:
            return self.readback(out)
        self.readbacks += 1
        return out.uncache()

    def iterate(self, num_steps: int, carry: Mapping[str, str],
                collect: Sequence[str] = ()) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Run the chain ``num_steps`` times, feeding outputs back into stage
        params between steps, all on the device: no readback, no host
        sync, no Python branch on a device value inside the loop.

        ``carry``: output name -> param name (every stage param of that
        name takes the output after each step).  ``collect``: outputs whose
        per-step values are stacked on the device as history.

        Returns ``(final_params, history)``, device tensors; the stage
        programs are updated in place, so ``run``/``iterate`` continue from
        the new state.  Read the results back with :meth:`readback`."""
        if not self._row_stage:
            raise ValidationError(
                "pipeline.iterate: requires a row-terminal chain "
                "(reduce/then) so step outputs can feed back into params."
            )
        if not carry:
            raise ValidationError(
                "pipeline.iterate: carry={} would loop without feedback; "
                "use run() in a host loop instead."
            )
        targets: List[Tuple[int, str, str]] = []
        for out_name, param_name in carry.items():
            hits = [i for i, st in enumerate(self._stages)
                    if st.program is not None and param_name in st.program.params]
            if not hits:
                raise ValidationError(
                    f"pipeline.iterate: carry target param {param_name!r} "
                    f"does not exist on any stage program."
                )
            targets.extend((i, param_name, out_name) for i in hits)
        with observability.verb_span(
            "pipeline.iterate", self._frame.num_rows, self._frame.num_blocks
        ) as span:
            span.mark("validate")
            finals, hist = self._iterate(num_steps, carry, collect, targets)
            span.mark("dispatch")
        for i, pname, _ in targets:
            self._stages[i].program.update_params(**{pname: finals[pname]})
        return finals, hist

    def _iterate(self, num_steps, carry, collect, targets):
        """The loop of :meth:`iterate`: ``(final params, history)`` on the
        device."""
        cols = self._entry_cols()
        pl = [dict(p) for p in self._params_list()]
        hist: Dict[str, List[torch.Tensor]] = {k: [] for k in collect}
        with torch.no_grad():
            for _ in range(num_steps):
                cancellation.checkpoint()
                row = self._body(cols, pl)
                for name in list(carry) + list(collect):
                    if name not in row:
                        raise ValidationError(
                            f"pipeline.iterate: {name!r} is not an output of "
                            f"the chain; outputs are {sorted(row)}."
                        )
                for i, pname, oname in targets:
                    old, new = pl[i][pname], row[oname]
                    if not isinstance(old, torch.Tensor):
                        raise ValidationError(
                            f"pipeline.iterate: param {pname!r} is a pytree, "
                            f"not a single array; only leaf-array params can "
                            f"be carried — bind the leaves as separate params."
                        )
                    if new.shape != old.shape:
                        raise ValidationError(
                            f"pipeline.iterate: carried output {oname!r} has "
                            f"shape {tuple(new.shape)} but param {pname!r} has "
                            f"shape {tuple(old.shape)}; shapes must match for a "
                            f"stable loop carry."
                        )
                    pl[i][pname] = new.to(old.dtype)
                for k in collect:
                    hist[k].append(row[k])
        finals = {pname: pl[i][pname] for i, pname, _ in targets}
        return finals, {k: torch.stack(v) if v else v for k, v in hist.items()}


def pipeline(frame: TensorFrame, engine=None, device: DeviceLike = None) -> Pipeline:
    """Start a verb chain over ``frame`` (see :class:`Pipeline`).
    ``device``: where the stage programs built from functions run (None =
    the CUDA card).  A ``MeshExecutor`` ``engine`` (mesh-global chains)
    waits for ROADMAP.md Queue 1 item 13."""
    if getattr(frame, "_tfs_lazy", False):
        # a Pipeline over a lazy frame materialises the plan first: a
        # Pipeline is its own chaining surface
        from . import planner

        frame = planner.ensure_frame(frame)
    if engine is not None:
        raise NotImplementedError(
            "pipeline(engine=...): mesh-global chains over a MeshExecutor "
            "are not ported yet: they wait for ROADMAP.md Queue 1 item 13"
        )
    return Pipeline(frame, device=device)
