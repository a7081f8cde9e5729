"""MeshExecutor: the verbs over a device mesh.

Port of ``tensorframes_tpu/parallel/dist.py``.  Two execution modes, as in
the JAX package, because the reference's per-partition semantics and the
global semantics differ for cross-row programs:

* ``mode="global"`` (default): the whole frame is ONE logical block.  A
  cross-row program sees every row; ``reduce_blocks`` is one reduction
  over all rows.
* ``mode="per_block"``: the reference's partition semantics.  Each mesh
  device applies the program to its own ``n // d`` rows, the remainder
  runs as one extra block, and ``reduce_blocks`` re-applies the program to
  the per-device partials.

PyTorch has no partitioner: the JAX package hands the whole-frame program
to GSPMD, which splits it and inserts the collectives.  The port moves the
data itself and keeps the engine's one fold shape
(``Executor._combine_partials``: stack the partials in order, apply the
program once):

* ``map_blocks``/``map_rows`` split the rows into ``d`` equal shards, one a
  mesh device, and concatenate the outputs in order on the mesh's first
  device.  ``map_rows`` is row-independent by construction; ``map_blocks``
  splits only when ``analysis.rows_independent`` proves its program at the
  exact sizes (the true row count, the count padded to a multiple of
  ``d`` with repeats of the last row, and the shard size).  A cross-row or
  unproven program runs once over the whole block on the first device,
  and the JAX package's divisor warning is still logged.
* ``reduce_blocks``/``reduce_rows`` fold one partial a shard, stack them
  on the first device and re-apply the program once; an uneven row count
  reduces the even prefix over the whole mesh and the tail apart, then
  re-applies the program to the two partials (JAX ``_split_reduce``).
  ``reduce_rows(mode="sequential")`` keeps the strict left fold, exact.
* ``aggregate``: the monoid segment path pads with reduction identities
  to a multiple of ``d``, places one row shard a device
  (``_place_shards``), reduces each shard's segments there and reduces the
  per-shard partials again by key on the first device; the general path
  pads the groups axis of each bucket to a multiple of ``d`` and splits
  it (``_run_groups``).

A mesh of one device runs the serial engine over the frame as one block,
so it equals the serial verbs over the same rows bit for bit.

Across processes (``parallel/multihost.py``): a frame made by
``frame_from_process_local`` keeps each rank's rows on that rank's
devices.  The map verbs run each rank's rows there and return a
process-local frame; the reduce verbs all-gather the partials in rank
order before the one re-apply.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import analysis, dtypes, observability
from ..frame import Column, TensorFrame
from ..ops import device_pool, validation
from ..ops.engine import (
    Executor,
    GroupedFrame,
    _GroupRun,
    _check_shape_hints,
    _host,
    _segment_index,
    _segment_reduce,
    _with_prelude,
)
from ..ops.validation import ValidationError
from ..program import Program
from ..schema import ColumnInfo
from ..shape import Shape, UNKNOWN
from . import multihost
from .mesh import Mesh, data_mesh

_log = logging.getLogger("tensorframes_tpu_torch.parallel")

_IDENTITY = {"sum": 0, "prod": 1}


def _identity(kind: str, dtype: torch.dtype):
    """The reduction identity of ``kind`` in ``dtype`` (pad rows of the
    bare-monoid segment path)."""
    if kind in _IDENTITY:
        return _IDENTITY[kind]
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _whole(value):
    """A column value as one array: a process-local column's rows (all of
    them, in a single-process run) as a tensor."""
    if getattr(value, "_tfs_process_local", False):
        return value[0:len(value)]
    return value


def _pad_rows(value, pad: int, first: bool = False):
    """``value`` with ``pad`` repeats of its last (``first``: its first)
    row appended."""
    if not pad:
        return value
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
        row = value[:1] if first else value[-1:]
        return np.concatenate([value, np.repeat(row, pad, axis=0)])
    row = value[:1] if first else value[-1:]
    return torch.cat([value, row.expand((pad,) + tuple(value.shape[1:]))])


def _fill_rows(value, pad: int, fill):
    """``value`` with ``pad`` rows of ``fill`` appended."""
    if isinstance(value, torch.Tensor):
        return torch.cat([value, value.new_full((pad,) + tuple(value.shape[1:]), fill)])
    value = np.asarray(value)
    return np.concatenate([value, np.full((pad,) + value.shape[1:], fill, dtype=value.dtype)])


class MeshExecutor(Executor):
    """Verb executor over a :class:`~.mesh.Mesh` (None: :func:`data_mesh`,
    the CUDA cards)."""

    # monoid aggregates run the segment path split over the data axis
    # (_segment_run); non-monoid programs keep the general path with the
    # groups axis split (_run_groups)
    supports_segment_aggregate = True

    # the mesh IS this executor's multi-device story, so the block-parallel
    # device pool (ops/device_pool.py) must not also claim the devices
    supports_device_pool = False

    is_mesh = True

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        mode: str = "global",
        data_axis: str = "dp",
    ):
        if mode not in ("global", "per_block"):
            raise ValidationError(
                f"MeshExecutor mode must be 'global' or 'per_block', got "
                f"{mode!r}"
            )
        self.mesh = mesh if mesh is not None else data_mesh()
        if data_axis not in self.mesh.axis_names:
            raise ValidationError(
                f"data axis {data_axis!r} not in mesh axes "
                f"{self.mesh.axis_names}"
            )
        self.mode = mode
        self.axis = data_axis

    # -- helpers -------------------------------------------------------------

    @property
    def default_device(self) -> torch.device:
        """The mesh's first device, where the reductions meet."""
        return self.mesh.device

    @property
    def _num_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _device(self, i: int) -> torch.device:
        """The device of this process's shard ``i``."""
        devs = self.mesh.devices
        return devs[i % len(devs)]

    def _serial(self, frame: TensorFrame) -> bool:
        """One position on the data axis and the rows in this process: the
        verbs run the serial engine over the frame as one block."""
        return self._num_shards == 1 and not multihost.is_process_local(frame)

    @staticmethod
    def _one_block(frame: TensorFrame) -> TensorFrame:
        return TensorFrame(list(frame.columns), (0, frame.num_rows))

    def _programs(self, program: Program):
        """``on(i)``: ``program`` with its params on shard ``i``'s device
        (one copy a device and verb call)."""
        copies: Dict[torch.device, Program] = {}

        def on(i: int) -> Program:
            dev = self._device(i)
            if dev not in copies:
                copies[dev] = device_pool.program_on(program, dev)
            return copies[dev]

        return on

    def _divisor(self, n: int) -> int:
        """The JAX package's divisor fallback for ``n`` rows: the largest
        divisor of ``n`` that fits the data axis, with its warning when
        ``n`` is not a multiple of it."""
        d = self._num_shards
        if n % d == 0:
            return d
        dd = d
        while n % dd:
            dd -= 1
        _log.warning(
            "row count %d is not divisible by the %d-device data axis; "
            "executing on %d device(s). Size row counts as a multiple of "
            "the mesh for full parallelism.",
            n,
            d,
            dd,
        )
        return dd

    def _place_shards(self, values: Mapping[str, tuple], rows: int, k: int) -> List[Dict[str, torch.Tensor]]:
        """``values`` (name -> ``(value, scalar type)``, ``rows`` rows each)
        split into ``k`` equal row shards, shard ``i`` staged on device
        ``i``: the placement every split path makes."""
        m = rows // k
        return [
            self._stage_values(
                {nm: (v[i * m:(i + 1) * m], st) for nm, (v, st) in values.items()},
                self._device(i),
            ).ready()
            for i in range(k)
        ]

    def _run_shards(self, shards, call_for) -> List[Dict[str, torch.Tensor]]:
        """``call_for(i)(shards[i])`` on each shard's device, in order."""
        outs = []
        for i, ins in enumerate(shards):
            with device_pool.device_scope(self._device(i)):
                outs.append(call_for(i)(ins))
        return outs

    def _gather(self, outs: List[Dict[str, torch.Tensor]], rows: Optional[int] = None):
        """Per-shard outputs concatenated in shard order on the first
        device, trimmed to ``rows``."""
        dev = self.mesh.device
        if len(outs) == 1:
            cat = {k: v.to(dev) for k, v in outs[0].items()}
        else:
            cat = {k: torch.cat([o[k].to(dev) for o in outs]) for k in outs[0]}
        if rows is None:
            return cat
        return {k: v[:rows] for k, v in cat.items()}

    def _input_values(self, program: Program, frame: TensorFrame, infos, host_stage) -> Dict[str, tuple]:
        """Every program input's whole column as ``(value, scalar type)``
        (host stage applied where present)."""
        out = {}
        for name in program.input_names:
            col = frame.column(program.column_for_input(name))
            if host_stage and name in host_stage:
                arr = self._staged_value(host_stage[name], col.cells(), name)
                out[name] = (arr, dtypes.coerce(dtypes.from_numpy(arr.dtype)))
            else:
                out[name] = (_whole(col.data), dtypes.coerce(infos[name].scalar_type))
        return out

    def _global_inputs(self, program: Program, frame: TensorFrame, infos, host_stage=None,
                       pad: int = 0) -> List[Dict[str, torch.Tensor]]:
        """The inputs placed over the whole data axis (``pad`` repeats of
        the last row appended first): one dict of tensors a shard."""
        values = {k: (_pad_rows(v, pad), st)
                  for k, (v, st) in self._input_values(program, frame, infos, host_stage).items()}
        return self._place_shards(values, frame.num_rows + pad, self._num_shards)

    def _pad_safe(self, program, frame, infos, host_stage) -> bool:
        """Whether ``map_blocks`` may pad and split this program over the
        data axis: ``analysis.rows_independent`` at the true row count, the
        padded count and the shard size.  Host-staged, ragged and
        host-only inputs never split."""
        if host_stage:
            return False
        for name in program.input_names:
            col = frame.column(program.column_for_input(name))
            if col.is_ragged or not col.info.scalar_type.device_ok:
                return False
        specs = analysis.input_specs_for(program, infos)
        if specs is None:
            return False
        n = frame.num_rows
        padded = n + ((-n) % self._num_shards)
        sizes = sorted({n, padded, padded // self._num_shards})
        return analysis.rows_independent(program, specs, sizes)

    def _finish_map(self, frame: TensorFrame, outs: Dict[str, torch.Tensor], trim: bool) -> TensorFrame:
        # one output block; a non-trimmed map keeps the caller's logical
        # partitioning, and the outputs stay on the device
        out = TensorFrame.from_blocks([outs])
        if trim:
            return out
        return self._with_passthrough(frame, list(out.columns), frame.offsets)

    def _serial_map(self, frame, trim, run) -> TensorFrame:
        """A map verb on a one-position mesh: the serial engine over the
        frame as one block, the output keeping the caller's blocks."""
        out = run(self._one_block(frame))
        if trim:
            return out
        return TensorFrame(list(out.columns), frame.offsets)

    # -- map verbs -----------------------------------------------------------

    def map_blocks(
        self,
        program: Program,
        frame: TensorFrame,
        trim: bool = False,
        host_stage=None,
    ) -> TensorFrame:
        if self._serial(frame):
            return self._serial_map(
                frame, trim,
                lambda f: Executor.map_blocks(self, program, f, trim=trim, host_stage=host_stage),
            )
        host_stage = _with_prelude(program, host_stage)
        with observability.verb_span("map_blocks", frame.num_rows, frame.num_blocks) as span:
            infos = validation.check_map_inputs(
                program, frame, "map_blocks", host_staged=host_stage or ()
            )
            span.mark("validate")
            program.note_entry(False)
            n = frame.num_rows
            with torch.no_grad():
                if multihost.is_process_local(frame):
                    return self._map_process_local(program, frame, infos, False, trim, host_stage)
                if self.mode == "per_block":
                    outs = self._map_blocks_per_block(program, frame, infos, host_stage)
                else:
                    outs = self._map_blocks_global(program, frame, infos, host_stage)
            span.mark("dispatch")
            if not trim:
                for name, v in outs.items():
                    if v.ndim == 0 or v.shape[0] != n:
                        if self.mode == "per_block":
                            raise ValidationError(
                                f"map_blocks(per_block): output {name!r} has shape "
                                f"{tuple(v.shape)}, expected lead dim {n}"
                            )
                        raise ValidationError(
                            f"map_blocks: output {name!r} has shape {tuple(v.shape)} but "
                            f"the frame has {n} rows; a non-trimmed map must "
                            f"preserve the row count (use map_blocks_trimmed)."
                        )
            _check_shape_hints(program, outs, "map_blocks", cell_level=False)
            return self._finish_map(frame, outs, trim)

    def _map_blocks_global(self, program, frame, infos, host_stage):
        """The global mode: split over the whole data axis when the program
        is proven row-independent, else one call over the whole block."""
        n = frame.num_rows
        d = self._num_shards
        if n and self._pad_safe(program, frame, infos, host_stage):
            # the program is provably row-independent, so padding rows
            # (repeats of the last row) and splitting cannot change the
            # first n output rows
            pad = (-n) % d
            shards = self._global_inputs(program, frame, infos, host_stage, pad=pad)
            on = self._programs(program)
            return self._gather(self._run_shards(shards, lambda i: on(i).call), n)
        self._divisor(n)  # the JAX package's fallback warning, when uneven
        values = self._input_values(program, frame, infos, host_stage)
        ins = self._place_shards(values, n, 1)[0]
        with device_pool.device_scope(self.mesh.device):
            return self._gather([program.call(ins)])

    def _map_blocks_per_block(self, program, frame, infos, host_stage):
        """Reference per-partition semantics: one program application per
        device-local block of ``n // d`` rows, the remainder as one extra
        block on the first device."""
        d = self._num_shards
        n = frame.num_rows
        n_even = (n // d) * d
        if n_even == 0:
            raise ValidationError(
                f"map_blocks(per_block): frame has {n} rows < {d} devices; "
                f"use the global mode or fewer devices"
            )
        values = self._input_values(program, frame, infos, host_stage)
        shards = self._place_shards({k: (v[:n_even], st) for k, (v, st) in values.items()}, n_even, d)
        on = self._programs(program)
        outs = self._run_shards(shards, lambda i: on(i).call)
        if n_even < n:
            tail = self._place_shards({k: (v[n_even:], st) for k, (v, st) in values.items()}, n - n_even, 1)[0]
            with device_pool.device_scope(self.mesh.device):
                outs.append(program.call(tail))
        return self._gather(outs)

    def map_rows(self, program: Program, frame: TensorFrame, host_stage=None) -> TensorFrame:
        """Row semantics are partition-independent, so both modes pad the
        rows to a multiple of the data axis, split them and vmap each
        shard on its device (ragged columns: one padded, split call a
        shape bucket, ``_run_rows_bucket``)."""
        if self._serial(frame):
            return self._serial_map(
                frame, False,
                lambda f: Executor.map_rows(self, program, f, host_stage=host_stage),
            )
        host_stage = _with_prelude(program, host_stage)
        with observability.verb_span("map_rows", frame.num_rows, frame.num_blocks) as span:
            infos = validation.check_map_inputs(
                program, frame, "map_rows", host_staged=host_stage or (), allow_ragged=True,
            )
            span.mark("validate")
            ragged = [
                nm for nm in program.input_names
                if not (host_stage and nm in host_stage)
                and frame.column(program.column_for_input(nm)).is_ragged
            ]
            if ragged:
                out = self._map_rows_ragged(program, frame, infos, ragged, host_stage)
                span.mark("dispatch")
                return out
            program.note_entry(True)
            n = frame.num_rows
            with torch.no_grad():
                if multihost.is_process_local(frame):
                    return self._map_process_local(program, frame, infos, True, False, host_stage)
                if n == 0:
                    outs = self._empty_map_outputs(program, infos, True)
                    return self._build_map_output(frame, [outs], trim=False)
                pad = (-n) % self._num_shards
                shards = self._global_inputs(program, frame, infos, host_stage, pad=pad)
                on = self._programs(program)
                outs = self._gather(self._run_shards(shards, lambda i: on(i).vmapped()), n)
            span.mark("dispatch")
            _check_shape_hints(program, outs, "map_rows", cell_level=True)
            return self._finish_map(frame, outs, trim=False)

    def _run_rows_bucket(self, program: Program, values: Mapping[str, tuple]) -> Dict[str, torch.Tensor]:
        """A ragged ``map_rows`` bucket split over the data axis: rows are
        independent under vmap, so the bucket pads to a multiple of the
        axis (repeating its last row), each shard runs on its device, and
        the pad rows are sliced off."""
        d = self._num_shards
        if d == 1:
            return Executor._run_rows_bucket(self, program, values)
        k = len(next(iter(values.values()))[0])
        pad = (-k) % d
        shards = self._place_shards({n: (_pad_rows(v, pad), st) for n, (v, st) in values.items()}, k + pad, d)
        on = self._programs(program)
        return self._gather(self._run_shards(shards, lambda i: on(i).vmapped()), k)

    def _map_process_local(self, program, frame, infos, rows_level, trim, host_stage):
        """A map verb over a multi-process frame: each device runs the
        program on its shard of this rank's rows, and the outputs stay
        there as a process-local frame."""
        verb = "map_rows" if rows_level else "map_blocks"
        if host_stage:
            raise ValidationError(
                f"{verb}: host_stage needs a host column, and a process-local "
                f"frame keeps its rows on the devices; stage before "
                f"frame_from_process_local"
            )
        cols = {nm: frame.column(program.column_for_input(nm)) for nm in program.input_names}
        shards_of = {nm: c.data.shards for nm, c in cols.items()}
        m = int(next(iter(shards_of.values()))[0].shape[0])
        if not rows_level and self.mode == "global" and not trim:
            specs = analysis.input_specs_for(program, infos)
            if specs is None or not analysis.rows_independent(
                program, specs, sorted({frame.num_rows, m})
            ):
                raise ValidationError(
                    "map_blocks: a global-mode program over a process-local "
                    "frame must be provably row-independent, since other "
                    "processes hold the other rows; use mode='per_block' "
                    "for per-partition semantics"
                )
        on = self._programs(program)
        outs = []
        for i in range(len(self.mesh.devices)):
            dev = self._device(i)
            ins = {nm: shards_of[nm][i].to(dtypes.coerce(infos[nm].scalar_type).torch_dtype)
                   for nm in cols}
            with device_pool.device_scope(dev):
                p = on(i)
                out = p.vmapped()(ins) if rows_level else p.call(ins)
            if not trim:
                for name, v in out.items():
                    if v.ndim == 0 or v.shape[0] != m:
                        raise ValidationError(
                            f"{verb}: output {name!r} has shape {tuple(v.shape)} "
                            f"but the device shard has {m} rows; a non-trimmed "
                            f"map must preserve the row count"
                        )
            outs.append(out)
        _check_shape_hints(program, outs[0], verb, cell_level=rows_level)
        local = sum(int(next(iter(o.values())).shape[0]) for o in outs)
        counts = multihost._all_gather_ints([local])
        lo = sum(counts[:multihost.process_index()])
        out_cols = []
        for name in outs[0]:
            data = multihost.ProcessLocalData(name, [o[name] for o in outs], lo, sum(counts))
            info = ColumnInfo(name, dtypes.from_torch(data.dtype), Shape(data.shape).with_lead(UNKNOWN))
            out_cols.append(Column(info, data))
        if trim:
            res = TensorFrame(out_cols)
        else:
            res = self._with_passthrough(frame, out_cols, frame.offsets)
        res.process_rows = (lo, lo + local)
        return res

    # -- reduce verbs ---------------------------------------------------------

    def _partials(self, runner, values, lo: int, hi: int, k: int) -> List[Dict[str, torch.Tensor]]:
        """One partial a shard of rows ``[lo, hi)`` split ``k`` ways, folded
        on its device and moved to the first device, in shard order."""
        shards = self._place_shards({b: (v[lo:hi], st) for b, (v, st) in values.items()}, hi - lo, k)
        parts = self._run_shards(shards, runner)
        return [{b: p[b].to(self.mesh.device) for b in p} for p in parts]

    def _split_reduce(self, runner, values, n: int) -> Dict[str, torch.Tensor]:
        """A reduction over ``n`` rows on the whole data axis when ``n`` is
        not a multiple of it: the even prefix split over every device, the
        tail apart, then the program re-applied to the two stacked partials
        (legal because the verb contracts require re-applicable
        reductions, JAX ``_split_reduce``)."""
        d = self._num_shards
        n_even = (n // d) * d
        bases = list(values)
        p1 = self._combine_partials(runner(0), bases, self._partials(runner, values, 0, n_even, d))
        if n_even == n:
            return p1
        p2 = self._partials(runner, values, n_even, n, 1)[0]
        return self._combine_partials(runner(0), bases, [p1, p2])

    def _reduce_run(self, program, run_for, bases, reduced, frame, sequential: bool):
        """The device side of the reduce verbs: the final row on the first
        device."""
        on = self._programs(program)

        def runner(i):
            return run_for(on(i))

        if multihost.is_process_local(frame):
            if sequential:
                raise ValidationError(
                    "reduce_rows(mode='sequential'): the strict left fold needs "
                    "every row in one process; a process-local frame keeps "
                    "them apart (use mode='tree')"
                )
            return self._reduce_process_local(runner, bases, reduced, frame)
        n = frame.num_rows
        d = self._num_shards
        values = {
            b: (_whole(frame.column(reduced[b].name).data), dtypes.coerce(reduced[b].scalar_type))
            for b in bases
        }
        if sequential:
            # the strict left fold in row order, exact: one call over every row
            self._divisor(n)
            return self._partials(runner, values, 0, n, 1)[0]
        if self.mode == "per_block":
            n_even = (n // d) * d
            if n_even == 0:
                raise ValidationError(
                    f"reduce_blocks(per_block): frame has {n} rows < {d} devices"
                )
            partials = self._partials(runner, values, 0, n_even, d)
            if n_even < n:
                partials += self._partials(runner, values, n_even, n, 1)
            return self._combine_partials(runner(0), bases, partials)
        if n % d and n >= d:
            return self._split_reduce(runner, values, n)
        k = self._divisor(n)
        return self._combine_partials(runner(0), bases, self._partials(runner, values, 0, n, k))

    def _reduce_process_local(self, runner, bases, reduced, frame):
        """Partials of this rank's device shards, all-gathered in rank
        order, then the one re-apply on the first device."""
        local = []
        for i in range(len(self.mesh.devices)):
            ins = {b: frame.column(reduced[b].name).data.shards[i].to(
                dtypes.coerce(reduced[b].scalar_type).torch_dtype) for b in bases}
            with device_pool.device_scope(self._device(i)):
                local.append(runner(i)(ins))
        dev = self.mesh.device
        stacked = {b: torch.stack([p[b].to(dev) for p in local]) for b in bases}
        gathered = {b: torch.cat(multihost.all_gather_tensor(stacked[b])) for b in bases}
        partials = [{b: gathered[b][j] for b in bases} for j in range(gathered[bases[0]].shape[0])]
        return self._combine_partials(runner(0), bases, partials)

    def _mesh_reduce(self, verb, program, frame, setup, sequential=False) -> Dict[str, object]:
        with observability.verb_span(verb, frame.num_rows, frame.num_blocks) as span:
            bases, reduced, run_for = setup()
            span.mark("validate")
            with torch.no_grad():
                final = self._reduce_run(program, run_for, bases, reduced, frame, sequential)
            span.mark("dispatch")
            out = {b: _host(final[b]) for b in bases}
            span.mark("sync")
            return out

    def reduce_rows(self, program: Program, frame: TensorFrame, mode: str = "tree"):
        """The pairwise fold over the global rows, shard partials folded
        again on the first device (both modes: row semantics are
        partition-independent)."""
        if self._serial(frame):
            return Executor.reduce_rows(self, program, self._one_block(frame), mode=mode)
        return self._mesh_reduce(
            "reduce_rows", program, frame,
            lambda: self._reduce_rows_setup(program, frame, mode),
            sequential=mode == "sequential",
        )

    def reduce_blocks(self, program: Program, frame: TensorFrame):
        if self._serial(frame):
            return Executor.reduce_blocks(self, program, self._one_block(frame))
        return self._mesh_reduce(
            "reduce_blocks", program, frame, lambda: self._reduce_blocks_setup(program, frame)
        )

    # -- aggregate ------------------------------------------------------------

    def aggregate(self, program: Program, grouped: GroupedFrame) -> TensorFrame:
        if multihost.is_process_local(grouped.frame):
            raise ValidationError(
                "aggregate: a process-local frame keeps its rows apart across "
                "processes; the keyed reduction needs them in one process"
            )
        return Executor.aggregate(self, program, grouped)

    def _segment_run(self, program, plan, keys, data, span):
        """The segment path split over the data axis: each shard's rows are
        sorted and segment-reduced on its device; the per-shard partials
        (keys, reductions, counts) meet on the first device, in shard
        order, and are reduced again by key with the same kinds before the
        plan's group stage.  Only bare-monoid plans pad (their stages never
        read a pad row's count); others split over the largest divisor."""
        if self._num_shards == 1:
            return Executor._segment_run(self, program, plan, keys, data, span)
        n = len(next(iter(keys.values()))[0])
        # bare-monoid plans pad to a data-axis multiple with reduction
        # identities, so uneven row counts split over the WHOLE mesh
        # instead of the largest divisor
        pad = (-n) % self._num_shards if plan.trivial_kinds else 0
        k = self._num_shards if pad else self._divisor(n)
        # pad keys copy row 0's key (no group is added), pad values are the
        # reduction's identity (no group's result changes)
        values = {f"key:{kn}": (_pad_rows(_whole(v), pad, first=True), st)
                  for kn, (v, st) in keys.items()}
        for name, (v, st) in data.items():
            v = _whole(v)
            if pad:
                base = name[: -len("_input")]
                v = _fill_rows(v, pad, _identity(plan.trivial_kinds[base], st.torch_dtype))
            values[name] = (v, st)
        shards = self._place_shards(values, n + pad, k)
        on = self._programs(program)
        dev = self.mesh.device
        parts = []
        for i, ins in enumerate(shards):
            with device_pool.device_scope(self._device(i)):
                uniq, order, counts = _segment_index([ins[f"key:{kn}"] for kn in keys])
                pre = plan.pre({nm: ins[nm] for nm in data}, on(i).params)
                segs = [_segment_reduce(pc[order], kind, counts)
                        for pc, kind in zip(pre, plan.reduce_kinds)]
            parts.append(([u.to(dev) for u in uniq], [s.to(dev) for s in segs], counts.to(dev)))
        span.mark("group_index_device")
        ukeys = [torch.cat([p[0][j] for p in parts]) for j in range(len(keys))]
        uniq, order, n_parts = _segment_index(ukeys)
        segs = [
            _segment_reduce(torch.cat([p[1][j] for p in parts])[order], kind, n_parts)
            for j, kind in enumerate(plan.reduce_kinds)
        ]
        counts = _segment_reduce(torch.cat([p[2] for p in parts])[order], "sum", n_parts)
        return uniq, plan.post(segs, counts, program.params)

    def _run_groups(self, vrun, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One [groups, size, *cell] bucket of the general path split over
        the data axis: the groups axis pads to a multiple of it (groups are
        independent under vmap) and each shard runs on its device."""
        d = self._num_shards
        if d == 1 or not isinstance(vrun, _GroupRun):
            return vrun(batch)
        g = next(iter(batch.values())).shape[0]
        pad = (-g) % d
        values = {b: (_pad_rows(v, pad), dtypes.from_torch(v.dtype)) for b, v in batch.items()}
        shards = self._place_shards(values, g + pad, d)
        on = self._programs(vrun.program)
        return self._gather(self._run_shards(shards, lambda i: _GroupRun(on(i), vrun.bases)), g)


__all__ = ["MeshExecutor"]
