"""The execution engine: a serial, single-device ``map_blocks``.

PyTorch counterpart of the map-blocks path of
``tensorframes_tpu/ops/engine.py``: input staging (``_device_inputs``),
the per-block program call, the per-block output checks (same messages),
the output frame with passthrough columns shadowed by outputs, and the
empty-frame contract.  Blocks run one after another on the program's
device; PyTorch launches asynchronously, so block N+1's host->device copy
is queued while block N computes.  Outputs stay on the device as tensors
until ``collect``/``to_arrays``.

Bucketing, prefetch, the device pool, the frame cache, fault tolerance,
streaming plans, spans and the other verbs wait for later slices
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import dtypes
from ..device import DeviceLike, resolve_device
from ..frame import TensorFrame
from ..program import Program
from ..schema import ColumnInfo
from . import validation
from .validation import ValidationError


class Executor:
    """Serial verb executor: blocks run one after another on the program's
    device (where its params live)."""

    # ---------------------------------------------------------------- map --

    def _device_value(self, value: Any, st, device: torch.device) -> torch.Tensor:
        """One block/column of data -> device tensor in its compute dtype.
        Tensors (chained verb outputs) are used in place — at most a cast;
        host arrays are cast on the host, then copied."""
        if isinstance(value, torch.Tensor):
            return value.to(device=device, dtype=st.torch_dtype)
        arr = np.ascontiguousarray(np.asarray(value), dtype=st.host_dtype())
        return torch.from_numpy(arr).to(device, non_blocking=True)

    def _device_inputs(
        self,
        program: Program,
        block: Mapping[str, Any],
        infos: Mapping[str, ColumnInfo],
        device: torch.device,
    ) -> Dict[str, torch.Tensor]:
        inputs = {}
        for n in program.input_names:
            value = block[program.column_for_input(n)]
            st = dtypes.coerce(infos[n].scalar_type)
            inputs[n] = self._device_value(value, st, device)
        return inputs

    def map_blocks(
        self,
        program: Program,
        frame: TensorFrame,
        trim: bool = False,
    ) -> TensorFrame:
        """``mapBlocks`` / ``mapBlocksTrimmed`` (trim=True: output row count
        may differ, no passthrough columns)."""
        device = program.device
        infos = validation.check_map_inputs(program, frame, "map_blocks")
        if frame.num_rows == 0 and not trim:
            # empty-frame contract: a non-trimmed map of an empty frame is
            # an empty frame with the program's inferred output schema — no
            # program execution.  (A TRIMMED map still applies the program
            # to the empty block: its output row count is program-defined.)
            out_blocks = [self._empty_map_outputs(program, infos)]
        else:
            out_blocks = []
            with torch.no_grad():
                for bi, n_rows in enumerate(frame.block_sizes):
                    inputs = self._device_inputs(
                        program, frame.block(bi), infos, device
                    )
                    outs = program.call(inputs)
                    del inputs
                    self._check_block_outputs(outs, n_rows, trim)
                    out_blocks.append(outs)
        return self._build_map_output(frame, out_blocks, trim)

    def _check_block_outputs(self, outs, n_rows: int, trim: bool) -> None:
        """The non-trimmed row-count contract and the trimmed agreement
        contract (shapes print as tuples, as in the JAX package)."""
        if not trim:
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

    def _empty_map_outputs(
        self, program: Program, infos
    ) -> Dict[str, np.ndarray]:
        """Zero-row output block for the empty-frame map contract, shaped
        by ``Program.analyze`` (meta tensors: nothing runs)."""
        specs = {
            n: (dtypes.coerce(infos[n].scalar_type), (0,) + tuple(infos[n].cell_shape))
            for n in program.input_names
        }
        outs: Dict[str, np.ndarray] = {}
        for s in program.analyze(specs):
            if not s.is_output:
                continue
            shape = tuple(s.shape)
            if not shape or shape[0] != 0:
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
        # non-trimmed: append original columns not shadowed by outputs
        # (outputs ++ original, DebugRowOps.scala:349-372; the schema
        # forbids duplicate names, so an output shadows its namesake)
        shadowed = set(out_frame.column_names)
        cols = list(out_frame.columns)
        for cname in frame.column_names:
            if cname not in shadowed:
                cols.append(frame.column(cname))
        return TensorFrame(cols, out_frame.offsets)


# ---------------------------------------------------------------------------
# public verb API
# ---------------------------------------------------------------------------


def map_blocks(
    fn,
    frame: TensorFrame,
    trim: bool = False,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    device: DeviceLike = None,
) -> TensorFrame:
    """Apply a block-level program to every block.

    ``fn``: a :class:`Program` or a callable (wrapped on ``device``; None =
    the CUDA card).  Passing ``device=`` with a Program that lives on
    another device raises."""
    if isinstance(fn, Program):
        program = Program.wrap(fn, fetches, feed_dict)
        if device is not None and resolve_device(device) != program.device:
            raise ValueError(
                f"map_blocks(device={str(device)!r}) but the program's params "
                f"live on {program.device}"
            )
    else:
        program = Program.wrap(fn, fetches, feed_dict, device=device)
    return Executor().map_blocks(program, frame, trim=trim)


def map_blocks_trimmed(fn, frame: TensorFrame, **kw) -> TensorFrame:
    """``map_blocks(..., trim=True)``: the output row count may differ."""
    return map_blocks(fn, frame, trim=True, **kw)
