"""Verb pre-flight validation for the map verbs.

PyTorch counterpart of the map-verb half of
``tensorframes_tpu/ops/validation.py``: each program input must name an
existing, fully-analyzed, device-feedable column.  Messages and ``TFSxxx``
codes are the JAX package's, word for word, so a failure reads the same
in both packages.  The reduce-verb contracts arrive with those verbs.
"""

from __future__ import annotations

from typing import Dict

from ..frame import TensorFrame
from ..program import Program
from ..schema import ColumnInfo


class ValidationError(ValueError):
    """A verb's schema contract was violated.  ``code``: the stable
    ``TFSxxx`` diagnostic code (``docs/ANALYSIS.md``)."""

    def __init__(self, message: str, code: str = None):
        super().__init__(message)
        self.code = code


def _column_for_input(
    frame: TensorFrame,
    program: Program,
    input_name: str,
    verb: str,
) -> ColumnInfo:
    col_name = program.column_for_input(input_name)
    schema = frame.schema
    if col_name not in schema:
        raise ValidationError(
            f"{verb}: program input {input_name!r} requests column "
            f"{col_name!r}, which does not exist in the frame. Available "
            f"columns: {schema.names}. (Program inputs are matched to columns "
            f"by name; pass feed_dict={{input: column}} to rename.)",
            code="TFS103",
        )
    ci = schema[col_name]
    if not ci.scalar_type.device_ok:
        raise ValidationError(
            f"{verb}: column {col_name!r} has host-only scalar type "
            f"{ci.scalar_type} and cannot be fed to a device program "
            f"directly. Pass host_stage={{{input_name!r}: decode_fn}} to run "
            f"a host-side preprocessing stage (e.g. JPEG decode -> uint8 "
            f"pixels) before the device program — the reference's in-graph "
            f"DecodeJpeg contract (read_image.py:164-167).",
            code="TFS104",
        )
    if not ci.is_analyzed:
        raise ValidationError(
            f"{verb}: column {col_name!r} has un-analyzed cell shape "
            f"{ci.cell_shape}. Run tensorframes_tpu.analyze(frame) first, "
            f"construct the frame from uniform arrays, or use map_rows "
            f"(which buckets ragged rows by shape).",
            code="TFS105",
        )
    return ci


def check_map_inputs(
    program: Program, frame: TensorFrame, verb: str
) -> Dict[str, ColumnInfo]:
    """Validate the inputs of a map verb; returns input -> ColumnInfo."""
    return {
        n: _column_for_input(frame, program, n, verb)
        for n in program.input_names
    }
