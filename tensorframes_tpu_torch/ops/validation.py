"""Verb pre-flight validation: the ``SchemaTransforms`` layer.

PyTorch counterpart of ``tensorframes_tpu/ops/validation.py``:

* map verbs: each program input must name an existing, fully-analyzed,
  device-feedable column (``map_rows`` also takes ragged columns);
* ``reduce_rows``: the pairwise ``x_1``/``x_2`` naming contract, each
  output ``x`` keeping the cell shape of column ``x``;
* ``reduce_blocks``/``aggregate``: the ``x_input`` block contract, each
  output ``x`` one cell of column ``x``.

Messages and ``TFSxxx`` codes are the JAX package's, word for word, so a
failure reads the same in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

from ..frame import TensorFrame
from ..program import GraphNodeSummary, Program
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
    host_staged: bool = False,
    allow_ragged: bool = False,
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
    if host_staged:
        # a host stage materialises this input on the host, so binary /
        # ragged / un-analyzed columns are all legal here
        return ci
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
        if allow_ragged:
            # map_rows resolves ragged cells per row by shape-bucketing
            return ci
        raise ValidationError(
            f"{verb}: column {col_name!r} has un-analyzed cell shape "
            f"{ci.cell_shape}. Run tensorframes_tpu.analyze(frame) first, "
            f"construct the frame from uniform arrays, or use map_rows "
            f"(which buckets ragged rows by shape).",
            code="TFS105",
        )
    return ci


def check_map_inputs(
    program: Program,
    frame: TensorFrame,
    verb: str,
    host_staged=(),
    allow_ragged: bool = False,
) -> Dict[str, ColumnInfo]:
    """Validate the inputs of map_blocks/map_rows; returns input->ColumnInfo.

    ``host_staged``: input names whose data a host preprocessing stage
    produces rather than the column directly."""
    staged = set(host_staged)
    unknown = staged - set(program.input_names)
    if unknown:
        raise ValidationError(
            f"{verb}: host_stage given for names {sorted(unknown)} that are "
            f"not program inputs; inputs are {program.input_names}",
            code="TFS112",
        )
    return {
        n: _column_for_input(
            frame, program, n, verb, host_staged=n in staged,
            allow_ragged=allow_ragged,
        )
        for n in program.input_names
    }


def check_reduce_rows(program: Program, frame: TensorFrame) -> Dict[str, ColumnInfo]:
    """Enforce the pairwise x_1/x_2 contract; returns output name -> ColumnInfo.

    Reference: ``reduceRowsSchema`` (``DebugRowOps.scala:172-262``).
    """
    inputs = set(program.input_names)
    outputs: Dict[str, ColumnInfo] = {}
    suffixed = {}
    for n in inputs:
        if n.endswith("_1") or n.endswith("_2"):
            suffixed.setdefault(n[:-2], set()).add(n[-1])
        else:
            raise ValidationError(
                f"reduce_rows: program input {n!r} does not follow the "
                f"pairwise naming convention: every input must be named "
                f"'<col>_1' or '<col>_2' (Operations.scala:86-96).",
                code="TFS106",
            )
    for base, halves in suffixed.items():
        if halves != {"1", "2"}:
            raise ValidationError(
                f"reduce_rows: column {base!r} must be consumed as BOTH "
                f"{base}_1 and {base}_2; found only suffix(es) "
                f"{sorted(halves)}.",
                code="TFS106",
            )
        # both halves of a pair must feed from the SAME column (the
        # pairwise fold has one source)
        c1 = program.column_for_input(f"{base}_1")
        c2 = program.column_for_input(f"{base}_2")
        col = base if c1 == f"{base}_1" else c1
        col2 = base if c2 == f"{base}_2" else c2
        if col != col2:
            raise ValidationError(
                f"reduce_rows: inputs {base}_1/{base}_2 must feed from one "
                f"column; the feed maps them to {col!r} and {col2!r}.",
                code="TFS107",
            )
        schema = frame.schema
        if col not in schema:
            raise ValidationError(
                f"reduce_rows: inputs {base}_1/{base}_2 refer to column "
                f"{col!r}, which does not exist. Available: {schema.names}.",
                code="TFS103",
            )
        ci = schema[col]
        if not ci.is_analyzed:
            raise ValidationError(
                f"reduce_rows: column {col!r} has un-analyzed cell shape "
                f"{ci.cell_shape}; run analyze(frame) first.",
                code="TFS105",
            )
        outputs[base] = ci
    return outputs


def check_reduce_rows_outputs(
    reduced: Mapping[str, ColumnInfo],
    summaries: List[GraphNodeSummary],
) -> None:
    out_names = {s.name for s in summaries if s.is_output}
    expected = set(reduced)
    if out_names != expected:
        raise ValidationError(
            f"reduce_rows: program outputs {sorted(out_names)} must exactly "
            f"match the reduced columns {sorted(expected)} (each output x is "
            f"the combined value of x_1 and x_2).",
            code="TFS109",
        )
    for s in summaries:
        if s.is_output:
            ci = reduced[s.name]
            if tuple(s.shape) != tuple(ci.cell_shape):
                raise ValidationError(
                    f"reduce_rows: output {s.name!r} has shape {s.shape} but "
                    f"column {s.name!r} has cell shape {ci.cell_shape}; a "
                    f"pairwise reducer must preserve the cell shape.",
                    code="TFS109",
                )


def check_reduce_blocks(
    program: Program, frame: TensorFrame, verb: str = "reduce_blocks"
) -> Dict[str, ColumnInfo]:
    """Enforce the x_input block contract; returns output name -> ColumnInfo
    (the RESOLVED source column's, so a feed-dict rename reads its column).

    Reference: ``reduceBlocksSchema`` (``DebugRowOps.scala:80-170``).
    """
    outputs: Dict[str, ColumnInfo] = {}
    for n in program.input_names:
        if not n.endswith("_input"):
            raise ValidationError(
                f"{verb}: program input {n!r} does not follow the block "
                f"naming convention: every input must be named '<col>_input' "
                f"and consume a whole block of column <col> "
                f"(Operations.scala:98-108).",
                code="TFS108",
            )
        base = n[: -len("_input")]
        col = program.column_for_input(n)
        if col == n:
            col = base
        schema = frame.schema
        if col not in schema:
            raise ValidationError(
                f"{verb}: input {n!r} refers to column {col!r}, which does "
                f"not exist. Available: {schema.names}.",
                code="TFS103",
            )
        ci = schema[col]
        if not ci.is_analyzed:
            raise ValidationError(
                f"{verb}: column {col!r} has un-analyzed cell shape "
                f"{ci.cell_shape}; run analyze(frame) first.",
                code="TFS105",
            )
        if not ci.scalar_type.device_ok:
            raise ValidationError(
                f"{verb}: column {col!r} is host-only ({ci.scalar_type}) and "
                f"cannot be reduced on device.",
                code="TFS104",
            )
        outputs[base] = ci
    return outputs


def check_reduce_blocks_outputs(
    reduced: Mapping[str, ColumnInfo],
    summaries: List[GraphNodeSummary],
    verb: str = "reduce_blocks",
) -> None:
    out_names = {s.name for s in summaries if s.is_output}
    expected = set(reduced)
    if out_names != expected:
        raise ValidationError(
            f"{verb}: program outputs {sorted(out_names)} must exactly match "
            f"the reduced columns {sorted(expected)} (each output x is the "
            f"block-reduction of x_input).",
            code="TFS109",
        )
    for s in summaries:
        if s.is_output:
            ci = reduced[s.name]
            if tuple(s.shape) != tuple(ci.cell_shape):
                raise ValidationError(
                    f"{verb}: output {s.name!r} has shape {s.shape} but column "
                    f"{s.name!r} has cell shape {ci.cell_shape}; a block "
                    f"reducer must emit one cell per block so the reduction "
                    f"can be re-applied across blocks.",
                    code="TFS109",
                )
