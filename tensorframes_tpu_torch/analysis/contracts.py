"""``tft.check``: pre-dispatch contract verification.

PyTorch counterpart of ``tensorframes_tpu/analysis/contracts.py``.
``check(frame, program, verb)`` runs the verbs' schema checks
(``ops/validation.py``), program construction (``builder.py``, the
GraphDef importer), shape inference on ``meta`` tensors and the
row-dependence classification, all without dispatching anything, and
returns structured diagnostics instead of raising at the first one::

    [Diagnostic(code="TFS103", severity="error",
                summary="map_blocks: program input 'x' requests ...",
                location="map_blocks:input:x",
                advice="pass feed_dict={input: column} ..."), ...]

Codes, severities and advice are the JAX package's, and the same codes
ride on the dispatch-time exceptions (``ValidationError.code``), the
relational checks (``TFS14x``, :func:`check_relational`) included: the
shuffle and the joins raise the same codes at dispatch time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from . import rowdep

# the stable diagnostic registry: code -> (title, default severity).
# NEVER renumber — codes are a wire contract (bridge check RPC) and ride
# on dispatch-time exceptions; add new codes at the end of each band.
# Bands: TFS10x program/schema contracts, TFS11x trace-time, TFS12x
# GraphDef import, TFS13x analysis facts (info).
CODES: Dict[str, tuple] = {
    "TFS101": ("unknown verb", "error"),
    "TFS102": ("program construction failed", "error"),
    "TFS103": ("input names a missing column", "error"),
    "TFS104": ("host-only column fed to a device program", "error"),
    "TFS105": ("un-analyzed / ragged cell shape for a block verb",
               "error"),
    "TFS106": ("reduce_rows pairwise naming contract violated", "error"),
    "TFS107": ("reduce pair halves feed different columns", "error"),
    "TFS108": ("reduce_blocks/aggregate _input naming contract violated",
               "error"),
    "TFS109": ("reduce output does not match the column cell contract",
               "error"),
    "TFS110": ("shape hint contradicts the inferred shape", "error"),
    "TFS111": ("program failed to trace", "error"),
    "TFS112": ("host_stage names a non-input", "error"),
    "TFS120": ("GraphDef op has no lowering", "error"),
    "TFS121": ("GraphDef decode-prelude contract violated", "error"),
    "TFS122": ("GraphDef output shape not describable", "error"),
    "TFS123": ("GraphDef structurally invalid", "error"),
    "TFS130": ("program is not row-independent", "info"),
    "TFS131": ("row-dependence unknown (dispatch will probe)", "info"),
    # TFS14x: relational contracts (relational/)
    "TFS140": ("shuffle/join key column missing or duplicated", "error"),
    "TFS141": ("join key columns have mismatched dtypes", "error"),
    "TFS142": ("shuffle/join key cells are ragged / non-hashable",
               "error"),
    "TFS143": ("join output column name collision", "error"),
}

_SEV_RANK = {"error": 0, "warn": 1, "info": 2}

_VERBS = (
    "map_blocks", "map_blocks_trimmed", "map_rows", "reduce_blocks",
    "reduce_rows", "aggregate",
)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding: stable ``code``, ``severity`` in
    ``error``/``warn``/``info``, human ``summary``, a ``location`` path
    (``verb:input:x``, ``program``, ``graphdef``), and ``advice`` — the
    "what to do" half the reference's error messages carry."""

    code: str
    severity: str
    summary: str
    location: str
    advice: str

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


def _diag(code: str, summary: str, location: str, advice: str,
          severity: Optional[str] = None) -> Diagnostic:
    sev = severity or CODES[code][1]
    return Diagnostic(code, sev, summary, location, advice)


def _from_exception(e: BaseException, default_code: str, location: str,
                    advice: str = "") -> Diagnostic:
    code = getattr(e, "code", None) or default_code
    if code not in CODES:
        code = default_code
    return _diag(code, str(e), location, advice)


def check_relational(
    frame,
    verb: str,
    keys: Optional[Sequence[str]] = None,
    right=None,
    how: str = "inner",
) -> List[Diagnostic]:
    """Relational contract verification: the ``TFS14x``
    checks for ``verb`` in ``shuffle``/``join`` — key presence,
    duplication, scalar/hashable cells, cross-side dtype match, and
    output-name collisions — statically, against the schemas alone.
    Worst-first, like :func:`check`; the same codes ride the
    dispatch-time ``ValidationError`` the verbs raise."""
    diags: List[Diagnostic] = []
    keys = list(keys or ())
    loc = f"{verb}:key"
    if not keys:
        return [_diag(
            "TFS140", f"{verb} needs a key column", loc,
            "pass on=<column> (join) / key=<column> (shuffle)",
        )]
    if len(keys) > len(set(keys)):
        diags.append(_diag(
            "TFS140",
            f"{verb}: key columns {keys} name a column more than once",
            loc, "each key column may appear once",
        ))
    if len(set(keys)) > 1:
        diags.append(_diag(
            "TFS140",
            f"{verb}: multi-column keys are not supported yet "
            f"({keys}); combine the columns into one key first",
            loc, "re-key on a single column",
        ))
    key = keys[0]

    def _side(f, side: str):
        schema = f.schema
        if key not in schema:
            diags.append(_diag(
                "TFS140",
                f"{verb}: key column {key!r} does not exist on the "
                f"{side} side. Available columns: {schema.names}",
                f"{loc}:{side}",
                "the key must name an existing column on both sides",
            ))
            return None
        ci = schema[key]
        if ci.cell_shape.rank != 0:
            diags.append(_diag(
                "TFS142",
                f"{verb}: {side} key column {key!r} holds cells of "
                f"shape {ci.cell_shape}; keys must be scalar",
                f"{loc}:{side}",
                "hash-partitioning needs one hashable cell per row",
            ))
        col = f.column(key)
        if col.is_ragged and not isinstance(col.data, np.ndarray):
            diags.append(_diag(
                "TFS142",
                f"{verb}: {side} key column {key!r} holds ragged "
                f"cells; analyze/bucket the frame first",
                f"{loc}:{side}",
                "ragged cells have no stable byte representation to "
                "hash",
            ))
        return ci

    lci = _side(frame, "left")
    if verb == "join" and right is not None:
        rci = _side(right, "right")
        if lci is not None and rci is not None and (
            lci.scalar_type.name != rci.scalar_type.name
        ):
            diags.append(_diag(
                "TFS141",
                f"join: key column {key!r} has dtype "
                f"{lci.scalar_type.name} on the left and "
                f"{rci.scalar_type.name} on the right",
                loc,
                "byte-equality joins need one representation; cast "
                "one side first",
            ))
        collide = sorted(
            (set(frame.column_names) & set(right.column_names)) - {key}
        )
        if collide:
            diags.append(_diag(
                "TFS143",
                f"join: non-key column name(s) {collide} exist on "
                f"both sides",
                f"{verb}:columns",
                "rename or drop one side's columns before joining",
            ))
    diags.sort(key=lambda d: (_SEV_RANK[d.severity], d.code))
    return diags


def check(
    frame,
    program,
    verb: str,
    host_stage: Optional[Mapping[str, Any]] = None,
    fetches: Optional[Sequence[str]] = None,
    inputs: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    outputs: Optional[Mapping[str, str]] = None,
    keys: Optional[Sequence[str]] = None,
    right=None,
    how: str = "inner",
    device=None,
) -> List[Diagnostic]:
    """Statically verify ``program`` against ``frame``'s schema for
    ``verb``; returns diagnostics sorted worst-first (empty = the
    dispatch-time validation layer will accept it).

    ``program`` accepts everything the verbs accept: a python function,
    DSL nodes, an existing :class:`Program`, or frozen GraphDef bytes
    (with ``fetches``/``inputs``/``shapes``/``outputs`` — the OpBuilder
    surface).  ``keys``: the grouping columns for ``aggregate``.
    ``device``: where a program built here places its params (None = the
    CUDA card).  Nothing dispatches: the only traces run on ``meta``
    tensors (shape inference and the one-time row-dependence
    classification)."""
    if verb in ("join", "shuffle"):
        # relational verbs carry no program: the TFS14x key contracts
        # are the whole static surface
        return check_relational(frame, verb, keys, right=right, how=how)
    diags: List[Diagnostic] = []
    if verb not in _VERBS:
        return [_diag(
            "TFS101",
            f"unknown verb {verb!r}",
            "verb",
            f"one of {', '.join(_VERBS)} (or the relational verbs "
            f"join/shuffle)",
        )]

    # ---- program construction (GraphDef import included) -------------------
    from ..builder import compile_program  # lazy: builder pulls the engine
    from ..graphdef.importer import GraphImportError
    from ..graphdef.ops import UnsupportedOpError
    from ..program import Program, ProgramError

    if not isinstance(program, Program) or fetches or inputs or shapes:
        from ..device import resolve_device

        device = resolve_device(device)  # no card and no device= raises here
        try:
            program = compile_program(
                program, fetches=fetches, inputs=inputs, shapes=shapes,
                outputs=outputs, what=f"check({verb})", device=device,
            )
        except UnsupportedOpError as e:
            return diags + [_from_exception(
                e, "TFS120", "graphdef",
                "register a lowering in graphdef/ops.py, or export the "
                "graph without this op",
            )]
        except GraphImportError as e:
            return diags + [_from_exception(
                e, "TFS123", "graphdef",
                "fix the GraphDef (the importer validates fetches, "
                "placeholders, decode preludes, and acyclicity)",
            )]
        except ProgramError as e:
            return diags + [_from_exception(
                e, "TFS102", "program",
                "programs declare named inputs and named fetches; see "
                "Program.wrap",
            )]
        except Exception as e:  # noqa: BLE001 — user construction code
            return diags + [_from_exception(e, "TFS102", "program", "")]

    trim = verb == "map_blocks_trimmed"
    base_verb = "map_blocks" if trim else verb

    from ..ops import validation
    from ..shape import UNKNOWN, Shape

    staged = set(host_stage or ()) | set(
        getattr(program, "host_prelude", {}) or {}
    )

    # ---- schema contracts ---------------------------------------------------
    infos: Dict[str, Any] = {}
    if base_verb in ("map_blocks", "map_rows"):
        unknown_staged = sorted(
            set(host_stage or ()) - set(program.input_names)
        )
        if unknown_staged:
            diags.append(_diag(
                "TFS112",
                f"{base_verb}: host_stage given for names "
                f"{unknown_staged} that are not program inputs; inputs "
                f"are {program.input_names}",
                f"{verb}:host_stage",
                "host_stage keys must name program inputs",
            ))
        for n in program.input_names:
            try:
                infos[n] = validation._column_for_input(
                    frame, program, n, base_verb,
                    host_staged=n in staged,
                    allow_ragged=base_verb == "map_rows",
                )
            except validation.ValidationError as e:
                diags.append(_from_exception(
                    e, "TFS103", f"{verb}:input:{n}",
                    "match program inputs to frame columns by name, or "
                    "pass feed_dict={input: column}",
                ))
    else:
        try:
            if base_verb == "reduce_rows":
                infos = validation.check_reduce_rows(program, frame)
            else:
                infos = validation.check_reduce_blocks(
                    program, frame, verb=base_verb
                )
        except validation.ValidationError as e:
            diags.append(_from_exception(
                e, "TFS108" if base_verb != "reduce_rows" else "TFS106",
                f"{verb}:inputs",
                "reduce_rows consumes '<col>_1'/'<col>_2' pairs; "
                "reduce_blocks/aggregate consume '<col>_input' blocks",
            ))
    if base_verb == "aggregate":
        schema = frame.schema
        for k in keys or ():
            if k not in schema:
                diags.append(_diag(
                    "TFS103",
                    f"aggregate: grouping key {k!r} does not exist in "
                    f"the frame. Available columns: {schema.names}",
                    f"{verb}:key:{k}",
                    "group_by keys must name frame columns",
                ))

    if any(d.severity == "error" for d in diags):
        diags.sort(key=lambda d: (_SEV_RANK[d.severity], d.code))
        return diags

    # ---- trace-time contracts (meta tensors; nothing runs) -------------------
    specs: Dict[str, Any] = {}
    for n in program.input_names:
        if base_verb in ("map_blocks", "map_rows"):
            ci = infos.get(n)
        else:  # reduce verbs: infos keyed by output base name
            base = n[: -len("_input")] if n.endswith("_input") else n[:-2]
            ci = infos.get(base)
        if ci is None or n in staged:
            specs = {}
            break  # host-staged cell shapes are only known at run time
        cell = tuple(ci.cell_shape)
        if base_verb == "map_rows" and any(d == UNKNOWN for d in cell):
            specs = {}
            break  # ragged map_rows resolves per row-bucket at run time
        if base_verb in ("map_blocks", "reduce_blocks", "aggregate"):
            shape = Shape((UNKNOWN,) + cell)
        elif base_verb == "reduce_rows":
            shape = Shape(cell)
        else:  # map_rows: the cell program
            shape = Shape(cell)
        specs[n] = (ci.scalar_type, shape)
    summaries = None
    if specs:
        try:
            summaries = program.analyze(specs)
        except Exception as e:  # noqa: BLE001 — user program under trace
            msg = str(e)
            code = "TFS110" if "hint" in msg else "TFS111"
            diags.append(_from_exception(
                e, code, "program",
                "the program must trace at the schema's shapes/dtypes "
                "before any verb can run it" if code == "TFS111" else
                "shape hints refine unknown dims; they may never "
                "contradict inferred shapes",
            ))
    if summaries is not None and base_verb in (
        "reduce_rows", "reduce_blocks", "aggregate"
    ):
        try:
            if base_verb == "reduce_rows":
                validation.check_reduce_rows_outputs(infos, summaries)
            else:
                validation.check_reduce_blocks_outputs(
                    infos, summaries, verb=base_verb
                )
        except validation.ValidationError as e:
            diags.append(_from_exception(
                e, "TFS109", f"{verb}:outputs",
                "a reducer's outputs must exactly match the reduced "
                "columns and preserve their cell shapes, so the "
                "reduction can be re-applied across blocks",
            ))

    # ---- row-dependence classification (info) ------------------------------
    if (
        base_verb == "map_blocks"
        and not trim
        and not staged
        and not any(d.severity == "error" for d in diags)
    ):
        cls_specs = rowdep.input_specs_for(program, infos)
        if cls_specs is not None:
            cls = rowdep.classify(program, cls_specs)
            if cls.verdict == rowdep.UNKNOWN:
                diags.append(_diag(
                    "TFS131",
                    f"row-dependence not statically classifiable "
                    f"({cls.reason}); dispatch will prove it per size "
                    f"with the compile probe",
                    f"{verb}:program",
                    "size-branching python control flow defeats the "
                    "static classifier; the per-size probe stays sound",
                ))
            elif cls.verdict != rowdep.ROW_INDEPENDENT:
                diags.append(_diag(
                    "TFS130",
                    f"program is {cls.verdict} ({cls.reason}); "
                    f"per-output: {cls.outputs}",
                    f"{verb}:program",
                    "cross-row / size-dependent programs keep exact "
                    "per-size executables: bucket padding, chunked h2d "
                    "streaming, OOM splitting, and bridge coalescing "
                    "are all disabled for them",
                ))

    diags.sort(key=lambda d: (_SEV_RANK[d.severity], d.code))
    return diags
