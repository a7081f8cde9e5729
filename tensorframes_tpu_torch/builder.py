"""OpBuilder: the fluent verb-builder protocol.

Re-design of the reference's Py4J surface ``PythonOpBuilder``
(``src/main/scala/org/tensorframes/impl/PythonInterface.scala:86-170``):
the python client accumulates a graph (bytes or file path), shape hints,
requested fetches, and a placeholder->column feed map, then dispatches
``buildDF`` (frame-returning verbs) or ``buildRow`` (reducing verbs).  The
reference needs this builder because every attribute crosses a Py4J socket;
here there is no process boundary, but the protocol is kept as the stable
programmatic surface mirroring ``map_blocks / map_rows / reduce_blocks /
reduce_rows / aggregate_blocks`` (``PythonInterface.scala:46-68``) — the
entry point an external front-end (e.g. a Spark bridge) would drive.

Port of ``tensorframes_tpu/builder.py`` over the port's verbs: the
builders take ``device=`` (None = the CUDA card) where the JAX package's
take an executor, since the port has one serial executor.

    out = (OpBuilder.map_blocks(frame, trim=False)
           .graph_from_file("model.pb")
           .fetches(["out"])
           .inputs({"x": "col"})
           .shape("out", [-1, 10])
           .build_df())
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .device import DeviceLike
from .frame import TensorFrame
from .ops import engine
from .ops.engine import GroupedFrame
from .program import Program, ProgramError


def compile_program(
    source: Any,
    fetches: Optional[Sequence[str]] = None,
    inputs: Optional[Mapping[str, str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    outputs: Optional[Mapping[str, str]] = None,
    is_graphdef: Optional[bool] = None,
    what: str = "program",
    device: DeviceLike = None,
) -> Program:
    """Build a :class:`Program` from any accepted source — GraphDef
    bytes, a python function, DSL nodes, or an existing Program — with
    the builder's feed/fetch/shape-hint semantics, on ``device`` (None =
    the CUDA card).  This is the one program-construction path of
    :class:`OpBuilder`, so a program built once can be cached and reused
    instead of re-importing the GraphDef per call."""
    if is_graphdef is None:
        is_graphdef = isinstance(source, (bytes, bytearray))
    if is_graphdef:
        from .graphdef import import_graphdef

        if not fetches:
            raise ProgramError(
                f"{what}: GraphDef programs need fetches before build"
            )
        program = import_graphdef(
            source,
            fetches=list(fetches),
            inputs=dict(inputs) if inputs else None,
            outputs=dict(outputs) if outputs else None,
            device=device,
        )
    else:
        if outputs:
            raise ProgramError(
                "outputs renames apply to GraphDef programs only"
            )
        program = Program.wrap(
            source, list(fetches) if fetches else fetches,
            dict(inputs) if inputs else None, device=device,
        )
    if shapes:
        # the ShapeDescription override: hints refine engine-inferred
        # shapes in analyze() and are checked against real outputs at
        # run time (contradictions raise)
        program = program.with_shape_hints(shapes)
    return program


class OpBuilder:
    """Accumulates program source + hints for one verb invocation.

    Mirrors the reference builder's accessors: ``graph``/``graph_from_file``
    (``PythonInterface.scala:110-118``), ``shape`` (L97-103), ``fetches``
    (L105-108), ``inputs`` (L120-127), ``build_df``/``build_row``
    (L129-151)."""

    def __init__(
        self,
        verb: str,
        frame: Any,
        trim: bool = False,
        device: DeviceLike = None,
    ):
        self._verb = verb
        self._frame = frame
        self._trim = trim
        self._device = device
        self._source: Any = None  # callable | Program | GraphDef bytes/path
        self._is_graphdef = False
        self._fetches: Optional[List[str]] = None
        self._feed: Dict[str, str] = {}
        self._out_renames: Dict[str, str] = {}
        self._shapes: Dict[str, Sequence[int]] = {}
        self._host_stage: Dict[str, Any] = {}

    # -- verb factories (PythonInterface.scala:46-68) ------------------------

    @staticmethod
    def map_blocks(
        frame: TensorFrame, trim: bool = False, device: DeviceLike = None
    ) -> "OpBuilder":
        return OpBuilder("map_blocks", frame, trim, device)

    @staticmethod
    def map_rows(frame: TensorFrame, device: DeviceLike = None) -> "OpBuilder":
        return OpBuilder("map_rows", frame, device=device)

    @staticmethod
    def reduce_blocks(frame: TensorFrame, device: DeviceLike = None) -> "OpBuilder":
        return OpBuilder("reduce_blocks", frame, device=device)

    @staticmethod
    def reduce_rows(frame: TensorFrame, device: DeviceLike = None) -> "OpBuilder":
        return OpBuilder("reduce_rows", frame, device=device)

    @staticmethod
    def aggregate_blocks(
        grouped: GroupedFrame, device: DeviceLike = None
    ) -> "OpBuilder":
        return OpBuilder("aggregate", grouped, device=device)

    # -- accumulators --------------------------------------------------------

    def graph(self, source) -> "OpBuilder":
        """Attach the program: a python function, a Program, DSL node(s), or
        serialized GraphDef bytes."""
        if isinstance(source, (bytes, bytearray)):
            self._is_graphdef = True
        self._source = source
        return self

    def graph_from_file(self, path: str) -> "OpBuilder":
        """Attach a frozen GraphDef from a file path — the reference's
        default transport (``core.py:38-49`` writes a temp file to avoid
        shipping bytes through Py4J)."""
        self._source = path
        self._is_graphdef = True
        return self

    def fetches(self, names: Sequence[str]) -> "OpBuilder":
        self._fetches = list(names)
        return self

    def inputs(self, feed: Mapping[str, str]) -> "OpBuilder":
        """placeholder/input name -> frame column name."""
        self._feed.update(feed)
        return self

    def outputs(self, renames: Mapping[str, str]) -> "OpBuilder":
        """fetch ref -> result column name (GraphDef programs only): the
        output-direction rename for frozen graphs whose node names don't
        match the verb naming contract."""
        self._out_renames.update(renames)
        return self

    def shape(self, name: str, shape: Sequence[int]) -> "OpBuilder":
        """Output-shape hint (the ``ShapeDescription`` override mechanism,
        ``ShapeDescription.scala:3-16``)."""
        self._shapes[name] = list(shape)
        return self

    def host_stage(self, input_name: str, fn) -> "OpBuilder":
        """Attach a host preprocessing fn for one input (binary decode —
        the host half of the reference's in-graph DecodeJpeg feed,
        ``read_image.py:164-167``)."""
        self._host_stage[input_name] = fn
        return self

    # -- dispatch ------------------------------------------------------------

    def _program(self) -> Program:
        if self._source is None:
            raise ProgramError(
                f"{self._verb} builder: no graph attached; call .graph(...) "
                f"or .graph_from_file(...)"
            )
        return compile_program(
            self._source,
            fetches=self._fetches,
            inputs=self._feed or None,
            shapes=self._shapes or None,
            outputs=self._out_renames or None,
            is_graphdef=self._is_graphdef,
            what=self._verb,
            device=self._device,
        )

    def build_df(self) -> TensorFrame:
        """Run a frame-returning verb (``buildDF``,
        ``PythonInterface.scala:144-151``)."""
        program = self._program()
        if self._verb == "map_blocks":
            return engine.map_blocks(
                program,
                self._frame,
                trim=self._trim,
                host_stage=self._host_stage or None,
            )
        if self._verb == "map_rows":
            return engine.map_rows(
                program,
                self._frame,
                host_stage=self._host_stage or None,
            )
        if self._verb == "aggregate":
            if self._host_stage:
                raise ProgramError(
                    "host_stage is only supported on the map verbs "
                    "(map_blocks/map_rows); preprocess with a map first, "
                    "then aggregate the result"
                )
            return engine.aggregate(program, self._frame)
        raise ProgramError(
            f"{self._verb} returns a row, not a frame; use build_row()"
        )

    def build_row(self) -> Dict[str, np.ndarray]:
        """Run a reducing verb to a single row (``buildRow``,
        ``PythonInterface.scala:129-139``)."""
        if self._host_stage:
            raise ProgramError(
                "host_stage is only supported on the map verbs "
                "(map_blocks/map_rows); preprocess with a map first, then "
                "reduce the result"
            )
        program = self._program()
        if self._verb == "reduce_blocks":
            return engine.reduce_blocks(program, self._frame)
        if self._verb == "reduce_rows":
            return engine.reduce_rows(program, self._frame)
        raise ProgramError(
            f"{self._verb} returns a frame, not a row; use build_df()"
        )
