"""Programmatic GraphDef construction.

A copy of ``tensorframes_tpu/graphdef/builder.py``, kept in the port so that
it never imports the JAX package: the same graph builds the same bytes.

The write-side counterpart of the importer: the reference's Scala DSL emits
``NodeDef`` protos (``dsl/DslImpl.scala:143-157``, ``ProtoConversions.scala``)
that are binary-compared against python TF's output in its golden tests
(``dsl/ExtractNodes.scala``).  Here the builder serves the same two purposes
TPU-natively: generating wire-format fixtures for importer tests without a
TensorFlow install, and exporting programs for interchange with TF tooling.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .. import dtypes as dt
from ..shape import Shape
from .proto import AttrValue, GraphDef, NodeDef, TensorProto


class GraphBuilder:
    """Accumulates NodeDefs; names must be unique (TF graph invariant)."""

    def __init__(self):
        self.nodes: List[NodeDef] = []
        self._names = set()

    def _add(
        self,
        op: str,
        name: str,
        inputs: Sequence[str] = (),
        attrs: Optional[Dict[str, AttrValue]] = None,
    ) -> str:
        if name in self._names:
            raise ValueError(f"duplicate node name {name!r}")
        self._names.add(name)
        self.nodes.append(NodeDef(name, op, list(inputs), attrs or {}))
        return name

    def placeholder(
        self, name: str, dtype="float32", shape: Optional[Sequence[int]] = None
    ) -> str:
        st = dtype if isinstance(dtype, dt.ScalarType) else dt.by_name(dtype)
        attrs = {"dtype": AttrValue("type", st.tf_enum)}
        if shape is not None:
            attrs["shape"] = AttrValue("shape", Shape(shape))
        return self._add("Placeholder", name, (), attrs)

    def const(self, name: str, value) -> str:
        """A Const node of ``value``: anything numpy takes, or a
        ``torch.bfloat16`` tensor (its bit patterns, as JAX's builder
        writes a bfloat16 array)."""
        tp = TensorProto.from_numpy(value)
        return self._add(
            "Const",
            name,
            (),
            {
                "value": AttrValue("tensor", tp),
                "dtype": AttrValue("type", tp.dtype),
            },
        )

    def op(
        self,
        op: str,
        name: str,
        inputs: Sequence[str],
        **attrs,
    ) -> str:
        encoded: Dict[str, AttrValue] = {}
        for k, v in attrs.items():
            if isinstance(v, AttrValue):
                encoded[k] = v
            elif isinstance(v, bool):
                encoded[k] = AttrValue("b", v)
            elif isinstance(v, int):
                encoded[k] = AttrValue("i", v)
            elif isinstance(v, float):
                encoded[k] = AttrValue("f", v)
            elif isinstance(v, bytes):
                encoded[k] = AttrValue("s", v)
            elif isinstance(v, str):
                encoded[k] = AttrValue("s", v.encode())
            elif isinstance(v, (list, tuple)):
                encoded[k] = AttrValue("list", list(v))
            else:
                raise ValueError(
                    f"cannot encode attr {k}={v!r} ({type(v).__name__})"
                )
        return self._add(op, name, inputs, encoded)

    def build(self) -> GraphDef:
        return GraphDef(list(self.nodes))

    def to_bytes(self) -> bytes:
        """Serialize, with TF-required dtype/count attrs filled in
        (``tfcompat.complete_for_tf``) so the emitted bytes import into a
        real TensorFlow, not only into our own importer — the contract the
        reference's golden tests pin (``ExtractNodes.scala:14-74``)."""
        from .tfcompat import complete_for_tf

        return complete_for_tf(self.build()).encode()
