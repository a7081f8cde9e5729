"""Column and frame schema: tensor-annotated column metadata as a first-class object.

A copy of ``tensorframes_tpu/schema.py`` importing the port's ``dtypes`` and
``shape``.  That module is the TPU-native re-design of the reference's
metadata subsystem:

* ``ColumnInformation`` (``ColumnInformation.scala:46-138``)
  smuggles tensor shape/dtype through Spark's ``StructField.metadata`` under the
  keys in ``MetadataConstants.scala:19,27`` and patches it back after Spark ops
  drop it (``DebugRowOps.scala:578-586``).  SURVEY.md §7 flags that as a design
  wart; here the schema IS the metadata — a ``Schema`` object owned by the
  frame, never piggybacked, never lost.
* ``DataFrameInfo`` (``DataFrameInfo.scala:10-38``) — the per-frame view and the
  ``explain`` pretty-print.

A ``ColumnInfo`` records the *block shape*: lead dim = rows per block (-1 when
unknown or varying), trailing dims = cell shape.  This matches the reference's
convention where ``analyze`` prepends the partition size to the merged cell
shape (``ExperimentalOperations.scala:85-92``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from . import dtypes
from .dtypes import ScalarType
from .shape import Shape


class SchemaError(ValueError):
    """Raised on schema construction/validation problems."""


@dataclasses.dataclass(frozen=True)
class ColumnInfo:
    """Tensor metadata for one column (reference ``SparkTFColInfo`` /
    ``ColumnInformation``)."""

    name: str
    scalar_type: ScalarType
    block_shape: Shape  # lead dim = rows (-1 unknown), tail = cell shape

    def __post_init__(self):
        if self.block_shape.rank < 1:
            raise SchemaError(
                f"column {self.name!r}: block shape must have a lead (row) "
                f"dimension, got {self.block_shape}"
            )

    @property
    def cell_shape(self) -> Shape:
        return self.block_shape.tail()

    @property
    def is_analyzed(self) -> bool:
        """True when the cell shape is fully known — the precondition for
        feeding this column to a compiled program (reference: block ops refuse
        un-analyzed columns, ``DebugRowOps.scala:318-346``)."""
        return self.cell_shape.is_static

    def with_lead(self, lead: int) -> "ColumnInfo":
        return dataclasses.replace(self, block_shape=self.block_shape.with_lead(lead))

    def merge(self, other: "ColumnInfo") -> "ColumnInfo":
        """Merge metadata for the same column across partitions
        (reference ``ColumnInformation.merged``, ``ColumnInformation.scala:16-26``)."""
        if self.name != other.name:
            raise SchemaError(f"cannot merge columns {self.name!r} and {other.name!r}")
        if self.scalar_type is not other.scalar_type:
            raise SchemaError(
                f"column {self.name!r}: conflicting scalar types "
                f"{self.scalar_type} vs {other.scalar_type}"
            )
        return dataclasses.replace(
            self, block_shape=self.block_shape.merge(other.block_shape)
        )

    def __repr__(self):
        return f"{self.name} {self.scalar_type}{self.block_shape}"


class Schema:
    """Ordered collection of ``ColumnInfo`` — the frame's authoritative schema."""

    def __init__(self, cols: Iterable[ColumnInfo]):
        self._cols: Tuple[ColumnInfo, ...] = tuple(cols)
        self._by_name: Dict[str, ColumnInfo] = {}
        for c in self._cols:
            if c.name in self._by_name:
                raise SchemaError(f"duplicate column name {c.name!r}")
            self._by_name[c.name] = c

    # -- accessors ----------------------------------------------------------

    @property
    def columns(self) -> Tuple[ColumnInfo, ...]:
        return self._cols

    @property
    def names(self) -> List[str]:
        return [c.name for c in self._cols]

    def __len__(self):
        return len(self._cols)

    def __iter__(self):
        return iter(self._cols)

    def __contains__(self, name: str):
        return name in self._by_name

    def __getitem__(self, name: str) -> ColumnInfo:
        ci = self._by_name.get(name)
        if ci is None:
            raise SchemaError(
                f"column {name!r} not found; available columns: {self.names}"
            )
        return ci

    def get(self, name: str) -> Optional[ColumnInfo]:
        return self._by_name.get(name)

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def of(**cols) -> "Schema":
        """``Schema.of(x=("float32", [-1]), y=("int64", [-1, 3]))``."""
        out = []
        for name, (st, bshape) in cols.items():
            out.append(
                ColumnInfo(
                    name,
                    st if isinstance(st, ScalarType) else dtypes.by_name(st),
                    Shape(bshape),
                )
            )
        return Schema(out)

    def select(self, names: Iterable[str]) -> "Schema":
        return Schema(self[n] for n in names)

    def drop(self, names: Iterable[str]) -> "Schema":
        names = set(names)
        return Schema(c for c in self._cols if c.name not in names)

    def concat(self, other: "Schema") -> "Schema":
        return Schema(tuple(self._cols) + tuple(other._cols))

    def merge(self, other: "Schema") -> "Schema":
        """Column-wise metadata merge; schemas must list the same columns."""
        if self.names != other.names:
            raise SchemaError(
                f"cannot merge schemas with different columns: "
                f"{self.names} vs {other.names}"
            )
        return Schema(a.merge(b) for a, b in zip(self._cols, other._cols))

    def with_lead(self, lead: int) -> "Schema":
        return Schema(c.with_lead(lead) for c in self._cols)

    # -- pretty-print --------------------------------------------------------

    def explain(self) -> str:
        """Human-readable tensor schema (reference ``DataFrameInfo.explain``,
        ``DataFrameInfo.scala:10-17``, surfaced by ``tfs.print_schema``,
        ``core.py:293-302``)."""
        lines = ["root"]
        for c in self._cols:
            analyzed = "" if c.is_analyzed else " (un-analyzed)"
            lines.append(
                f" |-- {c.name}: {c.scalar_type} block{c.block_shape}"
                f" cell{c.cell_shape}{analyzed}"
            )
        return "\n".join(lines)

    def __repr__(self):
        return f"Schema({', '.join(map(repr, self._cols))})"

    def __eq__(self, other):
        return isinstance(other, Schema) and self._cols == other._cols

    def __hash__(self):
        return hash(self._cols)
