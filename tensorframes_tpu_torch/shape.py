"""Tensor shape algebra with unknown dimensions.

A copy of ``tensorframes_tpu/shape.py`` (pure Python), kept in the port so
that it never imports the JAX package.  That module is the TPU-native
re-design of the reference's shape subsystem
(``Shape.scala:16-129``).

The reference models a shape as an immutable ``Seq[Long]`` where ``-1`` marks an
unknown dimension, with a precision lattice (``checkMorePreciseThan``,
``Shape.scala:54-59``) and block/cell conversions (``prepend``/``tail``,
``Shape.scala:34-40``).  We keep exactly that contract — it is the backbone of
the verb validation layer — but add the operations the execution layer needs:

* ``is_static`` — every device-bound block must pass through a shape that
  answers True here.
* ``merge`` — the shape lattice join used by ``analyze`` (reference
  ``ExperimentalOperations.scala:133-157``): dimensions that disagree become
  Unknown, rank mismatch raises.

Unknown dimensions never reach a device program: they live only in schema metadata
and are resolved to concrete sizes when a block is packed for the device.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

UNKNOWN = -1


class ShapeError(ValueError):
    """Raised on illegal shape operations (rank mismatch, precision violation)."""


class Shape:
    """An immutable tensor shape; ``-1`` encodes an unknown dimension.

    Mirrors ``Shape.scala:16-109``.  ``dims`` is ordered outermost-first, so for
    a *block* shape ``dims[0]`` is the number of rows in the block and
    ``dims[1:]`` is the *cell* shape of each row.
    """

    __slots__ = ("_dims",)

    def __init__(self, dims: Iterable[int] = ()):  # noqa: D107
        d = tuple(int(x) for x in dims)
        for x in d:
            if x < -1:
                raise ShapeError(f"illegal dimension {x} in shape {d}")
        self._dims = d

    # -- constructors -------------------------------------------------------

    @staticmethod
    def scalar() -> "Shape":
        """The empty (rank-0) shape; reference ``Shape.empty``."""
        return Shape(())

    @staticmethod
    def unknown_lead(cell: "Shape") -> "Shape":
        """A block shape with unknown row count over the given cell shape."""
        return cell.prepend(UNKNOWN)

    @staticmethod
    def of_array(arr) -> "Shape":
        """Shape of a numpy array or torch tensor."""
        return Shape(arr.shape)

    # -- accessors ----------------------------------------------------------

    @property
    def dims(self) -> Tuple[int, ...]:
        return self._dims

    @property
    def rank(self) -> int:
        return len(self._dims)

    @property
    def is_scalar(self) -> bool:
        return not self._dims

    @property
    def is_static(self) -> bool:
        """True iff no unknown dims — the device-feedable condition."""
        return all(d != UNKNOWN for d in self._dims)

    def num_elements(self) -> Optional[int]:
        """Total element count, or None if any dim is unknown.

        Reference ``Shape.scala:48-52`` (``numElements``).
        """
        n = 1
        for d in self._dims:
            if d == UNKNOWN:
                return None
            n *= d
        return n

    # -- block/cell algebra --------------------------------------------------

    def prepend(self, lead: int) -> "Shape":
        """Cell shape -> block shape with ``lead`` rows (``Shape.scala:34-36``)."""
        return Shape((int(lead),) + self._dims)

    def tail(self) -> "Shape":
        """Block shape -> cell shape (``Shape.scala:38-40``)."""
        if not self._dims:
            raise ShapeError("cannot take tail of a scalar shape")
        return Shape(self._dims[1:])

    def drop_lead(self) -> "Shape":
        return self.tail()

    def with_lead(self, lead: int) -> "Shape":
        """Replace the lead dimension (used when resolving block sizes)."""
        if not self._dims:
            raise ShapeError("cannot set lead dim of a scalar shape")
        return Shape((int(lead),) + self._dims[1:])

    # -- lattice -------------------------------------------------------------

    def is_more_precise_than(self, other: "Shape") -> bool:
        """True iff self refines ``other``: same rank, and wherever ``other``
        has a concrete dim, self agrees.  Reference ``checkMorePreciseThan``
        (``Shape.scala:54-59``)."""
        if self.rank != other.rank:
            return False
        return all(o == UNKNOWN or s == o for s, o in zip(self._dims, other._dims))

    def check_more_precise_than(self, other: "Shape", context: str = "") -> None:
        if not self.is_more_precise_than(other):
            where = f" ({context})" if context else ""
            raise ShapeError(
                f"Shape {self} is not compatible with (not more precise than) "
                f"expected shape {other}{where}"
            )

    def refine(self, hint: "Shape", context: str = "") -> "Shape":
        """Overlay a user hint: unknown dims take the hint's value, concrete
        dims must agree (hints refine, never contradict, the engine-inferred
        shape — the ``ShapeDescription`` override contract,
        ``TensorFlowOps.scala:126-133``)."""
        if self.rank != hint.rank:
            raise ShapeError(
                f"shape hint {hint} has rank {hint.rank} but the inferred "
                f"shape {self} has rank {self.rank}"
                + (f" ({context})" if context else "")
            )
        out = []
        for s, h in zip(self._dims, hint._dims):
            if s == UNKNOWN:
                out.append(h)
            elif h == UNKNOWN or h == s:
                out.append(s)
            else:
                raise ShapeError(
                    f"shape hint {hint} contradicts the inferred shape "
                    f"{self}: hints may only refine unknown dimensions"
                    + (f" ({context})" if context else "")
                )
        return Shape(out)

    def merge(self, other: "Shape") -> "Shape":
        """Lattice join: pointwise agreement or Unknown; rank must match.

        Reference ``ExperimentalOperations.scala:147-157`` (``merge``/``f2``).
        """
        if self.rank != other.rank:
            raise ShapeError(
                f"cannot merge shapes of different rank: {self} vs {other}"
            )
        return Shape(
            s if s == o else UNKNOWN for s, o in zip(self._dims, other._dims)
        )

    def resolve(self, concrete: Sequence[int], context: str = "") -> "Shape":
        """Bind unknowns against a fully concrete shape, validating agreement.

        This is the packing-time step where schema shapes meet real block data
        (the role of ``DataOps.inferPhysicalShape``,
        ``impl/DataOps.scala:105-144``).
        """
        c = Shape(concrete)
        if not c.is_static:
            raise ShapeError(f"resolve target must be static, got {c}")
        c.check_more_precise_than(self, context)
        return c

    # -- dunder --------------------------------------------------------------

    def __iter__(self):
        return iter(self._dims)

    def __len__(self):
        return len(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other):
        if isinstance(other, Shape):
            return self._dims == other._dims
        if isinstance(other, tuple):
            return self._dims == other
        return NotImplemented

    def __hash__(self):
        return hash(self._dims)

    def __repr__(self):
        inner = ",".join("?" if d == UNKNOWN else str(d) for d in self._dims)
        return f"[{inner}]"
