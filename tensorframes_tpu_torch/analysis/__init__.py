"""Static program analysis: the row-dependence classifier and the
pre-dispatch contract check.

PyTorch counterpart of ``tensorframes_tpu/analysis``:

* :mod:`.rowdep`: one pass over a program's ATen graph classifies every
  output as ``ROW_INDEPENDENT`` / ``CROSS_ROW`` / ``SIZE_DEPENDENT`` /
  ``UNKNOWN`` once per (program, input signature), so the gates that
  reshape a block's lead axis (bucket padding, padded ragged buckets, the
  OOM split, the pooled pipeline's pads) answer new size questions without
  tracing again; ``UNKNOWN`` falls back to the exact-size probe
  (``ops/segment_compile.cached_rows_independent``).
* :mod:`.contracts`: ``check(frame, program, verb)`` returns structured
  ``TFSxxx`` diagnostics before anything is dispatched.

:mod:`.contracts` pulls the verb layers in, so ``check`` is re-exported
lazily to keep the ``ops`` <-> ``analysis`` import order acyclic.
"""

from __future__ import annotations

from .rowdep import (  # noqa: F401
    CROSS_ROW,
    ROW_INDEPENDENT,
    SIZE_DEPENDENT,
    UNKNOWN,
    AnalysisXCheckError,
    Classification,
    classify,
    enabled,
    input_specs_for,
    rows_independent,
    xcheck_enabled,
)

__all__ = [
    "ROW_INDEPENDENT",
    "CROSS_ROW",
    "SIZE_DEPENDENT",
    "UNKNOWN",
    "AnalysisXCheckError",
    "Classification",
    "classify",
    "enabled",
    "xcheck_enabled",
    "rows_independent",
    "input_specs_for",
    "check",
    "check_relational",
    "Diagnostic",
    "CODES",
]


def check(*args, **kwargs):
    """Pre-dispatch contract verification: see
    :func:`tensorframes_tpu_torch.analysis.contracts.check`."""
    from . import contracts

    return contracts.check(*args, **kwargs)


def check_relational(*args, **kwargs):
    """Relational contract verification: see
    :func:`tensorframes_tpu_torch.analysis.contracts.check_relational`."""
    from . import contracts

    return contracts.check_relational(*args, **kwargs)


def __getattr__(name):
    if name in ("Diagnostic", "CODES"):
        from . import contracts

        return getattr(contracts, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
