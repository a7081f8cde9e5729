"""Program: the named-input tensor program fed to every verb.

PyTorch counterpart of ``tensorframes_tpu/program.py``.  A ``Program``
wraps a function over torch tensors whose argument names are the input
names and whose outputs are named fetches.  PyTorch runs eagerly, so there
is no trace or compile cache behind the verbs: the callable is kept as
given, and ``update_params`` swaps the param tensors it is called with (it
never rebuilds the callable) and bumps ``_params_version``, the generation
the planner's cross-plan sharing keys on.

Params (a tensor, or a pytree of nested dicts/lists/tuples of tensors)
move to the program's device once, at construction or ``update_params``,
not per block.  ``analyze`` shape-infers the program on ``meta`` tensors:
no data, no device work, and refines the result by the program's shape
hints (``with_shape_hints``).  ``vmapped`` is the row-level call of
``map_rows``: the cell program under ``torch.func.vmap``, as the JAX
package's is under ``jax.vmap``.

Where the JAX package lowers to StableHLO, the port exports with
``torch.export``:

* ``serialize`` / :func:`deserialize_program`: a frozen artifact (params
  in as buffers, every Unknown lead dim one ``rows`` ``Dim``, each Unknown
  cell dim its own), behind JAX's ``tfs-program-v1`` JSON header;
* ``aot_compile`` / ``aot_compile_raw``: the program exported at one exact
  (bucketed) signature with its params as live arguments, memoized in the
  derived-callable LRU (``cached_jit``, ``_DERIVED_CAP``) and fingerprinted
  by the torch version and the exported graph's code; with the compile
  cache configured (``compile_cache.py``) the artifact is saved under
  ``<dir>/programs/<fingerprint>.pt2``.

``parallel.flash`` launches its kernels through ``ctypes``, which an
export cannot trace, so under an export ``flash_attention`` calls the
``tensorframes_torch::flash_fwd`` op, whose implementation is the flash
forward itself: an exported or deserialized program launches
``flash_fwd_tma`` on the card (``flash.kernel_launches`` counts it) and
the plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import io
import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from . import dtypes, observability
from .device import DeviceLike, resolve_device
from .dtypes import ScalarType
from .shape import Shape, UNKNOWN


class ProgramError(ValueError):
    """Raised for malformed programs (bad signature, bad outputs)."""


@dataclasses.dataclass(frozen=True)
class GraphNodeSummary:
    """Shape/dtype summary of one program input or output."""

    name: str
    is_input: bool
    is_output: bool
    scalar_type: ScalarType
    shape: Shape

    def __repr__(self):
        role = "input" if self.is_input else "output"
        return f"{self.name}[{role}]: {self.scalar_type}{self.shape}"


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a pytree of dicts/lists/tuples (named
    tuples, such as a quantized weight's ``QTensor``, keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> List[tuple]:
    """``(path, leaf)`` pairs in a stable order (dict keys as given)."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(tree_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_leaves(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def _tree_structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_tree_structure(v) for v in tree))
    return "*"


def _traced(values) -> bool:
    """Whether a program call runs under a tracer (a ``make_fx`` proxy
    mode, ``torch.compile``, or fake or ``meta`` inputs, which compute
    nothing) rather than eagerly on data."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    if get_proxy_mode() is not None or torch.compiler.is_compiling():
        return True
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.is_meta or is_fake(v)
    return False


def _to_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class Program:
    """A tensor program with named inputs and named outputs.

    ``fn`` takes keyword tensors named by ``input_names`` and returns a
    ``dict`` of named outputs, a single tensor (only when ``fetches`` names
    exactly one output), or a tuple matching ``fetches``.  Outputs are
    ordered sorted-by-name.  ``feed_dict`` maps input name -> column name.
    ``device``: where the params live and the verbs run (None = the CUDA
    card; raises without one)."""

    def __init__(
        self,
        fn: Callable[..., Any],
        input_names: Sequence[str],
        fetches: Optional[Sequence[str]] = None,
        feed_dict: Optional[Mapping[str, str]] = None,
        params: Optional[Mapping[str, Any]] = None,
        device: DeviceLike = None,
    ):
        self._fn = fn
        self._device = resolve_device(device)
        self._declared_fetches = list(fetches) if fetches is not None else None
        all_names = list(input_names)
        self._params: Dict[str, Any] = {
            k: tree_map(lambda a: _to_tensor(a, self._device), v)
            for k, v in (params or {}).items()
        }
        # monotonic params generation: bumped by update_params so caches
        # keyed on live param VALUES (the planner's cross-plan sharing)
        # tell two states of one Program apart without hashing tensors
        self._params_version = 0
        # derived callables (cached_jit, aot_compile), least recently used
        # first; and the entries the verbs have dispatched ("block",
        # "rows"): the planner's "warm" (see ops/planner.py)
        self._derived: Dict[Any, Any] = {}
        self._warm_entries: set = set()
        for k in self._params:
            if k not in all_names:
                raise ProgramError(
                    f"params key {k!r} is not a program argument; "
                    f"arguments are {all_names}"
                )
        # column-fed inputs exclude param-fed arguments
        self._input_names = [n for n in all_names if n not in self._params]
        if not self._input_names:
            raise ProgramError(
                "a program needs at least one column-fed input (all "
                "arguments were bound by params)"
            )
        self._feed = dict(feed_dict or {})
        for k in self._feed:
            if k not in self._input_names:
                raise ProgramError(
                    f"feed_dict key {k!r} is not a program input; "
                    f"inputs are {self._input_names}"
                )
        self._fetches: Optional[List[str]] = None  # resolved at first call
        # output name -> shape hint (the reference's ShapeDescription)
        self._shape_hints: Dict[str, Shape] = {}
        # input name -> host fn the map verbs merge under the caller's
        # host_stage (set by the GraphDef importer for in-graph Decode*
        # nodes; an explicit caller host_stage wins per input)
        self.host_prelude: Dict[str, Any] = {}

    # -- construction --------------------------------------------------------

    @staticmethod
    def wrap(
        fn_or_program,
        fetches: Optional[Sequence[str]] = None,
        feed_dict: Optional[Mapping[str, str]] = None,
        params: Optional[Mapping[str, Any]] = None,
        device: DeviceLike = None,
    ) -> "Program":
        if isinstance(fn_or_program, Program):
            if params:
                raise ProgramError(
                    "cannot bind params on an existing Program; pass params "
                    "when the program is created, or call update_params"
                )
            if fetches is not None and sorted(fetches) != sorted(
                fn_or_program._declared_fetches or []
            ):
                raise ProgramError(
                    "cannot re-declare fetches on an existing Program; pass "
                    "fetches when the program is created/imported"
                )
            if feed_dict:
                return fn_or_program.with_feed(feed_dict)
            return fn_or_program
        # DSL nodes (and sequences of them) lower to a Program
        is_node = hasattr(fn_or_program, "to_program")
        is_node_seq = (
            isinstance(fn_or_program, (list, tuple))
            and fn_or_program
            and all(hasattr(x, "to_program") for x in fn_or_program)
        )
        if is_node or is_node_seq:
            if params:
                raise ProgramError(
                    "params are not supported for DSL-node programs; use "
                    "dsl.constant for fixed values or a python-function "
                    "program for updatable params"
                )
            from . import dsl  # local import: dsl depends on this module

            nodes = [fn_or_program] if is_node else list(fn_or_program)
            p = dsl.build_program(nodes, feed_dict=feed_dict, device=device)
            if fetches is not None and sorted(fetches) != sorted(
                p._declared_fetches or []
            ):
                raise ProgramError(
                    f"fetches {sorted(fetches)} do not match the DSL fetch "
                    f"node names {sorted(p._declared_fetches or [])}; name "
                    f"fetch nodes with .named(...) instead"
                )
            return p
        if not callable(fn_or_program):
            raise ProgramError(
                f"expected a callable or Program, got "
                f"{type(fn_or_program).__name__}"
            )
        sig = inspect.signature(fn_or_program)
        names = []
        for p in sig.parameters.values():
            if p.kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY,
            ):
                names.append(p.name)
            elif p.kind in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                raise ProgramError(
                    "program functions must declare explicit named parameters "
                    "(column names); *args/**kwargs are not allowed"
                )
        if not names:
            raise ProgramError("a program needs at least one named input")
        return Program(fn_or_program, names, fetches, feed_dict, params, device)

    def _copy(self, feed: Mapping[str, str]) -> "Program":
        p = Program(
            self._fn,
            self._input_names + list(self._params),
            self._declared_fetches,
            feed,
            self._params,
            self._device,
        )
        p._shape_hints = dict(self._shape_hints)
        p.host_prelude = dict(self.host_prelude)
        return p

    def with_feed(self, feed_dict: Mapping[str, str]) -> "Program":
        """A copy with additional input->column renames merged in."""
        merged = dict(self._feed)
        merged.update(feed_dict)
        return self._copy(merged)

    def with_shape_hints(
        self, hints: Mapping[str, Sequence[int]]
    ) -> "Program":
        """A copy carrying output-shape hints (the reference's
        ``ShapeDescription`` override, ``TensorFlowOps.scala:126-133``):
        each hint refines, and never contradicts, the inferred shape.
        Applied by ``analyze`` and checked against real outputs by the map
        verbs."""
        p = self._copy(self._feed)
        for name, s in hints.items():
            p._shape_hints[name] = Shape(s)
        if self._declared_fetches is not None:
            bad = sorted(set(p._shape_hints) - set(self._declared_fetches))
            if bad:
                raise ProgramError(
                    f"shape hints for unknown outputs {bad}; program "
                    f"outputs are {sorted(self._declared_fetches)}"
                )
        return p

    @property
    def shape_hints(self) -> Dict[str, Shape]:
        return dict(self._shape_hints)

    # -- accessors -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def input_names(self) -> List[str]:
        """Column-fed input names (param-bound arguments excluded)."""
        return list(self._input_names)

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    @property
    def param_names(self) -> List[str]:
        return list(self._params)

    @property
    def name(self) -> str:
        """The wrapped function's qualified name (for error messages)."""
        return getattr(self._fn, "__qualname__", None) or repr(self._fn)

    def update_params(self, **arrays) -> "Program":
        """Replace param values in place (structure, shapes and dtypes must
        match).  Every key is validated before anything is swapped, so a
        failed update leaves the program unchanged."""
        validated: Dict[str, Any] = {}
        for k, v in arrays.items():
            if k not in self._params:
                raise ProgramError(
                    f"update_params: {k!r} is not a param; params are "
                    f"{sorted(self._params)}"
                )
            old = self._params[k]
            new = tree_map(lambda a: _to_tensor(a, self._device), v)
            if _tree_structure(old) != _tree_structure(new):
                raise ProgramError(
                    f"update_params: {k!r} must keep its pytree structure; "
                    f"build a new Program for a different structure"
                )
            for (path, ol), (_, nl) in zip(tree_leaves(old), tree_leaves(new)):
                if nl.shape != ol.shape or nl.dtype != ol.dtype:
                    raise ProgramError(
                        f"update_params: {k!r} must keep shape "
                        f"{tuple(ol.shape)} / dtype {ol.dtype}, got "
                        f"{tuple(nl.shape)} / {nl.dtype} (at {path or k!r}; "
                        f"build a new Program instead)"
                    )
            validated[k] = new
        self._params.update(validated)
        self._params_version += 1
        return self

    def column_for_input(self, name: str) -> str:
        """Frame column feeding a given input (identity unless feed_dict)."""
        return self._feed.get(name, name)

    @property
    def columns_needed(self) -> List[str]:
        """Each input's feeding column, in input order (after
        ``feed_dict``)."""
        return [self.column_for_input(n) for n in self._input_names]

    @property
    def fetches(self) -> Optional[List[str]]:
        return list(self._fetches) if self._fetches is not None else (
            sorted(self._declared_fetches) if self._declared_fetches else None
        )

    # -- execution -----------------------------------------------------------

    def _normalize_outputs(self, out) -> Dict[str, torch.Tensor]:
        if isinstance(out, dict):
            res = dict(out)
        elif isinstance(out, (tuple, list)):
            if self._declared_fetches is None or len(self._declared_fetches) != len(
                out
            ):
                raise ProgramError(
                    "tuple program outputs require fetches=[...] of matching "
                    f"length; got {len(out)} outputs, fetches="
                    f"{self._declared_fetches}"
                )
            res = dict(zip(self._declared_fetches, out))
        else:
            if self._declared_fetches is None or len(self._declared_fetches) != 1:
                raise ProgramError(
                    "a program returning a single array must declare exactly "
                    "one fetch name (pass fetches=['name']), or return a dict "
                    "{name: array}"
                )
            res = {self._declared_fetches[0]: out}
        if self._declared_fetches is not None:
            missing = [f for f in self._declared_fetches if f not in res]
            if missing:
                raise ProgramError(
                    f"program outputs {sorted(res)} are missing requested "
                    f"fetches {missing}"
                )
            res = {f: res[f] for f in self._declared_fetches}
        if not res:
            raise ProgramError("program produced no outputs")
        for name, v in res.items():
            if not isinstance(name, str):
                raise ProgramError(f"output names must be strings, got {name!r}")
            if not isinstance(v, torch.Tensor):
                res[name] = torch.as_tensor(np.asarray(v), device=self._device)
        # canonical order: sorted by name (DebugRowOps.scala:349-372)
        ordered = {k: res[k] for k in sorted(res)}
        if self._fetches is None:
            self._fetches = list(ordered)
        return ordered

    def call(
        self,
        inputs: Mapping[str, Any],
        params: Optional[Mapping[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run the program on ``inputs`` with the current (or given) params.
        A call under a tracer counts one ``program_traces`` (analysis runs
        suppress it); an eager call counts none."""
        if params is None:
            params = self._params
        kwargs = {n: inputs[n] for n in self._input_names}
        if _traced(kwargs.values()):
            observability.note_program_trace()
        kwargs.update(params)
        return self._normalize_outputs(self._fn(**kwargs))

    def vmapped(self):
        """The row-level call of ``map_rows``: ``fn(inputs, params=None)``
        runs the cell program over the lead axis of every input under
        ``torch.func.vmap`` (the JAX package's ``Program.vmapped``); params
        are shared by every row.  What vmap refuses (``.item()`` and Python
        control flow on values, in-place writes to captured tensors,
        randomness) raises a ProgramError naming the verb and the program;
        nothing falls back to a loop over rows."""
        names = self._input_names

        def run(inputs, params=None):
            params = self._params if params is None else params

            def cell(*xs):
                return self.call(dict(zip(names, xs)), params)

            try:
                return torch.func.vmap(cell)(*(inputs[n] for n in names))
            except RuntimeError as e:
                if "vmap" not in str(e):
                    raise
                raise ProgramError(
                    f"map_rows: program {self.name!r} cannot run row by row "
                    f"under torch.func.vmap: {e}"
                ) from e

        return run

    def note_entry(self, rows_level: bool) -> None:
        """The engine dispatched this program's block entry (or its row
        entry, ``rows_level``): the planner's "warm" (``ops/planner.py``)."""
        self._warm_entries.add("rows" if rows_level else "block")

    def entry_warm(self, rows_level: bool) -> bool:
        return ("rows" if rows_level else "block") in self._warm_entries

    # -- derived callables ---------------------------------------------------

    # cap on derived callables kept per Program; least recently USED
    # evicted first, so a Program reused across many short-lived signatures
    # does not pin their exported graphs forever
    _DERIVED_CAP = 32

    def _derived_hit(self, key):
        """LRU touch: re-insert ``key`` so eviction order is recency of
        use, not of insertion."""
        self._derived[key] = self._derived.pop(key)
        return self._derived[key]

    def _derived_put(self, key, value):
        while len(self._derived) >= self._DERIVED_CAP:
            self._derived.pop(next(iter(self._derived)))
        self._derived[key] = value
        return value

    def cached_jit(self, key, build_raw):
        """Memoize ``build_raw()``, a raw ``fn(*args, params)``, with the
        live params bound as its last argument (the JAX package's
        ``cached_jit``, which jits it; eager torch has nothing to compile,
        so the memo is the callable itself).  Eviction is LRU: a hit
        re-inserts the key, so a burst of one-off keys cannot evict a hot
        one."""
        if key in self._derived:
            return self._derived_hit(key)
        raw = build_raw()
        bound = lambda *args: raw(*args, self._params)  # noqa: E731
        bound.raw = raw
        return self._derived_put(key, bound)

    # -- ahead-of-time export (the cold-start path) -------------------------

    def _raw_entry(self, rows_level: bool):
        """The raw entry ``fn(inputs, params)``: the block call, or the
        vmapped row call of ``map_rows``."""
        if rows_level:
            return self.vmapped()
        return lambda inputs, params: self.call(inputs, params)

    def _examples(self, input_specs: Mapping[str, Any], what: str) -> Dict[str, torch.Tensor]:
        """Zero tensors on the program's device at ``input_specs``'
        static shapes (input name -> ``(ScalarType or torch.dtype, shape)``)."""
        out = {}
        for n in self._input_names:
            if n not in input_specs:
                raise ProgramError(
                    f"no spec for program input {n!r}; got specs for "
                    f"{sorted(input_specs)}"
                )
            dt, shape = _spec(input_specs[n])
            if any(d == UNKNOWN for d in shape):
                raise ProgramError(
                    f"input {n!r}: {what} needs a static shape, got "
                    f"{tuple(shape)} (bucket the lead dim first)"
                )
            out[n] = torch.zeros(tuple(shape), dtype=dt, device=self._device)
        return out

    def aot_compile(self, input_specs: Mapping[str, Any], rows_level: bool = False):
        """Export the program at one exact (bucketed) input signature;
        returns the bound callable ``fn(inputs) -> {name: tensor}``, which
        carries ``.fingerprint`` (16 hex characters) and ``.signature``.
        ``rows_level``: export the vmapped row entry (``map_rows``).  See
        :meth:`aot_compile_raw`."""
        return self.aot_compile_raw(
            self._raw_entry(rows_level), input_specs, ("aot", bool(rows_level))
        )

    def aot_compile_raw(self, raw, input_specs: Mapping[str, Any], tag):
        """:meth:`aot_compile` for an arbitrary raw entry ``fn(inputs,
        params)`` of this program.  Exported once per (``tag``, signature)
        and memoized in the derived-callable LRU; the params are live
        arguments, so ``update_params`` reaches the returned callable.

        The fingerprint hashes the torch version, the signature and the
        exported graph's code, which hold no object ids or source
        locations: two Programs wrapping the same source give the same
        fingerprint, in any process.  With the compile cache configured
        the exported program is saved as ``<dir>/programs/<fp>.pt2``."""
        examples = self._examples(input_specs, "aot_compile")
        sig = tuple((n, tuple(t.shape), str(t.dtype)) for n, t in sorted(examples.items()))
        key = (tag, sig)
        if key in self._derived:
            return self._derived_hit(key)
        ep = _export(_LiveEntry(raw), (examples, self._params))
        h = hashlib.sha256()
        h.update(torch.__version__.encode())
        h.update(repr(sig).encode())
        h.update(ep.graph_module.code.encode())
        fp = h.hexdigest()[:16]
        from . import compile_cache

        home = compile_cache.subdir("programs")
        if home is not None:
            path = os.path.join(home, f"{fp}.pt2")
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                torch.export.save(ep, tmp)
                os.replace(tmp, path)
        mod = ep.module()
        fn = lambda inputs: mod(dict(inputs), self._params)  # noqa: E731
        fn.fingerprint = fp
        fn.signature = sig
        return self._derived_put(key, fn)

    # -- serialization -------------------------------------------------------

    def serialize(self, input_specs: Mapping[str, Any]) -> bytes:
        """Freeze into a portable program artifact (``torch.export``).

        The params are frozen in as buffers, and Unknown (-1) dims become
        symbolic: every Unknown lead dim shares one ``rows`` ``Dim`` (all
        columns of a block have the same row count), each Unknown cell dim
        gets its own, so one artifact serves any block size.  The bytes
        are JAX's layout: the JSON header ``tfs-program-v1`` (``inputs``,
        ``fetches``, ``feed``), ``b"\\x00"``, then the payload of
        ``torch.export.save``.  Round-trip via :func:`deserialize_program`.

        ``input_specs``: input name -> ``(ScalarType, shape)``, Unknown
        dims allowed."""
        from torch.export import Dim

        rows = None
        examples: Dict[str, torch.Tensor] = {}
        dynamic: Dict[str, Dict[int, Any]] = {}
        n_cell = 0
        for n in self._input_names:
            if n not in input_specs:
                raise ProgramError(
                    f"serialize: no spec for program input {n!r}; got "
                    f"specs for {sorted(input_specs)}"
                )
            dt, shape = _spec(input_specs[n])
            dims, sizes = {}, []
            for i, d in enumerate(shape):
                if d != UNKNOWN:
                    sizes.append(d)
                    continue
                if i == 0:
                    rows = rows or Dim("rows")
                    dims[i] = rows
                    sizes.append(3)
                else:
                    dims[i] = Dim(f"u{n_cell}")
                    sizes.append(5 + n_cell)
                    n_cell += 1
            examples[n] = torch.zeros(tuple(sizes), dtype=dt, device=self._device)
            dynamic[n] = dims
        ep = _export(_FrozenEntry(self), (examples,), dynamic_shapes=({**dynamic},))
        header = json.dumps(
            {
                "format": "tfs-program-v1",
                "inputs": self._input_names,
                "fetches": self._fetches or self.fetches,
                "feed": self._feed,
            }
        ).encode()
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        return header + b"\x00" + buf.getvalue()

    # -- analysis ------------------------------------------------------------

    def analyze(
        self,
        input_specs: Mapping[str, Any],
        hints: Optional[Mapping[str, Sequence[int]]] = None,
    ) -> List[GraphNodeSummary]:
        """Shape-infer the program against input specs without executing it.

        ``input_specs``: input name -> ``(ScalarType, shape)``.  The program
        runs on ``meta`` tensors (params included), which carry shapes and
        dtypes but no data.  Unknown (-1) dims are evaluated at two probe
        sizes; output dims that track the probe come back Unknown.

        ``hints``: output name -> shape, merged over the program's own
        (``with_shape_hints``).  A hint refines an inferred shape (an
        Unknown dim takes the hinted value); a contradiction raises."""
        shapes: Dict[str, Shape] = {}
        stypes: Dict[str, ScalarType] = {}
        for n in self._input_names:
            if n not in input_specs:
                raise ProgramError(
                    f"analyze: no spec for program input {n!r}; "
                    f"got specs for {sorted(input_specs)}"
                )
            st, shape = input_specs[n]
            shapes[n] = Shape(shape)
            stypes[n] = st
        meta_params = {
            k: tree_map(lambda a: a.to("meta"), v) for k, v in self._params.items()
        }

        def _eval(probe: int) -> Dict[str, torch.Tensor]:
            ins = {
                n: torch.empty(
                    tuple(probe if d == UNKNOWN else d for d in shapes[n]),
                    dtype=stypes[n].torch_dtype,
                    device="meta",
                )
                for n in self._input_names
            }
            with torch.no_grad(), observability.suppress_trace_count():
                return self.call(ins, meta_params)

        out_a = _eval(3)
        if any(not s.is_static for s in shapes.values()):
            out_b = _eval(7)
            out_shapes = {}
            for name in out_a:
                sa, sb = Shape(out_a[name].shape), Shape(out_b[name].shape)
                if sa.rank != sb.rank:
                    raise ProgramError(
                        f"analyze: output {name!r} changes rank with the "
                        f"unknown input dims ({sa} vs {sb}); its shape "
                        f"cannot be described"
                    )
                out_shapes[name] = sa.merge(sb)
        else:
            out_shapes = {n: Shape(t.shape) for n, t in out_a.items()}
        merged_hints = dict(self._shape_hints)
        for name, h in (hints or {}).items():
            merged_hints[name] = Shape(h)
        unknown_hints = sorted(set(merged_hints) - set(out_shapes))
        if unknown_hints:
            raise ProgramError(
                f"shape hints given for non-existent outputs: "
                f"{unknown_hints}; program outputs are {sorted(out_shapes)}"
            )
        summaries = [
            GraphNodeSummary(n, True, False, stypes[n], shapes[n])
            for n in self._input_names
        ]
        for name, shape in out_shapes.items():
            if name in merged_hints:
                try:
                    shape = shape.refine(
                        merged_hints[name], context=f"output {name!r}"
                    )
                except Exception as e:
                    raise ProgramError(str(e)) from e
            summaries.append(
                GraphNodeSummary(
                    name, False, True, dtypes.from_torch(out_a[name].dtype), shape
                )
            )
        return summaries


def _spec(spec):
    """``(torch.dtype, Shape)`` of an input spec: ``(ScalarType or
    torch.dtype, shape)`` or an example tensor."""
    if isinstance(spec, torch.Tensor):
        return spec.dtype, Shape(tuple(spec.shape))
    st, shape = spec
    dt = st if isinstance(st, torch.dtype) else dtypes.coerce(st).torch_dtype
    return dt, Shape(shape)


class _LiveEntry(torch.nn.Module):
    """A raw entry ``fn(inputs, params)`` as the module ``aot_compile``
    exports: the params are arguments, so they stay live."""

    def __init__(self, raw):
        super().__init__()
        self._raw = raw

    def forward(self, inputs, params):
        return self._raw(inputs, params)


class _FrozenEntry(torch.nn.Module):
    """A program with its param leaves as buffers, the module
    ``serialize`` exports: the params are frozen into the artifact."""

    def __init__(self, program: "Program"):
        super().__init__()
        self._program = program
        self._n = 0
        for _path, leaf in tree_leaves(program._params):
            self.register_buffer(f"p{self._n}", leaf)
            self._n += 1

    def forward(self, inputs):
        leaves = iter([getattr(self, f"p{i}") for i in range(self._n)])
        params = tree_map(lambda _leaf: next(leaves), self._program._params)
        return self._program.call(inputs, params)


def _export(module: torch.nn.Module, args, dynamic_shapes=None):
    """``torch.export.export`` of ``module`` with the flash kernels as the
    ``tensorframes_torch::flash_fwd`` op (``parallel.flash``); the trace
    is analysis, not a trace of the user's program."""
    from .parallel import flash

    with flash.export_tracing(), observability.suppress_trace_count(), torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic_shapes)


def _on_device(ep, device: torch.device):
    """``ep`` with its state on ``device`` (``move_to_device_pass`` when
    the artifact was exported elsewhere)."""
    tensors = list(ep.state_dict.values()) + [
        t for t in ep.constants.values() if isinstance(t, torch.Tensor)
    ]
    if all(t.device == device for t in tensors):
        return ep
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(ep, device)


def deserialize_program(data: bytes, device: DeviceLike = None) -> Program:
    """Rehydrate a :meth:`Program.serialize` artifact on ``device`` (None =
    the CUDA card; raises without one).

    The artifact is self-contained (params frozen in, shapes symbolic).
    Block-level semantics only, as in the JAX package: the exported graph
    cannot be re-vmapped, so feed it to ``map_blocks``/``reduce_*``, not
    ``map_rows``."""
    sep = data.index(b"\x00")
    header = json.loads(data[:sep].decode())
    if header.get("format") != "tfs-program-v1":
        raise ProgramError(
            f"not a serialized tensorframes program (format="
            f"{header.get('format')!r})"
        )
    from .parallel import flash

    flash.export_ops()  # the op an exported attention calls, before the load
    dev = resolve_device(device)
    ep = _on_device(torch.export.load(io.BytesIO(data[sep + 1:])), dev)
    module = ep.module()
    names = header["inputs"]

    def fn(**kwargs):
        return module({n: kwargs[n] for n in names})

    return Program(fn, names, header["fetches"], header.get("feed") or None, device=dev)
