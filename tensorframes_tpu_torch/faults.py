"""Deterministic fault injection for the block execution stack.

The port's copy of the engine half of ``tensorframes_tpu/faults.py``.
Device faults (an out-of-memory, a lost link) come from hardware state a
test cannot provoke on demand; ``TFS_FAULT_INJECT`` describes an *exact,
reproducible* failure schedule instead, and the engine's dispatch boundary
(``ops/fault_tolerance.py``) consults it before every block (and split
sub-range) dispatch.

Spec grammar -- ``;``-separated specs, each ``kind:key=value:...``::

    TFS_FAULT_INJECT="transient:block=3:attempt=0"
    TFS_FAULT_INJECT="oom:device=0:rate=0.25:seed=7"
    TFS_FAULT_INJECT="delay:ms=50;transient:rate=0.25:seed=7"

Engine kinds:

* ``transient`` -- raise :class:`InjectedTransient` (its message opens
  with ``UNAVAILABLE:``, so ``resilience.FailureDetector`` classifies it
  transient);
* ``oom`` -- raise :class:`InjectedOOM` (opens with
  ``RESOURCE_EXHAUSTED:``; drives the engine's block split, not the retry
  loop, as ``torch.cuda.OutOfMemoryError`` does);
* ``delay`` -- sleep ``ms`` milliseconds at the dispatch boundary.

The journal kind ``proc_kill`` fires at the durable-job journal's
boundaries (:func:`maybe_kill_boundary`, called by
``recovery/journal.py``): it SIGKILLs this process at boundary
``window=N`` in crash cell ``phase=pre|mid|post`` (unset means ``pre``)::

    TFS_FAULT_INJECT="proc_kill:window=2:phase=mid"

The bridge kinds (``bridge_stall``, ``bridge_delay``, ``bridge_drop``,
``replica_kill``) parse with the same grammar and selectors as in the JAX
package, so one spec string means one thing in both packages, but nothing
fires them until the bridge is ported (ROADMAP.md Queue 1 item 12).

Selectors (all optional; a spec fires when every given selector matches):

* ``block=N`` -- only block index N;
* ``device=N`` -- only dispatches bound for device index N (the serial
  engine dispatches as device 0);
* ``attempt=N`` -- only retry attempt N of a block dispatch (``0`` = the
  first try, so retry 1 succeeds); never fires on OOM-split
  sub-dispatches, which are recovery work, not fresh attempts;
* ``rate=F`` + ``seed=S`` -- fire with probability F, decided by a
  counter-free deterministic draw hashed from ``(seed, index, kind,
  block, attempt)``: the same spec over the same frame gives the same
  schedule in every process (and in both packages);
* ``minrows=N`` -- only dispatches covering >= N rows (makes an injected
  OOM stop firing once the engine has split the block small enough).

Injection has one choke point (:func:`maybe_inject`), is off by default
(unset/empty env), and counts in ``observability.counters()
['faults_injected']``.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import List, Optional, Tuple

import torch

from . import envutil, observability

logger = logging.getLogger("tensorframes_tpu_torch.faults")

ENV_VAR = "TFS_FAULT_INJECT"

_ENGINE_KINDS = ("transient", "oom", "delay")
_BRIDGE_KINDS = ("bridge_stall", "bridge_delay", "bridge_drop", "replica_kill")
_BOUNDARY_KINDS = ("proc_kill",)
_KINDS = _ENGINE_KINDS + _BRIDGE_KINDS + _BOUNDARY_KINDS
_INT_KEYS = ("block", "device", "attempt", "minrows", "seed", "call", "window")
_FLOAT_KEYS = ("rate", "ms")
_STR_KEYS = ("method", "phase")
# selectors are kind-scoped: a selector the matching side never consults
# would fire the spec unscoped, so such a spec is dropped with a warning
_SCOPED = {
    "engine": ("block", "device", "attempt", "minrows"),
    "bridge": ("method", "call"),
    "boundary": ("window", "phase"),
}


class InjectedTransient(RuntimeError):
    """An injected runtime-infrastructure failure (classifies transient)."""


class InjectedOOM(RuntimeError):
    """An injected device out-of-memory (classifies RESOURCE_EXHAUSTED)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    block: Optional[int] = None
    device: Optional[int] = None
    attempt: Optional[int] = None
    minrows: Optional[int] = None
    rate: Optional[float] = None
    seed: int = 0
    ms: float = 0.0
    index: int = 0  # position in the spec list (decorrelates rate draws)
    method: Optional[str] = None
    call: Optional[int] = None
    window: Optional[int] = None
    phase: Optional[str] = None

    def matches(
        self,
        block: int,
        attempt: int,
        device: Optional[int],
        n_rows: Optional[int],
        site: str,
    ) -> bool:
        if self.block is not None and self.block != block:
            return False
        if self.device is not None and self.device != device:
            return False
        if self.attempt is not None:
            # attempt selectors describe the RETRY schedule of a block
            # dispatch; split sub-dispatches are recovery, not attempts
            if site != "dispatch" or self.attempt != attempt:
                return False
        if self.minrows is not None and (n_rows is None or n_rows < self.minrows):
            return False
        if self.rate is not None:
            draw = random.Random(
                f"{self.seed}:{self.index}:{self.kind}:{block}:{attempt}"
            ).random()
            if draw >= self.rate:
                return False
        return True


    def matches_boundary(self, window: int, phase: str) -> bool:
        """Whether this (boundary-kind) spec fires at journal boundary
        ``window`` in crash cell ``phase``; an unset ``phase`` means
        ``pre`` (the kill lands before any durability action)."""
        if self.window is not None and self.window != window:
            return False
        if (self.phase or "pre") != phase:
            return False
        if self.rate is not None:
            draw = random.Random(
                f"{self.seed}:{self.index}:{self.kind}:{window}"
            ).random()
            if draw >= self.rate:
                return False
        return True


_warned: set = set()


def _warn_once(raw: str, why: str) -> None:
    if raw not in _warned:
        _warned.add(raw)
        logger.warning(
            "%s spec %r ignored: %s (grammar: kind:key=value:... with kind "
            "in %s)", ENV_VAR, raw, why, "/".join(_KINDS),
        )


def _parse_one(raw: str, index: int) -> Optional[FaultSpec]:
    parts = [p for p in raw.strip().split(":") if p]
    if not parts:
        return None
    kind = parts[0].strip().lower()
    if kind not in _KINDS:
        _warn_once(raw, f"unknown kind {kind!r}")
        return None
    fields = {"kind": kind, "index": index}
    for part in parts[1:]:
        if "=" not in part:
            _warn_once(raw, f"selector {part!r} is not key=value")
            return None
        key, _, val = part.partition("=")
        key = key.strip().lower()
        try:
            if key in _INT_KEYS:
                fields[key] = int(val)
            elif key in _FLOAT_KEYS:
                fields[key] = float(val)
            elif key in _STR_KEYS:
                fields[key] = val.strip()
            else:
                _warn_once(raw, f"unknown selector {key!r}")
                return None
        except ValueError:
            _warn_once(raw, f"selector {key}={val!r} is not numeric")
            return None
    scope = (
        "engine" if kind in _ENGINE_KINDS
        else ("bridge" if kind in _BRIDGE_KINDS else "boundary")
    )
    for other, keys in _SCOPED.items():
        bad = [k for k in keys if k in fields] if other != scope else []
        if bad:
            _warn_once(
                raw, f"selector(s) {bad} only apply to {other} kinds, not {kind!r}"
            )
            return None
    if fields.get("phase") not in (None, "pre", "mid", "post"):
        _warn_once(raw, f"phase={fields['phase']!r} is not pre/mid/post")
        return None
    return FaultSpec(**fields)


_cache: Tuple[str, List[FaultSpec]] = ("", [])


def specs() -> List[FaultSpec]:
    """The parsed ``TFS_FAULT_INJECT`` plan (cached per env value; read per
    call so tests can flip it mid-process)."""
    global _cache
    raw = envutil.env_raw(ENV_VAR)
    if raw == _cache[0]:
        return _cache[1]
    parsed = []
    if raw:
        for i, part in enumerate(raw.split(";")):
            spec = _parse_one(part, i)
            if spec is not None:
                parsed.append(spec)
    _cache = (raw, parsed)
    return parsed


def active() -> bool:
    """Whether any ENGINE-level injection spec is live (it brings the
    dispatch boundary's retry session up even with retries pinned off)."""
    return any(s.kind in _ENGINE_KINDS for s in specs())


def boundary_active() -> bool:
    """Whether any journal-boundary injection spec is live."""
    return any(s.kind in _BOUNDARY_KINDS for s in specs())


def maybe_kill_boundary(window: int, phase: str) -> None:
    """The journal-boundary hook (``recovery/journal.py``): SIGKILL this
    process for the first matching ``proc_kill`` spec, with no cleanup, as
    the crash-resume contract must survive.  A no-op (one truthiness
    check) when ``TFS_FAULT_INJECT`` is unset."""
    plan = specs()
    if not plan:
        return
    for spec in plan:
        if spec.kind in _BOUNDARY_KINDS and spec.matches_boundary(window, phase):
            import os
            import signal

            logger.warning(
                "faults: proc_kill firing at boundary window=%d phase=%s",
                window, phase,
            )
            os.kill(os.getpid(), signal.SIGKILL)


def maybe_inject(
    block: int,
    attempt: int,
    device: Optional[int] = None,
    n_rows: Optional[int] = None,
    site: str = "dispatch",
) -> None:
    """The dispatch-boundary hook: sleep for every matching ``delay`` spec,
    then raise for the first matching ``transient``/``oom`` spec.  A no-op
    (one truthiness check) when ``TFS_FAULT_INJECT`` is unset."""
    plan = specs()
    if not plan:
        return
    for spec in plan:
        if spec.kind not in _ENGINE_KINDS:
            continue
        if not spec.matches(block, attempt, device, n_rows, site):
            continue
        if spec.kind == "delay":
            time.sleep(spec.ms / 1000.0)
            continue
        observability.note_fault_injected()
        where = (
            f"block={block} attempt={attempt} device={device} "
            f"rows={n_rows} site={site}"
        )
        if spec.kind == "transient":
            raise InjectedTransient(
                f"UNAVAILABLE: injected transient fault ({where})"
            )
        raise InjectedOOM(f"RESOURCE_EXHAUSTED: injected out-of-memory ({where})")


_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_oom(exc: BaseException, _depth: int = 0) -> bool:
    """Whether ``exc`` (or its ``__cause__`` chain) is a device
    out-of-memory: ``torch.cuda.OutOfMemoryError``, an injected
    :class:`InjectedOOM`, or a ``RESOURCE_EXHAUSTED`` status."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = str(exc).lower()
    if any(m in text for m in _OOM_MARKERS):
        return True
    if _depth < 4 and exc.__cause__ is not None:
        return is_oom(exc.__cause__, _depth + 1)
    return False
