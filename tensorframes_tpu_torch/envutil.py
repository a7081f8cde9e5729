"""Shared env-knob parsing: one definition of the clamp-and-fallback
semantics every ``TFS_*`` knob uses (malformed values fall back to the
default; numeric values clamp to the floor).

The port's own copy of ``tensorframes_tpu/envutil.py`` (that module imports
only ``os``, but the port imports nothing of the JAX package).  The port's
knobs: ``TFS_HBM_BUDGET`` and ``TFS_CACHE_TENANT_BUDGET``
(``ops/frame_cache.py``) and ``TFS_DECODE_PAGE_TOKENS``
(``models/kv_pager.py``)."""

from __future__ import annotations

import os
from typing import Optional


def env_raw(name: str, default: str = "") -> str:
    """The raw (stripped) value of env knob ``name``; ``default`` when
    unset.  The ONE place a ``TFS_*`` knob touches ``os.environ``:
    callers with bespoke grammars (``auto`` tokens, ladders, fault
    plans) read through here and keep their parse local, so the repo
    lint (``tools/tfs_lint.py`` rule ``env-routing``) can prove no knob
    read bypasses the shared clamp-and-fallback conventions."""
    return os.environ.get(name, default).strip()


def env_set_default(name: str, value: str) -> None:
    """Pin env knob ``name`` to ``value`` for THIS process unless the
    environment already set it.  The one sanctioned ``TFS_*`` env
    WRITE: entrypoints that translate argv into knobs the library
    layer reads at startup (``bridge.replica --name`` pinning the
    replica identity before ``serve()``) go through here, keeping the
    env-routing lint's no-raw-access guarantee intact."""
    os.environ.setdefault(name, value)


def env_int(name: str, default: int, floor: int = 0) -> int:
    """``int(os.environ[name])`` clamped to ``floor``; ``default`` when
    unset or malformed."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return max(floor, int(raw))
    except ValueError:
        return default


def env_float(name: str, default: float, floor: float = 0.0) -> float:
    """``float(os.environ[name])`` clamped to ``floor``; ``default``
    when unset or malformed."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return max(floor, float(raw))
    except ValueError:
        return default


def env_opt_float(name: str) -> Optional[float]:
    """``float(os.environ[name])`` clamped to 0, or None when unset,
    empty, or malformed (for knobs whose absence means 'no limit')."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        return None


_BYTE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_bytes(raw: str) -> Optional[int]:
    """Parse a byte-count knob value — plain bytes or a ``K``/``M``/``G``
    binary suffix — to an int >= 0, or None when malformed.  The one
    parser behind every byte-budget knob (``TFS_HBM_BUDGET``,
    ``TFS_HOST_BUDGET``), so the accepted grammar cannot drift."""
    raw = raw.strip().lower()
    if not raw:
        return None
    mult = 1
    if raw[-1] in _BYTE_SUFFIX:
        mult = _BYTE_SUFFIX[raw[-1]]
        raw = raw[:-1]
    try:
        # OverflowError: "inf" / 9e999 overflow int(); malformed, not fatal
        return max(0, int(float(raw) * mult))
    except (ValueError, OverflowError):
        return None


def env_bytes(name: str, default: int = 0) -> int:
    """Byte-count env knob via :func:`parse_bytes`; ``default`` when
    unset, empty, or malformed."""
    parsed = parse_bytes(os.environ.get(name, ""))
    return default if parsed is None else parsed


# one-shot warnings: the answer to "why is this knob not doing what I
# asked" should land in the log exactly once per distinct cause, not
# once per verb call / window / epoch.  One set for the process — the
# keys are caller-namespaced strings.
_warned_once: set = set()


def warn_once(logger, key: str, msg: str, *args) -> None:
    """``logger.warning(msg, *args)`` the first time ``key`` is seen."""
    if key not in _warned_once:
        _warned_once.add(key)
        logger.warning(msg, *args)
