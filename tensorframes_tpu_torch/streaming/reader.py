"""Windowed out-of-core frame reader: parquet / Arrow sources at fixed
host memory.

PyTorch counterpart of ``tensorframes_tpu/streaming/reader.py``.
:class:`StreamFrame` re-windows a source of Arrow record batches (a
parquet file, a directory of part files, or any batch iterator, bounded
or not) into consecutive ``TFS_STREAM_WINDOW``-row windows, each an
ordinary :class:`~tensorframes_tpu_torch.frame.TensorFrame` built through
``io._column_from_arrow`` (the mapping ``read_parquet`` uses), so the
verbs' prefetch, bucketing, pool, retries and cancellation apply per
window unchanged.  At most ``prefetch depth + 1`` windows of host columns
exist at once; the ``peak_host_bytes`` gauge is the proof.

* Window k+1 is built on a :class:`~tensorframes_tpu_torch.ops.prefetch.
  Prefetcher` thread (``name="tfs-stream-window"``, unbounded mode) while
  the consumer works on window k.  Device tensors a verb stages from a
  window are staged on the verb's own copy stream with their event and
  held reference (``prefetch.stage_arrays``), so nothing the reader frees
  can be read late.
* Parquet-backed streams re-scan their files to iterate again.  One-shot
  sources (generators) are spooled window by window to ``TFS_SPILL_DIR``
  parquet part files on the first pass (``spill_bytes_written``), so a
  second pass replays from disk; without a spill dir it raises.
* A durable resume (``recovery.skip_stream``) discards the journaled
  windows at the table level: decoded, never built, never staged, counted
  in ``journal_windows_skipped``.

Knobs: ``TFS_STREAM_WINDOW`` (rows a window, default 65536),
``TFS_STREAM_BLOCKS`` (blocks a window, default 1), ``TFS_HOST_BUDGET``
(host bytes for live window columns, ``K``/``M``/``G`` suffixes; the
window is clamped so ``prefetch depth + 2`` windows fit, logged once;
0/unset: no clamp), ``TFS_SPILL_DIR`` (``spill.py``).
"""

from __future__ import annotations

import logging
import os
import shutil
import weakref
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from .. import envutil, observability
from ..envutil import env_bytes, env_int, warn_once
from ..frame import TensorFrame
from ..ops import prefetch
from ..ops.validation import ValidationError
from . import spill as _spill

logger = logging.getLogger("tensorframes_tpu_torch.streaming")

ENV_WINDOW = "TFS_STREAM_WINDOW"
ENV_BLOCKS = "TFS_STREAM_BLOCKS"
ENV_HOST_BUDGET = "TFS_HOST_BUDGET"

DEFAULT_WINDOW_ROWS = 65536


def _log_once(key: str, msg: str, *args) -> None:
    """One log line a distinct cause, not one a window."""
    warn_once(logger, "streaming:" + key, msg, *args)


def window_rows_default() -> int:
    """Rows per stream window (``TFS_STREAM_WINDOW``, >= 1)."""
    return env_int(ENV_WINDOW, DEFAULT_WINDOW_ROWS, floor=1)


def stream_blocks() -> int:
    """Blocks per window (``TFS_STREAM_BLOCKS``, >= 1)."""
    return env_int(ENV_BLOCKS, 1, floor=1)


def host_budget() -> int:
    """Host byte budget for live window columns (``TFS_HOST_BUDGET``; 0 =
    no clamp)."""
    return env_bytes(ENV_HOST_BUDGET, 0)


def frame_host_bytes(frame: TensorFrame) -> int:
    """Host bytes held by ``frame``'s numpy columns (tensor columns count 0:
    they are device memory, accounted by ``TFS_HBM_BUDGET``)."""
    total = 0
    for c in frame.columns:
        d = c.data
        if isinstance(d, np.ndarray):
            if d.dtype == object:
                total += sum(_cell_bytes(cell) for cell in d)
            else:
                total += d.nbytes
        elif isinstance(d, list):
            total += sum(_cell_bytes(cell) for cell in d)
    return total


def _cell_bytes(cell: Any) -> int:
    nb = getattr(cell, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(cell, (bytes, str)):
        return len(cell)
    return 0


def _row_bytes_estimate(schema) -> int:
    """Rough host bytes a row of an Arrow schema: fixed-width fields
    exactly, variable-width ones a 32-byte guess.  Only clamps the window;
    ``peak_host_bytes`` measures the real footprint."""
    import pyarrow as pa

    total = 0
    for field in schema:
        t = field.type
        mult = 1
        while pa.types.is_fixed_size_list(t):
            mult *= t.list_size
            t = t.value_type
        try:
            width = t.bit_width // 8
        except (ValueError, AttributeError):
            width = 32  # variable-width: strings, lists, binaries
        total += max(width, 1) * mult
    return max(total, 1)


def clamped_window(requested: int, schema, label: str = "stream") -> int:
    """``requested`` rows, clamped so ``prefetch depth + 2`` windows of
    ``schema``-shaped rows fit ``TFS_HOST_BUDGET`` (logged once).  Shared by
    the window iterator and ``scan_parquet``'s batch-size hint, so the
    Arrow read granularity respects the budget too."""
    w = requested
    budget = host_budget()
    if budget > 0:
        concurrent = prefetch.prefetch_depth() + 2
        fit = max(1, budget // (concurrent * _row_bytes_estimate(schema)))
        if fit < w:
            _log_once(
                f"clamp:{label}:{w}->{fit}",
                "streaming: %s=%s holds only %d rows per window at %d "
                "concurrent windows; clamping the %d-row window to %d",
                ENV_HOST_BUDGET, envutil.env_raw(ENV_HOST_BUDGET), fit,
                concurrent, w, fit,
            )
            w = fit
    return w


def _copy_path_detail(schema) -> str:
    """Host-only and ragged columns of an Arrow schema, with reasons: these
    columns stream through host memory every window."""
    import pyarrow as pa

    forced = {}
    for field in schema:
        t = field.type
        if (pa.types.is_string(t) or pa.types.is_large_string(t)
                or pa.types.is_binary(t) or pa.types.is_large_binary(t)):
            forced[field.name] = "host-only (string/binary passthrough)"
        elif pa.types.is_list(t) or pa.types.is_large_list(t):
            forced[field.name] = "ragged (variable cell shapes; analyze/bucket per window)"
    return "; ".join(f"{n}: {why}" for n, why in sorted(forced.items()))


class StreamGroupedFrame:
    """``stream.group_by(keys)``: the streaming ``GroupedFrame``, consumed by
    :func:`tensorframes_tpu_torch.streaming.aggregate`."""

    def __init__(self, stream: "StreamFrame", keys: Sequence[str]):
        if not keys:
            raise ValidationError("group_by needs at least one key column")
        self.stream = stream
        self.keys = list(keys)


class StreamFrame:
    """A windowed, out-of-core frame: :meth:`windows` yields consecutive
    bounded :class:`TensorFrame` views of the source.

    Build one with :func:`scan_parquet` or :func:`from_batches`; the
    streaming verbs (``streaming/verbs.py``) consume it."""

    def __init__(
        self,
        source: Callable[[], Iterator[Any]],
        window_rows: Optional[int] = None,
        num_blocks: Optional[int] = None,
        columns: Optional[Sequence[str]] = None,
        num_rows: Optional[int] = None,
        reiterable: bool = False,
        label: str = "stream",
    ):
        self._source = source
        self._requested_rows = int(window_rows) if window_rows else window_rows_default()
        if self._requested_rows < 1:
            raise ValidationError(f"window_rows must be >= 1, got {window_rows}")
        self._num_blocks = int(num_blocks) if num_blocks else stream_blocks()
        self._columns = list(columns) if columns else None
        self.num_rows = num_rows  # None when the source is unbounded
        self._reiterable = reiterable
        self._label = label
        self._consumed = False
        self._spool_dir: Optional[str] = None
        self._effective_rows: Optional[int] = None
        # durable resume (recovery.skip_stream): windows discarded at the
        # table level before any frame is built
        self._skip_windows = 0

    @property
    def window_rows(self) -> int:
        """The effective window: the requested rows, or the
        ``TFS_HOST_BUDGET`` clamp once a pass has resolved it."""
        return self._effective_rows if self._effective_rows is not None else self._requested_rows

    def group_by(self, *keys: str) -> StreamGroupedFrame:
        return StreamGroupedFrame(self, keys)

    def map_blocks(self, fn, trim: bool = False, fetches=None, feed_dict=None,
                   shapes=None, engine=None, device=None):
        """A block map stage applied lazily to every window
        (``verbs.MappedStream``); stacked stages form a streamed map chain,
        which under ``TFS_PLAN`` runs through the planner per window."""
        from .verbs import MappedStream, _wrap

        program = _wrap(fn, "map_blocks", fetches, feed_dict, shapes, device)
        return MappedStream(self, program, "map_blocks", trim, engine)

    def map_rows(self, fn, fetches=None, feed_dict=None, shapes=None, engine=None,
                 device=None):
        """A row map stage applied lazily to every window (see
        :meth:`map_blocks`)."""
        from .verbs import MappedStream, _wrap

        program = _wrap(fn, "map_rows", fetches, feed_dict, shapes, device)
        return MappedStream(self, program, "map_rows", False, engine)

    def __repr__(self):
        rows = "?" if self.num_rows is None else self.num_rows
        return (f"StreamFrame[{self._label}: {rows} rows, window={self.window_rows}, "
                f"blocks/window={self._num_blocks}]")

    # -- windowing -----------------------------------------------------------

    def _window_tables(self, chunks: Iterator[Any]) -> Iterator[Any]:
        """Re-window Arrow record batches / tables into tables of exactly
        ``window_rows`` rows (a shorter tail), buffering at most one window
        and one source batch."""
        import pyarrow as pa

        buf: List[Any] = []
        buffered = 0
        w: Optional[int] = None
        names: Optional[List[str]] = None
        for chunk in chunks:
            tbl = chunk if isinstance(chunk, pa.Table) else pa.Table.from_batches([chunk])
            if self._columns is not None:
                tbl = tbl.select(self._columns)
            if tbl.num_rows == 0:
                continue
            if names is None:
                names = tbl.column_names
            elif tbl.column_names != names:
                # part files may order the same fields differently
                tbl = tbl.select(names)
            if w is None:
                w = clamped_window(self._requested_rows, tbl.schema, self._label)
                self._effective_rows = w
                detail = _copy_path_detail(tbl.schema)
                if detail:
                    _log_once(
                        "copy-path:" + detail,
                        "streaming: source columns force the host copy path — %s. "
                        "These columns stream through host RAM every window and "
                        "never stage to device.", detail,
                    )
            buf.append(tbl)
            buffered += tbl.num_rows
            while buffered >= w:
                whole = pa.concat_tables(buf) if len(buf) > 1 else buf[0]
                yield whole.slice(0, w)
                rest = whole.slice(w)
                buf = [rest] if rest.num_rows else []
                buffered -= w
        if buffered:
            yield pa.concat_tables(buf) if len(buf) > 1 else buf[0]

    def _frame_from_table(self, tbl) -> TensorFrame:
        from ..io import _column_from_arrow, _combined

        cols = [_column_from_arrow(name, _combined(tbl.column(name)))
                for name in tbl.column_names]
        frame = TensorFrame(cols).repartition(self._num_blocks)
        # a window has no durable host copy once the stream moves on:
        # frame.cache() spills its evicted shards instead of dropping them
        frame._host_windowed = True
        return frame

    def _iter_accounted(self, stage_frame, num_items: Optional[int]) -> Iterator[TensorFrame]:
        """The one accounted window loop, shared by the source pass, the
        spool replay and the shuffle's partitions: ``stage_frame(i)``
        (raising ``StopIteration`` when dry) runs on a prefetch thread; a
        window's host bytes enter the ``peak_host_bytes`` gauge when staged
        and leave it when the consumer moves past it.  On exit the staging
        thread stops first, then windows staged but never consumed are
        released, so an early exit or a failing verb leaves nothing pinned
        in the gauge."""
        acct = {"acquired": 0, "released": 0}

        def stage(i):
            frame = stage_frame(i)
            nbytes = frame_host_bytes(frame)
            acct["acquired"] += nbytes
            observability.note_stream_window()
            observability.note_host_window_bytes(nbytes)
            return frame, nbytes

        pf_iter = iter(prefetch.Prefetcher(stage, num_items, name="tfs-stream-window"))
        try:
            for frame, nbytes in pf_iter:
                try:
                    yield frame
                finally:
                    acct["released"] += nbytes
                    observability.note_host_window_bytes(-nbytes)
        finally:
            pf_iter.close()
            residual = acct["acquired"] - acct["released"]
            if residual:
                observability.note_host_window_bytes(-residual)

    def windows(self) -> Iterator[TensorFrame]:
        """Yield consecutive window frames, window k+1 built on a prefetch
        thread while the consumer works on window k."""
        if self._spool_dir is not None:
            yield from self._spooled_windows()
            return
        if self._consumed and not self._reiterable:
            raise ValidationError(
                f"StreamFrame[{self._label}]: the source is one-shot and was "
                f"already consumed; set {_spill.ENV_SPILL_DIR} to spool windows "
                f"to disk for re-iteration, or re-create the stream."
            )
        self._consumed = True
        spool = (_SpoolWriter(self._label)
                 if (not self._reiterable and _spill.configured()) else None)
        tables = self._window_tables(self._source())
        if self._skip_windows:
            if spool is not None:
                # a spool must hold every window to replay (durable jobs
                # refuse one-shot sources up front; this is the backstop)
                raise ValidationError(
                    f"StreamFrame[{self._label}]: cannot skip windows while "
                    f"spooling a one-shot source"
                )
            tables = self._skip_tables(tables, self._skip_windows)

        def stage_frame(i):
            tbl = next(tables)  # StopIteration ends the iteration
            frame = self._frame_from_table(tbl)
            if spool is not None:
                spool.write(i, tbl)
            return frame

        completed = False
        try:
            yield from self._iter_accounted(stage_frame, None)
            completed = True
        finally:
            if spool is not None:
                if completed:
                    self._spool_dir = spool.finish()
                    # a dropped stream must not leak its spool on disk
                    weakref.finalize(self, _remove_spool_dir, self._spool_dir)
                else:
                    spool.discard()

    def _skip_tables(self, tables, n: int):
        """Discard the first ``n`` window tables: decoded, never built."""
        skipped = 0
        for tbl in tables:
            if skipped < n:
                skipped += 1
                observability.note_journal_window_skipped()
                continue
            yield tbl

    def _spooled_windows(self) -> Iterator[TensorFrame]:
        """Replay the spooled part files, one file an original window."""
        import pyarrow.parquet as pq

        paths = [os.path.join(self._spool_dir, n)
                 for n in sorted(os.listdir(self._spool_dir)) if n.endswith(".parquet")]
        if self._skip_windows:
            for _ in paths[: self._skip_windows]:
                observability.note_journal_window_skipped()
            paths = paths[self._skip_windows:]

        def stage_frame(i):
            observability.note_spill_bytes_read(os.path.getsize(paths[i]))
            return self._frame_from_table(pq.read_table(paths[i]))

        yield from self._iter_accounted(stage_frame, len(paths))


def _remove_spool_dir(path: str) -> None:
    """GC finalizer body of a spooled StreamFrame: drop the spool."""
    shutil.rmtree(path, ignore_errors=True)


class _SpoolWriter:
    """First-pass window spool: one parquet part file a window under
    ``TFS_SPILL_DIR``, each closed before the consumer sees its window."""

    def __init__(self, label: str):
        self.dir = os.path.join(_spill.spill_dir(), f"spool-{os.getpid()}-{label}-{id(self):x}")
        os.makedirs(self.dir, exist_ok=True)

    def write(self, i: int, tbl) -> None:
        import pyarrow.parquet as pq

        path = os.path.join(self.dir, f"part-{i:06d}.parquet")
        pq.write_table(tbl, path)
        observability.note_spill_bytes_written(os.path.getsize(path))

    def finish(self) -> str:
        return self.dir

    def discard(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def scan_parquet(
    path,
    columns: Optional[Sequence[str]] = None,
    window_rows: Optional[int] = None,
    num_blocks: Optional[int] = None,
) -> StreamFrame:
    """Stream a parquet file, or a directory of part files in sorted name
    order, as a :class:`StreamFrame` (``io.read_parquet`` materialises;
    this streams).  Row groups are read through ``iter_batches`` and
    re-windowed, so windows do not depend on the writer's row groups; the
    stream re-iterates by re-scanning the files."""
    from ..io import _pyarrow, part_files

    _pyarrow()  # the one missing-dependency error
    import pyarrow.parquet as pq

    paths = part_files(path)
    total = sum(pq.ParquetFile(p).metadata.num_rows for p in paths)
    cols = list(columns) if columns else None
    hint = int(window_rows) if window_rows else window_rows_default()
    # the Arrow read granularity obeys the host budget too
    schema = pq.ParquetFile(paths[0]).schema_arrow
    if cols:
        import pyarrow as pa

        schema = pa.schema([schema.field(c) for c in cols])
    hint = clamped_window(hint, schema, os.path.basename(str(path)))

    def source():
        for p in paths:
            yield from pq.ParquetFile(p).iter_batches(batch_size=hint, columns=cols)

    return StreamFrame(
        source, window_rows=window_rows, num_blocks=num_blocks,
        columns=None,  # pushed down to iter_batches
        num_rows=total, reiterable=True,
        label=os.path.basename(str(path)) or "parquet",
    )


def from_batches(
    batches: Any,
    window_rows: Optional[int] = None,
    num_blocks: Optional[int] = None,
    columns: Optional[Sequence[str]] = None,
    label: str = "batches",
) -> StreamFrame:
    """Stream any source of Arrow record batches / tables: a callable
    returning an iterator (re-iterable: a fresh iterator a pass), or a
    plain iterable (one-shot: a second pass needs ``TFS_SPILL_DIR``, which
    spools the first).  The source may never end; the stream still runs
    at fixed host memory."""
    if callable(batches):
        return StreamFrame(batches, window_rows=window_rows, num_blocks=num_blocks,
                           columns=columns, reiterable=True, label=label)
    it = iter(batches)
    return StreamFrame(lambda: it, window_rows=window_rows, num_blocks=num_blocks,
                       columns=columns, reiterable=False, label=label)
