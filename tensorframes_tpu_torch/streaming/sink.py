"""Streaming output sinks: where the fixed-memory map verbs put their rows.

PyTorch counterpart of ``tensorframes_tpu/streaming/sink.py``.  A streamed
map makes one output frame a window and hands it to a sink the moment it
completes:

* :class:`ParquetSink` appends each window to one parquet file, written
  under a temporary name (``<path>.inprogress-<pid>``) and moved to
  ``path`` by an atomic rename in ``close()``, which the verbs run on
  success, cancellation and error alike: the file ends at a window
  boundary, and a process death never leaves a torn file at ``path``;
* :class:`DurablePartSink` writes one finalized part file a window under
  a directory (the sink of durable, ``job_id=`` map jobs);
* :class:`CollectSink` keeps the windows on the host and assembles one
  TensorFrame whose blocks are the windows (not fixed-memory;
  ``limit_rows`` guards it);
* ``sink=None`` on the verbs returns a lazy iterator of output windows.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..frame import TensorFrame, host_value
from ..ops.validation import ValidationError


class ParquetSink:
    """Append streamed output windows to one parquet file (temp name, then
    the atomic rename in :meth:`close`)."""

    def __init__(self, path, row_group_size: Optional[int] = None):
        self.path = str(path)
        self._tmp_path = f"{self.path}.inprogress-{os.getpid()}"
        self.row_group_size = row_group_size
        self.rows = 0
        self.windows = 0
        self._writer = None
        self._closed = False

    def write(self, frame: TensorFrame) -> None:
        if self._closed:
            raise ValidationError(f"ParquetSink({self.path!r}): write after close")
        from ..io import frame_to_table
        import pyarrow.parquet as pq

        table = frame_to_table(frame)
        if self._writer is None:
            self._writer = pq.ParquetWriter(self._tmp_path, table.schema)
        self._writer.write_table(table, row_group_size=self.row_group_size)
        self.rows += table.num_rows
        self.windows += 1

    def close(self) -> Dict[str, Any]:
        """Write the footer and rename to the final path (idempotent), and
        return the summary: path, rows, windows, bytes on disk."""
        if not self._closed:
            self._closed = True
            if self._writer is not None:
                self._writer.close()
                os.replace(self._tmp_path, self.path)
        return self.result()

    def result(self) -> Dict[str, Any]:
        """Summary dict; ``path`` is None when no window was written (the
        writer takes its schema from the first window, so none was made)."""
        nbytes = 0
        if self._writer is not None:
            live = self.path if self._closed else self._tmp_path
            if os.path.exists(live):
                nbytes = os.path.getsize(live)
        return {
            "path": self.path if self._writer is not None else None,
            "rows": self.rows,
            "windows": self.windows,
            "bytes": nbytes,
        }


class DurablePartSink:
    """One finalized part file a window under a directory
    (``part-<i>.parquet``, each written to a temp name and renamed), so a
    window the journal records as complete is durable on disk already.
    Part indices are absolute: ``start_at`` positions a resumed sink past
    the journaled windows, and the resumed directory equals an
    uninterrupted run's file for file."""

    def __init__(self, path):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.rows = 0
        self.windows = 0
        self._next_index = 0
        self._closed = False

    def start_at(self, window: int, prior_rows: int) -> None:
        self._next_index = int(window)
        self.windows = int(window)
        self.rows = int(prior_rows)

    def discard_existing(self) -> None:
        """Remove the part files of an earlier run (a fresh job writing into
        a reused directory must not leave stale higher-numbered parts)."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return
        for n in names:
            if (n.startswith("part-") and n.endswith(".parquet")) or ".tmp-" in n:
                try:
                    os.remove(os.path.join(self.path, n))
                except OSError:
                    pass

    def write(self, frame: TensorFrame) -> None:
        if self._closed:
            raise ValidationError(f"DurablePartSink({self.path!r}): write after close")
        from ..io import frame_to_table
        import pyarrow.parquet as pq

        table = frame_to_table(frame)
        part = os.path.join(self.path, f"part-{self._next_index:06d}.parquet")
        tmp = f"{part}.tmp-{os.getpid()}"
        pq.write_table(table, tmp)
        os.replace(tmp, part)
        self._next_index += 1
        self.rows += table.num_rows
        self.windows += 1

    def close(self) -> Dict[str, Any]:
        self._closed = True
        return self.result()

    def result(self) -> Dict[str, Any]:
        nbytes = parts = 0
        try:
            for n in os.listdir(self.path):
                if n.startswith("part-") and n.endswith(".parquet"):
                    parts += 1
                    nbytes += os.path.getsize(os.path.join(self.path, n))
        except OSError:
            pass
        return {
            "path": self.path if parts else None,
            "rows": self.rows,
            "windows": self.windows,
            "bytes": nbytes,
            "parts": parts,
        }


class CollectSink:
    """Keep output windows on the host and assemble one TensorFrame whose
    block boundaries are the stream's window boundaries (so it compares
    directly with a materialized run over the same offsets)."""

    def __init__(self, limit_rows: Optional[int] = None):
        self.limit_rows = limit_rows
        self.rows = 0
        self.windows = 0
        self._blocks: List[Dict[str, Any]] = []

    def write(self, frame: TensorFrame) -> None:
        for bi in range(frame.num_blocks):
            # copy to the host now: the window's device outputs and host
            # columns go back to their pools
            self._blocks.append({name: host_value(v) for name, v in frame.block(bi).items()})
        self.rows += frame.num_rows
        self.windows += 1
        if self.limit_rows is not None and self.rows > self.limit_rows:
            raise ValidationError(
                f"CollectSink: collected {self.rows} rows, over the "
                f"limit_rows={self.limit_rows} guard — this stream is bigger "
                f"than an in-memory collect; use a ParquetSink."
            )

    def close(self) -> Optional[TensorFrame]:
        return self.result()

    def result(self) -> Optional[TensorFrame]:
        if not self._blocks:
            return None
        return TensorFrame.from_blocks(self._blocks)
