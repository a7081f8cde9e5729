"""Fixed-memory streaming verbs: the six verbs over a
:class:`~tensorframes_tpu_torch.streaming.reader.StreamFrame`.

PyTorch counterpart of ``tensorframes_tpu/streaming/verbs.py``.  Each
window is an ordinary :class:`TensorFrame`, so it runs through the
unmodified engine (prefetch, bucketing, pool, retries, cancellation).
What this module adds is the composition across windows:

* **map verbs** stream window -> device -> sink: ``sink=None`` returns a
  lazy iterator of output windows, a path or sink object writes each
  window as it completes and returns the sink's summary; the sink is
  closed on success, cancellation and error alike, at a window boundary.
* **reduce verbs** fold incrementally: each window's per-block partials
  come from the engine's own ``_reduce_partials`` and the one final
  combine is its ``_combine_partials``, the fold shape of the
  materialized verbs, so a streamed reduce equals the materialized reduce
  over a frame with the same block boundaries, bit for bit.
* **aggregate** merges each window's grouped partials into the running
  result by re-applying the program to the concatenated partial rows (the
  init-then-merge contract ``aggregate`` already requires): exact monoids
  are bit-identical to the materialized aggregate.
* ``job_id=`` makes a verb durable (``recovery/``): every window is
  journaled, and a resumed run skips the journaled windows and gives the
  uninterrupted run's bytes.

Every verb records a ``stream_<verb>`` span annotated with ``streaming``
(windows, rows, live/peak host bytes); the reduce verbs' spans also carry
each window's ``fault_tolerance``, ``device_pool`` and ``frame_cache``
records, their numbers summed over the windows (``_MergingSpan``).  Each
window leaves one ``window <k>`` event on the flight recorder's ``stream``
track.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Union

import logging

import numpy as np
import torch

from .. import cancellation, observability
from ..frame import Column, TensorFrame
from ..ops.engine import GroupedFrame, _host, _resolve, _wrap, last_verb_stats
from ..ops.validation import ValidationError
from .reader import StreamFrame, StreamGroupedFrame
# lazy import would cycle at module load; the recovery package only
# imports ops.validation/observability, so this direct import is safe
from ..recovery.durable import closing_on_error as _closing_on_error
from .sink import ParquetSink

logger = logging.getLogger("tensorframes_tpu_torch.streaming")


def _as_sink(sink):
    if isinstance(sink, (str, bytes)) or hasattr(sink, "__fspath__"):
        return ParquetSink(sink)
    return sink


def _as_durable_sink(sink, what: str):
    """Durable jobs need a sink whose completed windows survive the
    process AT every window boundary: a path (or an explicit
    :class:`DurablePartSink`) becomes a directory of per-window
    finalized part files.  A single-file ParquetSink keeps its footer in
    memory until close — a crash would lose every written window — and
    in-memory sinks cannot survive at all; both are refused."""
    from .sink import DurablePartSink

    if isinstance(sink, DurablePartSink):
        return sink
    if isinstance(sink, (str, bytes)) or hasattr(sink, "__fspath__"):
        return DurablePartSink(sink)
    raise ValidationError(
        f"{what}: durable execution (job_id=) writes each window as a "
        f"finalized parquet part file under a directory — pass the "
        f"output PATH (or a DurablePartSink); in-memory sinks "
        f"(CollectSink, sink=None iterators) and single-file "
        f"ParquetSinks cannot survive a process death at a window "
        f"boundary"
    )


def _sink_fingerprint_field(sink) -> str:
    if isinstance(sink, (str, bytes)) or hasattr(sink, "__fspath__"):
        return str(sink)
    return type(sink).__name__


def _program_fingerprint_fields(program) -> dict:
    """The cheap statically-known program surface a job fingerprint
    binds (see ``recovery.job_fingerprint`` for what this deliberately
    does NOT cover)."""
    return {
        "inputs": list(program._input_names),
        "fetches": program._declared_fetches or [],
        "feed": sorted(program._feed.items()),
    }


class MappedStream(StreamFrame):
    """A map stage applied lazily to every window (its Program shared
    across windows).  Stacked instances form a streamed map chain:
    ``stream.map_blocks(m1).map_rows(m2)``.  Under ``TFS_PLAN`` the
    outermost stage of a stack of two or more routes each window through
    ``planner.run_window_chain`` (one fused dispatch a window, dead columns
    never staged); eager per-stage dispatch is the default, bit-identical."""

    def __init__(self, inner: StreamFrame, program, op: str, trim: bool,
                 engine):
        super().__init__(
            source=lambda: iter(()),
            window_rows=inner.window_rows or None,
            num_blocks=inner._num_blocks,
            num_rows=inner.num_rows if not trim else None,
            reiterable=True,
            label=f"{op}({inner._label})",
        )
        self._inner = inner
        self._program = program
        self._op = op
        self._trim = trim
        self._engine = engine

    def _plan_chain(self):
        """The maximal stack of default-engine map stages ending at
        self (innermost first) plus the base stream they apply to, or
        ``(None, None)`` when planning cannot take the stack (explicit
        engines stay on their own dispatch surface)."""
        steps = []
        node = self
        base = None
        while isinstance(node, MappedStream):
            if node._engine is not None:
                return None, None
            steps.append((node._op, node._program, node._trim))
            base = node._inner
            node = node._inner
        steps.reverse()
        return steps, base

    def windows(self):
        from ..ops import planner

        if planner.planning_enabled():
            steps, base = self._plan_chain()
            if steps is not None and len(steps) >= 2:
                for wf in base.windows():
                    cancellation.checkpoint()
                    yield planner.run_window_chain(wf, steps)
                return
        ex = _resolve(self._engine)
        for wf in self._inner.windows():
            cancellation.checkpoint()
            if self._op == "map_rows":
                yield ex.map_rows(self._program, wf)
            else:
                yield ex.map_blocks(self._program, wf, trim=self._trim)


def _frame_bytes(frame: TensorFrame) -> int:
    """Host/device byte size of a window frame's columns: the data volume a
    ``stream`` track event carries.  Ragged columns sum their cells;
    anything unsized counts zero rather than failing a trace event."""
    total = 0
    for c in frame.columns:
        d = c.data
        nb = d.numel() * d.element_size() if isinstance(d, torch.Tensor) else getattr(d, "nbytes", None)
        if nb is None:
            try:
                nb = sum(
                    int(getattr(cell, "nbytes", 0)) for cell in c.cells()
                )
            except Exception:  # noqa: BLE001 — tracing must never raise
                nb = 0
        total += int(nb)
    return total


class _MergingSpan:
    """Span adapter for the streamed reduce verbs: each window's block
    loop leaves its own record (``fault_tolerance``, ``device_pool``,
    ``frame_cache``), and a plain span's ``annotate`` overwrites, so the
    last window would erase every earlier window's retry and quarantine
    evidence.  This adapter SUMS numeric fields across windows (other
    fields keep the last value), so the stream span carries whole-stream
    totals (the JAX package's ``_MergingSpan``)."""

    def __init__(self, span):
        self._span = span
        self._acc: Dict[str, Dict[str, Any]] = {}

    def mark(self, phase: str) -> None:
        self._span.mark(phase)

    def annotate(self, key: str, value) -> None:
        if isinstance(value, dict):
            acc = self._acc.setdefault(key, {})
            for k, v in value.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    acc[k] = v
                else:
                    acc[k] = acc.get(k, 0) + v
            value = dict(acc)
        self._span.annotate(key, value)


def _annotate_window(span) -> None:
    """One window's block-loop record (``engine.last_verb_stats``) into the
    stream span: the keys the JAX package's reduce partials annotate."""
    rec = last_verb_stats() or {}
    for key in ("device_pool", "fault_tolerance", "frame_cache"):
        if key in rec:
            span.annotate(key, rec[key])


def _annotate(span, stream: StreamFrame, windows: int, rows: int) -> None:
    span.annotate(
        "streaming",
        {
            "windows": windows,
            "rows": rows,
            "window_rows": stream.window_rows,
            "live_host_bytes": observability.live_host_bytes(),
            "peak_host_bytes": observability.counters()["peak_host_bytes"],
        },
    )


def _drain_to_sink(
    outputs,
    sink,
    span_name: str,
    stream: StreamFrame,
    job_id: Optional[str] = None,
    fingerprint_fields: Optional[dict] = None,
):
    """The ONE sink-drain loop of the streamed map/pipeline verbs:
    write each output window as it completes, and close the sink on
    success, cancellation, and error alike — the window-boundary
    durability contract (docs/RESILIENCE.md) lives here and nowhere
    else.

    ``job_id``: the loop journals every completed window
    (``recovery/journal.py``), the sink becomes a per-window durable
    part directory, and a resumed run skips the journaled windows at
    the table level — a process death re-executes at most the one
    unfinished window, and a completed job returns its journaled
    summary without executing anything (exactly-once)."""
    writer = None
    if job_id is not None:
        from .. import recovery

        writer = recovery.adopt(
            job_id,
            f"stream:{span_name}",
            recovery.job_fingerprint(
                f"stream:{span_name}",
                sink=_sink_fingerprint_field(sink),
                **(fingerprint_fields or {}),
            ),
        )
        if writer.completed:
            result = writer.result_extra
            writer.close()
            return result
        with _closing_on_error(writer):
            # a refusal here (one-shot source, in-memory sink) must
            # release the in-process job slot, or the job_id wedges
            # behind JobActive for the life of the process
            recovery.check_durable_source(stream)
            sink = _as_durable_sink(sink, span_name)
            start = writer.boundary
            if start:
                sink.start_at(
                    start,
                    sum(int(e.get("rows", 0)) for e in writer.extras()),
                )
                recovery.skip_stream(stream, start)
            else:
                # a FRESH job into a reused directory must not leave a
                # previous run's higher-numbered parts for readers
                sink.discard_existing()
    else:
        sink = _as_sink(sink)
    with observability.verb_span(span_name, 0, 0) as span:
        windows = writer.boundary if writer is not None else 0
        rows = 0
        try:
            it = iter(outputs)
            while True:
                # the window's verb dispatch happens inside next(): the
                # flight-recorder event spans compute + sink write, one
                # event per window on the "stream" track
                t_win = observability.trace_now()
                try:
                    out = it.__next__()
                except StopIteration:
                    break
                sink.write(out)
                if writer is not None:
                    # the commit point: the part file is durable, now
                    # the journal records the boundary (a kill between
                    # the two re-runs the window; the part rewrite is
                    # idempotent — same window, same bytes)
                    writer.append(extra={"rows": out.num_rows})
                observability.trace_complete(
                    f"window {windows}", "stream", t_win,
                    window=windows, rows=out.num_rows,
                    bytes=_frame_bytes(out) if t_win is not None else 0,
                )
                windows += 1
                rows += out.num_rows
                del out
        except BaseException:
            # close on cancellation/error too — the sink finalises over
            # exactly the complete windows written — but NEVER let a
            # failing close replace the primary error: a DeadlineExceeded
            # must surface as a deadline, not as the disk-full OSError
            # the footer write hit on the way down
            try:
                sink.close()
            except Exception:
                logger.warning(
                    "%s: sink close failed while handling an earlier "
                    "error; the primary error follows",
                    span_name,
                    exc_info=True,
                )
            if writer is not None:
                writer.close()  # stays resumable from the journal
            _annotate(span, stream, windows, rows)
            raise
        result = sink.close()
        if writer is not None:
            with _closing_on_error(writer):
                writer.complete(result_extra=result)
        _annotate(span, stream, windows, rows)
        return result


def _map_stream(
    program,
    stream: StreamFrame,
    rows_level: bool,
    trim: bool,
    host_stage,
    sink,
    engine,
    job_id: Optional[str] = None,
):
    ex = _resolve(engine)

    def window_outputs() -> Iterator[TensorFrame]:
        for wf in stream.windows():
            # window boundary = cancellation checkpoint: a deadline that
            # passes mid-stream stops BEFORE the next window dispatches,
            # leaving the sink at a window boundary
            cancellation.checkpoint()
            if rows_level:
                yield ex.map_rows(program, wf, host_stage=host_stage)
            else:
                yield ex.map_blocks(
                    program, wf, trim=trim, host_stage=host_stage
                )

    if sink is None:
        if job_id is not None:
            raise ValidationError(
                "streamed map: job_id= (durable execution) needs a "
                "sink path — the lazy iterator form holds results in "
                "the consumer's memory, which cannot survive a process "
                "death"
            )
        # bounded in-memory form: a lazy iterator, one output window
        # live at a time, pulled at the consumer's pace
        return window_outputs()
    verb = "map_rows" if rows_level else (
        "map_blocks_trimmed" if trim else "map_blocks"
    )
    return _drain_to_sink(
        window_outputs(), sink, f"stream_{verb}", stream, job_id=job_id,
        fingerprint_fields=_program_fingerprint_fields(program),
    )


def map_blocks(
    fn,
    stream: StreamFrame,
    trim: bool = False,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    host_stage: Optional[Mapping[str, Any]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    sink=None,
    engine=None,
    job_id: Optional[str] = None,
    device=None,
):
    """Streamed ``map_blocks``: apply the block program to every window's
    blocks at fixed host memory.  Returns an iterator of output window
    frames (``sink=None``) or the sink's summary.  ``job_id`` makes the run
    durable (resumable through ``TFS_JOURNAL_DIR``).  ``device``: where a
    callable ``fn`` runs (None = the CUDA card)."""
    program = _wrap(fn, "map_blocks", fetches, feed_dict, shapes, device)
    return _map_stream(
        program, stream, False, trim, host_stage, sink, engine,
        job_id=job_id,
    )


def map_blocks_trimmed(fn, stream: StreamFrame, **kw):
    """Streamed ``tfs.map_blocks_trimmed`` (output row count per window
    is program-defined)."""
    return map_blocks(fn, stream, trim=True, **kw)


def map_rows(
    fn,
    stream: StreamFrame,
    fetches: Optional[Sequence[str]] = None,
    feed_dict: Optional[Mapping[str, str]] = None,
    host_stage: Optional[Mapping[str, Any]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    sink=None,
    engine=None,
    job_id: Optional[str] = None,
    device=None,
):
    """Streamed ``map_rows``: the cell program vmapped over every window at
    fixed host memory."""
    program = _wrap(fn, "map_rows", fetches, feed_dict, shapes, device)
    return _map_stream(
        program, stream, True, False, host_stage, sink, engine,
        job_id=job_id,
    )


def _reduce_stream(
    program,
    stream: StreamFrame,
    mode,
    engine,
    verb: str,
    job_id: Optional[str] = None,
):
    """Shared incremental fold of the two reduce verbs: per-window
    partials through the engine's ``_reduce_partials``, one final
    ``_combine_partials`` across everything — the materialized fold
    shape, window boundaries and all.

    State growth, precisely: HOST memory stays fixed (one window live),
    but the partial list grows by one reduced CELL per base column per
    block seen — bytes per window, not rows — and the final combine
    stacks them all once.  That is the price of exact bit-identity with
    the materialized fold shape; it bounds practical streams (a million
    windows of one f64 cell ≈ 8 MB) but not a truly endless one.  For
    never-ending sources, chunk the stream and re-reduce the chunk
    results, or use :func:`aggregate`, which folds eagerly and holds
    O(groups) state regardless of stream length.

    ``job_id``: every window's partials are journaled
    (byte-exact ``.npz``), so a resumed run loads the journaled
    partials, skips their windows at the table level, and folds the
    SAME partial list through the SAME ``_combine_partials`` shape —
    bit-identical to an uninterrupted run by construction."""
    writer = None
    prior_partials: list = []
    start_window = 0
    prior_rows = 0
    if job_id is not None:
        from .. import recovery

        writer = recovery.adopt(
            job_id,
            f"stream:{verb}",
            recovery.job_fingerprint(
                f"stream:{verb}",
                mode=str(mode),
                **_program_fingerprint_fields(program),
            ),
        )
        if writer.completed:
            res = writer.load_result() or {}
            writer.close()
            return dict(res)
        with _closing_on_error(writer):
            recovery.check_durable_source(stream)
            start_window = writer.boundary
            if start_window:
                # the journaled partials go back where the live ones sit,
                # bit for bit, so the one combine stacks the same tensors
                for st in writer.load_states():
                    prior_partials.extend(
                        {b: torch.as_tensor(a).to(program.device) for b, a in p.items()}
                        for p in recovery.unpack_partials(st or {})
                    )
                prior_rows = sum(
                    int(e.get("rows", 0)) for e in writer.extras()
                )
                recovery.skip_stream(stream, start_window)
    ex = _resolve(engine)
    try:
        with observability.verb_span(f"stream_{verb}", 0, 0) as span, torch.no_grad():
            merged = _MergingSpan(span)  # per-window records accumulate
            setup = None
            partials = list(prior_partials)
            windows, rows = start_window, prior_rows
            for wf in stream.windows():
                cancellation.checkpoint()
                t_win = observability.trace_now()
                if setup is None:
                    setup = (
                        ex._reduce_rows_setup(program, wf, mode)
                        if verb == "reduce_rows"
                        else ex._reduce_blocks_setup(program, wf)
                    )
                bases, reduced, run_for = setup
                window_partials = ex._reduce_partials(
                    program, run_for, bases, reduced, wf
                )
                _annotate_window(merged)
                partials.extend(window_partials)
                if writer is not None:
                    from .. import recovery

                    writer.append(
                        arrays=recovery.pack_partials(
                            [
                                {b: p[b] for b in bases}
                                for p in window_partials
                            ]
                        ),
                        extra={"rows": wf.num_rows},
                    )
                observability.trace_complete(
                    f"window {windows}", "stream", t_win,
                    window=windows, rows=wf.num_rows,
                    bytes=_frame_bytes(wf) if t_win is not None else 0,
                )
                windows += 1
                rows += wf.num_rows
            if setup is None:
                if partials and writer is not None:
                    # every window was already journaled (the crash fell
                    # between the last append and complete): re-ingest
                    # ONE window purely to rebuild the fold executable —
                    # validation + analysis, no partials dispatched
                    setup = _setup_from_first_window(
                        ex, program, stream, mode, verb
                    )
                else:
                    raise ValidationError(
                        f"stream_{verb}: cannot reduce an empty stream "
                        f"(no identity element is available for an "
                        f"arbitrary program)"
                    )
            bases, reduced, run_for = setup
            final = ex._combine_partials(run_for(program), bases, partials)
            _annotate(span, stream, windows, rows)
            out = {b: _host(final[b]) for b in bases}
            if writer is not None:
                writer.complete(result_arrays=out)
            return out
    except BaseException:
        if writer is not None:
            writer.close()  # stays resumable from the journal
        raise


def _setup_from_first_window(ex, program, stream, mode, verb: str):
    """Rebuild the reduce fold setup from the stream's FIRST window
    (resume edge: all windows journaled, none left to pull).  The base
    stream's resume skip is reset for this one pull."""
    from .. import recovery

    recovery.skip_stream(stream, 0)  # clears the resume skip
    for wf in stream.windows():
        return (
            ex._reduce_rows_setup(program, wf, mode)
            if verb == "reduce_rows"
            else ex._reduce_blocks_setup(program, wf)
        )
    raise ValidationError(
        f"stream_{verb}: journaled partials exist but the source "
        f"yields no windows to rebuild the fold from; the source "
        f"changed since the journal was written"
    )


def reduce_rows(
    fn,
    stream: StreamFrame,
    fetches: Optional[Sequence[str]] = None,
    mode: str = "tree",
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    engine=None,
    job_id: Optional[str] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Streamed ``reduce_rows``: pairwise-fold every row of an out-of-core
    stream down to one cell a column, holding one window at a time plus one
    reduced cell a block seen (see ``_reduce_stream``)."""
    program = _wrap(fn, "reduce_rows", fetches, shapes=shapes, device=device)
    return _reduce_stream(
        program, stream, mode, engine, "reduce_rows", job_id=job_id
    )


def reduce_blocks(
    fn,
    stream: StreamFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    engine=None,
    job_id: Optional[str] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Streamed ``reduce_blocks``: a per-block reduce as windows arrive, one
    application of the block program to the stacked partials at the end."""
    program = _wrap(fn, "reduce_blocks", fetches, shapes=shapes, device=device)
    return _reduce_stream(
        program, stream, None, engine, "reduce_blocks", job_id=job_id
    )


def _concat_partial_frames(a: TensorFrame, b: TensorFrame) -> TensorFrame:
    """Row-concat two aggregate partial frames (same columns by
    construction: keys ++ bases, uniform cells)."""
    cols = []
    for ca in a.columns:
        cb = b.column(ca.info.name)
        da, db = ca.data, cb.data
        if isinstance(da, torch.Tensor) or isinstance(db, torch.Tensor):
            # a journaled accumulator (host) meets a window's (the device)
            dev = (da if isinstance(da, torch.Tensor) else db).device
            data = torch.cat([torch.as_tensor(da).to(dev), torch.as_tensor(db).to(dev)])
        else:
            data = np.concatenate([np.asarray(da), np.asarray(db)])
        cols.append(Column(ca.info, data))
    return TensorFrame(cols)


def _load_journaled_acc(writer) -> Optional[TensorFrame]:
    """The newest journaled accumulator frame (``replace_state`` keeps
    exactly one state file — scan newest-first for it)."""
    from .. import recovery

    for i in range(writer.boundary - 1, -1, -1):
        st = writer.load_state(i)
        if st is not None:
            return recovery.unpack_blocks(st, writer.extras()[i])
    return None


def aggregate(
    fn,
    grouped: StreamGroupedFrame,
    fetches: Optional[Sequence[str]] = None,
    shapes: Optional[Mapping[str, Sequence[int]]] = None,
    engine=None,
    job_id: Optional[str] = None,
    device=None,
) -> TensorFrame:
    """Streamed ``aggregate``: keyed algebraic aggregation over an
    out-of-core stream at fixed memory — host RAM holds one window plus
    one partial row per distinct key seen so far.

    Per window the engine's own ``aggregate`` runs (segment fast path
    included); the running result merges each window's partials by
    re-applying the same program over the concatenated partial rows,
    which is legal for exactly the algebraic, re-applicable programs
    ``aggregate`` already requires (``Operations.scala:110-126``).

    ``job_id``: the running accumulator — O(groups) rows —
    is journaled at every window boundary (superseding the previous
    copy), so a resumed run restores it byte-exactly, skips the
    journaled windows, and keeps merging."""
    if not isinstance(grouped, StreamGroupedFrame):
        raise ValidationError(
            "streaming.aggregate takes stream.group_by(...); for a "
            "materialized frame use tfs.aggregate"
        )
    program = _wrap(fn, "aggregate", fetches, shapes=shapes, device=device)
    ex = _resolve(engine)
    stream, keys = grouped.stream, grouped.keys
    writer = None
    acc: Optional[TensorFrame] = None
    start_window = 0
    prior_rows = 0
    if job_id is not None:
        from .. import recovery

        writer = recovery.adopt(
            job_id,
            "stream:aggregate",
            recovery.job_fingerprint(
                "stream:aggregate",
                keys=sorted(keys),
                **_program_fingerprint_fields(program),
            ),
        )
        if writer.completed:
            res = writer.load_result() or {}
            with _closing_on_error(writer):
                out = recovery.unpack_blocks(res, writer.result_extra)
            writer.close()
            return out
        with _closing_on_error(writer):
            recovery.check_durable_source(stream)
            start_window = writer.boundary
            if start_window:
                acc = _load_journaled_acc(writer)
                prior_rows = sum(
                    int(e.get("rows", 0)) for e in writer.extras()
                )
                recovery.skip_stream(stream, start_window)
    try:
        with observability.verb_span("stream_aggregate", 0, 0) as span:
            windows, rows = start_window, prior_rows
            for wf in stream.windows():
                cancellation.checkpoint()
                t_win = observability.trace_now()
                part = ex.aggregate(program, GroupedFrame(wf, keys))
                acc = (
                    part
                    if acc is None
                    else ex.aggregate(
                        program,
                        GroupedFrame(
                            _concat_partial_frames(acc, part), keys
                        ),
                    )
                )
                if writer is not None:
                    from .. import recovery

                    arrays, extra = recovery.pack_blocks(acc)
                    writer.append(
                        arrays=arrays,
                        extra={**extra, "rows": wf.num_rows},
                        replace_state=True,
                    )
                observability.trace_complete(
                    f"window {windows}", "stream", t_win,
                    window=windows, rows=wf.num_rows,
                    bytes=_frame_bytes(wf) if t_win is not None else 0,
                )
                windows += 1
                rows += wf.num_rows
            if acc is None:
                raise ValidationError(
                    "stream_aggregate: cannot aggregate an empty stream"
                )
            _annotate(span, stream, windows, rows)
            if writer is not None:
                from .. import recovery

                arrays, extra = recovery.pack_blocks(acc)
                writer.complete(
                    result_arrays=arrays, result_extra=extra
                )
            return acc
    except BaseException:
        if writer is not None:
            writer.close()  # stays resumable from the journal
        raise


def run_pipeline(
    pipe,
    stream: StreamFrame,
    sink=None,
    job_id: Optional[str] = None,
) -> Union[Iterator[TensorFrame], Any]:
    """Run a frame-terminal :class:`~tensorframes_tpu.ops.pipeline.
    Pipeline` chain over every window (``Pipeline.with_frame`` re-binds
    the chain; the stages' Programs — and their hot executables — are
    shared across windows).  Row-terminal chains (reduce/then) have no
    per-window meaning; use the streaming reduce verbs.  ``job_id``
    makes the run durable (see :func:`_drain_to_sink`)."""
    if getattr(pipe, "_row_stage", False):
        raise ValidationError(
            "streaming.run_pipeline: the chain ends in a row-producing "
            "stage; stream the map stages and use streaming.reduce_* "
            "for the fold."
        )

    def window_outputs():
        for wf in stream.windows():
            cancellation.checkpoint()
            yield pipe.with_frame(wf).run()

    if sink is None:
        if job_id is not None:
            raise ValidationError(
                "streaming.run_pipeline: job_id= (durable execution) "
                "needs a sink path; the lazy iterator form cannot "
                "survive a process death"
            )
        return window_outputs()
    return _drain_to_sink(
        window_outputs(), sink, "stream_pipeline", stream, job_id=job_id
    )
