"""End-to-end streaming pipelines: source -> map -> join -> aggregate ->
sink, as one declarative spec.

PyTorch counterpart of ``tensorframes_tpu/relational/pipeline.py``, with
its spec grammar: the in-process runner that the bridge's ``pipeline``
RPC calls (``bridge/server.py``).  The runner drives the pipeline window
by window at fixed host memory, with a cancellation checkpoint at every
window boundary, and runs each window under a nested
:class:`~tensorframes_tpu_torch.observability.RequestLedger`
(``<cid>:w<i>``), so the per-window counters sum exactly to the enclosing
request's ledger.

Spec grammar (JSON-safe; ``graph`` values are GraphDef bytes, or any
program source ``builder.compile_program`` takes)::

    source: {"parquet": path, "window_rows"?: int, "columns"?: [...]}
            | {"frame_id": int}            # a registered frame, windowed
    stages: [
      {"op": "map_rows"|"map_blocks", "graph": ..., "fetches": [...],
       "inputs"?: {...}, "shapes"?: {...}, "trim"?: bool},
      {"op": "join", "on": key, "how"?: "inner"|"left",
       "build_frame_id": int | "build_frame": TensorFrame,
       "strategy"?: "auto"|"broadcast"|"sort_merge", "partitions"?: int},
      {"op": "aggregate", "keys": [...], "graph": ..., "fetches": [...]}
    ]                                      # aggregate must be terminal
    sink: {"kind": "frame"} | {"kind": "parquet", "path": ...}
            | {"kind": "collect", "limit_rows"?: int}

Key-column contracts are checked before the first window dispatches
(:func:`check_pipeline`, the ``TFS14x`` codes ``check`` returns).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .. import cancellation, observability
from ..frame import TensorFrame
from ..ops.engine import GroupedFrame, _resolve
from ..ops.validation import ValidationError
from ..streaming import from_batches, scan_parquet
from ..streaming.reader import StreamFrame
from ..streaming.sink import CollectSink, ParquetSink
from ..streaming.verbs import _concat_partial_frames
from ..recovery.durable import closing_on_error as _closing_on_error
# the function, not the submodule: the package re-exports `join` (the
# callable) over the submodule name, so a `from . import join` here
# would resolve to whichever won the package-init race
from .join import join as _join_call

logger = logging.getLogger("tensorframes_tpu_torch.relational")

_MAP_OPS = ("map_rows", "map_blocks")


# A map stage lazily applied per window; now the shared streaming
# MappedStream, so stacked pipeline map stages form a plan-
# routable chain: under TFS_PLAN each window runs ONE fused dispatch
# (dead columns pruned, bucket pads proven) instead of one dispatch per
# stage — bit-identical either way.
from ..streaming.verbs import MappedStream as _MappedStream  # noqa: E402


def _frame_windows_stream(frame: TensorFrame, window_rows: Optional[int]):
    """A registered frame as a window source (its Arrow form re-windowed
    through the ordinary reader, so accounting and clamping apply)."""
    table = frame.to_arrow()
    return from_batches(
        lambda: iter(table.to_batches()),
        window_rows=window_rows,
        label="frame",
    )


def _build_source(source, frames: Optional[Mapping[int, TensorFrame]]):
    if isinstance(source, StreamFrame):
        return source
    if not isinstance(source, Mapping):
        raise ValidationError(
            "pipeline: source must be a StreamFrame or a spec mapping"
        )
    if "parquet" in source:
        return scan_parquet(
            source["parquet"],
            columns=source.get("columns"),
            window_rows=source.get("window_rows"),
        )
    if "frame_id" in source:
        if frames is None or source["frame_id"] not in frames:
            raise ValidationError(
                f"pipeline: unknown source frame_id {source.get('frame_id')}"
            )
        return _frame_windows_stream(
            frames[source["frame_id"]], source.get("window_rows")
        )
    raise ValidationError(
        "pipeline: source needs 'parquet' or 'frame_id'"
    )


def _source_columns(
    source, frames: Optional[Mapping[int, TensorFrame]]
) -> Optional[List[str]]:
    """The source's column names, when statically known."""
    if isinstance(source, Mapping) and "parquet" in source:
        try:
            import pyarrow.parquet as pq

            from ..io import part_files

            schema = pq.ParquetFile(
                part_files(source["parquet"])[0]
            ).schema_arrow
            names = list(schema.names)
            cols = source.get("columns")
            return [c for c in names if not cols or c in cols]
        except Exception:  # noqa: BLE001 — fall back to runtime checks
            return None
    if isinstance(source, Mapping) and "frame_id" in source:
        f = (frames or {}).get(source["frame_id"])
        return f.column_names if f is not None else None
    if isinstance(source, StreamFrame):
        return None
    return None


def check_pipeline(
    source,
    stages: Sequence[Mapping[str, Any]],
    frames: Optional[Mapping[int, TensorFrame]] = None,
) -> List[Any]:
    """Pre-dispatch contract verification for a pipeline spec: walks the
    stage list tracking the statically-known column set (map output =
    fetches ++ unshadowed passthrough) and returns the ``TFS14x``
    diagnostics for every join/aggregate key contract it can prove —
    the same worst-first list ``tfs.check`` returns."""
    from ..analysis import contracts

    diags: List[Any] = []
    names = _source_columns(source, frames)
    for si, stage in enumerate(stages or ()):
        op = stage.get("op")
        loc = f"pipeline:stage{si}:{op}"
        if op in _MAP_OPS:
            fetches = list(stage.get("fetches") or ())
            if names is not None:
                if stage.get("trim"):
                    names = list(fetches)
                else:
                    names = fetches + [n for n in names if n not in fetches]
        elif op == "join":
            on = stage.get("on")
            build = stage.get("build_frame")
            if build is None and frames is not None:
                build = (frames or {}).get(stage.get("build_frame_id"))
            if not on:
                diags.append(contracts._diag(
                    "TFS140", f"{loc}: join needs on=<key column>",
                    loc, "name the join key column",
                ))
                continue
            if names is not None and on not in names:
                diags.append(contracts._diag(
                    "TFS140",
                    f"{loc}: key column {on!r} is not produced by the "
                    f"preceding stages (columns: {names})",
                    loc,
                    "fetch or pass the key column through every "
                    "upstream map stage",
                ))
            if isinstance(build, TensorFrame):
                # build-side key contracts (presence / scalar / hashable)
                diags.extend(
                    contracts.check_relational(build, "shuffle", [on])
                )
                collide = sorted(
                    (set(build.column_names) & set(names or [])) - {on}
                ) if names is not None else []
                if collide:
                    diags.append(contracts._diag(
                        "TFS143",
                        f"{loc}: non-key column name(s) {collide} exist "
                        f"on both join sides",
                        loc,
                        "rename or drop one side's columns before "
                        "joining",
                    ))
                names = (
                    (names or []) + [
                        n for n in build.column_names
                        if n != on and n not in (names or [])
                    ]
                    if names is not None else None
                )
        elif op == "aggregate":
            if si != len(stages) - 1:
                diags.append(contracts._diag(
                    "TFS101",
                    f"{loc}: aggregate must be the terminal stage",
                    loc, "move aggregate to the end of the pipeline",
                ))
            for k in stage.get("keys") or ():
                if names is not None and k not in names:
                    diags.append(contracts._diag(
                        "TFS140",
                        f"{loc}: grouping key {k!r} is not produced by "
                        f"the preceding stages (columns: {names})",
                        loc,
                        "group_by keys must name live columns",
                    ))
        else:
            diags.append(contracts._diag(
                "TFS101",
                f"{loc}: unknown pipeline op {op!r}",
                loc,
                "one of map_rows, map_blocks, join, aggregate",
            ))
    diags.sort(key=lambda d: (contracts._SEV_RANK[d.severity], d.code))
    return diags


def _stage_program(stage, what: str, device=None):
    from ..builder import compile_program

    return compile_program(
        stage["graph"],
        fetches=list(stage.get("fetches") or ()) or None,
        inputs=dict(stage.get("inputs") or {}) or None,
        shapes=dict(stage.get("shapes") or {}) or None,
        what=what,
        device=device,
    )


def run_stream_pipeline(
    source,
    stages: Optional[Sequence[Mapping[str, Any]]] = None,
    sink: Optional[Mapping[str, Any]] = None,
    frames: Optional[Mapping[int, TensorFrame]] = None,
    engine=None,
    tenant: Optional[str] = None,
    check: bool = True,
    job_id: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Execute a pipeline spec window by window.  Returns::

        {"frame": TensorFrame | None,   # aggregate/collect/frame sinks
         "sink": {...} | None,          # parquet sink summary
         "rows": int,                   # rows emitted to the terminal
         "windows": [ledger snapshots], # one per window (PR 10)
         "diagnostics": [...]}          # the pre-dispatch check result

    ``job_id`` makes the pipeline durable: every completed
    window journals its boundary (and, for frame/collect/aggregate
    terminals, its output state) under ``TFS_JOURNAL_DIR``, parquet
    sinks become per-window part directories, and a re-issued spec with
    the same ``job_id`` resumes from the journaled boundary — or, when
    the job already completed, returns the journaled result without
    executing a single window (exactly-once).  Both resume shapes mark
    the reply with ``"resumed": True``.  The returned per-window
    ledger snapshots cover exactly the windows THIS run executed, so
    their counters still sum to the request's attribution ledger.
    ``device``: where the stage programs run (None = the CUDA card)."""
    stages = list(stages or ())
    diags = check_pipeline(source, stages, frames) if check else []
    errors = [d for d in diags if d.severity == "error"]
    if errors:
        raise ValidationError(
            f"pipeline refused by pre-dispatch contract check: "
            f"{errors[0].summary}"
            + (f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""),
            code=errors[0].code,
        )

    writer = None
    if job_id is not None:
        from .. import recovery

        sink_kind = (
            dict(sink).get("kind", "frame")
            if isinstance(sink, Mapping)
            else "frame"
        )
        writer = recovery.adopt(
            job_id,
            "pipeline",
            recovery.job_fingerprint(
                "pipeline",
                ops=[s.get("op") for s in stages],
                sink=sink_kind,
            ),
        )
        if writer.completed:
            res_extra = writer.result_extra or {}
            result: Dict[str, Any] = {
                "rows": int(res_extra.get("rows", 0)),
                "windows": [],
                "diagnostics": [d.as_dict() for d in diags],
                "frame": None,
                "sink": res_extra.get("sink"),
                "resumed": True,
            }
            arrays = writer.load_result()
            if arrays is not None:
                result["frame"] = recovery.unpack_blocks(
                    arrays, res_extra
                )
            writer.close()
            return result

    # everything from source construction to the resume replay can
    # refuse (bad spec, sort-merge stage, torn state): the job slot
    # must be released on ANY of those raises
    with _closing_on_error(writer):
        ex = _resolve(engine)
        stream = _build_source(source, frames)

        agg_stage = None
        if stages and stages[-1].get("op") == "aggregate":
            agg_stage = stages[-1]
            stages = stages[:-1]

        cur = stream
        for si, stage in enumerate(stages):
            op = stage.get("op")
            if op in _MAP_OPS:
                program = _stage_program(stage, f"pipeline:stage{si}", device)
                cur = _MappedStream(
                    cur, program, op, bool(stage.get("trim")), engine
                )
            elif op == "join":
                build = stage.get("build_frame")
                if build is None:
                    fid = stage.get("build_frame_id")
                    if frames is None or fid not in frames:
                        raise ValidationError(
                            f"pipeline: join stage {si} names unknown "
                            f"build_frame_id {fid!r}"
                        )
                    build = frames[fid]
                cur = _join_call(
                    cur,
                    build,
                    on=stage["on"],
                    how=stage.get("how", "inner"),
                    strategy=stage.get("strategy", "auto"),
                    partitions=stage.get("partitions"),
                )
            else:
                raise ValidationError(
                    f"pipeline: unknown (or misplaced) op {op!r} at stage "
                    f"{si}"
                )

        agg_program = agg_keys = None
        if agg_stage is not None:
            agg_program = _stage_program(agg_stage, "pipeline:aggregate", device)
            agg_keys = list(agg_stage.get("keys") or ())
            if not agg_keys:
                raise ValidationError("pipeline: aggregate needs keys=[...]")

        sink = dict(sink or {"kind": "frame"})
        kind = sink.get("kind", "frame")
        sink_obj = None
        if agg_stage is None:
            if kind == "parquet":
                if writer is not None:
                    from ..streaming.sink import DurablePartSink

                    sink_obj = DurablePartSink(sink["path"])
                else:
                    sink_obj = ParquetSink(sink["path"])
            elif kind in ("frame", "collect"):
                sink_obj = CollectSink(limit_rows=sink.get("limit_rows"))
            else:
                raise ValidationError(f"pipeline: unknown sink kind {kind!r}")
        elif kind == "parquet":
            raise ValidationError(
                "pipeline: an aggregate-terminal pipeline returns a frame; "
                "write it with to_parquet afterwards"
            )

        acc: Optional[TensorFrame] = None
        start_window = 0
        prior_rows = 0
        if writer is not None:
            from .. import recovery
            from ..streaming.verbs import _load_journaled_acc

            # refuses sort-merge joins and one-shot sources up front — a
            # durable pipeline must be resumable window-for-window
            recovery.check_durable_source(cur)
            start_window = writer.boundary
            if not start_window and kind == "parquet" and (
                agg_stage is None
            ):
                # fresh job into a reused directory: stale parts out
                sink_obj.discard_existing()
            if start_window:
                prior_rows = sum(
                    int(e.get("rows", 0)) for e in writer.extras()
                )
                if agg_stage is not None:
                    acc = _load_journaled_acc(writer)
                elif kind == "parquet":
                    sink_obj.start_at(start_window, prior_rows)
                else:
                    # frame/collect: replay the journaled output windows
                    # into the sink (byte-exact .npz round trip), so the
                    # assembled frame equals the uninterrupted run's
                    for wi in range(start_window):
                        st = writer.load_state(wi)
                        if st is not None:
                            sink_obj.write(
                                recovery.unpack_blocks(
                                    st, writer.extras()[wi]
                                )
                            )
                recovery.skip_stream(cur, start_window)

    # -- the window loop: per-window ledgers nested under the active
    # request's (the bridge handler's) ledger, so per-window counters
    # sum exactly to the request's ledger / global delta --------------------
    parent = observability.current_request()
    base_cid = (
        parent.correlation_id
        if parent is not None
        else observability.new_correlation_id()
    )
    tenant = tenant or (parent.tenant if parent is not None else None)
    window_snaps: List[Dict[str, Any]] = []
    rows = prior_rows
    it = iter(cur.windows())
    i = start_window
    t_pipe = observability.trace_now()
    try:
        while True:
            cancellation.checkpoint()
            done = False
            led = observability.RequestLedger(
                f"{base_cid}:w{i}", tenant=tenant,
                method="pipeline:window",
            )
            token = observability.activate_request(led)
            try:
                try:
                    # the pull drives the WHOLE lazy chain for this
                    # window (read -> maps -> join probe) under the
                    # window's ledger
                    wf = next(it)
                except StopIteration:
                    done = True
                else:
                    if agg_program is not None:
                        part = ex.aggregate(
                            agg_program, GroupedFrame(wf, agg_keys)
                        )
                        acc = (
                            part
                            if acc is None
                            else ex.aggregate(
                                agg_program,
                                GroupedFrame(
                                    _concat_partial_frames(acc, part),
                                    agg_keys,
                                ),
                            )
                        )
                    else:
                        sink_obj.write(wf)
                    rows += wf.num_rows
                    if writer is not None:
                        # the boundary commit: terminal output is
                        # durable (part file / journaled state), now
                        # the manifest records the window as done
                        from .. import recovery

                        if agg_program is not None:
                            arrays, pextra = recovery.pack_blocks(acc)
                            writer.append(
                                arrays=arrays,
                                extra={**pextra, "rows": wf.num_rows},
                                replace_state=True,
                            )
                        elif kind == "parquet":
                            writer.append(
                                extra={"rows": wf.num_rows}
                            )
                        else:
                            arrays, pextra = recovery.pack_blocks(wf)
                            writer.append(
                                arrays=arrays,
                                extra={**pextra, "rows": wf.num_rows},
                            )
            finally:
                observability.deactivate_request(token)
                led.finish()
            if done:
                # the draining pull (trailing empty partitions, source
                # cleanup) can still bump counters; keep its snapshot
                # when it did, so the per-window sums equal the
                # request's ledger EXACTLY
                if led.counters:
                    window_snaps.append(led.snapshot())
                break
            window_snaps.append(led.snapshot())
            i += 1
    except BaseException:
        if sink_obj is not None and kind == "parquet":
            # window-boundary durability (docs/RESILIENCE.md): the sink
            # finalises over exactly the complete windows written
            try:
                sink_obj.close()
            except Exception:  # noqa: BLE001 — never mask the primary
                logger.warning(
                    "pipeline: sink close failed while handling an "
                    "earlier error", exc_info=True,
                )
        if writer is not None:
            writer.close()  # stays resumable from the journal
        raise
    observability.trace_complete(
        "pipeline", "relational", t_pipe, windows=i, rows=rows,
    )

    result: Dict[str, Any] = {
        "rows": rows,
        "windows": window_snaps,
        "diagnostics": [d.as_dict() for d in diags],
        "frame": None,
        "sink": None,
    }
    if start_window:
        # mid-job adoption: boundaries journaled by a prior owner
        # (possibly a dead process — fleet migration) were skipped,
        # not re-executed
        result["resumed"] = True
    if agg_stage is not None:
        result["frame"] = acc
    elif kind == "parquet":
        result["sink"] = sink_obj.close()
    else:
        result["frame"] = sink_obj.close()
    if writer is not None:
        from .. import recovery

        with _closing_on_error(writer):
            if result["frame"] is not None:
                arrays, pextra = recovery.pack_blocks(result["frame"])
                writer.complete(
                    result_arrays=arrays,
                    result_extra={**pextra, "rows": rows},
                )
            else:
                writer.complete(
                    result_extra={"rows": rows, "sink": result["sink"]}
                )
    return result
