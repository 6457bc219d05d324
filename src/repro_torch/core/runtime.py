"""Worker runtime + cluster (paper §3.2, Fig. 2/3 bottom).

Workers are the only components that touch customer data (Data Plane); the
planner/scheduler only handle metadata (Control Plane). Each worker owns:

  * a DataTransport (its shared-memory table store + Flight endpoint + spill
    dir) — the zero-copy fabric;
  * a ColumnarScanCache + IntermediateCache — single-tenant hosts can share
    disk/memory across subsequent ephemeral invocations (paper §4.2);
  * a PackageLinkBuilder — O(100 ms) ephemeral environment assembly.

Every user `print` and system event streams back to the Client in real time
("runs in the cloud, but feels local").
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from typing import TYPE_CHECKING

from repro_torch.columnar import compute
from repro_torch.columnar.catalog import Catalog
from repro_torch.columnar.objectstore import ObjectStore
from repro_torch.columnar.table import ColumnTable, concat_tables
from repro_torch.core import defaults
from repro_torch.core.cache import ColumnarScanCache, IntermediateCache
from repro_torch.columnar.table import numeric_column
from repro_torch.core.channels import (DataTransport, ShardUnavailable, TableHandle,
                                       partitioned_handle)
from repro_torch.core.envs import PackageLinkBuilder, PackageStore
from repro_torch.core.logical import build_logical_plan
from repro_torch.core.physical import (CombineTask, FunctionTask, GatherTask,
                                       PartitionTask, PhysicalPlan, Planner,
                                       ScanTask, ShuffleMergeTask,
                                       ShuffleSampleTask, ShuffleWriteTask,
                                       WorkerProfile)
from repro_torch.core.spec import HIDDEN_ORDER_COLUMN

if TYPE_CHECKING:
    from repro_torch.api import Project


class TaskError(RuntimeError):
    pass


class WorkerFailure(RuntimeError):
    """Raised by tasks running on a worker that was killed (chaos testing /
    real node loss)."""


class HandleUnavailable(RuntimeError):
    """An input's buffers were lost (producer worker died) — recoverable by
    re-executing the producer."""


# ---------------------------------------------------------------------------
# event streaming
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Event:
    kind: str                 # plan|task_start|log|env_built|cache_hit|task_done|task_failed|speculative
    task_id: str
    worker: str
    payload: Dict
    ts: float = dataclasses.field(default_factory=time.time)


class Client:
    """The user's terminal: collects the real-time event stream."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.events: List[Event] = []     # guard: _lock
        self._subs: List[Callable[[Event], None]] = []   # guard: _lock
        self._lock = threading.Lock()

    def subscribe(self, cb: Callable[["Event"], None]) -> None:
        """Register a live event listener (the engine uses this to learn
        about stream_chunk events the moment a producer publishes them)."""
        with self._lock:
            self._subs.append(cb)

    def unsubscribe(self, cb: Callable[["Event"], None]) -> None:
        with self._lock:
            if cb in self._subs:
                self._subs.remove(cb)

    def emit(self, event: Event) -> None:
        with self._lock:
            self.events.append(event)
            subs = list(self._subs)
        # callbacks run outside the lock: the engine's handler takes its own
        # lock and may dispatch tasks, which emit events right back here
        for cb in subs:
            cb(event)
        if self.verbose:
            p = event.payload
            line = p.get("line") or ", ".join(f"{k}={v}" for k, v in p.items())
            print(f"[{event.worker or 'cp'}] {event.kind} {event.task_id} {line}",
                  file=sys.stderr)

    def logs(self, task_id: Optional[str] = None) -> List[str]:
        with self._lock:
            return [e.payload["line"] for e in self.events
                    if e.kind == "log" and (task_id is None or e.task_id == task_id)]

    def of_kind(self, kind: str) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.kind == kind]


class _StdoutRouter:
    """Per-thread stdout capture so user `print`s stream as events while
    workers run concurrently in one process."""

    _installed = None

    def __init__(self, real):
        self.real = real
        self.routes: Dict[int, Callable[[str], None]] = {}
        self._buf: Dict[int, str] = {}

    def write(self, s: str) -> int:
        cb = self.routes.get(threading.get_ident())
        if cb is None:
            return self.real.write(s)
        tid = threading.get_ident()
        buf = self._buf.get(tid, "") + s
        while "\n" in buf:
            line, buf = buf.split("\n", 1)
            cb(line)
        self._buf[tid] = buf
        return len(s)

    def flush(self) -> None:
        self.real.flush()

    @classmethod
    def install(cls) -> "_StdoutRouter":
        if not isinstance(sys.stdout, cls):
            sys.stdout = cls(sys.stdout)
        return sys.stdout

    def route(self, cb: Callable[[str], None]):
        router = self

        class _Ctx:
            def __enter__(self):
                router.routes[threading.get_ident()] = cb

            def __exit__(self, *exc):
                tid = threading.get_ident()
                tail = router._buf.pop(tid, "")
                if tail:
                    cb(tail)
                router.routes.pop(tid, None)

        return _Ctx()


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


class Worker:
    def __init__(self, profile: WorkerProfile, catalog: Catalog,
                 object_store: ObjectStore, scratch_root: str,
                 package_store: PackageStore,
                 transport_memory_bytes: Optional[int] = None):
        self.profile = profile
        self.worker_id = profile.worker_id
        self.catalog = catalog
        self.transport = DataTransport(
            spill_dir=f"{scratch_root}/{self.worker_id}/spill",
            object_store=object_store,
            memory_budget_bytes=(transport_memory_bytes
                                 if transport_memory_bytes is not None
                                 else defaults.TRANSPORT_MEMORY_BYTES))
        self.scan_cache = ColumnarScanCache(
            catalog, scratch_dir=f"{scratch_root}/{self.worker_id}/scan")
        self.result_cache = IntermediateCache()
        self.env_builder = PackageLinkBuilder(
            package_store, envs_root=f"{scratch_root}/{self.worker_id}/envs")
        self.alive = True
        self._router = _StdoutRouter.install()

    # -- chaos hook -----------------------------------------------------------
    def kill(self) -> None:
        """Simulate node loss: in-memory buffers are gone, new tasks refused."""
        self.alive = False
        # drops resident tables AND aborts live streams, so a consumer
        # blocked mid-stream sees a dead producer instead of hanging
        self.transport.drop_memory()
        self.transport.flight.close()

    def _check_alive(self) -> None:
        if not self.alive:
            raise WorkerFailure(f"worker {self.worker_id} is down")

    # -- task execution -----------------------------------------------------------
    def execute(self, plan: PhysicalPlan, task, handles,
                client: Client, put_channel: str,
                project: Optional["Project"] = None,
                edge_channels: Optional[Dict[str, str]] = None) -> TableHandle:
        """Run one task. `handles` is the run's synchronized HandleMap (or a
        plain dict in tests); `edge_channels` maps parent task id -> transfer
        channel, bound by the engine at dispatch time from actual placement."""
        self._check_alive()
        t0 = time.perf_counter()
        if isinstance(task, ShuffleWriteTask):
            # publishes its own partition-addressed handle: P individually
            # fetchable slices, not one table — bypass the generic put
            parts = self._run_shuffle_write(plan, task, handles, client,
                                            edge_channels or {})
            self._check_alive()
            handle = self.transport.put_shuffle(
                f"{plan.run_id}:{task.task_id}", parts, put_channel)
            client.emit(Event("task_done", task.task_id, self.worker_id,
                              {"rows": handle.num_rows,
                               "bytes": handle.nbytes,
                               "seconds": round(time.perf_counter() - t0, 6),
                               "channel": "shuffle",
                               # per-partition byte histogram: the engine's
                               # skew detector reads these off the handle,
                               # the event is for observability/tests
                               "partition_bytes": [p.nbytes
                                                   for p in handle.parts]}))
            return handle
        if plan.chunk_rows > 0 and isinstance(task, ScanTask) \
                and task.streams_output:
            # streamed producers publish chunk-by-chunk and emit their own
            # task_done — consumers with a stream edge dispatch on the
            # first chunk instead of waiting for this return
            return self._run_scan_stream(plan, task, client, put_channel, t0)
        if plan.chunk_rows > 0 and isinstance(task, FunctionTask) \
                and (task.streams_output or task.stream_param) \
                and not task.materialize:
            return self._run_function_stream(plan, task, handles, client,
                                             project, edge_channels or {},
                                             put_channel, t0)
        if isinstance(task, ScanTask):
            table = self._run_scan(task, client)
        elif isinstance(task, GatherTask):
            table = self._run_gather(plan, task, handles, client)
        elif isinstance(task, CombineTask):
            table = self._run_combine(plan, task, handles, client, project)
        elif isinstance(task, ShuffleSampleTask):
            table = self._run_sample(plan, task, handles, client)
        elif isinstance(task, PartitionTask):
            table = self._run_partition(plan, task, handles, client, project)
        elif isinstance(task, ShuffleMergeTask):
            table = self._run_shuffle_merge(plan, task, handles, client)
        else:
            table = self._run_function(plan, task, handles, client, project,
                                       edge_channels or {})
        self._check_alive()
        # run-scoped key: concurrent runs share the fleet, so bare task ids
        # would collide in the transport's table store
        handle = self.transport.put(f"{plan.run_id}:{task.task_id}", table,
                                    put_channel)
        client.emit(Event("task_done", task.task_id, self.worker_id,
                          {"rows": table.num_rows, "bytes": table.nbytes,
                           "seconds": round(time.perf_counter() - t0, 6),
                           "channel": put_channel}))
        return handle

    def _run_scan(self, task: ScanTask, client: Client) -> ColumnTable:
        snap = self.catalog.get_snapshot(task.snapshot_id)
        cols = list(task.columns) if task.columns else None
        before = dict(self.scan_cache.stats)
        table = self.scan_cache.read_snapshot(snap, cols, file_keys=task.files)
        after = self.scan_cache.stats
        client.emit(Event("cache_probe", task.task_id, self.worker_id,
                          {"kind": "scan",
                           "hits": after["hits"] - before["hits"],
                           "misses": after["misses"] - before["misses"]}))
        return table

    # -- streamed execution (chunked data plane) ----------------------------
    def _scan_chunks(self, snap, cols, task: ScanTask, chunk_rows: int):
        """Per-file cache reads re-sliced to the plan's chunk size. The
        chunk concatenation is byte-identical to the whole-snapshot read
        (same file order, same per-file buffers)."""
        keys = list(task.files)
        if not keys:
            # no data files: one empty chunk so the schema still travels
            yield self.scan_cache.read_snapshot(snap, cols, file_keys=[])
            return
        for fk in keys:
            part = self.scan_cache.read_snapshot(snap, cols, file_keys=[fk])
            yield from compute.iter_table_chunks(part, chunk_rows)

    def _run_scan_stream(self, plan: PhysicalPlan, task: ScanTask,
                         client: Client, put_channel: str,
                         t0: float) -> TableHandle:
        """Streamed scan: publish the snapshot as fixed-size row chunks
        under one handle. Each chunk lands in the transport the moment its
        file slice is read; the engine dispatches stream-capable consumers
        on the first `stream_chunk` event instead of on task_done."""
        snap = self.catalog.get_snapshot(task.snapshot_id)
        cols = list(task.columns) if task.columns else None
        before = dict(self.scan_cache.stats)
        key = f"{plan.run_id}:{task.task_id}"
        writer = self.transport.open_stream(key, put_channel)
        n = 0
        try:
            for chunk in self._scan_chunks(snap, cols, task, plan.chunk_rows):
                self._check_alive()
                writer.append(chunk)
                client.emit(Event("stream_chunk", task.task_id,
                                  self.worker_id,
                                  {"chunk": n, "key": key,
                                   "location": writer.location,
                                   "rows": chunk.num_rows}))
                n += 1
            handle = writer.finish()
        except BaseException:
            writer.abort()
            raise
        after = self.scan_cache.stats
        client.emit(Event("cache_probe", task.task_id, self.worker_id,
                          {"kind": "scan",
                           "hits": after["hits"] - before["hits"],
                           "misses": after["misses"] - before["misses"]}))
        client.emit(Event("task_done", task.task_id, self.worker_id,
                          {"rows": handle.num_rows, "bytes": handle.nbytes,
                           "seconds": round(time.perf_counter() - t0, 6),
                           "channel": "stream", "chunks": n}))
        return handle

    def _fetch_parts(self, plan: PhysicalPlan, task, handles,
                     columns=None, as_parts: bool = False):
        """Resolve a merge task's per-shard inputs through one partitioned
        handle — local parts zero-copy, remote over their own channel. A
        missing handle or a part whose buffers died maps back to exactly its
        producer task (HandleUnavailable), so the engine re-executes that
        one shard, never a sibling. Returns (result, n_parts, n_local) where
        result is the concatenated table, or the ordered part list when
        `as_parts` (the combine path needs the shard boundaries)."""
        part_handles = []
        for edge in task.inputs:
            h = handles.get(edge.parent_task)
            if h is None:
                raise HandleUnavailable(edge.parent_task)
            part_handles.append((edge.parent_task, h))
        phandle = partitioned_handle(f"{plan.run_id}:{task.task_id}",
                                     [h for _, h in part_handles])
        n_local = sum(self.transport.has_local(h.key) for _, h in part_handles)
        try:
            if as_parts:
                result = self.transport.get_parts(phandle, columns=columns)
            else:
                result = self.transport.get(phandle, columns=columns)
        except ShardUnavailable as e:
            lost = next((tid for tid, h in part_handles if h.key == e.key),
                        task.inputs[0].parent_task)
            raise HandleUnavailable(lost) from e
        return result, len(part_handles), n_local

    def _run_gather(self, plan: PhysicalPlan, task: GatherTask,
                    handles, client: Client) -> ColumnTable:
        """Merge a sharded producer's raw rows: resolve every part where it
        lives and concatenate exactly once."""
        cols = list(task.columns) if task.columns else None
        table, n_parts, n_local = self._fetch_parts(plan, task, handles,
                                                    columns=cols)
        client.emit(Event("gather", task.task_id, self.worker_id,
                          {"parts": n_parts, "local": n_local,
                           "remote": n_parts - n_local}))
        return table

    def _run_combine(self, plan: PhysicalPlan, task: CombineTask,
                     handles, client: Client,
                     project: Optional["Project"]) -> ColumnTable:
        """Merge a combinable aggregation's per-shard partial states
        (spec.combinable.combine) — the map-side-combine replacement for a
        raw-row gather. Parts resolve through the same partitioned machinery
        (local states zero-copy, remote over their channel); a lost part
        maps back to exactly its partial task for per-shard re-execution."""
        from repro_torch.api import default_project
        project = project or default_project()
        spec = project.functions[task.name]
        if spec.combinable is None:
            raise TaskError(f"{task.name}: plan expects a combinable "
                            f"aggregation but the project declares none "
                            f"(stale plan or project drift)")
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            return cached
        parts, n_parts, n_local = self._fetch_parts(plan, task, handles,
                                                    as_parts=True)
        # the combine is user code (custom reducers): it runs under the
        # model's declared ephemeral environment, same as the partial half
        table = self._invoke_user_code(
            plan, task, spec, lambda: spec.combinable.combine(parts),
            client, label=f"{task.name} (combine)")
        client.emit(Event("combine", task.task_id, self.worker_id,
                          {"parts": n_parts, "local": n_local,
                           "remote": n_parts - n_local,
                           "state_bytes": int(sum(p.nbytes for p in parts))}))
        return table

    def _deliver_edge(self, edge, handles, via: Optional[str] = None,
                      extra_columns: Sequence[str] = ()) -> ColumnTable:
        """Resolve one input edge with its declared pushdowns: fetch via the
        bound channel (or the handle's own), apply the edge predicate, then
        the strict column projection. A lost handle or dead producer maps to
        HandleUnavailable(producer) for per-task recovery."""
        handle = handles.get(edge.parent_task)
        if handle is None:
            raise HandleUnavailable(edge.parent_task)
        pred = edge.ref.predicate()
        need = None
        if edge.ref.columns is not None:
            need = list(edge.ref.columns)
            for c in list(extra_columns) + (pred.referenced_columns()
                                            if pred else []):
                if c not in need:
                    need.append(c)
        try:
            table = self.transport.get(handle, columns=need, via=via)
        except (OSError, ConnectionError, KeyError) as e:
            raise HandleUnavailable(edge.parent_task) from e
        if pred is not None:
            table = compute.filter_table(table, pred)
        if edge.ref.columns is not None:
            # strict on the declared columns (a typo must raise, not silently
            # vanish), lenient on system extras like a sample's sort key
            keep = list(edge.ref.columns)
            keep += [c for c in extra_columns
                     if c not in keep and c in table.column_names]
            table = table.project(keep)
        return table

    def _edge_chunks(self, plan: PhysicalPlan, edge, handles,
                     via: Optional[str] = None):
        """Chunk-wise `_deliver_edge`: resolve one input edge as a chunk
        iterator with the edge's predicate/projection applied per chunk —
        the full input table never materializes on this worker. A handle
        that turns out non-streamable (producer cache hit, non-stream
        retry) degrades to a whole fetch re-sliced locally. Lost chunks or
        a dead producer map to HandleUnavailable(producer) exactly like a
        whole-handle fetch, so per-chunk recovery re-executes exactly the
        producer whose buffers died."""
        handle = handles.get(edge.parent_task)
        if handle is None:
            raise HandleUnavailable(edge.parent_task)
        pred = edge.ref.predicate()
        need = None
        if edge.ref.columns is not None:
            need = list(edge.ref.columns)
            for c in (pred.referenced_columns() if pred else []):
                if c not in need:
                    need.append(c)
        try:
            if handle.channel in ("stream", "chunked"):
                chunks = self.transport.get_stream(handle, columns=need)
            else:
                whole = self.transport.get(handle, columns=need, via=via)
                chunks = compute.iter_table_chunks(whole, plan.chunk_rows)
            for chunk in chunks:
                if pred is not None:
                    chunk = compute.filter_table(chunk, pred)
                if edge.ref.columns is not None:
                    chunk = chunk.project(list(edge.ref.columns))
                yield chunk
        except (ShardUnavailable, OSError, ConnectionError, KeyError) as e:
            raise HandleUnavailable(edge.parent_task) from e

    def _run_function_stream(self, plan: PhysicalPlan, task: FunctionTask,
                             handles, client: Client,
                             project: Optional["Project"],
                             edge_channels: Dict[str, str],
                             put_channel: str, t0: float) -> TableHandle:
        """Streamed function execution (plan.chunk_rows > 0). Two shapes,
        both consuming the stream edge chunk-by-chunk:

          * rowwise (`task.streams_output`): apply the model per chunk and
            republish each output chunk immediately — this task's own
            consumer can already be running (pipelined dispatch);
          * `agg_phase="partial"` with a state-closed contract merge: fold
            per-chunk partial states through `contract.merge_states` into
            one state table with exactly the whole-shard partial's schema.

        Emits its own task_done (like the shuffle-write path) because the
        streamed output is published incrementally, not via the generic
        put in `execute`."""
        key = f"{plan.run_id}:{task.task_id}"
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            handle = self.transport.put(key, cached, put_channel)
            client.emit(Event("task_done", task.task_id, self.worker_id,
                              {"rows": cached.num_rows,
                               "bytes": cached.nbytes,
                               "seconds": round(time.perf_counter() - t0, 6),
                               "channel": put_channel}))
            return handle
        from repro_torch.api import default_project
        project = project or default_project()
        spec = project.functions[task.name]
        fn = spec.fn
        contract = None
        if getattr(task, "agg_phase", "") == "partial":
            contract = spec.combinable
            if contract is None or contract.merge_states is None:
                raise TaskError(f"{task.name}: plan streams a combinable "
                                f"partial but the project's contract has no "
                                f"state-closed merge (stale plan or project "
                                f"drift)")
            fn = contract.partial
        # the streamed edge: the declared stream_param, or the rowwise
        # model's single input when the parent itself didn't stream
        if task.stream_param:
            stream_edge = next(e for e in task.inputs
                               if e.param == task.stream_param)
        else:
            stream_edge = task.inputs[0]
        # broadcast inputs (join build side, ...) resolve whole, up front
        kwargs = {}
        for edge in task.inputs:
            if edge is stream_edge:
                continue
            via = (edge_channels.get(edge.parent_task) or edge.channel
                   or "zerocopy")
            kwargs[edge.param] = self._deliver_edge(edge, handles, via=via)
        in_via = (edge_channels.get(stream_edge.parent_task)
                  or stream_edge.channel or "zerocopy")
        in_chunks = self._edge_chunks(plan, stream_edge, handles, via=in_via)
        report = self.env_builder.build(spec.env, fresh=True)
        client.emit(Event("env_built", task.task_id, self.worker_id,
                          {"env_id": report.env_id,
                           "seconds": round(report.duration_s, 6),
                           "cache_hit": report.cache_hit}))
        emit_log = lambda line: client.emit(Event("log", task.task_id,
                                                  self.worker_id,
                                                  {"line": line}))
        router = _StdoutRouter.install()

        def call_chunk(chunk: ColumnTable) -> ColumnTable:
            # per-chunk user invocation: only the model body converts to
            # TaskError — HandleUnavailable/WorkerFailure raised while the
            # input iterator pulls the next chunk must keep propagating
            # for per-shard recovery
            try:
                with router.route(emit_log):
                    out = fn(**{stream_edge.param: chunk}, **kwargs)
            except Exception as e:  # noqa: BLE001 — user code
                raise TaskError(
                    f"{task.name}: {type(e).__name__}: {e}\n"
                    f"{traceback.format_exc()}") from e
            return _coerce_output(task.name, out)

        try:
            if task.streams_output:
                writer = self.transport.open_stream(key, put_channel)
                n = 0
                cache_parts: Optional[List[ColumnTable]] = []
                cache_bytes = 0
                try:
                    for chunk in in_chunks:
                        self._check_alive()
                        out = call_chunk(chunk)
                        writer.append(out)
                        client.emit(Event("stream_chunk", task.task_id,
                                          self.worker_id,
                                          {"chunk": n, "key": key,
                                           "location": writer.location,
                                           "rows": out.num_rows}))
                        n += 1
                        if cache_parts is not None:
                            cache_bytes += out.nbytes
                            if cache_bytes <= defaults.STREAM_CACHE_MAX_BYTES:
                                cache_parts.append(out)
                            else:
                                cache_parts = None  # too big: stream-only
                    handle = writer.finish()
                except BaseException:
                    writer.abort()
                    raise
                if cache_parts is not None:
                    self.result_cache.put(task.cache_key,
                                          concat_tables(cache_parts))
                client.emit(Event("task_done", task.task_id, self.worker_id,
                                  {"rows": handle.num_rows,
                                   "bytes": handle.nbytes,
                                   "seconds": round(
                                       time.perf_counter() - t0, 6),
                                   "channel": "stream", "chunks": n}))
                return handle
            # partial fold: per-chunk states, merged once (one combine
            # point keeps float accumulation order deterministic)
            states = [call_chunk(chunk) for chunk in in_chunks]
            self._check_alive()
            try:
                merged = compute.fold_partial_states(states,
                                                     contract.merge_states)
            except Exception as e:  # noqa: BLE001 — contract code
                raise TaskError(f"{task.name} (state merge): "
                                f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()}") from e
            merged = _coerce_output(task.name, merged)
            merged = self.result_cache.put(task.cache_key, merged)
            handle = self.transport.put(key, merged, put_channel)
            client.emit(Event("task_done", task.task_id, self.worker_id,
                              {"rows": merged.num_rows,
                               "bytes": merged.nbytes,
                               "seconds": round(time.perf_counter() - t0, 6),
                               "channel": put_channel,
                               "chunks": len(states)}))
            return handle
        finally:
            self.env_builder.destroy(report)  # truly ephemeral

    # -- partition exchange (shuffle) ---------------------------------------
    def _run_shuffle_write(self, plan: PhysicalPlan, task: ShuffleWriteTask,
                           handles, client: Client,
                           edge_channels: Dict[str, str]) -> List[ColumnTable]:
        """Partition one producer shard into P key-addressed slices. The
        edge's predicate/projection run HERE, before partitioning, so
        per-partition consumers see exactly what the unsharded model would;
        a join's probe side also gets the hidden __xord__ column stamped
        with (shard_index << 40) + local_row, which the final merge sorts
        by to restore the unsharded row order."""
        edge = next(e for e in task.inputs if e.param != "__splits__")
        via = edge_channels.get(edge.parent_task) or edge.channel or None
        table = self._deliver_edge(edge, handles, via=via)
        if task.order_column:
            base = np.int64(task.hints.shard_index) << np.int64(40)
            ordv = base + np.arange(table.num_rows, dtype=np.int64)
            table = table.with_column(HIDDEN_ORDER_COLUMN,
                                      numeric_column(ordv))
        if task.mode == "range":
            sedge = next(e for e in task.inputs if e.param == "__splits__")
            shandle = handles.get(sedge.parent_task)
            if shandle is None:
                raise HandleUnavailable(sedge.parent_task)
            try:
                splits = self.transport.get(shandle)
            except (OSError, ConnectionError, KeyError) as e:
                raise HandleUnavailable(sedge.parent_task) from e
            return compute.range_partition(table, list(task.keys), splits,
                                           descending=task.descending)
        return compute.hash_partition(table, list(task.keys),
                                      task.num_partitions)

    def _run_sample(self, plan: PhysicalPlan, task: ShuffleSampleTask,
                    handles, client: Client) -> ColumnTable:
        """Range-mode split selection: read the first sort key from every
        producer shard (column-projected — only key bytes move) and pick
        P-1 splits all writers will share."""
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            return cached
        shards = [self._deliver_edge(e, handles,
                                     extra_columns=task.keys[:1])
                  for e in task.inputs]
        splits = compute.sample_splits(shards, list(task.keys),
                                       task.num_partitions)
        splits = self.result_cache.put(task.cache_key, splits)
        client.emit(Event("sample", task.task_id, self.worker_id,
                          {"splits": splits.num_rows,
                           "shards": len(shards)}))
        return splits

    def _run_partition(self, plan: PhysicalPlan, task: PartitionTask,
                       handles, client: Client,
                       project: Optional["Project"]) -> ColumnTable:
        """Run the exchange contract's operator over partition j: fetch
        parts[j] from every writer of each exchanged param (writer order ==
        shard order, preserving original relative row order), broadcast the
        rest whole. A skew sub-task additionally takes its contiguous
        row-range slice of the split input. A lost partition maps back to
        exactly its producing shuffle write."""
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            return cached
        from repro_torch.api import default_project
        project = project or default_project()
        spec = project.functions[task.name]
        if spec.exchange is None:
            raise TaskError(f"{task.name}: plan expects a partition exchange "
                            f"but the project declares none "
                            f"(stale plan or project drift)")
        writer_edges: Dict[str, List] = {}
        bcast_edges = []
        for e in task.inputs:
            if "#" in e.param:
                p, k = e.param.rsplit("#", 1)
                writer_edges.setdefault(p, []).append((int(k), e))
            else:
                bcast_edges.append(e)
        kwargs: Dict[str, ColumnTable] = {}
        n_parts = n_local = 0
        for p, kes in writer_edges.items():
            kes.sort(key=lambda ke: ke[0])
            whandles = []
            for _, e in kes:
                h = handles.get(e.parent_task)
                if h is None:
                    raise HandleUnavailable(e.parent_task)
                whandles.append((e.parent_task, h))
            try:
                slices = self.transport.get_partition(
                    [h for _, h in whandles], task.partition_index)
            except ShardUnavailable as exc:
                lost = next((tid for tid, h in whandles
                             if exc.key.startswith(f"{h.key}/p")),
                            whandles[0][0])
                raise HandleUnavailable(lost) from exc
            n_parts += len(slices)
            n_local += sum(
                self.transport.has_local(h.parts[task.partition_index].key)
                for _, h in whandles)
            table = compute.concat_tables(slices)
            sort_keys = task.param_sort.get(p)
            if sort_keys:
                # chained "keys" partitions: restore the unsharded row order
                # (stable sort on the upstream group keys, unique per row)
                # so float accumulations stay byte-identical
                table = table.take(
                    compute._sort_indices(table, list(sort_keys)))
            if p == task.split_param and task.num_subs > 1:
                lo = table.num_rows * task.sub_index // task.num_subs
                hi = table.num_rows * (task.sub_index + 1) // task.num_subs
                table = table.slice(lo, hi - lo)
            kwargs[p] = table
        for e in bcast_edges:
            kwargs[e.param] = self._deliver_edge(e, handles)
        client.emit(Event("partition", task.task_id, self.worker_id,
                          {"partition": task.partition_index,
                           "parts": n_parts, "local": n_local,
                           "remote": n_parts - n_local,
                           "sub": task.sub_index, "subs": task.num_subs}))
        return self._invoke_user_code(
            plan, task, spec, lambda: spec.exchange.partition(**kwargs),
            client, label=f"{task.name} (partition {task.partition_index})")

    def _run_shuffle_merge(self, plan: PhysicalPlan, task: ShuffleMergeTask,
                           handles, client: Client) -> ColumnTable:
        """Reassemble partition outputs byte-identically to the unsharded
        run (columnar.compute.merge_partitions). System code — no user
        environment; a lost part maps back to exactly its partition task."""
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            return cached
        parts, n_parts, n_local = self._fetch_parts(plan, task, handles,
                                                    as_parts=True)
        table = compute.merge_partitions(parts, task.merge,
                                         keys=list(task.keys))
        table = self.result_cache.put(task.cache_key, table)
        if task.materialize:
            snap = self.catalog.write_table(task.name, table,
                                            branch=plan.branch,
                                            message=f"run {plan.run_id}")
            client.emit(Event("materialized", task.task_id, self.worker_id,
                              {"snapshot": snap.snapshot_id}))
        client.emit(Event("shuffle_merge", task.task_id, self.worker_id,
                          {"parts": n_parts, "local": n_local,
                           "remote": n_parts - n_local,
                           "merge": task.merge}))
        return table

    def _invoke_user_code(self, plan: PhysicalPlan, task, spec,
                          call, client: Client, label: str) -> ColumnTable:
        """The shared tail of every user-code task — build the declared
        ephemeral environment, run `call` with prints streaming as log
        events, coerce + result-cache the output, and materialize when the
        task asks. Inputs must already be resolved: only `call` itself is
        wrapped as user error (HandleUnavailable has to keep propagating
        for per-shard recovery)."""
        report = self.env_builder.build(spec.env, fresh=True)
        client.emit(Event("env_built", task.task_id, self.worker_id,
                          {"env_id": report.env_id,
                           "seconds": round(report.duration_s, 6),
                           "cache_hit": report.cache_hit}))
        emit_log = lambda line: client.emit(Event("log", task.task_id,
                                                  self.worker_id,
                                                  {"line": line}))
        # (re)install at execution time: test harnesses swap sys.stdout
        # between phases; production never re-wraps
        router = _StdoutRouter.install()
        try:
            with router.route(emit_log):
                out = call()
        except Exception as e:  # noqa: BLE001 — user code
            raise TaskError(f"{label}: {type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()}") from e
        finally:
            self.env_builder.destroy(report)  # truly ephemeral
        table = _coerce_output(task.name, out)
        table = self.result_cache.put(task.cache_key, table)
        if task.materialize:
            snap = self.catalog.write_table(task.name, table,
                                            branch=plan.branch,
                                            message=f"run {plan.run_id}")
            client.emit(Event("materialized", task.task_id, self.worker_id,
                              {"snapshot": snap.snapshot_id}))
        return table

    def _run_function(self, plan: PhysicalPlan, task: FunctionTask,
                      handles, client: Client,
                      project: Optional["Project"],
                      edge_channels: Dict[str, str]) -> ColumnTable:
        cached = self.result_cache.get(task.cache_key)
        if cached is not None:
            client.emit(Event("cache_hit", task.task_id, self.worker_id,
                              {"cache_key": task.cache_key}))
            return cached
        from repro_torch.api import default_project
        project = project or default_project()
        spec = project.functions[task.name]
        # 1. inputs via the planned channels (paper §4.3)
        kwargs = {}
        for edge in task.inputs:
            via = (edge_channels.get(edge.parent_task) or edge.channel
                   or "zerocopy")
            kwargs[edge.param] = self._deliver_edge(edge, handles, via=via)
        # 2. run business logic under the declared ephemeral environment
        # (paper §4.2) with real-time log streaming; a materializing task
        # writes back to the lakehouse (paper Listing 1). Partial phase of a
        # combinable aggregation: run the contract's shard-local reducer
        # over this shard instead of the model body — the CombineTask merges
        # the resulting states downstream.
        fn = spec.fn
        if getattr(task, "agg_phase", "") == "partial":
            if spec.combinable is None:
                raise TaskError(f"{task.name}: plan expects a combinable "
                                f"partial but the project declares none")
            fn = spec.combinable.partial
        return self._invoke_user_code(plan, task, spec,
                                      lambda: fn(**kwargs), client,
                                      label=task.name)


def _coerce_output(name: str, out) -> ColumnTable:
    if isinstance(out, ColumnTable):
        return out
    if isinstance(out, dict):
        return ColumnTable.from_pydict(out)
    raise TaskError(f"model {name!r} must return a dataframe "
                    f"(ColumnTable or dict of columns), got {type(out)}")


# ---------------------------------------------------------------------------
# Cluster
# ---------------------------------------------------------------------------


class LocalCluster:
    """A single-tenant Data Plane: a fleet of (in-process) workers shared by
    N concurrent runs through one ExecutionEngine (lazily created)."""

    def __init__(self, catalog: Catalog, object_store: ObjectStore,
                 scratch_root: str, n_workers: int = 2,
                 memory_gb: float = 4.0,
                 package_store: Optional[PackageStore] = None,
                 engine_opts: Optional[Dict] = None,
                 transport_memory_bytes: Optional[int] = None):
        self.catalog = catalog
        self.object_store = object_store
        self.scratch_root = scratch_root
        self.package_store = package_store or PackageStore(
            f"{scratch_root}/pkgstore")
        # per-worker DataTransport resident-byte budget (None = unlimited);
        # benchmarks set this small to prove spill-under-budget correctness
        self.transport_memory_bytes = transport_memory_bytes
        # forwarded to the lazily-created ExecutionEngine (mmap_spill_bytes,
        # skew_factor, ... — benchmarks tune these per scenario)
        self.engine_opts = dict(engine_opts or {})
        self.workers: Dict[str, Worker] = {}    # guard: _lock
        self._lock = threading.Lock()     # provision() races with dispatch
        self._engine = None                     # guard: _lock
        for i in range(n_workers):
            self._add(WorkerProfile(f"worker-{i}", memory_gb=memory_gb))

    def _add(self, profile: WorkerProfile) -> Worker:
        w = Worker(profile, self.catalog, self.object_store,
                   self.scratch_root, self.package_store,
                   transport_memory_bytes=self.transport_memory_bytes)
        with self._lock:
            self.workers[profile.worker_id] = w
            engine, n = self._engine, len(self.workers)
        if engine is not None:
            # dispatch capacity must grow with the fleet, or on-demand
            # provisioning silently caps concurrency at the construction-time
            # pool size
            engine.fleet_resized(n)
        return w

    def engine(self):
        """The shared event-driven dispatcher; all runs on this cluster
        multiplex through it (warm caches, one worker fleet)."""
        from repro_torch.core.engine import ExecutionEngine

        with self._lock:
            if self._engine is None:
                self._engine = ExecutionEngine(self, **self.engine_opts)
            return self._engine

    def profiles(self) -> List[WorkerProfile]:
        with self._lock:    # provision() may mutate workers concurrently
            return [w.profile for w in self.workers.values() if w.alive]

    def provision(self, profile: WorkerProfile) -> Worker:
        """On-demand VM (paper Fig. 2 step 3)."""
        return self._add(profile)

    def get(self, worker_id: str) -> Worker:
        with self._lock:   # provision() mutates `workers` concurrently
            w = self.workers.get(worker_id)
            known = sorted(self.workers)
        if w is not None:
            return w
        if worker_id.startswith("ondemand-"):
            # late binding may reference an on-demand profile mid-run
            return self.provision(WorkerProfile(worker_id, memory_gb=8.0,
                                                on_demand=True))
        # fabricating a worker here would mask typos and stale placements
        raise KeyError(f"unknown worker {worker_id!r}; have {known}")

    def healthy_workers(self) -> List[Worker]:
        with self._lock:
            return [w for w in self.workers.values() if w.alive]

    def kill_worker(self, worker_id: str) -> None:
        # lookup under the lock (provision() mutates the dict concurrently);
        # the kill itself runs outside it — it fires engine callbacks that
        # re-enter cluster methods taking this lock
        with self._lock:
            w = self.workers[worker_id]
        w.kill()

    def close(self) -> None:
        with self._lock:
            engine, self._engine = self._engine, None
            fleet = list(self.workers.values())
        if engine is not None:
            engine.close()
        for w in fleet:
            w.transport.close()


# ---------------------------------------------------------------------------
# run entry points (used by repro.api and the CLIs)
# ---------------------------------------------------------------------------


def submit_run(project: "Project", cluster,
               branch: str = "main", targets: Optional[Sequence[str]] = None,
               client: Optional[Client] = None, run_id: Optional[str] = None,
               force_channel: Optional[str] = None,
               journal_path: Optional[str] = None,
               shard_threshold_bytes: Optional[int] = None,
               max_shards: Optional[int] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               validate: str = "off",
               lineage_pushdown: bool = True,
               stream: bool = True,
               chunk_rows: Optional[int] = None,
               **engine_kw):
    """Plan + submit a run to the cluster's shared engine; returns a
    RunHandle immediately so N invocations can execute concurrently.
    `cluster` is anything ClusterLike (LocalCluster, remote.RemoteCluster).
    Tables over `shard_threshold_bytes` are scanned as up to `max_shards`
    (default: fleet size) parallel shard tasks. `priority` orders this
    run's tasks on the engine's shared ready heap: higher effective
    priority (static + aging credit) wins contended worker slots first;
    among equal effective priorities an earlier `deadline_s` (this run's
    SLO, seconds from submission) wins, then FIFO. Extra keyword args
    (`max_retries`, `speculation_factor`, `speculation_min_s`) forward to
    ``ExecutionEngine.submit`` — benchmarks disable straggler speculation
    this way so 1-CPU timing noise doesn't double-run multi-second tasks."""
    if validate not in ("off", "warn", "strict"):
        raise ValueError(f"validate must be 'off', 'warn' or 'strict', "
                         f"got {validate!r}")
    if validate != "off":
        raise NotImplementedError(
            f"validate={validate!r} needs the static analyzer, which is not "
            "ported yet (ROADMAP.md, Queue 1 item 4: repro/analysis/)")
    logical = build_logical_plan(project, targets)
    planner_kw = {}
    if shard_threshold_bytes is not None:
        planner_kw["shard_threshold_bytes"] = shard_threshold_bytes
    if max_shards is not None:
        planner_kw["max_shards"] = max_shards
    # stream=False forces the materialized data plane (whole-table handles);
    # chunk_rows overrides defaults.STREAM_CHUNK_ROWS for this run
    planner_kw["stream"] = stream
    if chunk_rows is not None:
        planner_kw["chunk_rows"] = chunk_rows
    # lineage_pushdown: the reference narrows scans and gathers with the
    # analyzer's pass-1 column lineage and, when the analyzer fails, falls
    # back to the declared-union read sets. The analyzer is not ported yet
    # (ROADMAP.md, Queue 1 item 4), so the port always takes that fallback:
    # the same results, with gathers that may carry more columns.
    planner = Planner(cluster.catalog, cluster.profiles(),
                      force_channel=force_channel, **planner_kw)
    plan = planner.plan(logical, branch=branch, run_id=run_id)
    return cluster.engine().submit(plan, project, client=client,
                                   journal_path=journal_path,
                                   priority=priority, deadline_s=deadline_s,
                                   **engine_kw)


def execute_run(project: "Project", catalog: Catalog = None, cluster=None,
                branch: str = "main", targets: Optional[Sequence[str]] = None,
                client: Optional[Client] = None, run_id: Optional[str] = None,
                force_channel: Optional[str] = None,
                journal_path: Optional[str] = None,
                shard_threshold_bytes: Optional[int] = None,
                max_shards: Optional[int] = None,
                validate: str = "off",
                lineage_pushdown: bool = True,
                **engine_kw):
    import tempfile

    owns_cluster = cluster is None
    if cluster is None:
        if catalog is None:
            raise ValueError("execute_run needs a catalog or a cluster")
        scratch = tempfile.mkdtemp(prefix="repro_dp_")
        cluster = LocalCluster(catalog, catalog.store, scratch)
    try:
        handle = submit_run(project, cluster, branch=branch, targets=targets,
                            client=client, run_id=run_id,
                            force_channel=force_channel,
                            journal_path=journal_path,
                            shard_threshold_bytes=shard_threshold_bytes,
                            max_shards=max_shards, validate=validate,
                            lineage_pushdown=lineage_pushdown, **engine_kw)
        return handle.wait()
    finally:
        if owns_cluster:
            cluster.close()
