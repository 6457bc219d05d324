"""Event-driven execution engine: late-binding placement, multi-run sharing.

The paper's control plane (§4.1) emits a physical plan and defers the
"priority scheduler" to future work. This engine fills that gap the way
Wukong and DataFlower argue serverless DAGs should be driven: by *events*,
not by a centralized polling loop over a precomputed schedule.

  * **indegree counters + ready queue** — every task knows how many distinct
    parents it still waits on; a completion callback decrements its children
    and dispatches any that hit zero immediately (no `cv.wait` spin); the
    ready queue is a heap ordered by (effective run priority desc, deadline,
    FIFO seq) — effective priority ages monotonically while an entry waits,
    so a high-priority run's tasks take contended worker slots first but a
    sustained high-priority stream cannot starve a queued background run,
    and a run submitted with an SLO deadline beats equal-priority peers;
  * **late-binding placement** — the planner emits hints (memory needs,
    co-location groups, on-demand flags); the engine binds each task to a
    concrete worker at dispatch time: least-loaded among healthy workers
    whose memory fits, with bounded per-worker queues for backpressure and
    group pinning so zero-copy co-location survives;
  * **dispatch-time channels** — producer→consumer channels are chosen when
    both placements are known (same worker → zerocopy/mmap, across → flight),
    so channel choice reflects *actual* placement, not a plan-time guess;
  * **multi-run concurrency** — N runs share one worker fleet and its
    caches; each run has an isolated Client, journal, and synchronized
    HandleMap, so concurrent pipeline invocations multiplex a warm cluster;
  * **fault tolerance as events** — retries, transitive lost-input
    recovery, and straggler speculation are completion/timer events on the
    same queue; completions are journaled for crash-restart.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple, TYPE_CHECKING

from repro_torch.core import defaults
from repro_torch.core.channels import TableHandle
from repro_torch.core.errors import DeadlineExceeded
from repro_torch.core.journal import RunJournal
from repro_torch.core.physical import (FunctionTask, InputEdge, PartitionTask,
                                       PhysicalPlan, PlacementHint,
                                       ShuffleWriteTask, WorkerProfile, _key_hash)
from repro_torch.core.runtime import (Client, Event, HandleUnavailable, TaskError,
                                      Worker, WorkerFailure)

if TYPE_CHECKING:
    from repro_torch.api import Project
    from repro_torch.core.contract import ClusterLike, WorkerLike


def _stable_digest(s: str) -> int:
    """PYTHONHASHSEED-independent digest: retries/speculation pick the same
    worker across processes and reruns."""
    return int.from_bytes(hashlib.blake2s(s.encode()).digest()[:8], "big")


class HandleMap:
    """Per-run task→TableHandle map, synchronized: pool threads read it from
    inside `Worker.execute` while completion callbacks mutate it."""

    def __init__(self):
        self._handles: Dict[str, TableHandle] = {}    # guard: _lock
        self._lock = threading.Lock()

    def get(self, task_id: str) -> Optional[TableHandle]:
        with self._lock:
            return self._handles.get(task_id)

    def put(self, task_id: str, handle: TableHandle) -> None:
        with self._lock:
            self._handles[task_id] = handle

    def pop(self, task_id: str) -> Optional[TableHandle]:
        with self._lock:
            return self._handles.pop(task_id, None)

    def snapshot(self) -> Dict[str, TableHandle]:
        with self._lock:
            return dict(self._handles)

    def __contains__(self, task_id: str) -> bool:
        with self._lock:
            return task_id in self._handles

    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)


@dataclasses.dataclass
class RunResult:
    run_id: str
    plan: PhysicalPlan
    handles: Dict[str, TableHandle]
    client: Client
    wall_seconds: float
    task_attempts: Dict[str, int]
    placements: Dict[str, str] = dataclasses.field(default_factory=dict)

    def read(self, name: str, cluster: "ClusterLike"):
        """Fetch a produced dataframe (targets or any intermediate)."""
        tid = f"func:{name}" if f"func:{name}" in self.handles else f"scan:{name}"
        task = self.plan.tasks.get(tid)
        # a projected gather holds only its consumers' column union — read
        # the full dataframe from the shard handles below instead
        projected = (getattr(task, "kind", "") == "gather"
                     and getattr(task, "columns", None) is not None
                     and tid.startswith("func:"))
        if tid in self.handles and not projected:
            return self._read_handle(tid, cluster)
        # sharded producer with no (whole-table) merge point: assemble the
        # full dataframe from the shard handles
        shard_tids = sorted(
            (t for t in self.handles
             if t.rsplit("#", 1)[0] in (f"func:{name}", f"scan:{name}")
             and "#" in t),
            key=lambda t: int(t.rsplit("#", 1)[1]))
        if shard_tids:
            from repro_torch.columnar import compute
            return compute.concat_tables(
                [self._read_handle(t, cluster) for t in shard_tids])
        # exchange partitions with no merge point (intermediates consumed
        # per-partition downstream): reassemble with the contract's merge

        def _pos(t: str) -> Tuple[int, int]:
            tail = t.split("@", 1)[1]
            j, _, s = tail.partition("~")
            return int(j), int(s or 0)

        part_tids = sorted((t for t in self.handles
                            if t.startswith(f"func:{name}@")), key=_pos)
        if part_tids:
            from repro_torch.columnar import compute
            t0 = self.plan.tasks.get(part_tids[0])
            return compute.merge_partitions(
                [self._read_handle(t, cluster) for t in part_tids],
                getattr(t0, "merge", "concat"),
                keys=list(getattr(t0, "merge_keys", ()) or ()))
        if tid in self.handles:
            return self._read_handle(tid, cluster)
        raise KeyError(f"no output named {name!r} in run {self.run_id}")

    def open_stream(self, name: str, cluster: "ClusterLike"):
        """Chunk-streaming access to a produced dataframe: returns
        ``(handle, opener)`` where ``opener()`` yields the output's row
        chunks in order via the transport's ``get_stream`` — the first
        chunk is available before the table is assembled, which is what
        the serving gateway's ``Ticket.iter_result`` rides. Returns None
        when the output needs multi-handle assembly (sharded producers,
        exchange partitions, projected gathers) — callers fall back to
        the materializing ``read``."""
        tid = f"func:{name}" if f"func:{name}" in self.handles else f"scan:{name}"
        if tid not in self.handles:
            return None
        task = self.plan.tasks.get(tid)
        if (getattr(task, "kind", "") == "gather"
                and getattr(task, "columns", None) is not None
                and tid.startswith("func:")):
            return None         # projected gather: read() reassembles shards
        handle = self.handles[tid]
        if handle.channel in ("partitioned", "shuffle", "stream"):
            return None
        placed_id = self.placements.get(tid, "")
        workers = sorted(cluster.healthy_workers(),
                         key=lambda w: w.worker_id != placed_id)
        if not workers:
            raise TaskError(f"no healthy workers left to stream {tid!r}")
        transport = workers[0].transport

        def opener(columns=None):
            return transport.get_stream(handle, columns)

        return handle, opener

    def _read_handle(self, tid: str, cluster: "ClusterLike"):
        """Read one task's buffers, degrading across the fleet: the recorded
        placement first, then any healthy worker (mmap/objectstore handles
        locate by path/key and zerocopy may have flight-visible twins). A
        dead producer surfaces as TaskError, never a raw socket error."""
        handle = self.handles[tid]
        placed_id = self.placements.get(tid, "")
        # healthy_workers() snapshots under the cluster lock (provision()
        # mutates the dict concurrently); recorded placement goes first.
        # Every handle resolves location-identically away from its placement
        # (zerocopy degrades to the producer's flight endpoint, mmap and
        # objectstore locate by path/key), so one fallback attempt suffices
        candidates = sorted(cluster.healthy_workers(),
                            key=lambda w: w.worker_id != placed_id)[:2]
        if not candidates:
            raise TaskError(f"no healthy workers left to read {tid!r}")
        err: Optional[Exception] = None
        for worker in candidates:
            try:
                return worker.transport.get(handle)
            except (ConnectionError, OSError, KeyError) as e:
                err = e
        raise TaskError(
            f"buffers for {tid!r} are gone (producer worker lost, channel "
            f"{handle.channel!r}); re-run to recompute") from err


@dataclasses.dataclass
class _Inflight:
    started: float
    workers: Set[str]
    speculated: bool = False
    timer: Optional[threading.Timer] = None


class _RunState:
    """Book-keeping for one run multiplexed onto the shared fleet."""

    def __init__(self, plan: PhysicalPlan, project, client: Client,
                 journal: Optional[RunJournal], max_retries: int,
                 spec_factor: float, spec_min_s: float, priority: int = 0,
                 deadline: Optional[float] = None):
        self.plan = plan
        self.project = project
        self.client = client
        self.journal = journal
        self.max_retries = max_retries
        self.spec_factor = spec_factor
        self.spec_min_s = spec_min_s
        self.priority = priority
        # absolute perf_counter time this run's SLO expires (None = no SLO);
        # the ready heap prefers earlier deadlines among equal priorities,
        # and cancel_expired kills the whole run once the moment passes
        self.deadline = deadline
        self.deadline_exceeded = False
        self.deadline_waited_s: Optional[float] = None
        self.deadline_timer: Optional[threading.Timer] = None
        self.handles = HandleMap()
        # producers currently publishing a live chunk stream: their
        # stream-capable consumers dispatch on the first chunk (pipelined
        # dispatch) instead of on task_done
        self.streaming: Set[str] = set()
        self.stream_cb = None       # the client subscription, for unsubscribe
        self.attempts: Dict[str, int] = {t: 0 for t in plan.order}
        self.indegree: Dict[str, int] = {t: len(plan.parents[t])
                                         for t in plan.order}
        self.done: Set[str] = set()
        self.inflight: Dict[str, _Inflight] = {}
        self.queued: Set[str] = set()   # tids on the engine's ready heap
        self.placements: Dict[str, str] = {}
        self.group_worker: Dict[str, str] = {}
        self.durations: List[float] = []
        self.error: Optional[str] = None
        self.finished = threading.Event()
        self.result: Optional[RunResult] = None
        self.t0 = time.perf_counter()

    def remaining(self) -> int:
        return len(self.plan.order) - len(self.done)


class RunHandle:
    """Future-like view of a submitted run."""

    def __init__(self, engine: "ExecutionEngine", state: _RunState):
        self._engine = engine
        self._state = state
        self.run_id = state.plan.run_id

    def done(self) -> bool:
        return self._state.finished.is_set()

    @property
    def client(self) -> Client:
        return self._state.client

    def wait(self, timeout: Optional[float] = None) -> RunResult:
        if not self._state.finished.wait(timeout):
            raise TimeoutError(f"run {self.run_id} still executing")
        if self._state.error is not None:
            if self._state.deadline_exceeded:
                raise DeadlineExceeded(
                    self._state.error,
                    waited_s=self._state.deadline_waited_s,
                    run_id=self.run_id)
            raise TaskError(self._state.error)
        return self._state.result


class ExecutionEngine:
    """Shared, event-driven dispatcher over one cluster's worker fleet —
    in-process threads (LocalCluster) or isolated processes (RemoteCluster),
    via the contract.ClusterLike/WorkerLike surface."""

    def __init__(self, cluster: "ClusterLike", worker_queue_depth: int = 4,
                 mmap_spill_bytes: int = defaults.MMAP_SPILL_BYTES,
                 skew_factor: Optional[float] = defaults.SKEW_FACTOR,
                 skew_min_bytes: int = defaults.SKEW_MIN_BYTES,
                 aging_interval_s: Optional[float] = defaults.PRIORITY_AGING_S):
        self.cluster = cluster
        self.worker_queue_depth = worker_queue_depth
        self.mmap_spill_bytes = mmap_spill_bytes
        # skew-aware repartitioning: a shuffle partition whose split-side
        # bytes exceed skew_factor x the median partition is re-split into
        # row-range sub-partitions before its consumer dispatches
        # (None disables — the static-partitioning baseline)
        self.skew_factor = skew_factor
        self.skew_min_bytes = skew_min_bytes
        # priority aging: a queued entry gains +1 effective priority per
        # aging_interval_s spent waiting, so sustained high-priority load
        # cannot starve a queued background run (None = static priorities)
        self.aging_interval_s = aging_interval_s
        self._lock = threading.RLock()
        self._runs: List[_RunState] = []         # guard: _lock
        self._load: Dict[str, int] = {}          # guard: _lock (inflight tasks)
        self._mem: Dict[str, int] = {}           # guard: _lock (inflight bytes)
        # one ready heap across all runs. Entries are mutable lists
        # [key, seq, tid, state] where key is the order tuple
        # (-effective_priority, deadline, seq), recomputed on aging rebuilds;
        # seq is engine-global and unique, so equal-key prefixes pop FIFO
        # and comparison never reaches the unorderable state object
        self._ready: List[List] = []             # guard: _lock
        self._seq = itertools.count()            # guard: _lock
        self._last_aged = time.perf_counter()    # guard: _lock
        self._pool = ThreadPoolExecutor(
            max_workers=self._pool_size(len(cluster.workers)),
            thread_name_prefix="engine")
        self._closed = False                     # guard: _lock

    def _pool_size(self, n_workers: int) -> int:
        return max(16, self.worker_queue_depth * (n_workers + 2))

    def fleet_resized(self, n_workers: int) -> None:
        """On-demand provisioning grew the fleet: grow dispatch capacity
        with it, or concurrency silently caps at the construction-time pool
        size. ThreadPoolExecutor spawns threads lazily up to `_max_workers`
        (checked on every submit), so raising the bound is sufficient —
        no threads are ever torn down."""
        needed = self._pool_size(n_workers)
        with self._lock:
            if needed > self._pool._max_workers:
                self._pool._max_workers = needed

    def worker_lost(self, worker_id: str) -> None:
        """Failure-detector hook (remote heartbeat / chaos kill): a worker
        process died, so every zerocopy/flight output resident only in its
        memory is gone. Proactively invalidate those completions and
        re-dispatch, so recovery starts now instead of when a consumer trips
        the hole; mmap and objectstore outputs are path/key-addressed and
        survive the process, so they're kept."""
        with self._lock:
            for state in list(self._runs):
                if state.finished.is_set():
                    continue
                lost = [tid for tid, wid in state.placements.items()
                        if wid == worker_id and tid in state.done]
                for tid in lost:
                    handle = state.handles.get(tid)
                    if handle is not None and (
                            handle.channel in ("mmap", "objectstore")
                            or (handle.channel in ("shuffle", "chunked")
                                and handle.parts
                                and all(p.channel in ("mmap", "objectstore")
                                        for p in handle.parts))):
                        continue
                    state.client.emit(Event("worker_lost", tid, worker_id,
                                            {"invalidated": True}))
                    self._invalidate(state, tid)
            self._dispatch_ready()

    # -- public API ---------------------------------------------------------
    def submit(self, plan: PhysicalPlan, project=None,
               client: Optional[Client] = None,
               journal_path: Optional[str] = None,
               max_retries: int = defaults.MAX_RETRIES,
               speculation_factor: float = defaults.SPECULATION_FACTOR,
               speculation_min_s: float = defaults.SPECULATION_MIN_S,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> RunHandle:
        """Register a run and dispatch its source tasks. Returns immediately;
        the run progresses on completion events. `priority` orders the shared
        ready heap: when worker slots are contended, a higher-priority run's
        tasks dispatch first; among equal effective priorities an earlier
        `deadline_s` (seconds from now, the run's SLO) wins, then FIFO.
        Queued entries age: +1 effective priority per engine
        `aging_interval_s` waited, so background runs cannot starve."""
        with self._lock:
            if self._closed:
                raise TaskError("engine is closed")
        client = client or Client()
        journal = RunJournal(journal_path) if journal_path else None
        if journal:
            journal.record_plan(plan.plan_id, plan.run_id, plan.order)
        client.emit(Event("plan", plan.plan_id, "", {"tasks": len(plan.order),
                                                     "run_id": plan.run_id,
                                                     "priority": priority,
                                                     "deadline_s": deadline_s}))
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        state = _RunState(plan, project, client, journal, max_retries,
                          speculation_factor, speculation_min_s,
                          priority=priority, deadline=deadline)
        if plan.chunk_rows > 0 and hasattr(client, "subscribe"):
            # pipelined dispatch: learn about stream_chunk events the moment
            # a producer publishes them (subscribed before any task runs, so
            # the first chunk can never be missed)
            state.stream_cb = (lambda ev, _s=state:
                               self._on_stream_event(_s, ev))
            client.subscribe(state.stream_cb)
        with self._lock:
            if self._closed:
                if journal:
                    journal.close()
                if state.stream_cb is not None:
                    client.unsubscribe(state.stream_cb)
                raise TaskError("engine is closed")
            self._runs.append(state)
            for tid in plan.order:
                if state.indegree[tid] == 0:
                    self._enqueue(state, tid)
            self._dispatch_ready()
        if deadline_s is not None:
            # deadline enforcement, not just ordering: when the SLO moment
            # passes the run is cancelled (cancel_expired), never finished
            # late. Small epsilon so the timer fires strictly after the
            # deadline comparison in cancel_expired can see it expired.
            timer = threading.Timer(deadline_s + 0.002, self.cancel_expired)
            timer.daemon = True
            state.deadline_timer = timer
            timer.start()
        if not state.plan.order:
            self._finalize(state)
        return RunHandle(self, state)

    def run(self, plan: PhysicalPlan, project=None,
            client: Optional[Client] = None, **kw) -> RunResult:
        return self.submit(plan, project, client, **kw).wait()

    def cancel_expired(self) -> List[str]:
        """Cancel every run whose absolute SLO deadline has passed.

        Reuses the close() cancel plumbing: queued heap entries of a
        finalized run are dropped by the stale-entry guard in
        `_dispatch_ready`, `_attempt` refuses to execute for a finished
        run, and `_on_done` evicts late completions — so marking the run
        failed + finalizing is sufficient for ready/queued tasks; inflight
        remote tasks additionally get a best-effort `worker.cancel`.
        Each run's deadline timer calls this, and callers (the serving
        gateway, tests) may invoke it directly. Returns the cancelled
        run_ids."""
        to_cancel: List[Tuple[object, str, str]] = []
        expired: List[str] = []
        with self._lock:
            now = time.perf_counter()
            for state in list(self._runs):
                if (state.deadline is None or state.finished.is_set()
                        or now < state.deadline):
                    continue
                waited = now - state.t0
                state.deadline_exceeded = True
                state.deadline_waited_s = waited
                for tid, info in state.inflight.items():
                    if info.timer is not None:
                        info.timer.cancel()
                    for wid in info.workers:
                        w = self.cluster.workers.get(wid)
                        if w is not None and hasattr(w, "cancel"):
                            to_cancel.append((w, state.plan.run_id, tid))
                state.client.emit(Event(
                    "deadline_exceeded", "", "",
                    {"run_id": state.plan.run_id, "waited_s": waited,
                     "tasks_done": len(state.done),
                     "tasks_remaining": state.remaining()}))
                state.error = (f"run {state.plan.run_id} deadline exceeded "
                               f"after {waited:.3f}s "
                               f"({len(state.done)}/{len(state.plan.order)} "
                               "tasks done); cancelled")
                expired.append(state.plan.run_id)
                self._finalize(state)
        # best-effort, off-lock (same discipline as close()): a dead or
        # slow worker must not stall deadline enforcement for other runs
        for w, run_id, tid in to_cancel:
            try:
                w.cancel(run_id, tid)
            except Exception:  # noqa: BLE001 — run is already cancelled
                pass
        return expired

    def close(self) -> None:
        to_cancel: List[Tuple[object, str, str]] = []
        with self._lock:
            self._closed = True
            pending = list(self._runs)
            for state in pending:
                for tid, info in state.inflight.items():
                    if info.timer is not None:
                        info.timer.cancel()
                    for wid in info.workers:
                        w = self.cluster.workers.get(wid)
                        if w is not None and hasattr(w, "cancel"):
                            to_cancel.append((w, state.plan.run_id, tid))
            # fail pending runs so RunHandle.wait() never blocks forever
            # (under the lock: a run completing concurrently must not be
            # marked aborted after its result was finalized)
            for state in pending:
                if not state.finished.is_set():
                    state.error = (f"run {state.plan.run_id} aborted: "
                                   "engine closed")
                    self._finalize(state)
        # best-effort, off-lock: tell remote workers to drop aborted tasks'
        # outputs instead of publishing them after the run is gone
        for w, run_id, tid in to_cancel:
            try:
                w.cancel(run_id, tid)
            except Exception:  # noqa: BLE001 — dying worker, already aborted
                pass
        self._pool.shutdown(wait=False)

    # -- placement: late binding -------------------------------------------
    def _select_worker(self, state: _RunState, task, exclude: Set[str],
                       allow_provision: bool = True  # guard-held: _lock
                       ) -> Optional[Worker]:
        """Bind a worker now, from actual load/liveness: group-pinned if
        possible, else least-loaded whose memory fits; provision on-demand
        when nothing fits (unless the caller forbids it — speculation must
        never grow the fleet for a twin); None = no candidate right now
        (backpressure: a completion event will re-drain the ready queue)."""
        hints = task.hints
        need = hints.memory_bytes

        def _mem_free(w: Worker) -> int:
            return int(w.profile.memory_gb * 1e9
                       - self._mem.get(w.worker_id, 0))

        healthy = [w for w in self.cluster.healthy_workers()
                   if w.worker_id not in exclude]
        fits = [w for w in healthy if w.profile.memory_gb * 1e9 >= need]
        if not fits:
            if healthy and not hints.on_demand:
                fits = healthy          # degraded fleet: overcommit memory
            elif not allow_provision:
                return None
            else:
                prof = WorkerProfile(
                    f"ondemand-{len(self.cluster.workers)}",
                    memory_gb=max(need / 1e9 * 1.5, 1.0),
                    on_demand=True)
                return self.cluster.provision(prof)
        pinned = state.group_worker.get(hints.colocate_group)
        if pinned is not None:
            w = self.cluster.workers.get(pinned)
            if (w is not None and w.alive and w.worker_id not in exclude
                    and self._load.get(pinned, 0) < self.worker_queue_depth
                    and _mem_free(w) >= need):
                return w
        open_slots = [
            w for w in fits
            if self._load.get(w.worker_id, 0) < self.worker_queue_depth
            and _mem_free(w) >= need]
        if not open_slots:
            # nothing can host it right now: wait for a completion if any
            # task is in flight (memory/slots will free); otherwise the
            # estimates over-state a genuinely idle fleet — overcommit
            if any(self._load.get(w.worker_id, 0) for w in fits):
                return None
            fits.sort(key=lambda w: (-_mem_free(w), w.worker_id))
            return fits[0]
        open_slots.sort(key=lambda w: (self._load.get(w.worker_id, 0),
                                       -_mem_free(w), w.worker_id))
        return open_slots[0]

    def _pick_retry_worker(self, state: _RunState, task,
                           exclude: Set[str]) -> Worker:
        healthy = [w for w in self.cluster.healthy_workers()
                   if w.worker_id not in exclude]
        if not healthy:
            healthy = self.cluster.healthy_workers()
        if not healthy:
            raise TaskError("no healthy workers left")
        healthy.sort(key=lambda w: w.worker_id)
        return healthy[_stable_digest(task.task_id) % len(healthy)]

    # -- dispatch -----------------------------------------------------------
    def _order_key(self, state: _RunState, seq: int,
                   now: float) -> Tuple[float, float, int]:
        """Heap order for one ready entry (lock held): effective priority
        desc (static run priority + monotonic aging credit), then earliest
        deadline, then FIFO seq. Aging credit accrues per RUN — +1 per
        aging interval since the run was submitted — so a starved run's
        downstream tasks inherit its seniority instead of rejoining the
        back of the line freshly-enqueued after every parent completes."""
        eff = float(state.priority)
        if self.aging_interval_s:
            eff += int((now - state.t0) / self.aging_interval_s)
        deadline = state.deadline if state.deadline is not None else float("inf")
        return (-eff, deadline, seq)

    def _enqueue(self, state: _RunState, tid: str) -> None:
        """Queue a task on the shared ready heap (lock held). The seq is
        sticky for the entry's lifetime: a backpressure re-queue keeps its
        FIFO position instead of dropping to the back of the line."""
        if tid in state.queued:
            return
        state.queued.add(tid)
        now = time.perf_counter()
        seq = next(self._seq)
        heapq.heappush(self._ready,
                       [self._order_key(state, seq, now), seq, tid, state])

    def _age_ready(self, now: float) -> None:
        """Recompute every queued entry's effective priority from its run's
        age and re-heapify (lock held). Runs at most once per aging
        interval — finer rebuilds can't change the integer aging credit."""
        if (not self.aging_interval_s or not self._ready
                or now - self._last_aged < self.aging_interval_s):
            return
        self._last_aged = now
        for entry in self._ready:
            entry[0] = self._order_key(entry[3], entry[1], now)
        heapq.heapify(self._ready)

    # -- pipelined dispatch: streams satisfy edges early --------------------
    def _ready_indegree(self, state: _RunState, tid: str) -> int:
        """Effective indegree (lock held): a stream-capable consumer's edge
        to a currently-streaming producer counts as satisfied — the consumer
        reads chunks as they land instead of waiting for task_done. Only the
        declared stream edge discounts; every other edge still needs a full
        completion."""
        base = state.indegree[tid]
        task = state.plan.tasks.get(tid)
        sp = getattr(task, "stream_param", "")
        if base <= 0 or not sp:
            return base
        for edge in task.inputs:
            if (edge.param == sp and edge.parent_task in state.streaming
                    and edge.parent_task not in state.done):
                return base - 1
        return base

    def _on_stream_event(self, state: _RunState, ev: Event) -> None:
        """Client subscription (pool thread, synchronous with the producer's
        emit): the first chunk of a streaming producer publishes a
        provisional `stream` handle and wakes consumers whose only missing
        edge is that stream. task_done later overwrites the provisional
        handle with the sealed chunked one."""
        if ev.kind != "stream_chunk":
            return
        tid = ev.task_id
        with self._lock:
            if (state.finished.is_set() or state.error or tid in state.done
                    or tid in state.streaming
                    or tid not in state.plan.tasks):
                return
            state.streaming.add(tid)
            state.handles.put(tid, TableHandle(
                ev.payload["key"], "stream", 0, 0,
                location=ev.payload.get("location", "")))
            for child in state.plan.children(tid):
                if (child not in state.done and child not in state.inflight
                        and self._ready_indegree(state, child) == 0):
                    self._enqueue(state, child)
            self._dispatch_ready()

    def _clear_streaming(self, state: _RunState, tid: str) -> None:
        """Forget a task's live-stream state (lock held): drop it from the
        streaming set and pop a provisional handle so a retry republishes
        cleanly (possibly from another worker)."""
        state.streaming.discard(tid)
        h = state.handles.get(tid)
        if h is not None and h.channel == "stream":
            state.handles.pop(tid)

    def _dispatch_ready(self) -> None:
        """Drain the ready heap (lock held) — highest effective priority
        first, earliest deadline then FIFO within it — as far as worker
        queues allow."""
        self._age_ready(time.perf_counter())
        blocked: List[List] = []
        while self._ready:
            entry = heapq.heappop(self._ready)
            _, _, tid, state = entry
            if (state.finished.is_set() or state.error
                    or tid in state.done or tid in state.inflight
                    or self._ready_indegree(state, tid) != 0):
                # stale entry: the run ended, a twin won, or a parent was
                # invalidated after this was queued
                state.queued.discard(tid)
                continue
            task = state.plan.tasks[tid]
            worker = self._select_worker(state, task, exclude=set())
            if worker is None:
                blocked.append(entry)   # backpressure: re-pushed below
                continue
            state.queued.discard(tid)
            self._launch(state, tid, worker)
        for entry in blocked:
            heapq.heappush(self._ready, entry)

    def _launch(self, state: _RunState, tid: str, worker: Worker,
                speculative: bool = False) -> None:  # guard-held: _lock
        task = state.plan.tasks[tid]
        state.attempts[tid] += 1
        info = state.inflight.setdefault(
            tid, _Inflight(started=time.perf_counter(), workers=set()))
        info.workers.add(worker.worker_id)
        group = task.hints.colocate_group
        pinned = self.cluster.workers.get(state.group_worker.get(group, ""))
        if pinned is None or not pinned.alive:
            state.group_worker[group] = worker.worker_id    # (re)pin group
        self._load[worker.worker_id] = self._load.get(worker.worker_id, 0) + 1
        self._mem[worker.worker_id] = (self._mem.get(worker.worker_id, 0)
                                       + task.hints.memory_bytes)
        state.client.emit(Event("task_start", tid, worker.worker_id,
                                {"attempt": state.attempts[tid],
                                 "speculative": speculative}))
        if speculative:
            state.client.emit(Event("speculative", tid, worker.worker_id,
                                    {"reason": "straggler"}))
        elif info.timer is None:
            self._arm_speculation_timer(state, tid, info)
        try:
            self._pool.submit(self._attempt, state, tid, task, worker,
                              state.attempts[tid])
        except RuntimeError:
            # pool already shut down (engine closed between the run abort
            # and this dispatch): the attempt will never execute, so its
            # finally-block never frees the slot — roll the reservation
            # back here or `_load`/`_mem` leak the bytes forever
            self._load[worker.worker_id] = max(
                0, self._load.get(worker.worker_id, 1) - 1)
            self._mem[worker.worker_id] = max(
                0, self._mem.get(worker.worker_id, 0)
                - task.hints.memory_bytes)
            info.workers.discard(worker.worker_id)
            if not info.workers:
                if info.timer is not None:
                    info.timer.cancel()
                state.inflight.pop(tid, None)

    # -- channel binding at dispatch time ----------------------------------
    def _bind_channels(self, state: _RunState, task,
                       worker: Worker) -> Dict[str, str]:
        """Choose each input edge's transfer channel from *actual* producer
        placement (the consumer's placement is `worker`, decided just now)."""
        channels: Dict[str, str] = {}
        if not isinstance(task, (FunctionTask, ShuffleWriteTask)):
            # scans have no inputs; gathers, combines, samples and partition
            # tasks self-resolve each part through partitioned/shuffle
            # handles (local zero-copy, else the part's own channel), so
            # binding edges here would be dead work on the lock-held
            # dispatch path
            return channels
        force = state.plan.force_channel
        for edge in task.inputs:
            if force:
                channels[edge.parent_task] = force
                continue
            handle = state.handles.get(edge.parent_task)
            producer = state.placements.get(edge.parent_task)
            if handle is not None and handle.channel in ("objectstore",
                                                         "mmap"):
                # objectstore/mmap handles locate by key/path, not by the
                # producer's flight endpoint — read them via their own
                # channel wherever the consumer runs (mmap spill files are
                # on the shared scratch filesystem)
                channels[edge.parent_task] = handle.channel
            elif producer == worker.worker_id:
                channels[edge.parent_task] = "zerocopy"
            else:
                channels[edge.parent_task] = "flight"
        return channels

    def _put_channel(self, state: _RunState, task) -> str:
        if state.plan.force_channel:
            return state.plan.force_channel
        if task.estimated_bytes > self.mmap_spill_bytes:
            return "mmap"               # big outputs spill; children mmap
        return "zerocopy"

    # -- the attempt itself (pool thread, no engine lock) -------------------
    def _attempt(self, state: _RunState, tid: str, task,
                 worker: Worker, attempt: int) -> None:
        if state.finished.is_set():
            # the run was aborted (engine closed / failed) between dispatch
            # and execution: skip the work, but still release the slot and
            # memory `_launch` reserved
            self._task_slot_freed(worker, task)
            return
        t_start = time.perf_counter()
        # journal fsyncs happen on the pool thread, never under the engine
        # lock: N concurrent runs must not serialize on each other's disk I/O
        if state.journal:
            state.journal.record_task_start(state.plan.plan_id, tid,
                                            worker.worker_id, attempt)
        try:
            with self._lock:
                put_channel = self._put_channel(state, task)
                edge_channels = self._bind_channels(state, task, worker)
            handle = worker.execute(state.plan, task, state.handles,
                                    state.client, put_channel, state.project,
                                    edge_channels=edge_channels)
        except HandleUnavailable as e:
            lost = str(e.args[0]) if e.args else ""
            self._on_lost_input(state, tid, lost, worker)
        except (WorkerFailure, TaskError, Exception) as e:  # noqa: BLE001
            self._on_failed(state, tid, worker, e)
        else:
            self._on_done(state, tid, worker, handle,
                          time.perf_counter() - t_start)
        finally:
            self._task_slot_freed(worker, task)

    def _task_slot_freed(self, worker: Worker, task) -> None:
        with self._lock:
            n = self._load.get(worker.worker_id, 1)
            self._load[worker.worker_id] = max(0, n - 1)
            m = self._mem.get(worker.worker_id, 0)
            self._mem[worker.worker_id] = max(0, m - task.hints.memory_bytes)
            # a slot opened: drain whatever run the heap says goes next
            if self._ready:
                self._dispatch_ready()

    # -- completion events --------------------------------------------------
    def _on_done(self, state: _RunState, tid: str, worker: Worker,
                 handle: TableHandle, duration: float) -> None:
        if state.journal:
            # fsync BEFORE publishing the completion (journal contract:
            # downstream tasks consume only journaled outputs) and outside
            # the engine lock; a speculation loser writes a harmless
            # duplicate record (recover() keeps one per task id)
            task = state.plan.tasks[tid]
            state.journal.record_task_done(
                state.plan.plan_id, tid,
                getattr(task, "cache_key", getattr(task, "snapshot_id", "")),
                worker.worker_id, duration, handle.num_rows, handle.nbytes)
        with self._lock:
            if tid in state.done or state.finished.is_set():
                # speculation loser, or the run already finalized (failed or
                # aborted): exactly one handle wins, stragglers are evicted
                worker.transport.evict(handle)
                return
            state.done.add(tid)
            state.handles.put(tid, handle)   # overwrites a provisional
            state.streaming.discard(tid)     # stream handle with the sealed one
            state.placements[tid] = worker.worker_id
            state.durations.append(duration)
            info = state.inflight.pop(tid, None)
            if info is not None and info.timer is not None:
                info.timer.cancel()
            # the event-driven core: decrement children, dispatch immediately
            for child in state.plan.children(tid):
                if child in state.done:
                    continue    # already consumed an earlier output of tid
                state.indegree[child] -= 1
                if state.indegree[child] == 0:
                    # skew gate: all of a partition task's writers are done
                    # and their byte histograms are known — re-split a hot
                    # partition into row-range sub-tasks before it dispatches
                    for rt in self._maybe_split_partition(state, child):
                        self._enqueue(state, rt)
                elif (child not in state.inflight
                      and self._ready_indegree(state, child) == 0):
                    # last non-stream edge done; the remaining edge is a
                    # live stream — pipelined dispatch
                    self._enqueue(state, child)
            self._dispatch_ready()
            if state.remaining() == 0:
                self._finalize(state)

    # -- skew-aware dynamic repartitioning ----------------------------------
    def _maybe_split_partition(self, state: _RunState,
                               tid: str) -> List[str]:
        """Called (lock held) when a PartitionTask's indegree hits zero: its
        shuffle writers are complete, so the per-partition byte histogram is
        known from their handles. If this partition's split-side bytes
        exceed skew_factor x the median partition, replace the task with S
        contiguous row-range sub-tasks of the split input (the other inputs
        — a join's build partition — are consumed whole by every sub).
        Returns the task ids to enqueue (just [tid] when no split)."""
        task = state.plan.tasks.get(tid)
        if (self.skew_factor is None
                or not isinstance(task, PartitionTask)
                or task.num_subs > 1 or not task.split_param):
            return [tid]
        j = task.partition_index
        split_prefix = f"{task.split_param}#"
        sizes: List[int] = []
        for e in task.inputs:
            if not e.param.startswith(split_prefix):
                continue
            h = state.handles.get(e.parent_task)
            if h is None or h.channel != "shuffle" or j >= len(h.parts):
                return [tid]    # writer mid-recovery: dispatch unsplit
            if not sizes:
                sizes = [0] * len(h.parts)
            for jj, p in enumerate(h.parts):
                sizes[jj] += p.nbytes
        if not sizes:
            return [tid]
        my_bytes = sizes[j]
        median = sorted(sizes)[len(sizes) // 2]
        if (my_bytes < self.skew_min_bytes
                or my_bytes <= self.skew_factor * max(median, 1)):
            return [tid]
        n_subs = max(2, min(8, round(my_bytes / max(median, 1))))
        plan = state.plan
        subs: List[PartitionTask] = []
        for s in range(n_subs):
            stid = f"{tid}~{s}"
            subs.append(dataclasses.replace(
                task, task_id=stid,
                # distinct content identity per sub-slice: the result cache
                # must never serve sub 0's rows for sub 1, nor a whole
                # partition for a slice of it
                cache_key=_key_hash(task.cache_key, f"sub-{s}-{n_subs}"),
                inputs=list(task.inputs),   # edges are read-only, share them
                sub_index=s, num_subs=n_subs,
                estimated_bytes=max(task.estimated_bytes // n_subs, 1),
                hints=PlacementHint(
                    memory_bytes=max(task.hints.memory_bytes // n_subs, 1),
                    colocate_group=f"g:{stid}",
                    shard_index=task.hints.shard_index,
                    num_shards=task.hints.num_shards)))
        # splice the subs into the per-run plan where the original stood and
        # rewire each consumer edge (the merge) into one edge per sub
        idx = plan.order.index(tid)
        plan.order[idx:idx + 1] = [t.task_id for t in subs]
        plan.tasks.pop(tid)
        for t in subs:
            plan.tasks[t.task_id] = t
        for child, edge in list(plan.consumer_edges.get(tid, ())):
            ctask = plan.tasks[child]
            epos = ctask.inputs.index(edge)
            ctask.inputs[epos:epos + 1] = [
                InputEdge(param=f"{edge.param}~{s}",
                          parent_task=subs[s].task_id, ref=edge.ref)
                for s in range(n_subs)]
        plan._build_index()
        # run-state bookkeeping: the original never ran; subs are ready now
        # (their parents are exactly the original's, all done)
        state.queued.discard(tid)
        state.attempts.pop(tid, None)
        state.indegree.pop(tid, None)
        for t in subs:
            state.attempts[t.task_id] = 0
            state.indegree[t.task_id] = len(
                [p for p in plan.parents[t.task_id] if p not in state.done])
        for child, _ in plan.consumer_edges.get(subs[0].task_id, ()):
            if child not in state.done:
                state.indegree[child] = len(
                    [p for p in plan.parents[child] if p not in state.done])
        # remote daemons key shipped plans by plan_id; the mutation must
        # force a re-ship or they'd execute against the pre-split topology
        plan.plan_id = _key_hash(plan.plan_id, tid, str(n_subs))
        state.client.emit(Event("skew_split", tid, "",
                                {"partition": j, "subs": n_subs,
                                 "bytes": my_bytes, "median_bytes": median}))
        return [t.task_id for t in subs
                if state.indegree[t.task_id] == 0]

    def _on_failed(self, state: _RunState, tid: str, worker: Worker,
                   err: Exception) -> None:
        if state.journal:
            state.journal.record_task_failed(state.plan.plan_id, tid,
                                             worker.worker_id, str(err))
        with self._lock:
            if tid in state.done or state.finished.is_set():
                return                  # a speculative twin already won
            task = state.plan.tasks[tid]
            # a failed streaming attempt leaves a dead provisional handle
            # behind — the retry republishes the stream from scratch
            self._clear_streaming(state, tid)
            if state.attempts[tid] <= state.max_retries:
                state.client.emit(Event("task_retry", tid, worker.worker_id,
                                        {"error": str(err)[:200],
                                         "attempt": state.attempts[tid]}))
                info = state.inflight.get(tid)
                exclude = set(info.workers) if info else {worker.worker_id}
                try:
                    w = self._pick_retry_worker(state, task, exclude)
                except TaskError as e:
                    self._fail_run(state, tid, str(e))
                    return
                self._launch(state, tid, w)
            else:
                self._fail_run(state, tid, str(err))

    def _on_lost_input(self, state: _RunState, tid: str, lost_parent: str,
                       worker: Worker) -> None:
        """A producer's buffers died with its worker: re-run the producer
        (and, transitively, ITS lost inputs when the rerun hits the same
        wall). `tid` re-queues behind the recovered producer via indegree."""
        with self._lock:
            if tid in state.done or state.finished.is_set():
                return
            state.client.emit(Event("input_lost", tid, worker.worker_id,
                                    {"producer": lost_parent}))
            # tid may itself have streamed output chunks before its input
            # died — its re-execution republishes the stream from scratch
            self._clear_streaming(state, tid)
            info = state.inflight.pop(tid, None)
            if info is not None and info.timer is not None:
                info.timer.cancel()
            producers = [lost_parent] if lost_parent else state.plan.parents[tid]
            for p in producers:
                self._invalidate(state, p)
            state.indegree[tid] = len([p for p in state.plan.parents[tid]
                                       if p not in state.done])
            if self._ready_indegree(state, tid) == 0:
                self._enqueue(state, tid)
            self._dispatch_ready()

    def _invalidate(self, state: _RunState, tid: str) -> None:
        """Forget a completed task whose output buffers were lost; safe to
        re-execute because outputs are content-addressed & idempotent."""
        self._clear_streaming(state, tid)
        if tid in state.done:
            state.done.discard(tid)
            state.handles.pop(tid)
            state.placements.pop(tid, None)
            # consumers not yet done owe this producer a completion again
            for child in state.plan.children(tid):
                if child not in state.done:
                    state.indegree[child] = len(
                        [p for p in state.plan.parents[child]
                         if p not in state.done])
        # recompute OWN indegree before the requeue check: when a worker
        # loss invalidates a producer and its consumer together, the
        # consumer's counter still reads 0 from the producer's original
        # completion. Enqueueing on that stale 0 lets the producer's re-run
        # decrement it to -1, and the ready heap's stale-entry guard
        # (indegree != 0) would then drop the task forever — a hung run
        state.indegree[tid] = len([p for p in state.plan.parents[tid]
                                   if p not in state.done])
        if tid not in state.inflight and self._ready_indegree(state, tid) == 0:
            self._enqueue(state, tid)

    def _fail_run(self, state: _RunState, tid: str, err: str) -> None:
        state.error = f"run {state.plan.run_id} failed at {tid}: {err}"
        for info in state.inflight.values():
            if info.timer is not None:
                info.timer.cancel()
        self._finalize(state)

    def _finalize(self, state: _RunState) -> None:
        with self._lock:
            if state.finished.is_set():
                return
            if state.deadline_timer is not None:
                # no-op when called from the timer's own thread
                state.deadline_timer.cancel()
                state.deadline_timer = None
            if state in self._runs:
                self._runs.remove(state)
            if state.stream_cb is not None:
                state.client.unsubscribe(state.stream_cb)
                state.stream_cb = None
            if state.journal:
                state.journal.close()
            state.result = RunResult(
                state.plan.run_id, state.plan, state.handles.snapshot(),
                state.client, time.perf_counter() - state.t0,
                dict(state.attempts), dict(state.placements))
            state.finished.set()

    # -- straggler speculation: timer events, not polling -------------------
    def _arm_speculation_timer(self, state: _RunState, tid: str,
                               info: _Inflight, delay: Optional[float] = None) -> None:
        if delay is None:
            delay = max(state.spec_min_s, 0.05)
        timer = threading.Timer(delay, self._speculation_check,
                                args=(state, tid))
        timer.daemon = True
        info.timer = timer
        timer.start()

    def _speculation_check(self, state: _RunState, tid: str) -> None:
        with self._lock:
            info = state.inflight.get(tid)
            if (info is None or tid in state.done or info.speculated
                    or state.finished.is_set()):
                return
            if tid in state.streaming:
                # a mid-stream producer's consumers may already be reading
                # its live chunks — a speculative twin would fork the stream
                # under the same key; re-arm instead
                self._arm_speculation_timer(state, tid, info)
                return
            if len(state.durations) < 2:
                self._arm_speculation_timer(state, tid, info)
                return
            median = sorted(state.durations)[len(state.durations) // 2]
            threshold = max(state.spec_factor * median, state.spec_min_s)
            elapsed = time.perf_counter() - info.started
            if elapsed < threshold:
                self._arm_speculation_timer(state, tid, info,
                                            delay=threshold - elapsed)
                return
            task = state.plan.tasks[tid]
            # the twin goes through the same placement constraints as any
            # dispatch (queue depth, memory accounting): a straggler must not
            # overcommit an already-loaded worker, and never provisions a
            # fresh on-demand worker just to race itself
            twin = self._select_worker(state, task, exclude=set(info.workers),
                                       allow_provision=False)
            if twin is None:
                # backpressure: every candidate is at queue depth — try again
                self._arm_speculation_timer(state, tid, info)
                return
            info.speculated = True
            self._launch(state, tid, twin, speculative=True)
