"""Physical plan: logical DAG + system operations (paper §4.1, Fig. 3 middle).

The planner resolves semantic dataframe references against the catalog
(snapshots, file manifests), inserts system nodes (scans with column/predicate
pushdown, materialize writes), and precomputes content-addressed cache keys so
workers can skip recomputation. Output is pure metadata — executable by any
worker.

Placement is **late-bound**: the planner does NOT pin tasks to workers or
edges to channels. It emits placement *hints* — per-task memory needs,
co-location groups (the zero-copy win requires producer/consumer on one
host), and on-demand flags — and the ExecutionEngine binds actual workers
and channels at dispatch time, when real load and liveness are known
(Wukong/DataFlower-style: orchestration follows the data flow, not a
precomputed schedule).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.columnar.catalog import Catalog
from repro_torch.core import defaults
from repro_torch.core.logical import LogicalPlan, PlanError
from repro_torch.core.spec import ModelRef


def _key_hash(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


CHANNELS = ("zerocopy", "mmap", "flight", "objectstore")


# ---------------------------------------------------------------------------
# rewrite-rule guards
#
# Shared by the planner (to decide whether a combine/exchange rewrite fires)
# and by `repro.analysis` explain mode (to tell the user WHICH guard blocked
# it). Each guard returns (classification, "") on success or (None, BPL###)
# naming the blocking rule — the silent gather fallback becomes a stable,
# documented lint code.
# ---------------------------------------------------------------------------


def combinable_guard(spec, sharded) -> Tuple[Optional[Tuple[str, ModelRef]], str]:
    """Returns the (param, ref) that rides the shards when `spec` is a
    declared-combinable aggregation of exactly one sharded input whose shard
    side matches the contract, else (None, code) naming the blocking guard.
    `sharded` is any container of sharded parent NAMES."""
    contract = getattr(spec, "combinable", None)
    if contract is None:
        return None, "BPL250"
    # a contract that doesn't name its shard side (GroupByCombine,
    # StatsCombine, single-input custom reducers) implies a single-input
    # partial; rewriting a multi-input model with it would hand the
    # partial kwargs it can't take — fall back to the gather instead
    if not contract.shard_param and len(spec.inputs) != 1:
        return None, "BPL251"
    # a join partial probes ONE build side: three or more inputs would
    # pass classification only to crash every per-shard partial
    if contract.kind == "join" and len(spec.inputs) != 2:
        return None, "BPL252"
    shd = [(p, r) for p, r in spec.inputs if r.name in sharded]
    if len(shd) != 1:
        return None, "BPL253"
    param, ref = shd[0]
    if contract.shard_param and contract.shard_param != param:
        return None, "BPL254"
    return (param, ref), ""


def exchange_guard(spec, sharded,
                   upstream_keys: Optional[Dict[str, Tuple[str, ...]]] = None
                   ) -> Tuple[Optional[List[str]], str]:
    """Returns the ordered list of exchanged params when `spec` declares an
    ExchangeContract that can fire given `sharded` parent names, else
    (None, code) naming the blocking guard. `upstream_keys` maps parent
    names produced by a "keys"-merged exchange to that exchange's group
    keys (the chained-projection guard)."""
    contract = getattr(spec, "exchange", None)
    if contract is None:
        return None, "BPL250"
    params = {p: r for p, r in spec.inputs}
    exchanged = (list(contract.shard_params) if contract.shard_params
                 else [p for p, _ in spec.inputs])
    if not exchanged or any(p not in params for p in exchanged):
        return None, "BPL255"
    if contract.mode == "range" and len(exchanged) != 1:
        return None, "BPL256"
    if contract.split_param and contract.split_param not in exchanged:
        return None, "BPL257"
    if contract.order_param and contract.order_param not in exchanged:
        return None, "BPL257"
    if not any(params[p].name in sharded for p in exchanged):
        return None, "BPL258"
    for p in exchanged:
        keys = (upstream_keys or {}).get(params[p].name)
        if keys is None:
            continue
        # chaining onto permuted "keys" partitions is only byte-exact
        # when the upstream group keys survive the consumer's projection
        # (the partition task re-sorts by them to restore row order)
        cols = params[p].columns
        if cols is not None and not set(keys) <= set(cols):
            return None, "BPL259"
    return exchanged, ""


@dataclasses.dataclass
class WorkerProfile:
    worker_id: str
    memory_gb: float = 4.0
    cpus: int = 4
    on_demand: bool = False


@dataclasses.dataclass
class PlacementHint:
    """Late-binding placement metadata: the engine turns hints into an actual
    worker at dispatch time."""
    memory_bytes: int = 0       # working-set need (input + output estimate)
    colocate_group: str = ""    # tasks sharing a group prefer one worker
    on_demand: bool = False     # exceeds every standing profile -> provision
    shard_index: int = 0        # this task's slice of a sharded producer
    num_shards: int = 1         # 1 = unsharded


@dataclasses.dataclass
class InputEdge:
    param: str
    parent_task: str
    ref: ModelRef
    channel: str = ""           # bound at dispatch time ("" = late-bound)


@dataclasses.dataclass
class ScanTask:
    task_id: str
    table: str
    branch: str
    snapshot_id: str
    columns: Optional[Tuple[str, ...]]     # union of consumer needs (None=all)
    files: Tuple[str, ...]                 # after stats-based pruning
    estimated_bytes: int
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "scan"
    # the producer may publish its output as a live row-chunk stream
    # (chunked per file, re-sliced to plan.chunk_rows) instead of one table
    streams_output: bool = False


@dataclasses.dataclass
class FunctionTask:
    task_id: str
    name: str
    env_id: str
    code_hash: str
    cache_key: str                          # content-addressed result identity
    inputs: List[InputEdge]
    materialize: bool
    estimated_bytes: int
    memory_gb: float
    timeout_s: float
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "function"
    # "partial": run spec.combinable.partial over one shard instead of
    # spec.fn — the output is aggregation state consumed by a CombineTask
    agg_phase: str = ""
    # contract identity for partial tasks: lets a remote daemon refuse a
    # dispatch whose contract disagrees with its loaded project (a
    # contract-only edit is invisible to code_hash)
    contract_id: str = ""
    # streamability classification (planner): `streams_output` marks a
    # rowwise task that may publish chunk-by-chunk; `stream_param` names the
    # input edge whose producer streams — the engine dispatches this task on
    # that producer's FIRST chunk instead of its completion, and the worker
    # consumes the edge through get_stream
    streams_output: bool = False
    stream_param: str = ""


@dataclasses.dataclass
class GatherTask:
    """Synthesized merge point for a sharded producer: one InputEdge per
    shard, in shard order (concatenation order == unsharded row order).
    Executes where the engine places it — local shards are read zero-copy,
    remote ones over flight, and the single concat happens there
    (columnar.compute.concat_tables)."""
    task_id: str
    name: str                               # logical dataframe being merged
    inputs: List[InputEdge]                 # shard edges, index order
    columns: Optional[Tuple[str, ...]]      # projection pushed into each part
    estimated_bytes: int
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "gather"


@dataclasses.dataclass
class CombineTask:
    """Map-side-combine merge point: replaces the plain GatherTask when the
    consumer of a sharded producer is a declared-combinable aggregation.
    Inputs are the per-shard partial-state tasks in shard order; the worker
    merges aggregation states (spec.combinable.combine) instead of
    concatenating raw rows, so only per-group states cross workers. Like a
    gather it executes under the ORIGINAL func task id, so downstream edges
    and RunResult.read address it unchanged."""
    task_id: str
    name: str                               # the aggregation model
    code_hash: str                          # daemon stale-code check
    cache_key: str                          # layout-independent identity
    inputs: List[InputEdge]                 # partial edges, shard order
    materialize: bool
    estimated_bytes: int
    timeout_s: float = 600.0                # combine runs user code too
    contract_id: str = ""                   # daemon stale-contract check
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "combine"


@dataclasses.dataclass
class ShuffleWriteTask:
    """Hash/range-partition one producer shard of an exchanged input into P
    key-addressed part files (columnar.compute.hash_partition /
    range_partition). The output is a partition-addressed shuffle handle:
    per-partition consumers fetch exactly parts[j] from each writer, so raw
    rows cross workers once, and only to the partition that reads them."""
    task_id: str                # shuffle:{consumer}/{param}#{k}
    name: str                   # the consumer model this writer feeds
    param: str                  # which consumer input this writer partitions
    cache_key: str
    inputs: List[InputEdge]     # producer edge (+ __splits__ in range mode)
    num_partitions: int
    keys: Tuple[str, ...]
    estimated_bytes: int
    mode: str = "hash"          # "hash" | "range"
    descending: bool = False
    order_column: bool = False  # append __xord__ before partitioning
    contract_id: str = ""       # daemon stale-contract check
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "shuffle_write"


@dataclasses.dataclass
class ShuffleSampleTask:
    """Range-mode split selection: sample the first sort key across every
    producer shard and pick P-1 splits (columnar.compute.sample_splits).
    Every shuffle writer of the exchange consumes the same splits table, so
    all writers agree on partition boundaries."""
    task_id: str                # shuffle:{consumer}/__splits__
    name: str
    cache_key: str
    inputs: List[InputEdge]     # one per producer shard, shard order
    keys: Tuple[str, ...]
    num_partitions: int
    estimated_bytes: int
    contract_id: str = ""
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "shuffle_sample"


@dataclasses.dataclass
class PartitionTask:
    """Run the exchange contract's per-partition operator over partition j:
    fetch parts[j] from every writer of each exchanged param (writer order ==
    shard order, so concatenation preserves original relative row order),
    broadcast the rest whole, and invoke contract.partition. Skew-aware
    repartitioning re-splits one of these into `num_subs` contiguous
    row-range sub-tasks of the `split_param` input (task ids `...~{s}`)."""
    task_id: str                # func:{name}@{j}  (sub-splits: @{j}~{s})
    name: str
    env_id: str
    code_hash: str
    cache_key: str
    inputs: List[InputEdge]     # writer edges param="{p}#{k}" + broadcasts
    partition_index: int
    param_shards: Dict[str, int]    # exchanged param -> writer count
    estimated_bytes: int
    memory_gb: float
    timeout_s: float
    split_param: str = ""       # input eligible for row-range sub-splits
    sub_index: int = 0
    num_subs: int = 1
    # exchanged param -> upstream merge keys to stable-sort the gathered
    # slices by before invoking the operator. Set when chaining onto a
    # "keys"-merged exchange: its partitions arrive partition-major, and the
    # sort restores the exact unsharded row order (upstream group keys are
    # unique per row), keeping float accumulations byte-identical
    param_sort: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    merge: str = "concat"       # how partitions reassemble (RunResult.read)
    merge_keys: Tuple[str, ...] = ()
    materialize: bool = False   # partitions never materialize; merge does
    contract_id: str = ""
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "partition"


@dataclasses.dataclass
class ShuffleMergeTask:
    """Order-normalizing merge point for an exchange: reassemble partition
    outputs (columnar.compute.merge_partitions) byte-identically to the
    unsharded run — "concat" for range partitions, a stable key sort for
    group_by, the hidden __xord__/__xmiss__ sort for joins. Like a gather it
    executes under the ORIGINAL func task id, so downstream edges and
    RunResult.read address it unchanged."""
    task_id: str
    name: str
    code_hash: str
    cache_key: str              # layout-independent identity
    inputs: List[InputEdge]     # partition edges, partition (+sub) order
    merge: str
    keys: Tuple[str, ...]
    materialize: bool
    estimated_bytes: int
    timeout_s: float = 600.0
    contract_id: str = ""
    hints: PlacementHint = dataclasses.field(default_factory=PlacementHint)
    kind: str = "shuffle_merge"


@dataclasses.dataclass
class PhysicalPlan:
    plan_id: str
    run_id: str
    branch: str
    tasks: Dict[str, object]
    order: List[str]
    targets: List[str]
    force_channel: Optional[str] = None     # benchmarking override
    # row-chunk size for streamable producers (0 = streaming disabled)
    chunk_rows: int = 0
    created_at: float = dataclasses.field(default_factory=time.time)

    def __post_init__(self):
        self._build_index()

    def _build_index(self) -> None:
        """Precompute the consumer-edge index once (O(V+E)); the engine's
        completion callbacks and channel binding use it instead of rescanning
        every task's inputs (the old O(V·E) `put_channel_for`)."""
        self.consumer_edges: Dict[str, List[Tuple[str, InputEdge]]] = {
            tid: [] for tid in self.order}
        self.parents: Dict[str, List[str]] = {}
        for tid in self.order:
            t = self.tasks[tid]
            ps: List[str] = []
            for e in getattr(t, "inputs", ()):  # FunctionTask or GatherTask
                self.consumer_edges[e.parent_task].append((tid, e))
                if e.parent_task not in ps:
                    ps.append(e.parent_task)
            self.parents[tid] = ps

    def task(self, task_id: str):
        return self.tasks[task_id]

    def children(self, task_id: str) -> List[str]:
        seen: List[str] = []
        for child, _ in self.consumer_edges.get(task_id, []):
            if child not in seen:
                seen.append(child)
        return seen

    def describe(self) -> str:
        lines = [f"plan {self.plan_id} (run {self.run_id}, branch {self.branch})"]
        for tid in self.order:
            t = self.tasks[tid]
            h = t.hints
            place = (f"group={h.colocate_group or '-'}"
                     f"{' ondemand' if h.on_demand else ''}")
            if h.num_shards > 1:
                place += f" shard={h.shard_index}/{h.num_shards}"
            if isinstance(t, ScanTask):
                cols = ",".join(t.columns) if t.columns else "*"
                lines.append(f"  SCAN {t.table}@{t.snapshot_id[:8]} [{cols}] "
                             f"files={len(t.files)} [{place}]")
            elif isinstance(t, GatherTask):
                lines.append(f"  GATHER {t.name} parts={len(t.inputs)} "
                             f"[{place}]")
            elif isinstance(t, CombineTask):
                lines.append(f"  COMBINE {t.name} parts={len(t.inputs)} "
                             f"cache={t.cache_key[:8]} [{place}]")
            elif isinstance(t, ShuffleWriteTask):
                lines.append(f"  SHUFFLE-WRITE {t.name}/{t.param} "
                             f"P={t.num_partitions} mode={t.mode} "
                             f"keys={','.join(t.keys)} [{place}]")
            elif isinstance(t, ShuffleSampleTask):
                lines.append(f"  SHUFFLE-SAMPLE {t.name} "
                             f"P={t.num_partitions} [{place}]")
            elif isinstance(t, PartitionTask):
                sub = (f" sub={t.sub_index}/{t.num_subs}"
                       if t.num_subs > 1 else "")
                lines.append(f"  PARTITION {t.name}@{t.partition_index}{sub} "
                             f"cache={t.cache_key[:8]} [{place}]")
            elif isinstance(t, ShuffleMergeTask):
                lines.append(f"  SHUFFLE-MERGE {t.name} merge={t.merge} "
                             f"parts={len(t.inputs)} [{place}]")
            else:
                edges = ", ".join(e.ref.name for e in t.inputs)
                mat = " MATERIALIZE" if t.materialize else ""
                lines.append(f"  FUNC {t.name}({edges}){mat} env={t.env_id} "
                             f"cache={t.cache_key[:8]} [{place}]")
        return "\n".join(lines)


class Planner:
    """Control-plane planner: metadata in, physical plan out."""

    def __init__(self, catalog: Catalog,
                 workers: Sequence[WorkerProfile],
                 force_channel: Optional[str] = None,
                 shard_threshold_bytes: int = 64 << 20,
                 max_shards: Optional[int] = None,
                 edge_columns: Optional[Dict[Tuple[str, str],
                                             Optional[Tuple[str, ...]]]] = None,
                 stream: bool = True,
                 chunk_rows: int = defaults.STREAM_CHUNK_ROWS):
        self.catalog = catalog
        self.workers = list(workers)
        if force_channel is not None and force_channel not in CHANNELS:
            raise PlanError(f"unknown channel {force_channel}")
        self.force_channel = force_channel
        # streaming data plane: when on, scans and rowwise chains are
        # classified streamable (streams_output / stream_param) and the plan
        # carries the chunk size; stream=False reproduces the fully
        # materialized plan (the benchmark baseline)
        self.stream = stream and chunk_rows > 0
        self.chunk_rows = chunk_rows
        # cost model: only tables worth the gather overhead are sharded, and
        # never wider than the fleet (None = one shard per standing worker)
        self.shard_threshold_bytes = shard_threshold_bytes
        self.max_shards = max_shards
        # column-lineage pushdown (repro.analysis pass 1): proven read sets
        # for edges whose consumer declared NO columns, keyed by
        # (consumer model, ref_id). A missing entry or a None value means
        # "reads everything" — exactly the old declared-union behavior.
        self.edge_columns = edge_columns or {}

    def _shard_count(self, est_bytes: int, n_files: int) -> int:
        cap = (self.max_shards if self.max_shards is not None
               else len(self.workers))
        n = min(cap, n_files)   # file = unit of scan work (immutable manifest)
        if n < 2 or est_bytes < self.shard_threshold_bytes:
            return 1
        return n

    # -- helpers --------------------------------------------------------------
    def _classify_combinable(self, spec, shard_map: Dict[str, List[str]]
                             ) -> Optional[Tuple[str, ModelRef]]:
        """Planner-side wrapper over `combinable_guard` (the blocking code is
        surfaced by repro.analysis explain mode, not here)."""
        return combinable_guard(spec, shard_map)[0]

    def _classify_exchange(self, spec, shard_map: Dict[str, List[str]],
                           exchange_meta: Dict[str, Dict]
                           ) -> Optional[List[str]]:
        """Planner-side wrapper over `exchange_guard`."""
        upstream_keys = {n: m["keys"] for n, m in exchange_meta.items()
                         if m["merge"] == "keys"}
        return exchange_guard(spec, shard_map, upstream_keys)[0]

    def _edge_read_columns(self, consumer: str,
                           ref: ModelRef) -> Optional[Tuple[str, ...]]:
        """Columns the (consumer, ref) edge reads: the declared pushdown hint
        when one exists, else the analyzer-proven read set (lineage
        pushdown), else None = everything."""
        if ref.columns is not None:
            return ref.columns
        return self.edge_columns.get((consumer, ref.ref_id))

    def _column_union(self, consumers: List[Tuple[str, ModelRef]],
                      schema: Optional[Dict[str, str]] = None
                      ) -> Optional[Tuple[str, ...]]:
        """Union of the columns the consumers read (predicate columns
        included); None when any consumer reads everything. Validated
        against `schema` when one is known (source tables — function output
        schemas don't exist at plan time)."""
        cols: List[str] = []
        for consumer, ref in consumers:
            read = self._edge_read_columns(consumer, ref)
            if read is None:
                return None  # someone wants everything
            for c in read:
                if c not in cols:
                    cols.append(c)
            pred = ref.predicate()
            if pred is not None:
                for c in pred.referenced_columns():
                    if c not in cols:
                        cols.append(c)
        if schema is not None:
            unknown = [c for c in cols if c not in schema]
            if unknown:
                raise PlanError(
                    f"columns {unknown} not in table schema {list(schema)}",
                    code="BPL101",
                    column=unknown[0])
        return tuple(cols)

    # -- planning ---------------------------------------------------------------
    def plan(self, logical: LogicalPlan, branch: str = "main",
             run_id: Optional[str] = None) -> PhysicalPlan:
        run_id = run_id or uuid.uuid4().hex[:12]
        tasks: Dict[str, object] = {}
        order: List[str] = []
        cache_keys: Dict[str, str] = {}     # logical name -> identity
        est_bytes: Dict[str, int] = {}
        shard_map: Dict[str, List[str]] = {}    # logical name -> shard tids
        # per-shard identities: chunk boundaries depend on the (consumer-
        # pruned) file list, so shard k's identity must name the exact files
        # it covers — a warm shared cluster must never serve a cached shard
        # computed over a different chunk layout
        shard_keys: Dict[str, List[str]] = {}
        # names whose shard_map entries are exchange PARTITIONS, with the
        # merge metadata a lazily-synthesized merge point needs. "keys"
        # partitions are a permutation of the unsharded row order, so they
        # may ride into order-insensitive consumers (combinables, further
        # exchanges) but never into row-order-preserving ones (rowwise)
        exchange_meta: Dict[str, Dict] = {}

        def consumer_union(name: str) -> Optional[Tuple[str, ...]]:
            """Column union of `name`'s logical consumers; None when any
            consumer reads everything or `name` is a run target —
            RunResult.read must expose the whole dataframe."""
            if name in logical.targets:
                return None
            consumers = logical.nodes[name].consumers
            if not consumers:
                return None
            return self._column_union(consumers)

        def ensure_gather(name: str) -> None:
            """A consumer genuinely needs the whole table: synthesize the
            merge task under the ORIGINAL task id, so downstream edges and
            RunResult.read address it unchanged. Exchange partitions whose
            merge is order-normalizing ("keys") get a ShuffleMergeTask; plain
            shards and "concat" partitions (contiguous output ranges) get the
            raw-row GatherTask."""
            shard_tids = shard_map[name]
            tid = shard_tids[0].split("#")[0].split("@")[0]
            if tid in tasks:
                return
            edges = [InputEdge(param=f"part{k}", parent_task=stid,
                               ref=ModelRef.create(name))
                     for k, stid in enumerate(shard_tids)]
            meta = exchange_meta.get(name)
            if meta is not None and meta["merge"] != "concat":
                tasks[tid] = ShuffleMergeTask(
                    task_id=tid, name=name, code_hash=meta["code_hash"],
                    cache_key=meta["cache_key"], inputs=edges,
                    merge=meta["merge"], keys=meta["keys"],
                    materialize=False, estimated_bytes=est_bytes[name],
                    timeout_s=meta["timeout_s"],
                    contract_id=meta["contract_id"])
                order.append(tid)
                return
            first = tasks[shard_tids[0]]
            # scans already carry the validated column union; function-level
            # gathers push the consumers' column union into each part fetch,
            # so only the bytes someone reads cross workers
            cols = (first.columns if isinstance(first, ScanTask)
                    else consumer_union(name))
            tasks[tid] = GatherTask(task_id=tid, name=name, inputs=edges,
                                    columns=cols,
                                    estimated_bytes=est_bytes[name])
            order.append(tid)

        for name in logical.order:
            node = logical.nodes[name]
            if node.kind == "source":
                snap = self.catalog.get_table(name, branch=branch)
                cols = self._column_union(node.consumers, snap.schema)
                # file pruning: a file survives if ANY consumer's predicate
                # might match it (per-edge filters re-applied at delivery)
                preds = [ref.predicate() for _, ref in node.consumers]
                if preds and all(p is not None for p in preds):
                    files = []
                    for f in snap.files:
                        if any(p.maybe_matches(f.column_stats) for p in preds):
                            files.append(f)
                else:
                    files = list(snap.files)
                frac = (len(cols) / max(len(snap.schema), 1)) if cols else 1.0
                est = int(sum(f.size_bytes for f in files) * frac)
                cache_keys[name] = _key_hash("scan", snap.snapshot_id,
                                             ",".join(cols or ("*",)))
                est_bytes[name] = est
                n = self._shard_count(est, len(files))
                if n > 1:
                    # contiguous file chunks keep row order, so the gather's
                    # index-ordered concat is byte-identical to one big scan
                    shard_tids = []
                    shard_keys[name] = []
                    for k in range(n):
                        chunk = files[k * len(files) // n:
                                      (k + 1) * len(files) // n]
                        stid = f"scan:{name}#{k}"
                        tasks[stid] = ScanTask(
                            task_id=stid, table=name, branch=branch,
                            snapshot_id=snap.snapshot_id, columns=cols,
                            files=tuple(f.key for f in chunk),
                            estimated_bytes=int(
                                sum(f.size_bytes for f in chunk) * frac),
                            hints=PlacementHint(shard_index=k, num_shards=n),
                            streams_output=self.stream)
                        order.append(stid)
                        shard_tids.append(stid)
                        shard_keys[name].append(_key_hash(
                            cache_keys[name], *(f.key for f in chunk)))
                    shard_map[name] = shard_tids
                else:
                    tid = f"scan:{name}"
                    tasks[tid] = ScanTask(task_id=tid, table=name,
                                          branch=branch,
                                          snapshot_id=snap.snapshot_id,
                                          columns=cols,
                                          files=tuple(f.key for f in files),
                                          estimated_bytes=est,
                                          streams_output=self.stream)
                    order.append(tid)
            else:
                spec = node.spec
                edge_ids = []
                est = 0
                for _, ref in spec.inputs:
                    parent_key = cache_keys[ref.name]
                    edge_ids.append(_key_hash(parent_key,
                                              ",".join(ref.columns or ("*",)),
                                              ref.filter or ""))
                    est += est_bytes.get(ref.name, 0)
                # a declared contract is part of the function's identity:
                # code_hash can't see it (it may live in globals/closures),
                # and a stale combined result served across a contract edit
                # would silently report the OLD aggregation. Folding it here
                # keeps the key layout-independent (sharded and unsharded
                # runs still share results) while invalidating the combine
                # and everything downstream on contract edits.
                contract = (getattr(spec, "combinable", None)
                            or getattr(spec, "exchange", None))
                cache_key = _key_hash("func", spec.code_hash, spec.env.env_id,
                                      *edge_ids,
                                      *((contract.contract_id,)
                                        if contract is not None else ()))
                cache_keys[name] = cache_key
                est = max(int(est * 1.2), 1)
                est_bytes[name] = est
                # recognized aggregations over a sharded input rewrite into
                # per-shard partial tasks + a CombineTask at the merge point:
                # the fleet aggregates in parallel and only per-group states
                # cross workers (map-side combine)
                exchange_params = self._classify_exchange(spec, shard_map,
                                                          exchange_meta)
                combine_input = (None if exchange_params is not None
                                 else self._classify_combinable(spec, shard_map))
                # row-wise functions ride their parent's shards: one task per
                # shard, no gather in between (f(concat(p)) == concat(f(p)))
                # — but never permuted exchange partitions ("keys" merge):
                # concat(f(partitions)) would come back in partition order,
                # not the unsharded row order
                shardable = (getattr(spec, "rowwise", False)
                             and not spec.materialize
                             and len(spec.inputs) == 1
                             and spec.inputs[0][1].name in shard_map
                             and exchange_meta.get(
                                 spec.inputs[0][1].name,
                                 {"merge": "concat"})["merge"] == "concat")
                if exchange_params is not None:
                    xc = spec.exchange
                    params = dict(spec.inputs)

                    def producers_of(r: ModelRef) -> Tuple[List[str], List[str]]:
                        """(task ids, identities) of `r`'s producers: its
                        shard/partition tasks when sharded, the single plain
                        task otherwise."""
                        if r.name in shard_map:
                            return shard_map[r.name], shard_keys[r.name]
                        ptid = (f"func:{r.name}" if f"func:{r.name}" in tasks
                                else f"scan:{r.name}")
                        return [ptid], [cache_keys[r.name]]

                    # partition count: fleet-width parallelism, matched to
                    # the widest exchanged producer
                    P = max(2, max(len(shard_map.get(params[p].name, ()))
                                   for p in exchange_params))
                    # non-exchanged inputs broadcast whole to every partition
                    bcast: List[Tuple[str, ModelRef, str]] = []
                    for p, r in spec.inputs:
                        if p in exchange_params:
                            continue
                        if r.name in shard_map:
                            ensure_gather(r.name)
                        btid = (f"func:{r.name}" if f"func:{r.name}" in tasks
                                else f"scan:{r.name}")
                        bcast.append((p, r, btid))
                    # range mode: one sample task over every producer shard
                    # picks the P-1 splits all writers share
                    sample_tid = ""
                    if xc.mode == "range":
                        r0 = params[exchange_params[0]]
                        ptids, pkeys = producers_of(r0)
                        sample_tid = f"shuffle:{name}/__splits__"
                        tasks[sample_tid] = ShuffleSampleTask(
                            task_id=sample_tid, name=name,
                            cache_key=_key_hash(cache_key, xc.contract_id,
                                                f"sample-{P}", *pkeys),
                            inputs=[InputEdge(param=f"shard{k}",
                                              parent_task=pt, ref=r0)
                                    for k, pt in enumerate(ptids)],
                            keys=xc.keys, num_partitions=P,
                            estimated_bytes=max(
                                est_bytes[r0.name] // 10, 1),
                            contract_id=xc.contract_id)
                        order.append(sample_tid)
                    # one writer per producer shard of each exchanged input;
                    # the writer colocates with its shard (hints inherit the
                    # only parent's group), so partitioning happens where the
                    # rows already live
                    writer_tids: Dict[str, List[str]] = {}
                    writer_keys: Dict[str, List[str]] = {}
                    for p in exchange_params:
                        r = params[p]
                        ptids, pkeys = producers_of(r)
                        wt: List[str] = []
                        wk: List[str] = []
                        for k, ptid in enumerate(ptids):
                            wtid = f"shuffle:{name}/{p}#{k}"
                            wkey = _key_hash(cache_key, xc.contract_id,
                                             f"write-{p}-{k}-{len(ptids)}-{P}",
                                             pkeys[k])
                            edges = [InputEdge(param=p, parent_task=ptid,
                                               ref=r)]
                            if sample_tid:
                                edges.append(InputEdge(
                                    param="__splits__",
                                    parent_task=sample_tid,
                                    ref=ModelRef.create(name)))
                            tasks[wtid] = ShuffleWriteTask(
                                task_id=wtid, name=name, param=p,
                                cache_key=wkey, inputs=edges,
                                num_partitions=P, keys=xc.keys,
                                estimated_bytes=max(
                                    est_bytes[r.name] // len(ptids), 1),
                                mode=xc.mode, descending=xc.descending,
                                order_column=(p == xc.order_param),
                                contract_id=xc.contract_id,
                                hints=PlacementHint(shard_index=k,
                                                    num_shards=len(ptids)))
                            order.append(wtid)
                            wt.append(wtid)
                            wk.append(wkey)
                        writer_tids[p] = wt
                        writer_keys[p] = wk
                    # chained "keys" partitions arrive partition-major; the
                    # partition task restores the unsharded row order by
                    # stable-sorting on the upstream group keys
                    param_sort = {
                        p: exchange_meta[params[p].name]["keys"]
                        for p in exchange_params
                        if exchange_meta.get(params[p].name,
                                             {}).get("merge") == "keys"}
                    # P per-partition consumer tasks, each fetching exactly
                    # its slice from every writer
                    part_tids: List[str] = []
                    part_keys: List[str] = []
                    for j in range(P):
                        ptid_j = f"func:{name}@{j}"
                        pkey = _key_hash(cache_key, xc.contract_id,
                                         f"part-{j}-{P}",
                                         *(k for p in exchange_params
                                           for k in writer_keys[p]))
                        edges = [InputEdge(param=f"{p}#{k}", parent_task=wt,
                                           ref=ModelRef.create(params[p].name))
                                 for p in exchange_params
                                 for k, wt in enumerate(writer_tids[p])]
                        edges += [InputEdge(param=p, parent_task=bt, ref=r)
                                  for p, r, bt in bcast]
                        tasks[ptid_j] = PartitionTask(
                            task_id=ptid_j, name=name,
                            env_id=spec.env.env_id,
                            code_hash=spec.code_hash, cache_key=pkey,
                            inputs=edges, partition_index=j,
                            param_shards={p: len(writer_tids[p])
                                          for p in exchange_params},
                            estimated_bytes=max(est // P, 1),
                            memory_gb=spec.resources.memory_gb,
                            timeout_s=spec.resources.timeout_s,
                            split_param=xc.split_param,
                            param_sort=dict(param_sort),
                            merge=xc.merge, merge_keys=xc.keys,
                            contract_id=xc.contract_id,
                            hints=PlacementHint(shard_index=j,
                                                num_shards=P))
                        order.append(ptid_j)
                        part_tids.append(ptid_j)
                        part_keys.append(pkey)
                    if xc.merge in ("concat", "keys") and not spec.materialize:
                        # partitions chain downstream as shards (a further
                        # combinable/exchange consumer runs per-partition and
                        # never gathers raw rows); a consumer that needs the
                        # whole table synthesizes the merge via ensure_gather
                        shard_map[name] = part_tids
                        shard_keys[name] = part_keys
                        exchange_meta[name] = {
                            "merge": xc.merge, "keys": xc.keys,
                            "code_hash": spec.code_hash,
                            "cache_key": cache_key,
                            "timeout_s": spec.resources.timeout_s,
                            "contract_id": xc.contract_id}
                    else:
                        # joins thread hidden order columns through their
                        # partitions — downstream must never see them, so the
                        # merge is synthesized immediately
                        tid = f"func:{name}"
                        tasks[tid] = ShuffleMergeTask(
                            task_id=tid, name=name,
                            code_hash=spec.code_hash, cache_key=cache_key,
                            inputs=[InputEdge(param=f"part{j}",
                                              parent_task=pt,
                                              ref=ModelRef.create(name))
                                    for j, pt in enumerate(part_tids)],
                            merge=xc.merge, keys=xc.keys,
                            materialize=spec.materialize,
                            estimated_bytes=est,
                            timeout_s=spec.resources.timeout_s,
                            contract_id=xc.contract_id)
                        order.append(tid)
                elif combine_input is not None:
                    param_s, ref_s = combine_input
                    parent_shards = shard_map[ref_s.name]
                    n = len(parent_shards)
                    # non-shard inputs (a join's small build side) broadcast
                    # whole to every partial; one shared edge per input, so
                    # the build side is computed once and fanned out
                    bcast: List[Tuple[str, ModelRef, str]] = []
                    for p, r in spec.inputs:
                        if p == param_s:
                            continue
                        if r.name in shard_map:
                            ensure_gather(r.name)
                        btid = (f"func:{r.name}"
                                if f"func:{r.name}" in tasks
                                else f"scan:{r.name}")
                        bcast.append((p, r, btid))
                    partial_tids = []
                    for k, ptid in enumerate(parent_shards):
                        stid = f"func:{name}#{k}"
                        # per-shard identity: derives from the parent shard's
                        # chunk identity AND the contract (editing keys/aggs
                        # must invalidate cached partial states)
                        skey = _key_hash(cache_key, contract.contract_id,
                                         f"partial-{k}-{n}",
                                         shard_keys[ref_s.name][k])
                        edges = [InputEdge(param=param_s, parent_task=ptid,
                                           ref=ref_s)]
                        edges += [InputEdge(param=p, parent_task=bt, ref=r)
                                  for p, r, bt in bcast]
                        # a partial may fold its shard chunk-by-chunk only
                        # when the contract declares a state-closed merge
                        # (merge_states) and the shard's producer streams
                        can_stream = (
                            self.stream
                            and getattr(contract, "merge_states", None)
                            is not None
                            and getattr(tasks.get(ptid), "streams_output",
                                        False))
                        tasks[stid] = FunctionTask(
                            task_id=stid, name=name, env_id=spec.env.env_id,
                            code_hash=spec.code_hash, cache_key=skey,
                            inputs=edges, materialize=False,
                            estimated_bytes=max(est // n, 1),
                            memory_gb=spec.resources.memory_gb,
                            timeout_s=spec.resources.timeout_s,
                            hints=PlacementHint(shard_index=k, num_shards=n),
                            agg_phase="partial",
                            contract_id=contract.contract_id,
                            stream_param=param_s if can_stream else "")
                        order.append(stid)
                        partial_tids.append(stid)
                    tid = f"func:{name}"
                    # layout-independent cache key: a warm cluster may serve
                    # the unsharded run's result for the combine and vice
                    # versa — the contract guarantees they're the same table
                    #
                    # the combine's working set is per-group aggregation
                    # states, not raw rows (the whole point of the rewrite);
                    # inheriting the input-sized estimate would demand
                    # input-sized memory hints — on-demand provisioning and
                    # mmap spills to merge a few KB of states. est//20
                    # mirrors the state<raw/20 bound the property harness
                    # enforces.
                    tasks[tid] = CombineTask(
                        task_id=tid, name=name, code_hash=spec.code_hash,
                        cache_key=cache_key,
                        inputs=[InputEdge(param=f"part{k}", parent_task=st,
                                          ref=ModelRef.create(name))
                                for k, st in enumerate(partial_tids)],
                        materialize=spec.materialize,
                        estimated_bytes=max(est // 20, 1),
                        timeout_s=spec.resources.timeout_s,
                        contract_id=contract.contract_id)
                    order.append(tid)
                elif shardable:
                    param, ref = spec.inputs[0]
                    parent_shards = shard_map[ref.name]
                    n = len(parent_shards)
                    shard_tids = []
                    shard_keys[name] = []
                    for k, ptid in enumerate(parent_shards):
                        stid = f"func:{name}#{k}"
                        # distinct identity per shard, transitively derived
                        # from the parent shard's identity (ultimately the
                        # exact file chunk): the intermediate cache must
                        # never serve shard j — or shard k of a different
                        # chunk layout — for shard k
                        skey = _key_hash(cache_key, f"shard-{k}-{n}",
                                         shard_keys[ref.name][k])
                        shard_keys[name].append(skey)
                        # rowwise chunk-through: stream the output, and when
                        # the parent shard itself streams, start on its first
                        # chunk (the pipelined-dispatch edge)
                        parent_streams = getattr(tasks.get(ptid),
                                                 "streams_output", False)
                        tasks[stid] = FunctionTask(
                            task_id=stid, name=name, env_id=spec.env.env_id,
                            code_hash=spec.code_hash,
                            cache_key=skey,
                            inputs=[InputEdge(param=param, parent_task=ptid,
                                              ref=ref)],
                            materialize=False,
                            estimated_bytes=max(est // n, 1),
                            memory_gb=spec.resources.memory_gb,
                            timeout_s=spec.resources.timeout_s,
                            hints=PlacementHint(shard_index=k, num_shards=n),
                            streams_output=self.stream,
                            stream_param=(param if self.stream
                                          and parent_streams else ""))
                        order.append(stid)
                        shard_tids.append(stid)
                    shard_map[name] = shard_tids
                else:
                    tid = f"func:{name}"
                    inputs = []
                    for param, ref in spec.inputs:
                        if ref.name in shard_map:
                            ensure_gather(ref.name)
                        ptid = (f"func:{ref.name}" if f"func:{ref.name}" in tasks
                                else f"scan:{ref.name}")
                        inputs.append(InputEdge(param=param, parent_task=ptid,
                                                ref=ref))
                    # an unsharded rowwise chain still streams: chunk-through
                    # output, and pipelined dispatch off a streaming parent.
                    # materialize= stays whole-table (the catalog write wants
                    # one table), so it only ever streams its INPUT.
                    rowwise = (self.stream and getattr(spec, "rowwise", False)
                               and len(inputs) == 1 and not spec.materialize)
                    parent_streams = (rowwise and getattr(
                        tasks.get(inputs[0].parent_task), "streams_output",
                        False))
                    tasks[tid] = FunctionTask(
                        task_id=tid, name=name, env_id=spec.env.env_id,
                        code_hash=spec.code_hash, cache_key=cache_key,
                        inputs=inputs, materialize=spec.materialize,
                        estimated_bytes=est, memory_gb=spec.resources.memory_gb,
                        timeout_s=spec.resources.timeout_s,
                        streams_output=rowwise,
                        stream_param=(inputs[0].param if parent_streams
                                      else ""))
                    order.append(tid)

        for t in logical.targets:
            if t in shard_map:
                ensure_gather(t)    # run results expose the whole dataframe

        plan = PhysicalPlan(plan_id=_key_hash(run_id, *order), run_id=run_id,
                            branch=branch, tasks=tasks, order=order,
                            targets=list(logical.targets),
                            force_channel=self.force_channel,
                            chunk_rows=self.chunk_rows if self.stream else 0)
        self._compute_hints(plan)
        return plan

    # -- placement hints: co-location groups + memory needs --------------------
    def _compute_hints(self, plan: PhysicalPlan) -> None:
        """Group children with their largest parent (locality first — the
        paper's zero-copy win requires co-location), bounded by the biggest
        standing worker's memory. No worker ids are assigned here: the engine
        late-binds each group to a concrete worker at first dispatch."""
        cap = max((w.memory_gb for w in self.workers), default=4.0) * 1e9
        group_bytes: Dict[str, int] = {}
        for tid in plan.order:
            t = plan.tasks[tid]
            need = getattr(t, "estimated_bytes", 0)
            if isinstance(t, FunctionTask):
                need = max(need, int(t.memory_gb * 1e9))
            t.hints.memory_bytes = need
            t.hints.on_demand = need > cap
            group = ""
            # partition tasks read one small slice from EVERY writer — no
            # single parent dominates, and inheriting the largest writer's
            # group would stack all P partitions on one worker; give each
            # its own group so the engine spreads them by load
            inherit = getattr(t, "kind", "") != "partition"
            if inherit and getattr(t, "inputs", None) and not t.hints.on_demand:
                # gathers group with their largest shard: that shard is read
                # zero-copy, only the smaller remote ones pay a flight hop
                parent_groups = sorted(
                    ((plan.tasks[e.parent_task].hints.colocate_group,
                      plan.tasks[e.parent_task].estimated_bytes)
                     for e in t.inputs),
                    key=lambda gv: -gv[1])
                for g, _ in parent_groups:
                    if g and group_bytes.get(g, 0) + need <= cap:
                        group = g
                        break
            if not group:
                group = f"g:{tid}"
            t.hints.colocate_group = group
            group_bytes[group] = group_bytes.get(group, 0) + need
