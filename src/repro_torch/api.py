"""The user-facing SDK — the paper's programming model (§3.3), verbatim shape:

    import repro_torch as bp

    @bp.model()
    @bp.python("3.11", pip={"pandas": "2.0"})
    def euro_selection(
        data=bp.Model(
            "transactions",
            columns=["id", "usd", "country"],
            filter="eventTime BETWEEN 2023-01-01 AND 2023-02-01",
        )
    ):
        ...
        return _df

    @bp.model(materialize=True)
    @bp.python("3.10", pip={"pandas": "1.5.3"})
    def usd_by_country(data=bp.Model("euro_selection")):
        ...
        return _df

    bp.run(project, cluster=...)
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.errors import ContractError
from repro_torch.core.spec import (CombineContract, EnvSpec, ExchangeContract,
                                   FunctionSpec, ModelRef, ResourceHint,
                                   extract_inputs)

_ENV_ATTR = "__repro_env__"
_RES_ATTR = "__repro_resources__"


def _check_keys(keys, what: str) -> tuple:
    keys = tuple(keys)
    if not keys:
        raise ContractError(f"{what} requires at least one key column "
                            "(empty key tuple)", code="BPL202")
    return keys


def _check_aggs(aggs: Dict[str, tuple], what: str) -> dict:
    """Aggs must be {out: (src, fn)} with fn two-phase combinable: anything
    outside compute.AGG_FUNCS (a median, a mode, ...) is holistic — its
    per-shard states don't merge, so declaring it would produce silently
    wrong results (or crash) mid-run."""
    from repro_torch.columnar.compute import AGG_FUNCS

    aggs = dict(aggs)
    for out, spec in aggs.items():
        if not (isinstance(spec, tuple) and len(spec) == 2):
            raise ContractError(
                f"{what} agg {out!r} must be a (source_column, fn) pair, "
                f"got {spec!r}", code="BPL204", column=out)
        src, fn = spec
        if fn not in AGG_FUNCS:
            raise ContractError(
                f"{what} agg {out!r} uses {fn!r}, which is not a "
                f"distributive/algebraic aggregate {AGG_FUNCS} — holistic "
                "aggregations (median, mode, ...) have no mergeable "
                "per-shard state", code="BPL204", column=out)
    return aggs


# ---------------------------------------------------------------------------
# shard-combinable aggregation contracts (map-side combine)
# ---------------------------------------------------------------------------


def combinable(partial: Callable, combine: Callable,
               shard_param: str = "") -> CombineContract:
    """Mark a custom reducer shard-combinable: `partial` (same signature as
    the model function) runs once per shard of the `shard_param` input and
    returns a partial-state dataframe; `combine` merges the ordered list of
    states into the final output. The contract is
    ``fn(concat(shards)) == combine([partial(s) for s in shards])``."""
    return CombineContract("custom", partial, combine, shard_param)


def GroupByCombine(keys: Sequence[str], aggs: Dict[str, tuple],
                   backend: str = "numpy",
                   device: str = "cuda") -> CombineContract:
    """Declare the model as ``compute.group_by(input, keys, aggs)``. The
    planner then aggregates each shard locally (mean as a sum+count pair)
    and merges per-group states at the gather instead of raw rows.
    ``backend="torch"`` routes both halves through the CUDA kernels on
    ``device`` (device aggregation + the combine kernel; ``device="cpu"``
    runs their plain PyTorch versions); numeric results then carry the
    kernels' float32 profile rather than exact numpy bytes. Backend and
    device are part of the contract identity, so result caches never mix
    the kernels' numbers with numpy's or the plain versions'."""
    from repro_torch.columnar import compute

    keys = list(_check_keys(keys, "GroupByCombine"))
    aggs = _check_aggs(aggs, "GroupByCombine")

    def partial(**kw):
        (table,) = kw.values()
        return compute.partial_group_by(table, keys, aggs, backend=backend,
                                        device=device)

    def combine(parts):
        return compute.combine_group_by(parts, keys, aggs, backend=backend,
                                        device=device)

    def merge_states(parts):
        return compute.merge_group_by_states(parts, keys, aggs)

    return CombineContract("group_by", partial, combine,
                           fingerprint=repr((keys, sorted(aggs.items()),
                                             backend, device)),
                           keys=tuple(keys),
                           aggs=tuple(sorted(aggs.items())),
                           merge_states=merge_states)


def JoinCombine(on: Sequence[str], probe: str, how: str = "inner",
                suffix: str = "_r") -> CombineContract:
    """Declare the model as ``compute.hash_join(probe, build, on)`` where
    the `probe` param is the (large, sharded) probe side and the remaining
    input is the small build side, broadcast whole to every shard. Each
    shard probes locally; the combine is an ordered concat (inner only)."""
    from repro_torch.columnar import compute

    on = list(_check_keys(on, "JoinCombine"))
    if how != "inner":
        # the combine is an ordered concat of shard-local probe results; a
        # left join can't tell a local miss from a hit in another shard's
        # build rows, so the concat would fabricate null-padded rows
        raise ContractError("only inner joins are shard-combinable "
                            f"(got how={how!r}); declare bp.JoinExchange "
                            "for left joins", code="BPL205")

    def partial(**kw):
        probe_t = kw.pop(probe)
        if len(kw) != 1:
            raise ValueError(f"JoinCombine needs exactly two inputs, got "
                             f"{[probe] + list(kw)}")
        (build_t,) = kw.values()
        return compute.partial_join(probe_t, build_t, on, how=how,
                                    suffix=suffix)

    # per-chunk probe outputs concat into a valid partial state, so the
    # combine itself doubles as the chunk-fold merge
    return CombineContract("join", partial, compute.combine_join,
                           shard_param=probe,
                           fingerprint=repr((on, probe, how, suffix)),
                           keys=tuple(on),
                           merge_states=compute.combine_join)


def StatsCombine() -> CombineContract:
    """Declare the model as ``compute.stats_table(input)``: per-shard stats
    are already combinable states (null counts add, min of mins, max of
    maxes)."""
    from repro_torch.columnar import compute

    def partial(**kw):
        (table,) = kw.values()
        return compute.partial_stats(table)

    # combine_stats output has the stats schema itself — state-closed, so
    # it merges per-chunk states as readily as per-shard ones
    return CombineContract("column_stats", partial, compute.combine_stats,
                           fingerprint="stats",
                           merge_states=compute.combine_stats)


# ---------------------------------------------------------------------------
# partition exchange (shuffle) contracts
# ---------------------------------------------------------------------------


def exchangeable(partition: Callable, keys: Sequence[str],
                 merge: str = "concat", mode: str = "hash",
                 shard_params: Sequence[str] = (), order_param: str = "",
                 split_param: str = "", descending: bool = False
                 ) -> ExchangeContract:
    """Mark a custom keyed operator partition-exchangeable: `partition`
    (same signature as the model function) runs once per hash/range
    partition of the `shard_params` inputs on `keys` (the rest broadcast
    whole), and the built-in `merge` reassembles the partition outputs.
    The contract is ``fn(inputs) == merge([partition(slice_j(inputs))])``."""
    if merge not in ("concat", "keys", "order"):
        raise ContractError(f"unknown merge {merge!r} (expected 'concat', "
                            "'keys' or 'order')", code="BPL203")
    if mode not in ("hash", "range"):
        raise ContractError(f"unknown mode {mode!r} (expected 'hash' or "
                            "'range')", code="BPL203")
    keys = _check_keys(keys, "exchangeable")
    if split_param and (merge != "order" or not order_param):
        # a row-range sub-split reorders the partition's output relative to
        # an unsplit run; only the "order" merge (hidden __xord__ sort) can
        # restore the exact unsharded row order afterwards. "keys"/"concat"
        # merges over sub-split partials would emit partial groups / broken
        # ranges.
        raise ContractError(
            f"split_param={split_param!r} requires merge='order' with an "
            "order_param (skew re-splits are only order-restorable through "
            "the hidden order column)", code="BPL206", column=split_param)
    return ExchangeContract("custom", keys, partition, merge=merge,
                            mode=mode, shard_params=tuple(shard_params),
                            order_param=order_param, split_param=split_param,
                            descending=descending)


def JoinExchange(on: Sequence[str], probe: str, build: str,
                 how: str = "inner", suffix: str = "_r") -> ExchangeContract:
    """Declare the model as ``compute.hash_join(probe, build, on)`` with
    BOTH sides sharded: each side's shards hash-partition on `on`, and
    partition j joins only the rows whose keys hash to j — including LEFT
    joins, which JoinCombine cannot do (a shard-local probe can't tell a
    local miss from a hit in another shard's build rows, but a
    partition-local probe sees every build row for its keys). The merge
    restores the unsharded row order via hidden order columns the probe
    side's writers stamp; the probe side is also eligible for skew-aware
    row-range re-splits (the build partition is consumed whole per sub)."""
    from repro_torch.columnar import compute

    on = list(_check_keys(on, "JoinExchange"))
    if how not in ("inner", "left"):
        raise ContractError(f"unsupported join {how!r} (expected 'inner' or "
                            "'left')", code="BPL203")

    def partition(**kw):
        probe_t = kw.pop(probe)
        build_t = kw.pop(build)
        if kw:
            raise ValueError(f"JoinExchange needs exactly two inputs, got "
                             f"extra {list(kw)}")
        return compute.join_partition(probe_t, build_t, on, how=how,
                                      suffix=suffix)

    return ExchangeContract("join", tuple(on), partition, merge="order",
                            mode="hash", shard_params=(probe, build),
                            order_param=probe, split_param=probe,
                            fingerprint=repr((on, probe, build, how, suffix)))


def SortExchange(by: Sequence[str],
                 descending: bool = False) -> ExchangeContract:
    """Declare the model as ``compute.sort_by(input, by)``: producer shards
    range-partition on sampled splits of the first sort key, each partition
    sorts locally, and partitions concatenate in index order — a shard-local
    global sort, byte-identical to sorting the gathered table."""
    from repro_torch.columnar import compute

    by = list(_check_keys(by, "SortExchange"))

    def partition(**kw):
        (table,) = kw.values()
        return compute.sort_by(table, by, descending=descending)

    return ExchangeContract("sort", tuple(by), partition, merge="concat",
                            mode="range", descending=descending,
                            fingerprint=repr((by, descending)))


def GroupByExchange(keys: Sequence[str],
                    aggs: Dict[str, tuple]) -> ExchangeContract:
    """Declare the model as ``compute.group_by(input, keys, aggs)`` executed
    per hash partition: partitions hold disjoint key sets, so each group
    aggregates entirely on one worker (exact medians/holistic aggregates
    would be legal here, unlike GroupByCombine's two-phase states) and the
    merge is a stable key sort. Downstream combinables/exchanges chain on
    the partitions without ever gathering raw rows."""
    from repro_torch.columnar import compute

    keys = list(_check_keys(keys, "GroupByExchange"))
    aggs = _check_aggs(aggs, "GroupByExchange")

    def partition(**kw):
        (table,) = kw.values()
        return compute.group_by(table, keys, aggs)

    return ExchangeContract("group_by", tuple(keys), partition, merge="keys",
                            mode="hash",
                            fingerprint=repr((keys, sorted(aggs.items()))),
                            aggs=tuple(sorted(aggs.items())))


def Model(name: str, columns: Optional[Sequence[str]] = None,
          filter: Optional[str] = None) -> ModelRef:
    """Reference a parent dataframe by name, with optional pushdown hints."""
    return ModelRef.create(name, columns, filter)


def _validate_contract_params(spec: FunctionSpec) -> None:
    """Decoration-time check that every input param a contract names exists
    in the model's signature. A contract probing a param the function
    doesn't have is statically DEAD — the planner guard would decline it on
    every run and the model would silently gather forever — so it's an
    error at the `@bp.model` site, named after the offending model.

    Signature-count mismatches (a join contract on a three-input model, an
    unnamed contract on a multi-input model) stay plan-time guard declines:
    `repro.analysis` explain mode reports them as BPL251/BPL252."""
    params = {p for p, _ in spec.inputs}

    def _need(pname: str, what: str) -> None:
        if pname and pname not in params:
            raise ContractError(
                f"model {spec.name!r}: {what}={pname!r} does not name an "
                f"input parameter (has {sorted(params)})",
                code="BPL201", model=spec.name)

    if spec.combinable is not None:
        _need(spec.combinable.shard_param, "shard_param")
    if spec.exchange is not None:
        xc = spec.exchange
        for p in xc.shard_params:
            _need(p, "shard_params entry")
        _need(xc.order_param, "order_param")
        _need(xc.split_param, "split_param")


class Project:
    """A registry of decorated functions — one deployable pipeline codebase."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.functions: Dict[str, FunctionSpec] = {}
        self._lock = threading.Lock()

    # -- decorators ---------------------------------------------------------
    def model(self, name: Optional[str] = None, materialize: bool = False,
              resources: Optional[ResourceHint] = None,
              rowwise: bool = False,
              combinable: Optional[CombineContract] = None,
              exchange: Optional[ExchangeContract] = None) -> Callable:
        """`rowwise=True` declares that every output row depends only on its
        input row (map-style); the planner may then split the function across
        the shards of a large input and merge once downstream.

        `combinable=` declares the function a distributive/algebraic
        aggregation (bp.GroupByCombine / bp.JoinCombine / bp.StatsCombine, or
        bp.combinable for a custom reducer): over a sharded input it runs as
        per-shard partials whose states merge at the gather — the fleet
        aggregates in parallel and only per-group states cross workers.

        `exchange=` declares the function a keyed operator over a hash/range
        partitioning (bp.JoinExchange / bp.SortExchange / bp.GroupByExchange,
        or bp.exchangeable): sharded inputs shuffle into P key-addressed
        partitions and the operator runs once per partition, shard-local end
        to end — raw rows cross workers once, partition-addressed."""
        if combinable is not None and exchange is not None:
            raise ContractError("a model declares combinable= or exchange=, "
                                "not both (the rewrites are exclusive)",
                                code="BPL200")

        def deco(fn: Callable) -> Callable:
            spec = FunctionSpec(
                name=name or fn.__name__,
                fn=fn,
                inputs=extract_inputs(fn),
                env=getattr(fn, _ENV_ATTR, EnvSpec.create()),
                materialize=materialize,
                resources=resources or getattr(fn, _RES_ATTR, ResourceHint()),
                rowwise=rowwise,
                combinable=combinable,
                exchange=exchange,
            )
            _validate_contract_params(spec)
            with self._lock:
                if spec.name in self.functions:
                    raise ValueError(f"duplicate model {spec.name!r} in project "
                                     f"{self.name!r}")
                self.functions[spec.name] = spec
            fn.__repro_spec__ = spec
            return fn

        return deco

    def python(self, version: str = "3.11",
               pip: Optional[Dict[str, str]] = None) -> Callable:
        """Declare the function's runtime environment. MUST be applied under
        @model (closer to the function), matching the paper's listing."""

        def deco(fn: Callable) -> Callable:
            setattr(fn, _ENV_ATTR, EnvSpec.create(version, pip))
            return fn

        return deco

    def resources(self, memory_gb: float = 1.0, cpus: int = 1,
                  device_mesh=None, timeout_s: float = 600.0) -> Callable:
        """Scale-up hint: rerun the same function with different sizing."""

        def deco(fn: Callable) -> Callable:
            setattr(fn, _RES_ATTR, ResourceHint(memory_gb, cpus,
                                                tuple(device_mesh) if device_mesh else None,
                                                timeout_s))
            return fn

        return deco

    # -- queries ---------------------------------------------------------------
    def source_tables(self) -> List[str]:
        produced = set(self.functions)
        refs = {r.name for f in self.functions.values() for _, r in f.inputs}
        return sorted(refs - produced)

    def clear(self) -> None:
        self.functions.clear()


# A module-level default project so the paper's exact snippet works.
_default_project = Project("default")


def default_project() -> Project:
    return _default_project


def model(*args, **kwargs):
    return _default_project.model(*args, **kwargs)


def python(*args, **kwargs):
    return _default_project.python(*args, **kwargs)


def resources(*args, **kwargs):
    return _default_project.resources(*args, **kwargs)


def check(project: Optional[Project] = None, *, catalog=None,
          branch: str = "main", targets: Optional[Sequence[str]] = None,
          sharded: Optional[Sequence[str]] = None):
    """Statically analyze a project without executing it: schema & column
    lineage (pass 1), contract conformance + rewrite-guard explain (pass 2),
    determinism / cache-safety lint (pass 3). Returns a
    ``repro.analysis.Report``; pass a catalog to validate against real
    source-table schemas.

    The analyzer (repro/analysis/) is not ported yet: this raises."""
    raise NotImplementedError(
        "bp.check: the static analyzer is not ported yet "
        "(ROADMAP.md, Queue 1 item 4: repro/analysis/)")


def run(project: Optional[Project] = None, *, catalog=None, cluster=None,
        branch: str = "main", targets: Optional[Sequence[str]] = None,
        client=None, run_id: Optional[str] = None,
        shard_threshold_bytes: Optional[int] = None,
        max_shards: Optional[int] = None,
        validate: str = "off",
        lineage_pushdown: bool = True):
    """Plan + execute a project. Thin wrapper over core.runtime.execute_run.

    ``validate="strict"`` runs the static analyzer first and raises the
    first error-severity diagnostic (PlanError/ContractError/LintError);
    ``"warn"`` reports diagnostics through the client event stream and
    continues; ``"off"`` (default) skips analysis. ``lineage_pushdown``
    lets the analyzer's proven column read sets narrow scans and gathers
    for consumers that declared no ``columns=`` hint."""
    from repro_torch.core.runtime import execute_run

    return execute_run(project or _default_project, catalog=catalog,
                       cluster=cluster, branch=branch, targets=targets,
                       client=client, run_id=run_id,
                       shard_threshold_bytes=shard_threshold_bytes,
                       max_shards=max_shards, validate=validate,
                       lineage_pushdown=lineage_pushdown)


def serve(project: Optional[Project] = None, *, catalog, scratch_root=None,
          cluster=None, source_table: Optional[str] = None,
          target: Optional[str] = None, endpoint: str = "default",
          branch: str = "main", validate: str = "warn",
          idempotent: bool = False, chunk_rows: Optional[int] = None,
          **gateway_kw):
    """Stand up a serving Gateway with this project registered as one
    endpoint — the request-level front door (micro-batching, SLO classes,
    admission control, deadline enforcement, live metrics) over a warm
    cluster.

        gw = bp.serve(project, catalog=catalog, scratch_root="/tmp/bp",
                      source_table="requests")
        ticket = gw.submit("default", request_table, slo="interactive")
        response = ticket.result()        # or: for chunk in ticket.iter_result()

    ``source_table`` is the request seam (defaults to the project's single
    source table when unambiguous); ``idempotent=True`` enables the
    gateway result cache for this endpoint and ``chunk_rows`` makes its
    responses chunk-streamable via ``Ticket.iter_result``; extra keyword
    args are Gateway knobs (max_batch_requests, max_pending, tenant_rate,
    result_cache, ...). Remember to ``gw.close()`` (or use it as a
    context manager).

    The gateway (repro/serving/) is not ported yet: this raises."""
    raise NotImplementedError(
        "bp.serve: the serving gateway is not ported yet "
        "(ROADMAP.md, Queue 1 item 5: repro/serving/)")


def submit(project: Optional[Project] = None, *, cluster,
           branch: str = "main", targets: Optional[Sequence[str]] = None,
           client=None, run_id: Optional[str] = None,
           shard_threshold_bytes: Optional[int] = None,
           max_shards: Optional[int] = None,
           priority: int = 0,
           deadline_s: Optional[float] = None,
           validate: str = "off",
           lineage_pushdown: bool = True):
    """Submit a run without blocking: returns a RunHandle whose `.wait()`
    yields the RunResult. Concurrent submissions share the cluster's worker
    fleet and caches through one event-driven engine (`cluster` may be a
    LocalCluster or a process-isolated remote.RemoteCluster). Scans/row-wise
    functions over `shard_threshold_bytes` split into up to `max_shards`
    shard tasks spread across the fleet. A higher effective `priority`
    (static + aging credit while queued) wins contended worker slots over
    lower-priority concurrent runs; equal priorities break toward the
    earlier `deadline_s` (this run's SLO, in seconds from submission),
    then FIFO. `validate`/`lineage_pushdown` are as in ``bp.run``."""
    from repro_torch.core.runtime import submit_run

    return submit_run(project or _default_project, cluster, branch=branch,
                      targets=targets, client=client, run_id=run_id,
                      shard_threshold_bytes=shard_threshold_bytes,
                      max_shards=max_shards, priority=priority,
                      deadline_s=deadline_s,
                      validate=validate, lineage_pushdown=lineage_pushdown)
