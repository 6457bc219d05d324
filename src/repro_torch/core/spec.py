"""Declarative specs behind the programming model (paper §3.3).

Everything a user *declares* — model inputs, runtime environments, resource
hints — is captured as data. The planner consumes these specs; user code never
touches infrastructure directly (the paper's "principled division of labor").
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.columnar.expr import Expr, parse_predicate


def _stable_hash(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8"))
        h.update(b"\0")
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# environments (paper §4.2: declarative, per-function runtimes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    python_version: str = "3.11"
    pip: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def create(cls, python_version: str = "3.11",
               pip: Optional[Dict[str, str]] = None) -> "EnvSpec":
        return cls(python_version, tuple(sorted((pip or {}).items())))

    @property
    def env_id(self) -> str:
        return _stable_hash(self.python_version,
                            ";".join(f"{n}=={v}" for n, v in self.pip))

    def packages(self) -> List[Tuple[str, str]]:
        return list(self.pip)


# ---------------------------------------------------------------------------
# data references (paper §3.3: inputs are *semantic* dataframes, not files)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelRef:
    """A reference to a parent dataframe by NAME, with optional pushdown hints."""

    name: str
    columns: Optional[Tuple[str, ...]] = None
    filter: Optional[str] = None

    @classmethod
    def create(cls, name: str, columns: Optional[Sequence[str]] = None,
               filter: Optional[Union[str, Expr]] = None) -> "ModelRef":
        if isinstance(filter, Expr):
            filter = repr(filter)
        return cls(name, tuple(columns) if columns is not None else None, filter)

    def predicate(self) -> Optional[Expr]:
        return parse_predicate(self.filter)

    @property
    def ref_id(self) -> str:
        return _stable_hash(self.name, ",".join(self.columns or ()),
                            self.filter or "")


# ---------------------------------------------------------------------------
# resources (paper §2: scale-UP between runs, not horizontal replicas)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceHint:
    """Per-invocation sizing. Ephemeral functions can be re-run with a
    different hint without code changes (the January -> full-year story)."""

    memory_gb: float = 1.0
    cpus: int = 1
    device_mesh: Optional[Tuple[int, ...]] = None  # for model-step nodes
    timeout_s: float = 600.0


# ---------------------------------------------------------------------------
# shard-combinable aggregations (map-side combine)
# ---------------------------------------------------------------------------


# default object reprs embed id(): "<function f at 0x7f...>" — a
# process-specific address. The control plane folds contract_id into the
# plan and a worker daemon recomputes it from its own import; an address in
# the fingerprint would make them disagree forever.
_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def _value_fingerprint(v: object) -> str:
    """Process-stable identity of a closed-over value. Plain repr() fails
    two ways: default reprs embed a memory address (different in every
    process), and large-array reprs elide the middle (edits invisible).
    Functions recurse into their own code fingerprint; buffer-backed values
    (ndarrays) hash their full bytes; anything else gets its repr with
    addresses stripped."""
    if hasattr(v, "__code__"):
        return _code_fingerprint(v)
    tobytes = getattr(v, "tobytes", None)
    if callable(tobytes):
        try:
            return _stable_hash("buf", str(getattr(v, "dtype", "")),
                                str(getattr(v, "shape", "")),
                                hashlib.sha256(tobytes()).hexdigest())
        except Exception:  # noqa: BLE001 — fall back to repr below
            pass
    return _ADDR_RE.sub(" at 0x", repr(v))


def _code_fingerprint(fn: Callable) -> str:
    """Identity of a partial/combine callable. co_code alone is blind to
    edits of literals and closed-over parameters (the usual way a reducer's
    keys/aggs are configured), so constants, names, and closure cells are
    folded in — same rationale as FunctionSpec.code_hash."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return _ADDR_RE.sub(" at 0x", repr(fn))
    consts = repr([c for c in code.co_consts if not inspect.iscode(c)])
    cells = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            cells.append(_value_fingerprint(cell.cell_contents))
        except ValueError:          # empty cell
            cells.append("<empty>")
    return _stable_hash(code.co_code.hex(), consts, repr(code.co_names),
                        repr(cells))


@dataclasses.dataclass(frozen=True)
class CombineContract:
    """User contract that an aggregation distributes over row-wise shards:

        fn(concat(shards), **rest) == combine([partial(s, **rest) for s in shards])

    ``partial`` has the model function's signature and runs once per shard
    of the ``shard_param`` input (the other inputs are broadcast whole);
    ``combine`` takes the ordered list of partial-state tables and produces
    the final output. The planner uses this to rewrite the task into
    per-shard partials plus a CombineTask, so only small aggregation states
    — never raw rows — cross workers at the merge point.
    """

    kind: str                   # "group_by" | "join" | "column_stats" | "custom"
    partial: Callable
    combine: Callable
    shard_param: str = ""       # which input rides the shards ("" = the only one)
    fingerprint: str = ""       # parameter identity (keys/aggs/on/...)
    # structured parameters for static analysis (repro.analysis): group/join
    # keys and the agg map as data, so schema inference never has to parse
    # the fingerprint repr. NOT folded into contract_id — the fingerprint
    # already carries their identity.
    keys: Tuple[str, ...] = ()
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...] = ()
    # optional state-closed merge: merge_states(list_of_states) -> state of
    # the SAME schema (nothing finalized). When present, a partial task may
    # consume its shard as a chunk stream — per-chunk partials fold through
    # this merge, so the shard never materializes whole. Custom reducers
    # without one fall back to whole-shard consumption. Not part of
    # contract_id: it is derived from kind/fingerprint, never user identity.
    merge_states: Optional[Callable] = None

    @property
    def contract_id(self) -> str:
        """Folded into partial-task cache keys: editing the contract must
        invalidate cached partial states even when the model body is
        unchanged."""
        return _stable_hash(self.kind, self.shard_param,
                            self.fingerprint or
                            _code_fingerprint(self.partial) + ":" +
                            _code_fingerprint(self.combine))


# ---------------------------------------------------------------------------
# partition exchange (shuffle) contracts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeContract:
    """User contract that a keyed operator distributes over a hash/range
    partitioning of its inputs on `keys`:

        fn(inputs) == merge([partition(slice_j(inputs)) for j in 0..P))

    where `slice_j` is the j-th partition of every `shard_params` input
    (same keys land in the same j) and `merge` is one of the built-in
    order-normalizing merges. The planner uses this to rewrite
    `sharded producer -> keyed consumer` into per-shard ShuffleWriteTasks
    plus per-partition consumer tasks, so the operator runs shard-local
    end to end and raw rows only ever move once, partition-addressed.

    ``partition`` has the model function's signature (one kwarg per input;
    `shard_params` arrive as that param's partition slice, the rest are
    broadcast whole). ``merge`` names how partition outputs reassemble:

      * "concat" — partitions are contiguous ranges of the output (range
        partitioning / sort_by);
      * "keys"   — stable lexicographic sort on `keys` restores group_by's
        np.unique output order (partitions hold disjoint key sets);
      * "order"  — stable sort on the hidden ``__xmiss__``/``__xord__``
        columns restores the unsharded row order (joins), then the hidden
        columns are dropped.

    ``order_param`` names the input whose original row order must be
    reconstructable at the merge; its shuffle writers append the hidden
    ``__xord__`` column before partitioning. ``split_param`` marks an input
    whose partition slice may be further split by contiguous ROW RANGE
    (skew-aware repartitioning) — legal only when every other input is
    consumed whole per partition and the merge is order-normalizing, which
    in practice means the probe side of a join.
    """

    kind: str                   # "join" | "sort" | "group_by" | "custom"
    keys: Tuple[str, ...]       # partition keys (sort: the sort columns)
    partition: Callable         # per-partition operator (model signature)
    merge: str = "concat"       # "concat" | "keys" | "order"
    mode: str = "hash"          # "hash" | "range" (range samples splits)
    shard_params: Tuple[str, ...] = ()  # exchanged inputs (() = all inputs)
    order_param: str = ""       # input that carries the __xord__ column
    split_param: str = ""       # input eligible for row-range skew splits
    descending: bool = False    # range mode: partition 0 holds the largest
    fingerprint: str = ""       # parameter identity (keys/on/how/...)
    # structured agg map for static analysis (group_by exchanges); not part
    # of contract_id — the fingerprint already carries its identity
    aggs: Tuple[Tuple[str, Tuple[str, str]], ...] = ()

    @property
    def contract_id(self) -> str:
        """Folded into every exchange task's cache key: editing the
        contract must invalidate cached shuffle writes and partitions even
        when the model body is unchanged."""
        return _stable_hash("exchange", self.kind, ",".join(self.keys),
                            self.merge, self.mode,
                            ",".join(self.shard_params), self.order_param,
                            self.split_param, str(self.descending),
                            self.fingerprint or
                            _code_fingerprint(self.partition))


# hidden columns a join exchange threads through its partitions so the
# merge can restore the unsharded row order; stripped before user code or
# run results ever see the table
HIDDEN_ORDER_COLUMN = "__xord__"
HIDDEN_MISS_COLUMN = "__xmiss__"


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FunctionSpec:
    """One user transformation: f(dataframe(s)) -> dataframe."""

    name: str                       # == output table name (paper: "the table
                                    # name is the name of the function")
    fn: Callable
    inputs: Tuple[Tuple[str, ModelRef], ...]  # (param name, ref)
    env: EnvSpec
    materialize: bool = False
    resources: ResourceHint = dataclasses.field(default_factory=ResourceHint)
    # user contract that f(concat(parts)) == concat(f(parts)): each output
    # row depends only on its input row, so the planner may run the function
    # once per input shard and defer the merge downstream
    rowwise: bool = False
    # declared distributive/algebraic aggregation: the planner may execute
    # it as per-shard partials + a combine at the gather point
    combinable: Optional[CombineContract] = None
    # declared keyed operator over a hash/range partitioning: the planner
    # may execute it as shuffle writes + per-partition tasks + a merge
    exchange: Optional[ExchangeContract] = None

    @property
    def code_hash(self) -> str:
        """Hash of the function's code object — drives cache invalidation
        when the user edits business logic (paper §4.2: 'tracks both code
        and data changes')."""
        code = self.fn.__code__
        try:
            src = inspect.getsource(self.fn)
            # hash the function BODY only: decorator lines mention project /
            # registry names that don't affect behaviour
            if "def " in src:
                src = "def " + src.split("def ", 1)[1]
        except (OSError, TypeError):
            src = ""
        consts = repr([c for c in code.co_consts if not inspect.iscode(c)])
        return _stable_hash(src or code.co_code.hex(), consts,
                            repr(code.co_names))

    @property
    def parents(self) -> List[str]:
        return [ref.name for _, ref in self.inputs]

    def signature_id(self) -> str:
        return _stable_hash(self.name, self.code_hash, self.env.env_id,
                            *[r.ref_id for _, r in self.inputs])


def extract_inputs(fn: Callable) -> Tuple[Tuple[str, ModelRef], ...]:
    """DAG topology is implicit in the signature: params whose default is a
    ModelRef are parent dataframes (paper Listing 1)."""
    out = []
    for pname, param in inspect.signature(fn).parameters.items():
        if isinstance(param.default, ModelRef):
            out.append((pname, param.default))
    return tuple(out)
