"""Columnar compute kernels over ColumnTable.

Host (numpy) implementations are the reference path used by pipeline workers.
The hot aggregation / filter kernels also have device paths in
``repro_torch.kernels`` (hand-written CUDA kernels with plain PyTorch
versions); ``backend="torch"`` routes through those wrappers so a worker
placed on a GPU runs the same logical plan on-device. ``device`` picks the
card (``"cuda"``, the default) or the CPU, where the wrappers run the plain
versions. The counterpart of ``repro/columnar/compute.py``, whose
``backend="jax"`` branches sit at the same three places.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from repro_torch.columnar.expr import Expr, parse_predicate
from repro_torch.columnar.table import (Column, ColumnTable, numeric_column,
                                        pack_validity)
# the sharded data plane's single merge point: row-concatenate shard tables
# in order (one-part concat is zero-copy — same Column objects/buffers back)
from repro_torch.columnar.table import concat_tables

AGG_FUNCS = ("sum", "mean", "count", "min", "max")


# ---------------------------------------------------------------------------
# filter / project
# ---------------------------------------------------------------------------


def filter_table(table: ColumnTable, predicate: Union[str, Expr],
                 backend: str = "numpy", device: str = "cuda") -> ColumnTable:
    """Row filter; predicate is an Expr or Bauplan filter string."""
    expr = parse_predicate(predicate)
    if expr is None:
        return table
    mask = np.asarray(expr.evaluate(table), dtype=bool)
    if backend == "torch":
        # Device path: mask+compact through the CUDA compaction kernels for
        # numeric columns; utf8 columns fall back to host gather.
        from repro_torch.kernels import ops as kops

        numeric = {n: table.column(n) for n in table.column_names
                   if table.column(n).kind != "utf8"}
        if numeric:
            idx = np.asarray(kops.compact_indices(mask, device=device))
        else:
            idx = np.nonzero(mask)[0]
        return table.take(idx)
    return table.filter(mask)


def project(table: ColumnTable, columns: Sequence[str]) -> ColumnTable:
    return table.project(columns)


# ---------------------------------------------------------------------------
# sorting
# ---------------------------------------------------------------------------


def _sort_indices(table: ColumnTable, by: Sequence[str],
                  descending: bool = False) -> np.ndarray:
    keys = []
    for name in reversed(list(by)):
        c = table.column(name)
        vals = c.to_numpy()
        if c.kind == "utf8":
            # lexicographic on decoded strings (object array sorts fine)
            vals = np.asarray(vals, dtype=object)
        keys.append(vals)
    idx = np.lexsort(keys)
    return idx[::-1] if descending else idx


def sort_by(table: ColumnTable, by: Sequence[str],
            descending: bool = False) -> ColumnTable:
    return table.take(_sort_indices(table, by, descending))


# ---------------------------------------------------------------------------
# group-by aggregate
# ---------------------------------------------------------------------------


def _encode_keys(table: ColumnTable, keys: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Map group keys to dense integer codes. Returns (codes, first_row_idx)."""
    cols = []
    for k in keys:
        c = table.column(k)
        vals = c.to_numpy()
        cols.append(np.asarray(vals, dtype=object) if c.kind == "utf8" else vals)
    if len(cols) == 1:
        uniques, codes = np.unique(cols[0], return_inverse=True)
        first = np.zeros(len(uniques), dtype=np.int64)
        seen = np.full(len(uniques), -1, dtype=np.int64)
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        boundaries = np.searchsorted(sorted_codes, np.arange(len(uniques)))
        first = order[boundaries]
        del seen
        return codes, first
    # multi-key: build structured codes via successive uniquification
    combined = np.zeros(table.num_rows, dtype=np.int64)
    for c in cols:
        _, sub = np.unique(c, return_inverse=True)
        combined = combined * (sub.max(initial=0) + 1) + sub
    uniques, codes = np.unique(combined, return_inverse=True)
    order = np.argsort(codes, kind="stable")
    boundaries = np.searchsorted(codes[order], np.arange(len(uniques)))
    first = order[boundaries]
    return codes, first


def group_by(table: ColumnTable, keys: Sequence[str],
             aggs: Dict[str, Tuple[str, str]],
             backend: str = "numpy", device: str = "cuda") -> ColumnTable:
    """Group-by aggregate.

    aggs maps output column name -> (input column, agg func). Example::

        group_by(t, ["country"], {"total_usd": ("usd", "sum")})

    Output rows are ordered by first appearance? No — by key code order
    (np.unique order), which is deterministic; tests rely on determinism
    only.
    """
    if table.num_rows == 0:
        # an exchange partition may be legitimately empty; its aggregate
        # dtypes must match the non-empty partitions' (count is always
        # int64, int sum/min/max stay int64) or the partition merge would
        # silently promote the whole column to float64
        data = {k: table.column(k).take(np.array([], np.int64)) for k in keys}
        for out_name, (src, fn) in aggs.items():
            is_int = (fn == "count"
                      or (fn in ("sum", "min", "max")
                          and np.issubdtype(table.column(src).dtype,
                                            np.integer)))
            data[out_name] = numeric_column(
                np.array([], dtype=np.int64 if is_int else np.float64))
        return ColumnTable(data)
    codes, first = _encode_keys(table, keys)
    n_groups = len(first)
    out: Dict[str, Column] = {k: table.column(k).take(first) for k in keys}
    for out_name, (src, fn) in aggs.items():
        if fn not in AGG_FUNCS:
            raise ValueError(f"unknown agg {fn!r}; supported: {AGG_FUNCS}")
        if fn == "count":
            out[out_name] = numeric_column(np.bincount(codes, minlength=n_groups)
                                           .astype(np.int64))
            continue
        src_col = table.column(src)
        vals = src_col.data.astype(np.float64)
        if backend == "torch":
            from repro_torch.kernels import ops as kops

            agg = kops.groupby_aggregate(vals, codes, n_groups, fn,
                                         device=device).cpu().numpy()
        else:
            if fn in ("sum", "mean"):
                sums = np.bincount(codes, weights=vals, minlength=n_groups)
                if fn == "sum":
                    agg = sums
                else:
                    counts = np.bincount(codes, minlength=n_groups)
                    agg = sums / np.maximum(counts, 1)
            elif fn in ("min", "max"):
                init = np.inf if fn == "min" else -np.inf
                agg = np.full(n_groups, init, dtype=np.float64)
                ufunc = np.minimum if fn == "min" else np.maximum
                ufunc.at(agg, codes, vals)
        if np.issubdtype(src_col.dtype, np.integer) and fn in ("sum", "min", "max"):
            agg = agg.astype(np.int64)
        out[out_name] = numeric_column(agg)
    return ColumnTable(out)


# ---------------------------------------------------------------------------
# map-side combine: partial/combine state pairs (shard-aware aggregation)
# ---------------------------------------------------------------------------
#
# Contract: for any row-wise split of a table into ordered shards,
#
#     combine_group_by([partial_group_by(s, keys, aggs) for s in shards],
#                      keys, aggs)  ==  group_by(concat(shards), keys, aggs)
#
# Distributive aggs (sum/count/min/max) carry their own value as state;
# algebraic mean decomposes into a (sum, count) pair and is finalized only
# at the combine — so a sharded producer's aggregation runs shard-local and
# only tiny per-group states cross workers, never raw rows.


def _state_aggs(aggs: Dict[str, Tuple[str, str]]) -> Dict[str, Tuple[str, str]]:
    """Per-shard state columns for an agg set (mean -> sum+count pair).
    ``<out>__sum`` / ``<out>__count`` are reserved for a mean's state; an
    output name colliding with them would silently overwrite the state and
    finalize the mean from the wrong column, so it's rejected here."""
    state: Dict[str, Tuple[str, str]] = {}
    for out, (src, fn) in aggs.items():
        if fn not in AGG_FUNCS:
            raise ValueError(f"unknown agg {fn!r}; supported: {AGG_FUNCS}")
        if fn == "mean":
            for suffix in ("__sum", "__count"):
                if f"{out}{suffix}" in aggs:
                    raise ValueError(
                        f"agg name {out + suffix!r} collides with mean "
                        f"{out!r}'s partial state; rename one of them")
            state[f"{out}__sum"] = (src, "sum")
            state[f"{out}__count"] = (src, "count")
        else:
            state[out] = (src, fn)
    return state


def partial_group_by(table: ColumnTable, keys: Sequence[str],
                     aggs: Dict[str, Tuple[str, str]],
                     backend: str = "numpy", device: str = "cuda") -> ColumnTable:
    """Shard-local aggregation state: one row per key present in the shard."""
    return group_by(table, keys, _state_aggs(aggs), backend=backend,
                    device=device)


def combine_group_by(parts: Sequence[ColumnTable], keys: Sequence[str],
                     aggs: Dict[str, Tuple[str, str]],
                     backend: str = "numpy", device: str = "cuda") -> ColumnTable:
    """Merge per-shard partial states into the final aggregate.

    Re-groups the concatenated state rows over the key union (sum of sums,
    sum of counts, min of mins, max of maxes); key order is np.unique order,
    identical to the unsharded ``group_by`` over the same rows. mean is
    finalized here as total_sum / total_count, guarded so a group fed only
    by empty shards (count 0) never divides by zero.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("combine of zero partial states")
    nonempty = [p for p in parts if p.num_rows]
    if not nonempty:
        # every shard was empty: mirror group_by's empty-table branch exactly
        # — including its dtypes (count is int64, int sum/min/max stay int64;
        # the empty partial states already carry those dtypes, mean has no
        # state column of its own and finalizes to float64)
        data = {k: parts[0].column(k) for k in keys}
        for out, (_, fn) in aggs.items():
            dtype = (np.float64 if fn == "mean"
                     else parts[0].column(out).dtype)
            data[out] = numeric_column(np.array([], dtype=dtype))
        return ColumnTable(data)
    state = concat_tables(nonempty)
    merge_aggs: Dict[str, Tuple[str, str]] = {}
    for out, (_, fn) in aggs.items():
        if fn == "mean":
            merge_aggs[f"{out}__sum"] = (f"{out}__sum", "sum")
            merge_aggs[f"{out}__count"] = (f"{out}__count", "sum")
        elif fn == "count":
            merge_aggs[out] = (out, "sum")      # counts add up
        else:
            merge_aggs[out] = (out, fn)         # sum->sum, min->min, max->max
    if backend == "torch" and state.num_rows:
        merged = _combine_states_torch(nonempty, state, keys, merge_aggs,
                                       device)
    else:
        merged = group_by(state, keys, merge_aggs)
    out_cols: Dict[str, Column] = {k: merged.column(k) for k in keys}
    for out, (_, fn) in aggs.items():
        if fn == "mean":
            sums = merged.column(f"{out}__sum").data.astype(np.float64)
            counts = merged.column(f"{out}__count").data.astype(np.float64)
            out_cols[out] = numeric_column(sums / np.maximum(counts, 1.0))
        else:
            out_cols[out] = merged.column(out)
    return ColumnTable(out_cols)


def _combine_states_torch(parts: Sequence[ColumnTable], state: ColumnTable,
                          keys: Sequence[str],
                          merge_aggs: Dict[str, Tuple[str, str]],
                          device: str) -> ColumnTable:
    """Device path for the state merge: keys are aligned on host (cheap
    metadata — at most one state row per key per shard), then each agg
    column is scattered into a dense (parts, groups) matrix and reduced
    across the part axis by the CUDA combine kernel."""
    from repro_torch.kernels import ops as kops

    codes, first = _encode_keys(state, keys)
    n_groups = len(first)
    # `state` is the parts concatenated in shard order; each state row's part
    # index makes every (part, group) cell a single writer
    row_part = np.repeat(np.arange(len(parts)),
                         [p.num_rows for p in parts])
    out: Dict[str, Column] = {k: state.column(k).take(first) for k in keys}
    for out_name, (src, fn) in merge_aggs.items():
        src_col = state.column(src)
        vals = src_col.data.astype(np.float64)
        neutral = {"sum": 0.0, "min": np.inf, "max": -np.inf}[fn]
        dense = np.full((len(parts), n_groups), neutral, dtype=np.float64)
        dense[row_part, codes] = vals
        agg = kops.combine_aggregate(dense, n_groups, fn,
                                     device=device).cpu().numpy()
        if np.issubdtype(src_col.dtype, np.integer):
            agg = agg.astype(np.int64)
        out[out_name] = numeric_column(agg)
    return ColumnTable(out)


def partial_join(probe: ColumnTable, build: ColumnTable, on: Sequence[str],
                 how: str = "inner", suffix: str = "_r") -> ColumnTable:
    """Per-shard probe of the broadcast build side. Only inner joins are
    combinable by concatenation: ``hash_join`` appends left-join misses
    after all matches, so per-shard left joins would interleave misses."""
    if how != "inner":
        raise ValueError("only inner joins are shard-combinable")
    return hash_join(probe, build, on, how=how, suffix=suffix)


def combine_join(parts: Sequence[ColumnTable]) -> ColumnTable:
    """Probe outputs ride the shard order, so the ordered concat is exactly
    the unsharded join's row order (inner join output follows probe order)."""
    return concat_tables(list(parts))


# ---------------------------------------------------------------------------
# chunk-incremental compute (streaming data plane)
# ---------------------------------------------------------------------------
# Streamed shards arrive as fixed-size row chunks. Rowwise functions apply
# chunk-by-chunk (their contract distributes over any row split); partial
# aggregations fold per-chunk states with a state-level merge that never
# finalizes (mean keeps its __sum/__count pair), so nothing in the streamed
# path ever concatenates the full input table.


def iter_table_chunks(table: ColumnTable, chunk_rows: int):
    """Yield zero-copy row slices of at most ``chunk_rows`` rows. Always
    yields at least one chunk — an empty table streams as one empty chunk so
    the downstream handle still carries the schema."""
    if chunk_rows <= 0 or table.num_rows <= chunk_rows:
        yield table
        return
    for start in range(0, table.num_rows, chunk_rows):
        yield table.slice(start, min(chunk_rows, table.num_rows - start))


def apply_rowwise_chunks(fn, chunks):
    """Apply a rowwise function to each chunk of a stream. By the rowwise
    contract ``fn(concat(chunks)) == concat(fn(chunks))``, so the chunked
    output concatenates byte-identically to the materialized path."""
    for chunk in chunks:
        yield fn(chunk)


def merge_group_by_states(parts: Sequence[ColumnTable], keys: Sequence[str],
                          aggs: Dict[str, Tuple[str, str]]) -> ColumnTable:
    """Merge ``partial_group_by`` states into one state of the SAME schema —
    unlike ``combine_group_by`` nothing is finalized (a mean's __sum/__count
    pair stays a pair), so the result can keep folding with later chunk
    states or feed the ordinary combine downstream."""
    parts = list(parts)
    if not parts:
        raise ValueError("merge of zero partial states")
    nonempty = [p for p in parts if p.num_rows]
    if not nonempty:
        return parts[0]
    if len(nonempty) == 1:
        return nonempty[0]
    merge_aggs: Dict[str, Tuple[str, str]] = {}
    for out, (_, fn) in aggs.items():
        if fn == "mean":
            merge_aggs[f"{out}__sum"] = (f"{out}__sum", "sum")
            merge_aggs[f"{out}__count"] = (f"{out}__count", "sum")
        elif fn == "count":
            merge_aggs[out] = (out, "sum")      # counts add up
        else:
            merge_aggs[out] = (out, fn)         # sum->sum, min->min, max->max
    return group_by(concat_tables(nonempty), keys, merge_aggs)


def fold_partial_states(states: Sequence[ColumnTable],
                        merge) -> ColumnTable:
    """Collapse per-chunk partial states with a state-closed merge. States
    are one row per key (or one row per column for stats) — holding all of
    them is cheap; the single merge keeps float accumulation order identical
    to merging the same states at a combine point."""
    states = list(states)
    if not states:
        raise ValueError("fold of zero partial states")
    if len(states) == 1:
        return states[0]
    return merge(states)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------


class _NullKey:
    """Stand-in for a null utf8 join/sort key inside object arrays: totally
    ordered below every string (so np.unique / argsort work) and equal only
    to itself — the module singleton — which reproduces Python `None`
    semantics in the dict-based join this vectorized path replaced."""

    __slots__ = ()

    def __lt__(self, other):
        return other is not self

    def __gt__(self, other):
        return False

    def __le__(self, other):
        return True

    def __ge__(self, other):
        return other is self

    def __repr__(self):
        return "<null>"


_NULL_KEY = _NullKey()


def _object_keys(col: Column) -> np.ndarray:
    vals = np.asarray(col.to_numpy(), dtype=object)
    if col.null_count:
        vals = np.array([v if v is not None else _NULL_KEY for v in vals],
                        dtype=object)
    return vals


def _join_codes(left: ColumnTable, right: ColumnTable,
                on: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Dense integer key codes over the union of both sides: equal keys get
    equal codes. Keys containing NaN never match anything (float NaN compares
    unequal to itself, so the row-loop join this replaces never matched
    them); null utf8 keys match each other (`None` is a singleton)."""
    nl, nr = left.num_rows, right.num_rows
    combined = np.zeros(nl + nr, dtype=np.int64)
    nan_mask = np.zeros(nl + nr, dtype=bool)
    for k in on:
        cl, cr = left.column(k), right.column(k)
        if cl.kind == "utf8" or cr.kind == "utf8":
            arr = np.concatenate([_object_keys(cl), _object_keys(cr)])
        else:
            arr = np.concatenate([np.asarray(cl.to_numpy()),
                                  np.asarray(cr.to_numpy())])
            if np.issubdtype(arr.dtype, np.floating):
                nan_mask |= np.isnan(arr)
        _, sub = np.unique(arr, return_inverse=True)
        combined = combined * (sub.max(initial=0) + 1) + sub
    lc, rc = combined[:nl].copy(), combined[nl:].copy()
    lc[nan_mask[:nl]] = -1      # NaN keys: distinct sentinels per side so
    rc[nan_mask[nl:]] = -2      # they never pair up
    return lc, rc


def _join_indices(left: ColumnTable, right: ColumnTable, on: Sequence[str],
                  how: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized build-and-probe: sort the right side's key codes once,
    then binary-search every left code into it. Returns (li, ri, lmiss)
    where (li, ri) are the match pairs ordered exactly like the row-loop
    join they replace — left rows in order, each left row's matches in
    right-row order — and lmiss are the unmatched left rows (left joins)."""
    if how not in ("inner", "left"):
        raise ValueError("how must be inner|left")
    lc, rc = _join_codes(left, right, on)
    order_r = np.argsort(rc, kind="stable")
    rc_sorted = rc[order_r]
    start = np.searchsorted(rc_sorted, lc, side="left")
    counts = np.searchsorted(rc_sorted, lc, side="right") - start
    li = np.repeat(np.arange(left.num_rows, dtype=np.int64), counts)
    total = int(counts.sum())
    # flatten the per-left-row [start, start+count) ranges into one gather
    offsets = np.concatenate([[0], np.cumsum(counts)])
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(offsets[:-1], counts)
            + np.repeat(start, counts))
    ri = order_r[flat]
    if how == "left":
        lmiss = np.nonzero(counts == 0)[0].astype(np.int64)
    else:
        lmiss = np.array([], dtype=np.int64)
    return li, ri, lmiss


def _assemble_join(left: ColumnTable, right: ColumnTable, on: Sequence[str],
                   li: np.ndarray, ri: np.ndarray, lmiss: np.ndarray,
                   suffix: str) -> ColumnTable:
    li_arr = np.concatenate([li, lmiss]).astype(np.int64)
    ri_arr = np.asarray(ri, dtype=np.int64)
    out = {n: left.column(n).take(li_arr) for n in left.column_names}
    n_miss = len(lmiss)
    for n in right.column_names:
        if n in on:
            continue
        name = n if n not in out else n + suffix
        c = right.column(n).take(ri_arr)
        if n_miss:
            # pad left-join misses with nulls
            pad_valid = np.concatenate([c.valid_mask(), np.zeros(n_miss, bool)])
            if c.kind == "utf8":
                from repro_torch.columnar.table import utf8_column

                vals = list(c.to_numpy()) + [None] * n_miss
                c = utf8_column(vals)
            else:
                data = np.concatenate([c.data, np.zeros(n_miss, c.data.dtype)])
                c = Column(c.kind, data, None, pack_validity(pad_valid))
        out[name] = c
    return ColumnTable(out)


def hash_join(left: ColumnTable, right: ColumnTable, on: Sequence[str],
              how: str = "inner", suffix: str = "_r") -> ColumnTable:
    """Hash join on equal column names. Supports inner and left joins.
    Output order matches the historical row-loop implementation byte for
    byte: left rows in order, each left row's matches in right-row order,
    left-join misses appended at the end (right columns null-padded)."""
    li, ri, lmiss = _join_indices(left, right, on, how)
    return _assemble_join(left, right, on, li, ri, lmiss, suffix)


# ---------------------------------------------------------------------------
# partition exchange (shuffle): hash/range partitioning + order-normalized
# merges. The partitioner is a STABLE argsort on partition codes, so rows
# sharing a partition keep their relative input order — which is what makes
# sharded group_by sums bit-identical (same per-group add order) and lets
# the join merge reconstruct the unsharded row order from a single hidden
# order column.
# ---------------------------------------------------------------------------


# hidden column names threaded through join-exchange partitions (mirrors
# repro.core.spec; duplicated literal so columnar stays core-free)
HIDDEN_ORDER_COLUMN = "__xord__"
HIDDEN_MISS_COLUMN = "__xmiss__"

_SPLITMIX_A = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_B = np.uint64(0x94D049BB133111EB)
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (wrapping arithmetic)."""
    h = h ^ (h >> np.uint64(30))
    h = h * _SPLITMIX_A
    h = h ^ (h >> np.uint64(27))
    h = h * _SPLITMIX_B
    return h ^ (h >> np.uint64(31))


def _hash_codes(table: ColumnTable, keys: Sequence[str],
                salt: int = 0) -> np.ndarray:
    """Content-based, process-stable uint64 hash per row over `keys`.
    Equal key VALUES must hash equally everywhere — across shards, workers,
    processes and reruns — or a key's rows land in different partitions and
    the exchange silently loses matches. So: no PYTHONHASHSEED-dependent
    hash(), float keys are canonicalized (-0.0 -> +0.0, one NaN bit
    pattern), and utf8 hashes its bytes (crc32 per unique value, mapped
    through np.unique codes so the Python loop is O(distinct), not O(rows))."""
    import zlib

    seed = (salt * _GOLDEN + _GOLDEN) & 0xFFFFFFFFFFFFFFFF
    h = np.full(table.num_rows, seed, dtype=np.uint64)
    for k in keys:
        c = table.column(k)
        if c.kind == "utf8":
            uniq, codes = np.unique(_object_keys(c), return_inverse=True)
            uh = np.empty(len(uniq), dtype=np.uint64)
            for i, u in enumerate(uniq):
                uh[i] = (zlib.crc32(u.encode("utf-8")) if isinstance(u, str)
                         else 0x9E3779B9)    # null key: fixed sentinel
            x = uh[codes]
        else:
            a = np.asarray(c.to_numpy())
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float64, copy=True)
                a[a == 0.0] = 0.0           # -0.0 == +0.0: same partition
                a[np.isnan(a)] = np.nan     # canonical NaN bits
                x = a.view(np.uint64)
            elif a.dtype == np.bool_:
                x = a.astype(np.uint64)
            else:
                x = a.astype(np.int64).view(np.uint64)
        h = _mix64(h ^ (x * _SPLITMIX_A))
    return h


def _partition_by_codes(table: ColumnTable, codes: np.ndarray,
                        num_partitions: int) -> List[ColumnTable]:
    """Split by precomputed partition codes with ONE stable reorder: rows
    within each partition keep their input order, and the parts are
    zero-copy slices of a single reordered table."""
    order = np.argsort(codes, kind="stable")
    bounds = np.searchsorted(codes[order], np.arange(num_partitions + 1))
    reordered = table.take(order)
    return [reordered.slice(int(bounds[j]), int(bounds[j + 1] - bounds[j]))
            for j in range(num_partitions)]


def hash_partition(table: ColumnTable, keys: Sequence[str],
                   num_partitions: int, salt: int = 0) -> List[ColumnTable]:
    """Partition rows by key hash: every row with the same key lands in the
    same partition index on every shard (content-based hash)."""
    P = int(num_partitions)
    if table.num_rows == 0:
        return [table.slice(0, 0) for _ in range(P)]
    codes = (_hash_codes(table, keys, salt) % np.uint64(P)).astype(np.int64)
    return _partition_by_codes(table, codes, P)


def sample_splits(tables: Sequence[ColumnTable], by: Sequence[str],
                  num_partitions: int,
                  max_samples_per_part: int = 4096) -> ColumnTable:
    """Range-partition boundaries from a deterministic evenly-spaced sample
    of the FIRST sort key across all shards. Returns a one-column table
    (``split``, ascending, deduplicated) with at most P-1 rows; fewer
    (skewed or tiny inputs) just leaves trailing partitions empty —
    correctness never depends on split quality, only balance does."""
    key = by[0]
    samples: List[np.ndarray] = []
    kind = None
    for t in tables:
        c = t.column(key)
        kind = c.kind
        v = (np.asarray(c.to_numpy(), dtype=object) if c.kind == "utf8"
             else np.asarray(c.to_numpy()))
        if len(v) > max_samples_per_part:
            idx = np.linspace(0, len(v) - 1, max_samples_per_part)
            v = v[idx.astype(np.int64)]
        samples.append(v)
    allv = np.concatenate(samples) if samples else np.array([])
    if allv.size == 0:
        return ColumnTable({"split": numeric_column(np.array([], np.float64))})
    s = np.sort(allv, kind="stable")
    pos = [len(s) * j // num_partitions for j in range(1, num_partitions)]
    splits = np.unique(s[pos]) if pos else s[:0]
    from repro_torch.columnar.table import column_from_values

    return ColumnTable({"split": column_from_values(list(splits))})


def range_partition(table: ColumnTable, by: Sequence[str],
                    splits: ColumnTable,
                    descending: bool = False) -> List[ColumnTable]:
    """Partition rows into contiguous ranges of the FIRST sort key at the
    sampled split boundaries. One consistent searchsorted side means rows
    with equal first keys always share a partition — so a per-partition
    stable lexsort on the full key list, concatenated in partition order,
    is byte-identical to the global stable sort. `num_partitions` is
    len(splits)+1; descending reverses the partition order so partition 0
    holds the largest keys."""
    P = splits.num_rows + 1
    if table.num_rows == 0:
        return [table.slice(0, 0) for _ in range(P)]
    c = table.column(by[0])
    v = (np.asarray(c.to_numpy(), dtype=object) if c.kind == "utf8"
         else np.asarray(c.to_numpy()))
    sc = splits.column("split")
    sv = (np.asarray(sc.to_numpy(), dtype=object) if c.kind == "utf8"
          else np.asarray(sc.to_numpy()))
    codes = np.searchsorted(sv, v, side="right").astype(np.int64)
    if descending:
        codes = (P - 1) - codes
    return _partition_by_codes(table, codes, P)


def join_partition(left: ColumnTable, right: ColumnTable, on: Sequence[str],
                   how: str = "inner", suffix: str = "_r") -> ColumnTable:
    """One shuffle partition of a distributed join. `left` carries the
    hidden ``__xord__`` column its shuffle writers attached (the global
    probe-row order key); the output threads it through — plus a
    ``__xmiss__`` flag — so ``merge_partitions(mode="order")`` can restore
    the exact unsharded join row order (matches by probe order, left-join
    misses appended at the end)."""
    ordv = left.column(HIDDEN_ORDER_COLUMN).data
    lclean = left.project([n for n in left.column_names
                           if n != HIDDEN_ORDER_COLUMN])
    li, ri, lmiss = _join_indices(lclean, right, on, how)
    out = _assemble_join(lclean, right, on, li, ri, lmiss, suffix)
    li_arr = np.concatenate([li, lmiss]).astype(np.int64)
    out = out.with_column(HIDDEN_ORDER_COLUMN,
                          numeric_column(ordv[li_arr].astype(np.int64)))
    miss = np.concatenate([np.zeros(len(li), np.int64),
                           np.ones(len(lmiss), np.int64)])
    return out.with_column(HIDDEN_MISS_COLUMN, numeric_column(miss))


def merge_partitions(parts: Sequence[ColumnTable], mode: str,
                     keys: Sequence[str] = ()) -> ColumnTable:
    """Reassemble partition outputs into the byte-identical unsharded
    result. "concat": partitions are contiguous output ranges (range
    partitioning / sort). "keys": stable lexsort on `keys` — partitions
    hold disjoint key sets, each internally in np.unique order, so the
    sort restores group_by's global key order. "order": stable sort on the
    hidden (miss, order) columns restores join row order, then drops them."""
    t = concat_tables(list(parts))
    if mode == "concat":
        return t
    if mode == "keys":
        return t.take(_sort_indices(t, list(keys)))
    if mode == "order":
        ordv = t.column(HIDDEN_ORDER_COLUMN).data
        if HIDDEN_MISS_COLUMN in t:
            idx = np.lexsort((ordv, t.column(HIDDEN_MISS_COLUMN).data))
        else:
            idx = np.argsort(ordv, kind="stable")
        t = t.take(idx)
        return t.project([n for n in t.column_names
                          if n not in (HIDDEN_ORDER_COLUMN,
                                       HIDDEN_MISS_COLUMN)])
    raise ValueError(f"unknown merge mode {mode!r}")


# ---------------------------------------------------------------------------
# table stats (feed Iceberg-style manifests)
# ---------------------------------------------------------------------------


def stats_table(table: ColumnTable) -> ColumnTable:
    """``column_stats`` as a dataframe (one row per column, schema order):
    ``column`` / ``null_count`` / ``min`` / ``max``. Numeric min/max only;
    utf8 and all-null columns carry NaN. This tabular form is what pipeline
    models return (functions map dataframes to dataframes) and is itself a
    combinable aggregation state: see ``combine_stats``."""
    from repro_torch.columnar.table import utf8_column

    names = table.column_names
    nulls = np.zeros(len(names), dtype=np.int64)
    mins = np.full(len(names), np.nan)
    maxs = np.full(len(names), np.nan)
    for i, name in enumerate(names):
        c = table.column(name)
        nulls[i] = c.null_count
        mask = c.valid_mask()
        if c.kind != "utf8" and mask.any():
            v = c.to_numpy()[mask]
            mins[i] = float(v.min())
            maxs[i] = float(v.max())
    return ColumnTable({"column": utf8_column(list(names)),
                        "null_count": numeric_column(nulls),
                        "min": numeric_column(mins),
                        "max": numeric_column(maxs)})


# a shard's stats ARE its aggregation state — no separate encoding needed
partial_stats = stats_table


def combine_stats(parts: Sequence[ColumnTable]) -> ColumnTable:
    """Merge per-shard ``stats_table`` outputs: null counts add, mins take
    the min of mins, maxes the max of maxes. NaN marks "no value" (empty or
    utf8 column in that shard) and is ignored unless every shard agrees."""
    parts = list(parts)
    if not parts:
        raise ValueError("combine of zero stats parts")
    base = parts[0]
    for p in parts[1:]:
        if p.column("column").to_numpy().tolist() != \
                base.column("column").to_numpy().tolist():
            raise ValueError("stats parts disagree on column set")
    nulls = np.sum([p.column("null_count").data for p in parts], axis=0)
    mins = np.fmin.reduce([p.column("min").data for p in parts])
    maxs = np.fmax.reduce([p.column("max").data for p in parts])
    return ColumnTable({"column": base.column("column"),
                        "null_count": numeric_column(nulls.astype(np.int64)),
                        "min": numeric_column(mins),
                        "max": numeric_column(maxs)})


def column_stats(table: ColumnTable) -> Dict[str, Dict]:
    stats: Dict[str, Dict] = {}
    for name in table.column_names:
        c = table.column(name)
        entry: Dict = {"null_count": c.null_count}
        vals = c.to_numpy()
        mask = c.valid_mask()
        if c.kind != "utf8" and mask.any():
            v = vals[mask]
            entry["min"] = v.min().item()
            entry["max"] = v.max().item()
        elif c.kind == "utf8" and mask.any():
            v = [x for x, m in zip(vals, mask) if m]
            entry["min"] = min(v)
            entry["max"] = max(v)
        stats[name] = entry
    return stats
