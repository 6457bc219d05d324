"""Plain PyTorch versions of the data kernels (the correctness contract).

The counterpart of ``repro/kernels/ref.py`` (its pure-jnp oracles
``ref_groupby``, ``ref_combine`` and ``ref_compact``), plus the plain
versions of the two compaction passes. The kernel wrappers take these only
for tensors on the CPU; ``chip_smoke.py`` also runs them on the card to hold
each kernel against them. They are written from tensor operations, never
from the single PyTorch call (``nonzero``, ``scatter_reduce``) that the
kernels are timed against.
"""
from __future__ import annotations

from typing import Tuple

import torch

_NEUTRAL = {"sum": 0.0, "count": 0.0, "min": float("inf"),
            "max": float("-inf")}


# ---------------------------------------------------------------------------
# group-by aggregation
# ---------------------------------------------------------------------------


def ref_groupby(values: torch.Tensor, codes: torch.Tensor, n_groups: int,
                fn: str = "sum") -> torch.Tensor:
    """values: (N,) float, codes: (N,) int -> (n_groups,) float32. Codes
    outside [0, n_groups) are dropped; empty groups hold the neutral element
    (mean: 0). Rows are sorted by code so each group is one contiguous
    segment: sums come from a float64 running sum, min / max from the ends
    of each segment sorted by value."""
    if fn not in ("sum", "count", "mean", "min", "max"):
        raise ValueError(fn)
    vals = values.to(torch.float32)
    n = vals.shape[0]
    if n == 0:
        return torch.full((n_groups,), _NEUTRAL.get(fn, 0.0),
                          dtype=torch.float32, device=vals.device)
    codes = codes.to(torch.int64)
    # out-of-range rows go to one extra segment that is sliced off
    c = torch.where((codes >= 0) & (codes < n_groups), codes,
                    torch.full_like(codes, n_groups))
    if fn in ("min", "max"):
        by_val = torch.argsort(vals, stable=True)
        order = by_val[torch.argsort(c[by_val], stable=True)]
    else:
        order = torch.argsort(c, stable=True)
    sc = c[order]
    groups = torch.arange(n_groups + 2, device=vals.device)
    bounds = torch.searchsorted(sc, groups)            # segment starts
    starts, ends = bounds[:n_groups], bounds[1:n_groups + 1]
    if fn in ("min", "max"):
        sv = vals[order]
        present = ends > starts
        if fn == "min":
            pick = sv[starts.clamp(max=n - 1)]
        else:
            pick = sv[(ends - 1).clamp(min=0)]
        return torch.where(present, pick,
                           torch.full_like(pick, _NEUTRAL[fn]))
    counts = (ends - starts).to(torch.float32)
    if fn == "count":
        return counts
    run = torch.zeros(n + 1, dtype=torch.float64, device=vals.device)
    run[1:] = torch.cumsum(vals[order].to(torch.float64), 0)
    sums = (run[ends] - run[starts]).to(torch.float32)
    if fn == "sum":
        return sums
    return sums / torch.clamp(counts, min=1.0)


def ref_combine(parts: torch.Tensor, fn: str = "sum") -> torch.Tensor:
    """parts (P, G) per-shard partial aggregates -> (G,) merged
    (neutral-filled cells for absent groups): a loop over the parts, as the
    kernel's threads loop over P."""
    if fn not in _NEUTRAL:
        raise ValueError(fn)
    parts = parts.to(torch.float32)
    acc = torch.full((parts.shape[1],), _NEUTRAL[fn], dtype=torch.float32,
                     device=parts.device)
    for row in parts:
        if fn in ("sum", "count"):
            acc = acc + row
        elif fn == "min":
            acc = torch.minimum(acc, row)
        else:
            acc = torch.maximum(acc, row)
    return acc


# ---------------------------------------------------------------------------
# filter compaction
# ---------------------------------------------------------------------------


def ref_block_counts(mask: torch.Tensor, block_n: int) -> torch.Tensor:
    """Survivors of each block of ``block_n`` rows (the last may be short)
    -> (ceil(N / block_n),) int32."""
    n = mask.shape[0]
    n_blocks = -(-n // block_n)
    padded = torch.zeros(n_blocks * block_n, dtype=torch.int32,
                         device=mask.device)
    padded[:n] = mask.to(torch.int32)
    return padded.view(n_blocks, block_n).sum(1, dtype=torch.int32)


def ref_block_compact(mask: torch.Tensor, offsets: torch.Tensor,
                      block_n: int) -> torch.Tensor:
    """Stable compaction within each block, stitched at the blocks'
    ``offsets`` (exclusive scan of the block counts, total last) ->
    (N,) int32: survivors' row indices ascending, then N - 1."""
    n = mask.shape[0]
    n_blocks = -(-n // block_n)
    padded = torch.zeros(n_blocks * block_n, dtype=torch.int64,
                         device=mask.device)
    padded[:n] = mask.to(torch.int64)
    local = torch.cumsum(padded.view(n_blocks, block_n), 1) - 1
    dst = (offsets[:n_blocks, None].to(torch.int64) + local).reshape(-1)[:n]
    dst = torch.where(mask.to(torch.bool), dst, torch.full_like(dst, n))
    out = torch.full((n + 1,), n - 1, dtype=torch.int32, device=mask.device)
    out[dst] = torch.arange(n, dtype=torch.int32, device=mask.device)
    return out[:n]


def ref_compact(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape compaction: returns (indices: (N,), count).

    indices[:count] are the positions where mask is True (ascending);
    indices[count:] are the rest (the argsort tail, as in the JAX oracle).
    """
    mask = mask.to(torch.bool)
    order = torch.argsort(torch.logical_not(mask).to(torch.int8), stable=True)
    count = torch.sum(mask.to(torch.int32))
    return order.to(torch.int32), count
