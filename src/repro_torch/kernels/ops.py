"""Public wrappers over the data kernels: the port of the data half of
``repro/kernels/ops.py`` (``groupby_aggregate``, ``combine_aggregate``,
``compact``, ``compact_indices``; flash attention belongs to a later slice).

Every wrapper takes ``device`` (default ``"cuda"``): inputs (numpy arrays or
tensors) are moved there, and the kernels of ``filter_compact`` and
``groupby_agg`` run on the card, or their plain versions on the CPU. A
``"cuda"`` device on a machine without a card raises. The Pallas wrappers pad
rows to the block size and groups to a lane multiple of 128 with
value-neutral entries; the CUDA kernels mask the ragged edge and drop codes
outside [0, n_groups) themselves, which is what that padding amounts to, so
nothing is padded here. Empty inputs return the neutral (or empty) result
without a launch, as the JAX wrappers compute it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import filter_compact as _fc
from repro_torch.kernels import groupby_agg as _gb

_NEUTRAL = {"sum": 0.0, "count": 0.0, "mean": 0.0, "min": float("inf"),
            "max": float("-inf")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {**_fc.LAUNCHES, **_gb.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_fc.LAUNCHES, _gb.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: torch sees no CUDA "
                               "device (pass device='cpu' for the plain "
                               "versions)")
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    return dev


_NUMPY = {torch.float32: np.float32, torch.int32: np.int32,
          torch.bool: np.bool_}


def _tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor on ``dev``; host arrays are
    cast on the host, so only the kernel's dtype crosses to the card."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=_NUMPY[dtype]))
    return x.to(device=dev, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# group-by aggregation
# ---------------------------------------------------------------------------


def groupby_aggregate(values, codes, n_groups: int, fn: str = "sum",
                      device="cuda") -> torch.Tensor:
    """Segment aggregate through the group-by kernel. values (N,), codes
    (N,) -> (n_groups,) float32 on ``device``. mean is sum / max(count, 1)."""
    if fn not in _NEUTRAL:
        raise ValueError(fn)
    dev = _device(device)
    vals = _tensor(values, torch.float32, dev)
    cds = _tensor(codes, torch.int32, dev)
    if n_groups == 0 or vals.shape[0] == 0:
        return torch.full((n_groups,), _NEUTRAL[fn], dtype=torch.float32,
                          device=dev)
    if fn == "mean":
        s = _gb.groupby(vals, cds, n_groups, "sum")
        c = _gb.groupby(vals, cds, n_groups, "count")
        return s / torch.clamp(c, min=1.0)
    return _gb.groupby(vals, cds, n_groups, fn)


def combine_aggregate(parts, n_groups: int, fn: str = "sum",
                      device="cuda") -> torch.Tensor:
    """Merge stacked per-shard partial aggregates: parts (P, n_groups), one
    row per shard, cells absent from a shard pre-filled with the merge op's
    neutral element. Returns the (n_groups,) combined aggregate. mean never
    reaches this point — it travels as a sum+count pair and is finalized by
    the caller."""
    if fn not in ("sum", "count", "min", "max"):
        raise ValueError(f"{fn!r} is not a distributive combine")
    dev = _device(device)
    stack = _tensor(parts, torch.float32, dev)
    p, g = stack.shape
    if p == 0 or g == 0:
        return torch.full((g,), _NEUTRAL[fn], dtype=torch.float32,
                          device=dev)[:n_groups]
    return _gb.combine(stack, fn)[:n_groups]


# ---------------------------------------------------------------------------
# filter compaction
# ---------------------------------------------------------------------------


def compact(mask, block_n: int = 1024,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (indices (N,) int32, count): indices[:count] = survivors
    ascending, indices[count:] = N - 1. Counts per block, an exclusive scan
    of them (as XLA did between the two Pallas kernels), then the fused
    compaction."""
    dev = _device(device)
    m = _tensor(mask, torch.bool, dev)
    n = m.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    bn = min(block_n, n)
    counts = _fc.block_counts(m, bn)
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    indices = _fc.block_compact(m, offsets, bn)
    return indices, offsets[-1]


def compact_indices(mask, device="cuda") -> np.ndarray:
    """Host-friendly: returns a numpy array of the surviving indices."""
    idx, count = compact(mask, device=device)
    return idx[: int(count)].cpu().numpy()
