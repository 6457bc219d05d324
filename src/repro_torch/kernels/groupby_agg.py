"""Group-by aggregation and the combine of per-shard states: launchers of
the CUDA kernels in ``csrc/groupby_agg.cu``, the port of
``repro/kernels/groupby_agg.py``.

- ``groupby`` replaces ``groupby_agg.groupby_pallas`` (``_gb_kernel``):
  segment sum / count / min / max of float32 values by int32 code.
- ``combine`` replaces ``groupby_agg.combine_pallas`` (``_combine_kernel``):
  merge of a (P, G) stack of per-shard partial aggregates over P.

Both are bound by bytes on the card; the design note is at the top of the
``.cu`` file. A tensor on the CPU goes to the plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"groupby": 0, "combine": 0}
_count_lock = threading.Lock()

FNS = {"sum": 0, "count": 1, "min": 2, "max": 3}

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "bp_groupby": [_P, _P, _P, _N, _N, _I, _P],
    "bp_combine": [_P, _P, _N, _N, _I, _P],
}


def _lib() -> ctypes.CDLL:
    return build.load("groupby_agg", _SIGNATURES)


def _counted(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, expected the CPU or "
                         "a CUDA device")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"{what}: empty input reaches no kernel")


def groupby(values: torch.Tensor, codes: torch.Tensor, n_groups: int,
            fn: str = "sum") -> torch.Tensor:
    """values (N,) float32, codes (N,) int32 -> (n_groups,) float32. Codes
    outside [0, n_groups) are dropped; empty groups hold the neutral
    element."""
    if fn not in FNS:
        raise ValueError(f"groupby: {fn!r} is not one of {tuple(FNS)}")
    if values.device.type == "cpu" and codes.device.type == "cpu":
        return ref.ref_groupby(values, codes, n_groups, fn)
    _check(values, "groupby values", torch.float32, 1)
    _check(codes, "groupby codes", torch.int32, 1)
    if codes.shape != values.shape or codes.device != values.device:
        raise ValueError("groupby: values and codes differ in shape or device")
    if n_groups <= 0:
        raise ValueError(f"groupby: n_groups={n_groups}")
    out = torch.empty(n_groups, dtype=torch.float32, device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.bp_groupby(values.data_ptr(), codes.data_ptr(),
                                out.data_ptr(), values.shape[0], n_groups,
                                FNS[fn], stream)
    build.check(lib, "groupby", status)
    _counted("groupby")
    return out


def combine(parts: torch.Tensor, fn: str = "sum") -> torch.Tensor:
    """parts (P, G) float32, absent cells holding the neutral element ->
    (G,) float32: sum for sum / count, elementwise min / max otherwise."""
    if fn not in FNS:
        raise ValueError(f"combine: {fn!r} is not one of {tuple(FNS)}")
    if parts.device.type == "cpu":
        return ref.ref_combine(parts, fn)
    _check(parts, "combine parts", torch.float32, 2)
    p, g = parts.shape
    out = torch.empty(g, dtype=torch.float32, device=parts.device)
    lib = _lib()
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.bp_combine(parts.data_ptr(), out.data_ptr(), p, g,
                                FNS[fn], stream)
    build.check(lib, "combine", status)
    _counted("combine")
    return out
