"""Predicate compaction: launchers of the CUDA kernels in
``csrc/filter_compact.cu``, the port of ``repro/kernels/filter_compact.py``.

- ``block_counts`` replaces ``filter_compact.block_counts``
  (``_count_kernel``): survivors of a bool mask per row block.
- ``block_compact`` replaces ``filter_compact.block_compact``
  (``_compact_kernel``) together with the XLA stitch of ``ops.compact``: it
  writes every survivor's global row index straight to its block's offset,
  and fills the tail with N - 1.

Both are bound by bytes on the card (a mask byte in, an int32 out per row);
the design note is at the top of the ``.cu`` file. A tensor on the CPU goes
to the plain version in ``ref.py``; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"block_counts": 0, "block_compact": 0}
_count_lock = threading.Lock()

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "bp_block_counts": [_P, _P, _N, _N, _P],
    "bp_block_compact": [_P, _P, _P, _N, _N, _P],
}


def _lib() -> ctypes.CDLL:
    return build.load("filter_compact", _SIGNATURES)


def _counted(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _check_mask(mask: torch.Tensor) -> None:
    if mask.device.type != "cuda":
        raise ValueError(f"filter_compact: tensor on {mask.device}, "
                         "expected the CPU or a CUDA device")
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("filter_compact: mask must be a contiguous 1-D bool "
                         f"tensor, got {mask.dtype} {tuple(mask.shape)}")
    if mask.shape[0] == 0 or mask.shape[0] >= 2 ** 31:
        raise ValueError(f"filter_compact: {mask.shape[0]} rows is outside "
                         "[1, 2**31)")


def block_counts(mask: torch.Tensor, block_n: int = 1024) -> torch.Tensor:
    """mask (N,) bool -> (ceil(N / block_n),) int32 survivors per block."""
    if mask.device.type == "cpu":
        return ref.ref_block_counts(mask, block_n)
    _check_mask(mask)
    n = mask.shape[0]
    out = torch.empty(-(-n // block_n), dtype=torch.int32, device=mask.device)
    lib = _lib()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.bp_block_counts(mask.data_ptr(), out.data_ptr(), n,
                                     block_n, stream)
    build.check(lib, "block_counts", status)
    _counted("block_counts")
    return out


def block_compact(mask: torch.Tensor, offsets: torch.Tensor,
                  block_n: int = 1024) -> torch.Tensor:
    """mask (N,) bool, offsets (ceil(N / block_n) + 1,) int64 exclusive scan
    of ``block_counts`` with the total last -> (N,) int32 indices:
    survivors ascending, then N - 1."""
    if mask.device.type == "cpu":
        return ref.ref_block_compact(mask, offsets, block_n)
    _check_mask(mask)
    n = mask.shape[0]
    n_blocks = -(-n // block_n)
    if (offsets.device != mask.device or offsets.dtype != torch.int64
            or tuple(offsets.shape) != (n_blocks + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(f"block_compact: offsets must be contiguous int64 "
                         f"({n_blocks + 1},) on {mask.device}")
    out = torch.empty(n, dtype=torch.int32, device=mask.device)
    lib = _lib()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.bp_block_compact(mask.data_ptr(), offsets.data_ptr(),
                                      out.data_ptr(), n, block_n, stream)
    build.check(lib, "block_compact", status)
    _counted("block_compact")
    return out
