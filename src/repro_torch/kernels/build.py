"""Builds the CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>_<hash>.so``
(at the root of the checkout), compiled by ``nvcc`` for ``sm_90a`` with a
plain C interface and loaded with ``ctypes``. The hash covers the source and
the flags, so a stale library is never loaded. All stale sources are compiled
at once, one ``nvcc`` process each. A missing ``nvcc`` or a failed build
raises with the compiler's output: nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("filter_compact", "groupby_agg")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", *ARCH_FLAGS, "-std=c++17", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of this process's
# builds, by source name
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """The nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found (neither on PATH nor at "
                       f"{DEFAULT_NVCC}): the CUDA kernels of repro_torch "
                       "cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, named by content."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every stale library of ``names`` at once; returns the paths.
    Raises RuntimeError with the compiler's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    stale = [name for name, path in paths.items() if not path.exists()]
    if not stale:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in stale:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])     # atomic: never a half-written .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``argtypes`` set from ``signatures`` and every entry point returning the
    int status of ``cudaGetLastError``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.bp_error_string.argtypes = [ctypes.c_int]
            lib.bp_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, what: str, status: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg: Optional[bytes] = lib.bp_error_string(status)
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({(msg or b'?').decode()})")
