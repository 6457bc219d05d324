"""Simulated object storage (the repo's "S3").

A directory-backed blob store with an S3-like bytes API. Two properties of
real object storage matter for reproducing the paper's measurements:

  1. access is *whole-object or byte-range GET over the network*, never mmap —
     readers pay a serialization/copy cost (contrast: local RCF files can be
     memory-mapped);
  2. per-request latency and bounded bandwidth dominate small/large reads
     respectively.

The store optionally models (2) with a configurable latency/bandwidth so
benchmarks can report both raw-local numbers and cloud-shaped numbers. The
default is no simulation (pure local I/O) — benchmark tables report both.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple


class ObjectStore:
    def __init__(self, root: str, latency_s: float = 0.0,
                 bandwidth_bytes_per_s: Optional[float] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.latency_s = latency_s
        self.bandwidth = bandwidth_bytes_per_s
        self.stats: Dict[str, int] = {"puts": 0, "gets": 0,
                                      "bytes_in": 0, "bytes_out": 0}

    # -- internals ----------------------------------------------------------
    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"bad key {key!r}")
        return os.path.join(self.root, key)

    def _simulate(self, nbytes: int) -> None:
        if self.latency_s:
            time.sleep(self.latency_s)
        if self.bandwidth:
            time.sleep(nbytes / self.bandwidth)

    # -- API ----------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # unique tmp per writer: concurrent runs may PUT the same
        # content-addressed key simultaneously (last replace wins, same bytes)
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        self._simulate(len(data))
        self.stats["puts"] += 1
        self.stats["bytes_in"] += len(data)

    def put_file(self, key: str, local_path: str) -> None:
        with open(local_path, "rb") as f:
            self.put(key, f.read())

    def get(self, key: str, byte_range: Optional[Tuple[int, int]] = None) -> bytes:
        path = self._path(key)
        with open(path, "rb") as f:
            if byte_range is not None:
                start, length = byte_range
                f.seek(start)
                data = f.read(length)
            else:
                data = f.read()
        self._simulate(len(data))
        self.stats["gets"] += 1
        self.stats["bytes_out"] += len(data)
        return data

    def get_to_file(self, key: str, local_path: str) -> str:
        data = self.get(key)
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(data)
        return local_path

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                key = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)

    def open_stream(self, key: str, chunk_size: int = 1 << 20) -> Iterator[bytes]:
        path = self._path(key)
        with open(path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    return
                self._simulate(len(chunk))
                self.stats["bytes_out"] += len(chunk)
                yield chunk
