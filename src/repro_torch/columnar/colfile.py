"""RCF — a column-seekable binary file format (the repo's "Parquet"/"Arrow IPC").

Layout:

    [ MAGIC b"RCF1" ][ uint64 header_len ][ header JSON (utf-8) ][ padding ]
    [ 64-byte-aligned raw buffers ... ]

The JSON header records, per column: kind, dtype, and the (offset, size) of
each raw buffer (data / offsets / validity), plus per-column min/max/null
stats. Because buffer locations are explicit:

  * reading a *projection* touches only the requested columns' byte ranges
    (predicate/column pushdown, paper §4.1);
  * ``mmap=True`` maps buffers straight from the OS page cache with zero
    deserialization (Arrow-IPC-style zero-copy reads, paper §4.3).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.columnar.table import Column, ColumnTable

MAGIC = b"RCF1"
ALIGN = 64


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_table(path: str, table: ColumnTable,
                metadata: Optional[Dict] = None) -> Dict:
    """Write table; returns the header dict (incl. column stats)."""
    from repro_torch.columnar.compute import column_stats

    stats = column_stats(table)
    columns: List[Dict] = []
    payload: List[np.ndarray] = []
    # First pass: compute buffer offsets. Header size depends on the JSON,
    # which depends on offsets — so lay buffers out relative to data_start
    # and store data_start separately.
    rel = 0
    for name in table.column_names:
        c = table.column(name)
        bufs = []
        for role, arr in c.buffers().items():
            arr = np.ascontiguousarray(arr)
            bufs.append({"role": role, "offset": rel, "size": int(arr.nbytes),
                         "dtype": str(arr.dtype)})
            payload.append(arr)
            rel = _align(rel + arr.nbytes)
        columns.append({"name": name, "kind": c.kind, "dtype": str(c.dtype),
                        "buffers": bufs, "stats": stats[name]})
    header = {"num_rows": table.num_rows, "columns": columns,
              "metadata": metadata or {}}
    hjson = json.dumps(header).encode("utf-8")
    data_start = _align(len(MAGIC) + 8 + len(hjson))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        f.write(b"\0" * (data_start - len(MAGIC) - 8 - len(hjson)))
        pos = 0
        for arr in payload:
            f.write(b"\0" * (_align(pos) - pos)) if pos != _align(pos) else None
            pos = _align(pos)
            f.write(arr.tobytes())
            pos += arr.nbytes
    os.replace(tmp, path)  # atomic publish (immutable-file discipline)
    header["data_start"] = data_start
    return header


def read_header(path: str) -> Dict:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an RCF file")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode("utf-8"))
    header["data_start"] = _align(4 + 8 + hlen)
    return header


def _load_buffer(f, mm, data_start: int, spec: Dict, use_mmap: bool) -> np.ndarray:
    dtype = np.dtype(spec["dtype"])
    count = spec["size"] // dtype.itemsize
    offset = data_start + spec["offset"]
    if use_mmap:
        return np.frombuffer(mm, dtype=dtype, count=count, offset=offset)
    f.seek(offset)
    return np.frombuffer(f.read(spec["size"]), dtype=dtype, count=count)


def read_table(path: str, columns: Optional[Sequence[str]] = None,
               mmap: bool = False) -> ColumnTable:
    """Read (a projection of) an RCF file.

    mmap=False reads only the selected columns' byte ranges (seek+read).
    mmap=True memory-maps the file once; buffers are views into the map
    (zero-copy, zero-deserialization).
    """
    header = read_header(path)
    data_start = header["data_start"]
    want = list(columns) if columns is not None else [c["name"] for c in header["columns"]]
    by_name = {c["name"]: c for c in header["columns"]}
    missing = [w for w in want if w not in by_name]
    if missing:
        raise KeyError(f"{path}: missing columns {missing}")
    out: Dict[str, Column] = {}
    f = open(path, "rb")
    try:
        mm = None
        if mmap:
            import mmap as mmap_mod

            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        for name in want:
            spec = by_name[name]
            bufs = {b["role"]: _load_buffer(f, mm, data_start, b, mmap)
                    for b in spec["buffers"]}
            out[name] = Column(spec["kind"], bufs["data"],
                               bufs.get("offsets"), bufs.get("validity"))
    finally:
        if not mmap:
            f.close()
        # NOTE: when mmap=True we intentionally leak f/mm into buffer
        # lifetimes — numpy views keep the map alive via .base.
    return ColumnTable(out)
