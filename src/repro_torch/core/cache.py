"""Worker-side caches (paper §4.2): columnar+differential scan cache and a
content-addressed intermediate-result cache.

Correctness hinges on the catalog's immutability discipline:

  * object-storage inputs map to immutable files via the Iceberg-style
    manifest, so `(table snapshot, column)` identifies bytes forever — the
    cache "knows with certainty when a table is stale" (new commit = new
    snapshot id = different key);
  * intermediate dataframes are identified by the transitive hash of
    (code, env, upstream identities) computed by the planner, so editing one
    function invalidates exactly its descendants.

The scan cache is *differential*: after reading (ID, USD, COUNTRY) once, a
request for (ID, USD, COUNTRY, CLIENT_ID) downloads only CLIENT_ID.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.columnar import colfile
from repro_torch.columnar.catalog import Catalog, Snapshot
from repro_torch.columnar.table import Column, ColumnTable


class ColumnarScanCache:
    """LRU cache of (data-file key, column) -> Column buffers."""

    def __init__(self, catalog: Catalog, scratch_dir: str,
                 capacity_bytes: int = 4 << 30):
        self.catalog = catalog
        self.scratch = os.path.abspath(scratch_dir)
        os.makedirs(self.scratch, exist_ok=True)
        self.capacity = capacity_bytes
        self._cols: "OrderedDict[Tuple[str, str], Column]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "bytes_fetched": 0,
                      "bytes_served_from_cache": 0}

    # -- internals -------------------------------------------------------------
    def _local_file(self, file_key: str) -> str:
        local = os.path.join(self.scratch, file_key.replace("/", "_"))
        if not os.path.exists(local):
            self.catalog.store.get_to_file(file_key, local)
        return local

    def _insert(self, key: Tuple[str, str], col: Column) -> None:
        self._cols[key] = col
        self._cols.move_to_end(key)
        self._bytes += col.nbytes
        while self._bytes > self.capacity and len(self._cols) > 1:
            _, evicted = self._cols.popitem(last=False)
            self._bytes -= evicted.nbytes

    # -- API ---------------------------------------------------------------------
    def read_file_columns(self, file_key: str,
                          columns: Sequence[str]) -> Dict[str, Column]:
        """Differential read: cached columns are served from memory; only the
        missing ones touch object storage."""
        out: Dict[str, Column] = {}
        missing: List[str] = []
        with self._lock:
            for c in columns:
                col = self._cols.get((file_key, c))
                if col is not None:
                    self._cols.move_to_end((file_key, c))
                    out[c] = col
                    self.stats["hits"] += 1
                    self.stats["bytes_served_from_cache"] += col.nbytes
                else:
                    missing.append(c)
                    self.stats["misses"] += 1
        if missing:
            local = self._local_file(file_key)
            fetched = colfile.read_table(local, columns=missing, mmap=False)
            with self._lock:
                for c in missing:
                    col = fetched.column(c)
                    self._insert((file_key, c), col)
                    out[c] = col
                    self.stats["bytes_fetched"] += col.nbytes
        return out

    def read_snapshot(self, snap: Snapshot, columns: Optional[Sequence[str]],
                      file_keys: Optional[Sequence[str]] = None) -> ColumnTable:
        from repro_torch.columnar.table import concat_tables

        cols = list(columns) if columns else list(snap.schema)
        keys = list(file_keys) if file_keys is not None else [f.key for f in snap.files]
        parts = []
        for fk in keys:
            part = self.read_file_columns(fk, cols)
            parts.append(ColumnTable({c: part[c] for c in cols}))
        if not parts:
            return ColumnTable({})
        return concat_tables(parts)

    def cached_columns(self, file_key: str) -> List[str]:
        with self._lock:
            return [c for (fk, c) in self._cols if fk == file_key]


class IntermediateCache:
    """Content-addressed cache of function outputs keyed by the planner's
    transitive cache_key. Enables skip-recompute when iterating (paper §4.2)
    and idempotent re-execution after failures (first write wins)."""

    def __init__(self, capacity_bytes: int = 8 << 30):
        self.capacity = capacity_bytes
        self._tables: "OrderedDict[str, ColumnTable]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "puts": 0}

    def get(self, cache_key: str) -> Optional[ColumnTable]:
        with self._lock:
            t = self._tables.get(cache_key)
            if t is None:
                self.stats["misses"] += 1
                return None
            self._tables.move_to_end(cache_key)
            self.stats["hits"] += 1
            return t

    def put(self, cache_key: str, table: ColumnTable) -> ColumnTable:
        with self._lock:
            existing = self._tables.get(cache_key)
            if existing is not None:
                return existing        # idempotent: first writer wins
            self._tables[cache_key] = table
            self._bytes += table.nbytes
            self.stats["puts"] += 1
            while self._bytes > self.capacity and len(self._tables) > 1:
                _, evicted = self._tables.popitem(last=False)
                self._bytes -= evicted.nbytes
            return table

    def __contains__(self, cache_key: str) -> bool:
        with self._lock:
            return cache_key in self._tables
