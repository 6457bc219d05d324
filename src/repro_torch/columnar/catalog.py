"""Nessie/Iceberg-style catalog: branches, commits, immutable snapshots.

The paper (§4.1–4.2) leans on two properties we reproduce exactly:

  * **immutability**: a table snapshot is a manifest of immutable data files
    (plus per-column stats). Data never changes under a snapshot id, so caches
    keyed by (snapshot, column) are *provably* fresh or stale;
  * **branches & commits** (Nessie): a branch is a named commit chain; a
    commit atomically updates table -> snapshot mappings, enabling
    "run today's code on last Friday's table" and cross-table transactions.

The catalog stores only *metadata* (JSON blobs in the object store) — it is
the Control-Plane view; workers read data files directly (Data Plane).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.columnar.expr import Expr, parse_predicate
from repro_torch.columnar.objectstore import ObjectStore
from repro_torch.columnar.table import ColumnTable
from repro_torch.columnar import colfile


def _content_id(payload) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class DataFile:
    """One immutable data file + its manifest entry (Iceberg-style)."""

    key: str                       # object-store key
    num_rows: int
    size_bytes: int
    column_stats: Dict[str, Dict]  # name -> {min, max, null_count}

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "DataFile":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable table snapshot: schema + manifest of data files."""

    snapshot_id: str
    schema: Dict[str, str]
    files: Tuple[DataFile, ...]
    created_at: float

    @property
    def num_rows(self) -> int:
        return sum(f.num_rows for f in self.files)

    def to_json(self) -> Dict:
        return {"snapshot_id": self.snapshot_id, "schema": self.schema,
                "files": [f.to_json() for f in self.files],
                "created_at": self.created_at}

    @classmethod
    def from_json(cls, d: Dict) -> "Snapshot":
        return cls(d["snapshot_id"], d["schema"],
                   tuple(DataFile.from_json(f) for f in d["files"]),
                   d["created_at"])

    # -- scan planning (predicate pushdown, §4.1) ---------------------------
    def plan_scan(self, columns: Optional[Sequence[str]] = None,
                  predicate: Optional[Expr] = None) -> List[DataFile]:
        """Prune manifest files whose column stats cannot match the filter."""
        expr = parse_predicate(predicate)
        out = []
        for f in self.files:
            if expr is not None and not expr.maybe_matches(f.column_stats):
                continue
            out.append(f)
        return out


class Catalog:
    """Branch -> commit-chain -> {table: snapshot} metadata store."""

    def __init__(self, store: ObjectStore, namespace: str = "catalog"):
        self.store = store
        self.ns = namespace
        # commit() is read-modify-write on the branch chain; concurrent
        # materializing runs must serialize or one run's commit is lost
        self._commit_lock = threading.Lock()
        if not self.store.exists(self._branch_key("main")):
            self._write_branch("main", [])

    # -- keys ----------------------------------------------------------------
    def _branch_key(self, branch: str) -> str:
        return f"{self.ns}/branches/{branch}.json"

    def _commit_key(self, commit_id: str) -> str:
        return f"{self.ns}/commits/{commit_id}.json"

    def _snapshot_key(self, snapshot_id: str) -> str:
        return f"{self.ns}/snapshots/{snapshot_id}.json"

    # -- low-level IO ----------------------------------------------------------
    def _write_branch(self, branch: str, commits: List[str]) -> None:
        self.store.put(self._branch_key(branch),
                       json.dumps({"commits": commits}).encode())

    def _read_branch(self, branch: str) -> List[str]:
        if not self.store.exists(self._branch_key(branch)):
            raise KeyError(f"unknown branch {branch!r}")
        return json.loads(self.store.get(self._branch_key(branch)))["commits"]

    # -- branches ---------------------------------------------------------------
    def list_branches(self) -> List[str]:
        keys = self.store.list(f"{self.ns}/branches/")
        return [k.split("/")[-1][:-5] for k in keys]

    def create_branch(self, branch: str, from_branch: str = "main") -> None:
        self._write_branch(branch, self._read_branch(from_branch))

    def delete_branch(self, branch: str) -> None:
        """Drop a branch pointer. Commits and snapshots it referenced are
        content-addressed and may be shared with other branches, so only
        the pointer file goes — readers holding a commit id keep working.
        Raises KeyError for an unknown branch; refuses to delete "main"
        (every catalog is born with it and serving forks from it)."""
        if branch == "main":
            raise ValueError("refusing to delete branch 'main'")
        with self._commit_lock:
            key = self._branch_key(branch)
            if not self.store.exists(key):
                raise KeyError(f"unknown branch {branch!r}")
            self.store.delete(key)

    def merge(self, from_branch: str, into_branch: str) -> str:
        """Fast-forward-style merge: replay source tables into target."""
        src_tables = self._tables_at(self._read_branch(from_branch))
        return self.commit(into_branch, src_tables,
                           message=f"merge {from_branch} into {into_branch}")

    # -- commits -----------------------------------------------------------------
    def commit(self, branch: str, table_updates: Dict[str, Snapshot],
               message: str = "") -> str:
        with self._commit_lock:
            chain = self._read_branch(branch)
            payload = {"parent": chain[-1] if chain else None,
                       "message": message,
                       "tables": {},
                       "created_at": time.time()}
            for name, snap in table_updates.items():
                self.store.put(self._snapshot_key(snap.snapshot_id),
                               json.dumps(snap.to_json()).encode())
                payload["tables"][name] = snap.snapshot_id
            commit_id = _content_id({k: payload[k]
                                     for k in ("parent", "tables", "message")})
            self.store.put(self._commit_key(commit_id),
                           json.dumps(payload).encode())
            self._write_branch(branch, chain + [commit_id])
            return commit_id

    def log(self, branch: str) -> List[Dict]:
        out = []
        for cid in self._read_branch(branch):
            d = json.loads(self.store.get(self._commit_key(cid)))
            d["commit_id"] = cid
            out.append(d)
        return out

    def _tables_at(self, chain: List[str]) -> Dict[str, Snapshot]:
        tables: Dict[str, str] = {}
        for cid in chain:
            d = json.loads(self.store.get(self._commit_key(cid)))
            tables.update(d["tables"])
        return {name: self.get_snapshot(sid) for name, sid in tables.items()}

    # -- tables ----------------------------------------------------------------------
    def list_tables(self, branch: str = "main") -> List[str]:
        return sorted(self._tables_at(self._read_branch(branch)).keys())

    def get_snapshot(self, snapshot_id: str) -> Snapshot:
        return Snapshot.from_json(
            json.loads(self.store.get(self._snapshot_key(snapshot_id))))

    def get_table(self, name: str, branch: str = "main",
                  at_commit: Optional[str] = None) -> Snapshot:
        chain = self._read_branch(branch)
        if at_commit is not None:
            if at_commit not in chain:
                raise KeyError(f"commit {at_commit} not on branch {branch}")
            chain = chain[:chain.index(at_commit) + 1]
        tables = self._tables_at(chain)
        if name not in tables:
            raise KeyError(f"table {name!r} not on branch {branch!r}; "
                           f"have {sorted(tables)}")
        return tables[name]

    # -- high-level write path ------------------------------------------------------
    def write_table(self, name: str, table: ColumnTable, branch: str = "main",
                    rows_per_file: Optional[int] = None,
                    message: str = "") -> Snapshot:
        """Split a ColumnTable into immutable RCF data files + commit."""
        import os
        import tempfile

        rows_per_file = rows_per_file or max(table.num_rows, 1)
        files: List[DataFile] = []
        n = table.num_rows
        for start in range(0, max(n, 1), rows_per_file):
            part = table.slice(start, min(rows_per_file, n - start)) if n else table
            with tempfile.NamedTemporaryFile(suffix=".rcf", delete=False) as tf:
                tmp_path = tf.name
            header = colfile.write_table(tmp_path, part)
            digest = hashlib.sha256(open(tmp_path, "rb").read()).hexdigest()[:16]
            key = f"data/{name}/{digest}.rcf"
            self.store.put_file(key, tmp_path)
            os.remove(tmp_path)
            files.append(DataFile(key=key, num_rows=part.num_rows,
                                  size_bytes=self.store.size(key),
                                  column_stats={c["name"]: c["stats"]
                                                for c in header["columns"]}))
            if n == 0:
                break
        snap = Snapshot(snapshot_id=_content_id([f.to_json() for f in files]),
                        schema=table.schema(), files=tuple(files),
                        created_at=time.time())
        self.commit(branch, {name: snap}, message or f"write {name}")
        return snap

    # -- high-level read path ----------------------------------------------------------
    def read_table(self, name: str, branch: str = "main",
                   columns: Optional[Sequence[str]] = None,
                   predicate: Optional[Expr] = None,
                   at_commit: Optional[str] = None,
                   local_dir: Optional[str] = None) -> ColumnTable:
        """Scan with column + predicate pushdown (no cache; see core.cache)."""
        import os
        import tempfile

        from repro_torch.columnar import compute
        from repro_torch.columnar.table import concat_tables

        snap = self.get_table(name, branch, at_commit)
        expr = parse_predicate(predicate)
        need_cols = None
        if columns is not None:
            need_cols = list(columns)
            for c in (expr.referenced_columns() if expr else []):
                if c not in need_cols:
                    need_cols.append(c)
        parts = []
        local_dir = local_dir or tempfile.mkdtemp(prefix="scan_")
        for f in snap.plan_scan(columns, expr):
            local = os.path.join(local_dir, f.key.replace("/", "_"))
            if not os.path.exists(local):
                self.store.get_to_file(f.key, local)
            parts.append(colfile.read_table(local, columns=need_cols))
        if not parts:
            empty = self.get_snapshot(snap.snapshot_id)
            cols = need_cols or list(empty.schema)
            import numpy as np

            from repro_torch.columnar.table import Column, utf8_column
            out = {}
            for c in cols:
                kind = empty.schema[c]
                out[c] = (utf8_column([]) if kind == "utf8"
                          else Column("numeric", np.array([], dtype=kind)))
            table = ColumnTable(out)
        else:
            table = concat_tables(parts)
        if expr is not None:
            table = compute.filter_table(table, expr)
        if columns is not None:
            table = table.project(list(columns))
        return table
