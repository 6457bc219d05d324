"""Arrow-analogue columnar substrate.

Bauplan stores all intermediate data as Arrow tables (paper §4.3): a columnar,
pointer-free layout (offset buffers + validity bitmaps) that supports zero-copy
sharing in shared memory, memory-mapping from disk, and cheap streaming.
pyarrow is not available offline, so this package implements the same contract
from scratch on numpy buffers — which also makes the zero-copy claims directly
testable (buffer identity).
"""
from repro_torch.columnar.table import Column, ColumnTable, utf8_column
from repro_torch.columnar.expr import Expr, col, lit, parse_predicate
from repro_torch.columnar import compute
from repro_torch.columnar.colfile import read_table, write_table, read_header
from repro_torch.columnar.objectstore import ObjectStore
from repro_torch.columnar.catalog import Catalog, DataFile, Snapshot

__all__ = [
    "Column", "ColumnTable", "utf8_column",
    "Expr", "col", "lit", "parse_predicate",
    "compute",
    "read_table", "write_table", "read_header",
    "ObjectStore", "Catalog", "DataFile", "Snapshot",
]
