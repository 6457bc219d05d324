"""ColumnTable: an Arrow-like, pointer-free, structure-of-arrays table.

Layout rules (mirroring Arrow, paper §4.3):
  * every column is backed by flat numpy buffers — a `data` buffer, an
    optional `offsets` buffer (utf8/varbinary), and an optional packed
    `validity` bitmap (LSB-first, 1 = valid);
  * buffers never contain memory addresses, only offsets — so the same
    buffers can be mapped into another address space (np.memmap, sockets,
    shared memory) without rewriting;
  * projection and metadata operations are zero-copy: they return new
    ColumnTable objects referencing the *same* Column objects / buffers.

Copy vs view is part of the API contract and is asserted in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np

# ---------------------------------------------------------------------------
# validity bitmaps (Arrow-compatible LSB-first packing)
# ---------------------------------------------------------------------------


def pack_validity(mask: np.ndarray) -> np.ndarray:
    """Pack a boolean mask into an LSB-first bitmap (np.uint8)."""
    mask = np.asarray(mask, dtype=bool)
    return np.packbits(mask, bitorder="little")


def unpack_validity(bitmap: np.ndarray, num_rows: int) -> np.ndarray:
    """Unpack an LSB-first bitmap into a boolean mask of length num_rows."""
    bits = np.unpackbits(np.asarray(bitmap, dtype=np.uint8), bitorder="little")
    return bits[:num_rows].astype(bool)


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------

_KINDS = ("numeric", "bool", "utf8")


@dataclasses.dataclass
class Column:
    """A single immutable column.

    kind == "numeric"/"bool": `data` holds the values (length = num_rows).
    kind == "utf8": `data` is a uint8 byte buffer and `offsets` an int32
    buffer of length num_rows + 1 (Arrow string layout).
    `validity` is an optional packed bitmap; None means all-valid.
    """

    kind: str
    data: np.ndarray
    offsets: Optional[np.ndarray] = None
    validity: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown column kind {self.kind!r}")
        if self.kind == "utf8":
            if self.offsets is None:
                raise ValueError("utf8 column requires offsets buffer")
            if self.offsets.dtype != np.int32:
                self.offsets = self.offsets.astype(np.int32)
            if self.data.dtype != np.uint8:
                self.data = np.ascontiguousarray(self.data).view(np.uint8)
        elif self.offsets is not None:
            raise ValueError(f"{self.kind} column cannot have offsets")

    # -- basic properties ---------------------------------------------------
    @property
    def num_rows(self) -> int:
        if self.kind == "utf8":
            return int(len(self.offsets) - 1)
        return int(len(self.data))

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        n = self.data.nbytes
        if self.offsets is not None:
            n += self.offsets.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def buffers(self) -> Dict[str, np.ndarray]:
        out = {"data": self.data}
        if self.offsets is not None:
            out["offsets"] = self.offsets
        if self.validity is not None:
            out["validity"] = self.validity
        return out

    # -- null handling --------------------------------------------------------
    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(self.num_rows, dtype=bool)
        return unpack_validity(self.validity, self.num_rows)

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(self.num_rows - self.valid_mask().sum())

    # -- conversions ----------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Values as a numpy array. utf8 -> object array of python strs."""
        if self.kind == "utf8":
            off = self.offsets
            buf = self.data.tobytes()
            return np.array(
                [buf[off[i]:off[i + 1]].decode("utf-8") for i in range(self.num_rows)],
                dtype=object,
            )
        return self.data

    def to_pylist(self) -> List:
        vals = self.to_numpy()
        mask = self.valid_mask()
        return [v if m else None for v, m in zip(vals.tolist(), mask.tolist())]

    # -- kernels used by compute (gather copies; slice views) -----------------
    def take(self, indices: np.ndarray) -> "Column":
        indices = np.asarray(indices)
        validity = None
        if self.validity is not None:
            validity = pack_validity(self.valid_mask()[indices])
        if self.kind == "utf8":
            off = self.offsets
            lengths = (off[1:] - off[:-1])[indices]
            new_off = np.zeros(len(indices) + 1, dtype=np.int32)
            np.cumsum(lengths, out=new_off[1:])
            new_data = np.empty(int(new_off[-1]), dtype=np.uint8)
            for j, i in enumerate(indices):
                new_data[new_off[j]:new_off[j + 1]] = self.data[off[i]:off[i + 1]]
            return Column("utf8", new_data, new_off, validity)
        return Column(self.kind, self.data[indices], None, validity)

    def slice(self, start: int, length: int) -> "Column":
        """Zero-copy row slice for fixed-width columns (views into buffers)."""
        stop = start + length
        if self.kind == "utf8":
            # offsets view keeps absolute byte positions; data buffer shared.
            return Column("utf8", self.data, self.offsets[start:stop + 1],
                          pack_validity(self.valid_mask()[start:stop])
                          if self.validity is not None else None)
        return Column(self.kind, self.data[start:stop], None,
                      pack_validity(self.valid_mask()[start:stop])
                      if self.validity is not None else None)

    def equals(self, other: "Column") -> bool:
        if self.kind != other.kind or self.num_rows != other.num_rows:
            return False
        if not np.array_equal(self.valid_mask(), other.valid_mask()):
            return False
        mask = self.valid_mask()
        a, b = self.to_numpy(), other.to_numpy()
        if self.kind == "utf8":
            return all(x == y for x, y, m in zip(a, b, mask) if m)
        if np.issubdtype(a.dtype, np.floating):
            am, bm = a[mask], b[mask]
            both_nan = np.isnan(am) & np.isnan(bm)
            return bool(np.all(both_nan | (am == bm)))
        return bool(np.array_equal(a[mask], b[mask]))


def numeric_column(values: Sequence, dtype=None,
                   validity: Optional[Sequence[bool]] = None) -> Column:
    data = np.asarray(values, dtype=dtype)
    if data.dtype == object:
        raise TypeError("numeric_column got non-numeric values")
    kind = "bool" if data.dtype == np.bool_ else "numeric"
    packed = pack_validity(np.asarray(validity, bool)) if validity is not None else None
    return Column(kind, data, None, packed)


def utf8_column(values: Sequence[Optional[str]]) -> Column:
    """Build a utf8 column (Arrow string layout) from python strings."""
    validity = [v is not None for v in values]
    encoded = [(v or "").encode("utf-8") for v in values]
    offsets = np.zeros(len(values) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    data = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
    packed = None if all(validity) else pack_validity(np.asarray(validity))
    return Column("utf8", data, offsets, packed)


def column_from_values(values) -> Column:
    if isinstance(values, Column):
        return values
    if isinstance(values, np.ndarray) and values.dtype != object:
        return numeric_column(values)
    vals = list(values)
    if any(isinstance(v, str) for v in vals):
        return utf8_column(vals)
    if any(v is None for v in vals):
        validity = [v is not None for v in vals]
        filled = [0 if v is None else v for v in vals]
        return numeric_column(np.asarray(filled, dtype=np.float64), validity=validity)
    return numeric_column(np.asarray(vals))


# ---------------------------------------------------------------------------
# ColumnTable
# ---------------------------------------------------------------------------


class ColumnTable:
    """An immutable named collection of equal-length Columns."""

    def __init__(self, columns: Mapping[str, Column]):
        self._columns: Dict[str, Column] = dict(columns)
        lengths = {name: c.num_rows for name, c in self._columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged table: {lengths}")

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_pydict(cls, data: Mapping[str, Iterable]) -> "ColumnTable":
        return cls({name: column_from_values(vals) for name, vals in data.items()})

    @classmethod
    def empty_like(cls, other: "ColumnTable") -> "ColumnTable":
        return other.take(np.array([], dtype=np.int64))

    # -- properties -----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self._columns:
            return 0
        return next(iter(self._columns.values())).num_rows

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._columns.values())

    def schema(self) -> Dict[str, str]:
        return {n: (c.kind if c.kind == "utf8" else str(c.dtype))
                for n, c in self._columns.items()}

    def column(self, name: str) -> Column:
        return self._columns[name]

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __repr__(self) -> str:
        return f"ColumnTable({self.num_rows} rows x {self.num_columns} cols: {self.column_names})"

    # -- zero-copy operations ---------------------------------------------------
    def project(self, names: Sequence[str]) -> "ColumnTable":
        """Column projection. ZERO-COPY: shares Column objects/buffers."""
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise KeyError(f"unknown columns {missing}; have {self.column_names}")
        return ColumnTable({n: self._columns[n] for n in names})

    def with_column(self, name: str, column: Union[Column, np.ndarray]) -> "ColumnTable":
        """Add/replace one column. ZERO-COPY for the untouched columns."""
        col_ = column_from_values(column)
        if self._columns and col_.num_rows != self.num_rows:
            raise ValueError(f"column {name} has {col_.num_rows} rows, table has {self.num_rows}")
        out = dict(self._columns)
        out[name] = col_
        return ColumnTable(out)

    def rename(self, mapping: Mapping[str, str]) -> "ColumnTable":
        return ColumnTable({mapping.get(n, n): c for n, c in self._columns.items()})

    def slice(self, start: int, length: int) -> "ColumnTable":
        return ColumnTable({n: c.slice(start, length) for n, c in self._columns.items()})

    # -- copying operations -----------------------------------------------------
    def take(self, indices: np.ndarray) -> "ColumnTable":
        return ColumnTable({n: c.take(indices) for n, c in self._columns.items()})

    def filter(self, mask: np.ndarray) -> "ColumnTable":
        mask = np.asarray(mask, dtype=bool)
        if len(mask) != self.num_rows:
            raise ValueError("mask length mismatch")
        return self.take(np.nonzero(mask)[0])

    # -- conversions --------------------------------------------------------------
    def to_pydict(self) -> Dict[str, List]:
        return {n: c.to_pylist() for n, c in self._columns.items()}

    def equals(self, other: "ColumnTable") -> bool:
        if self.column_names != other.column_names or self.num_rows != other.num_rows:
            return False
        return all(self._columns[n].equals(other._columns[n]) for n in self.column_names)


def concat_tables(tables: Sequence[ColumnTable]) -> ColumnTable:
    if not tables:
        raise ValueError("concat of zero tables")
    tables = list(tables)
    if len(tables) == 1:
        return tables[0]    # zero-copy: same Column objects/buffers
    names = tables[0].column_names
    for t in tables[1:]:
        if t.column_names != names:
            raise ValueError("schema mismatch in concat")
    out: Dict[str, Column] = {}
    for n in names:
        cols = [t.column(n) for t in tables]
        kind = cols[0].kind
        validity = None
        if any(c.validity is not None for c in cols):
            validity = pack_validity(np.concatenate([c.valid_mask() for c in cols]))
        if kind == "utf8":
            datas, offs, base = [], [np.zeros(1, np.int32)], 0
            for c in cols:
                start = int(c.offsets[0])
                datas.append(c.data[start:int(c.offsets[-1])])
                offs.append((c.offsets[1:] - start) + base)
                base += int(c.offsets[-1]) - start
            out[n] = Column("utf8", np.concatenate(datas) if datas else
                            np.empty(0, np.uint8), np.concatenate(offs), validity)
        else:
            out[n] = Column(kind, np.concatenate([c.data for c in cols]), None, validity)
    return ColumnTable(out)


def from_numpy_columns(columns: Mapping[str, Union[np.ndarray, List[str]]]
                       ) -> ColumnTable:
    """A table from plain host columns: numeric numpy arrays, or lists of
    python strings for utf8 columns. The same dict handed to
    ``ColumnTable.from_pydict`` of the JAX package yields byte-identical
    buffers, so both packages can start from one set of seeded inputs."""
    cols: Dict[str, Column] = {}
    for name, values in columns.items():
        if isinstance(values, np.ndarray) and values.dtype != object:
            cols[name] = numeric_column(values)
        elif all(v is None or isinstance(v, str) for v in values):
            cols[name] = utf8_column(list(values))
        else:
            raise TypeError(f"column {name!r}: expected a numeric numpy "
                            "array or a list of str")
    return ColumnTable(cols)
