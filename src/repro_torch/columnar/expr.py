"""Predicate / projection expressions with Bauplan-style string filters.

Users write filters like the paper's Listing 1:

    filter="eventTime BETWEEN 2023-01-01 AND 2023-02-01"
    filter="country IN ('IT','FR') AND usd > 100"

Expressions are structured objects so the planner can (a) evaluate them, (b)
extract referenced columns for projection pushdown, and (c) prune data files
from Iceberg-style column statistics (min/max) without touching data.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.columnar.table import ColumnTable

Scalar = Union[int, float, str, bool]

_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}


@dataclasses.dataclass(frozen=True)
class Expr:
    """A predicate expression tree node."""

    op: str                      # cmp op | "and" | "or" | "not" | "in" | "between" | "col" | "lit"
    children: Tuple["Expr", ...] = ()
    name: Optional[str] = None   # for "col"
    value: Optional[Union[Scalar, Tuple[Scalar, ...]]] = None  # for "lit"/"in"/"between"

    # -- composition ----------------------------------------------------------
    def __and__(self, other: "Expr") -> "Expr":
        return Expr("and", (self, other))

    def __or__(self, other: "Expr") -> "Expr":
        return Expr("or", (self, other))

    def __invert__(self) -> "Expr":
        return Expr("not", (self,))

    def _cmp(self, op: str, other) -> "Expr":
        return Expr(op, (self, other if isinstance(other, Expr) else lit(other)))

    # NOTE: == / != build comparison Exprs (DSL semantics, like polars).
    # Structural equality is `same_as`.
    def __eq__(self, other):  # type: ignore[override]
        return self._cmp("==", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp("!=", other)

    def same_as(self, other: "Expr") -> bool:
        if not isinstance(other, Expr):
            return False
        return (self.op == other.op and self.name == other.name
                and self.value == other.value
                and len(self.children) == len(other.children)
                and all(a.same_as(b) for a, b in zip(self.children, other.children)))

    def __lt__(self, other):
        return self._cmp("<", other)

    def __le__(self, other):
        return self._cmp("<=", other)

    def __gt__(self, other):
        return self._cmp(">", other)

    def __ge__(self, other):
        return self._cmp(">=", other)

    def __hash__(self):
        return hash((self.op, self.children, self.name,
                     tuple(self.value) if isinstance(self.value, (list, tuple)) else self.value))

    def isin(self, values: Sequence[Scalar]) -> "Expr":
        return Expr("in", (self,), value=tuple(values))

    def between(self, lo: Scalar, hi: Scalar) -> "Expr":
        return Expr("between", (self,), value=(lo, hi))

    # -- analysis ----------------------------------------------------------------
    def referenced_columns(self) -> List[str]:
        cols: List[str] = []

        def walk(e: Expr) -> None:
            if e.op == "col":
                if e.name not in cols:
                    cols.append(e.name)
            for c in e.children:
                walk(c)

        walk(self)
        return cols

    # -- evaluation ----------------------------------------------------------------
    def evaluate(self, table: ColumnTable) -> np.ndarray:
        """Evaluate to a value array ("col"/"lit") or boolean mask (predicates)."""
        if self.op == "col":
            col_ = table.column(self.name)
            vals = col_.to_numpy()
            return vals
        if self.op == "lit":
            return np.asarray(self.value)
        if self.op == "and":
            return self.children[0].evaluate(table) & self.children[1].evaluate(table)
        if self.op == "or":
            return self.children[0].evaluate(table) | self.children[1].evaluate(table)
        if self.op == "not":
            return ~self.children[0].evaluate(table)
        if self.op == "in":
            vals = self.children[0].evaluate(table)
            out = np.zeros(len(vals), dtype=bool)
            for v in self.value:
                out |= vals == v
            return out
        if self.op == "between":
            vals = self.children[0].evaluate(table)
            lo, hi = self.value
            return (vals >= lo) & (vals <= hi)
        if self.op in _CMP_OPS:
            lhs = self.children[0].evaluate(table)
            rhs = self.children[1].evaluate(table)
            return {"==": np.equal, "!=": np.not_equal, "<": np.less,
                    "<=": np.less_equal, ">": np.greater,
                    ">=": np.greater_equal}[self.op](lhs, rhs)
        raise ValueError(f"cannot evaluate op {self.op!r}")

    # -- file pruning from column stats ------------------------------------------
    def maybe_matches(self, stats: Dict[str, Dict[str, Scalar]]) -> bool:
        """Conservative file-level pruning: False only if NO row can match,
        given per-column {min, max} stats. Unknown columns -> True."""
        if self.op == "and":
            return (self.children[0].maybe_matches(stats)
                    and self.children[1].maybe_matches(stats))
        if self.op == "or":
            return (self.children[0].maybe_matches(stats)
                    or self.children[1].maybe_matches(stats))
        if self.op == "not":
            return True  # conservative
        rng = self._col_range(stats)
        if rng is None:
            return True
        lo, hi = rng
        if self.op == "between":
            blo, bhi = self.value
            return not (hi < blo or lo > bhi)
        if self.op == "in":
            return any(lo <= v <= hi for v in self.value)
        if self.op in _CMP_OPS and self.children[1].op == "lit":
            v = self.children[1].value
            return {"==": lambda: lo <= v <= hi,
                    "!=": lambda: True,
                    "<": lambda: lo < v,
                    "<=": lambda: lo <= v,
                    ">": lambda: hi > v,
                    ">=": lambda: hi >= v}[self.op]()
        return True

    def _col_range(self, stats) -> Optional[Tuple[Scalar, Scalar]]:
        child = self.children[0] if self.children else None
        if child is None or child.op != "col":
            return None
        st = stats.get(child.name)
        if not st or "min" not in st or "max" not in st:
            return None
        return st["min"], st["max"]

    # -- display -------------------------------------------------------------------
    def __repr__(self) -> str:
        if self.op == "col":
            return f"col({self.name!r})"
        if self.op == "lit":
            return repr(self.value)
        if self.op == "in":
            return f"{self.children[0]!r} IN {self.value!r}"
        if self.op == "between":
            return f"{self.children[0]!r} BETWEEN {self.value[0]!r} AND {self.value[1]!r}"
        if self.op in ("and", "or"):
            return f"({self.children[0]!r} {self.op.upper()} {self.children[1]!r})"
        if self.op == "not":
            return f"NOT ({self.children[0]!r})"
        return f"({self.children[0]!r} {self.op} {self.children[1]!r})"


def col(name: str) -> Expr:
    return Expr("col", name=name)


def lit(value: Scalar) -> Expr:
    return Expr("lit", value=value)


# ---------------------------------------------------------------------------
# String filter parser (the paper's `filter="..."` syntax)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\() | (?P<rparen>\)) | (?P<comma>,) |
        (?P<op><=|>=|!=|==|=|<|>) |
        (?P<kw>(?i:BETWEEN|AND|OR|NOT|IN)\b) |
        (?P<str>'[^']*'|"[^"]*") |
        (?P<date>\d{4}-\d{2}-\d{2}) |
        (?P<num>-?\d+\.\d+|-?\d+) |
        (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    pos, out = 0, []
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize filter at: {text[pos:]!r}")
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
        pos = m.end()
    return out


def _date_to_int(s: str) -> int:
    """Dates compare as yyyymmdd ints (matches synthetic eventTime columns)."""
    return int(s.replace("-", ""))


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of filter expression")
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect_kw(self, kw: str) -> None:
        tok = self.next()
        if tok[0] != "kw" or tok[1].upper() != kw:
            raise ValueError(f"expected {kw}, got {tok}")

    # expr := term (OR term)*
    def parse_expr(self) -> Expr:
        e = self.parse_term()
        while self.peek() and self.peek()[0] == "kw" and self.peek()[1].upper() == "OR":
            self.next()
            e = e | self.parse_term()
        return e

    # term := factor (AND factor)*
    def parse_term(self) -> Expr:
        e = self.parse_factor()
        while self.peek() and self.peek()[0] == "kw" and self.peek()[1].upper() == "AND":
            self.next()
            e = e & self.parse_factor()
        return e

    def parse_factor(self) -> Expr:
        tok = self.peek()
        if tok and tok[0] == "kw" and tok[1].upper() == "NOT":
            self.next()
            return ~self.parse_factor()
        if tok and tok[0] == "lparen":
            self.next()
            e = self.parse_expr()
            if self.next()[0] != "rparen":
                raise ValueError("missing )")
            return e
        return self.parse_comparison()

    def parse_value(self) -> Scalar:
        kind, text = self.next()
        if kind == "str":
            return text[1:-1]
        if kind == "num":
            return float(text) if "." in text else int(text)
        if kind == "ident":
            # bare date literal like 2023-01-01 tokenizes as num-num-num? No:
            # idents may also be enum-ish bare words; treat as string.
            if re.fullmatch(r"\d{4}-\d{2}-\d{2}", text):
                return _date_to_int(text)
            return text
        if kind == "date":
            return _date_to_int(text)
        raise ValueError(f"expected literal, got {kind}:{text}")

    def parse_comparison(self) -> Expr:
        kind, name = self.next()
        if kind != "ident":
            raise ValueError(f"expected column name, got {kind}:{name}")
        lhs = col(name)
        tok = self.peek()
        if tok is None:
            raise ValueError("dangling column reference")
        if tok[0] == "kw" and tok[1].upper() == "BETWEEN":
            self.next()
            lo = self._parse_maybe_date()
            self.expect_kw("AND")
            hi = self._parse_maybe_date()
            return lhs.between(lo, hi)
        if tok[0] == "kw" and tok[1].upper() == "IN":
            self.next()
            if self.next()[0] != "lparen":
                raise ValueError("IN requires ( ... )")
            vals = [self.parse_value()]
            while self.peek() and self.peek()[0] == "comma":
                self.next()
                vals.append(self.parse_value())
            if self.next()[0] != "rparen":
                raise ValueError("IN missing )")
            return lhs.isin(vals)
        if tok[0] == "op":
            op = self.next()[1]
            op = "==" if op == "=" else op
            return Expr(op, (lhs, lit(self._parse_maybe_date())))
        raise ValueError(f"expected operator after column {name}, got {tok}")

    def _parse_maybe_date(self) -> Scalar:
        # dates like 2023-01-01 tokenize as num(-2023?)... handle as a
        # 3-number sequence num '-' is absorbed into negative numbers; so we
        # reconstruct: num, num, num with values y, -m, -d.
        tok = self.peek()
        if tok and tok[0] == "num" and self.i + 2 < len(self.toks):
            t1, t2 = self.toks[self.i + 1], self.toks[self.i + 2]
            if (t1[0] == "num" and t2[0] == "num"
                    and t1[1].startswith("-") and t2[1].startswith("-")):
                y = int(self.next()[1])
                m = -int(self.next()[1])
                d = -int(self.next()[1])
                return y * 10000 + m * 100 + d
        return self.parse_value()


def parse_predicate(text: Union[str, Expr, None]) -> Optional[Expr]:
    """Parse a Bauplan-style filter string into an Expr (or pass through)."""
    if text is None or isinstance(text, Expr):
        return text
    tokens = _tokenize(text)
    if not tokens:
        return None
    parser = _Parser(tokens)
    e = parser.parse_expr()
    if parser.i != len(parser.toks):
        raise ValueError(f"trailing tokens in filter: {parser.toks[parser.i:]}")
    return e
