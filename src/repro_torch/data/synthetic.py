"""Synthetic datasets: the paper's `transactions` table (for pipeline
demos/benchmarks). Copy of the table half of ``repro/data/synthetic.py``;
the text corpus belongs to the training slice, which is not ported yet."""
from __future__ import annotations

import numpy as np

from repro_torch.columnar.table import ColumnTable

COUNTRIES = ["IT", "FR", "DE", "ES", "NL", "US", "GB", "JP", "BR", "IN"]


def make_transactions_table(n_rows: int = 1_000_000, seed: int = 0,
                            year: int = 2023) -> ColumnTable:
    """The paper's Fig.1 source table: transactions(id, usd, country,
    eventTime[, client_id])."""
    rng = np.random.default_rng(seed)
    months = rng.integers(1, 13, n_rows)
    days = rng.integers(1, 29, n_rows)
    return ColumnTable.from_pydict({
        "id": np.arange(n_rows, dtype=np.int64),
        "usd": np.round(rng.gamma(2.0, 50.0, n_rows), 2),
        "country": [COUNTRIES[i] for i in rng.integers(0, len(COUNTRIES),
                                                       n_rows)],
        "eventTime": (year * 10000 + months * 100 + days).astype(np.int64),
        "client_id": rng.integers(0, 10_000, n_rows).astype(np.int64),
    })
