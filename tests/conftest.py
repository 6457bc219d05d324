import os
import sys

# Tests see the REAL device count (1 CPU device) — the 512-device forcing
# lives exclusively in repro.launch.dryrun (see the assignment contract).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def transactions():
    from repro.data.synthetic import make_transactions_table

    return make_transactions_table(n_rows=20_000, seed=1)


@pytest.fixture
def lakehouse(tmp_path, transactions):
    """(catalog, store) with the transactions table committed."""
    from repro.columnar import Catalog, ObjectStore

    store = ObjectStore(str(tmp_path / "s3"))
    catalog = Catalog(store)
    catalog.write_table("transactions", transactions, rows_per_file=5_000)
    return catalog, store


@pytest.fixture
def cluster(tmp_path, lakehouse):
    from repro.core import LocalCluster

    catalog, store = lakehouse
    c = LocalCluster(catalog, store, str(tmp_path / "dp"), n_workers=2)
    yield c
    c.close()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")
