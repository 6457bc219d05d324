"""The port's CUDA kernels against their plain PyTorch versions on the card,
and one small pipeline run there. Marked ``cuda``: the card is looked for
inside a fixture, so every worker collects the same tests and each one
skips where torch sees no GPU. Run on the card with
``pytest -m cuda tests/test_torch_cuda.py``. Tolerances as in the CPU
tests: compaction exact, group-by rtol/atol 1e-4, combine 1e-5."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import filter_compact as fc
from repro_torch.kernels import groupby_agg as gb
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,p", [(1, 1.0), (777, 0.5), (100_003, 0.3),
                                 (65_536, 1.0), (65_536, 0.0)])
def test_compaction_kernels_match_plain(card, n, p):
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < p).to(card)
    bn = min(1024, n)
    counts = fc.block_counts(mask, bn)
    assert torch.equal(counts, ref.ref_block_counts(mask, bn))
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=card)
    torch.cumsum(counts, 0, out=offsets[1:])
    assert torch.equal(fc.block_compact(mask, offsets, bn),
                       ref.ref_block_compact(mask, offsets, bn))
    idx, cnt = ops.compact(mask, device=card)
    oracle, ocnt = ref.ref_compact(mask)
    c = int(cnt)
    assert c == int(ocnt)
    assert torch.equal(idx[:c], oracle[:c])
    assert bool((idx[c:] == n - 1).all())


@pytest.mark.parametrize("g", [6, 128, 5000, 100_000])
@pytest.mark.parametrize("fn", ["sum", "count", "min", "max", "mean"])
def test_groupby_kernel_matches_plain(card, g, fn):
    rng = np.random.default_rng(g)
    n = 300_001
    vals = torch.from_numpy(rng.gamma(2.0, 50.0, n).astype(np.float32)).to(card)
    codes = torch.from_numpy(rng.integers(-1, g + 1, n)
                             .astype(np.int32)).to(card)
    got = ops.groupby_aggregate(vals, codes, g, fn, device=card)
    want = ref.ref_groupby(vals, codes, g, fn)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,g", [(1, 5), (4, 6), (11, 260), (64, 200_000)])
@pytest.mark.parametrize("fn", ["sum", "count", "min", "max"])
def test_combine_kernel_matches_plain(card, p, g, fn):
    rng = np.random.default_rng(p * g)
    neutral = {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf}[fn]
    parts = np.where(rng.random((p, g)) < 0.3, neutral,
                     rng.normal(size=(p, g))).astype(np.float32)
    t = torch.from_numpy(parts).to(card)
    torch.testing.assert_close(gb.combine(t, fn), ref.ref_combine(t, fn),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_on_the_card_matches_cpu(card, tmp_path):
    import repro_torch as bp
    from repro_torch.columnar import Catalog, ObjectStore
    from repro_torch.configs.paper_pipeline import build_project, smoke_config
    from repro_torch.core import LocalCluster
    from repro_torch.data.synthetic import make_transactions_table

    cfg = smoke_config()
    catalog = Catalog(ObjectStore(str(tmp_path / "s3")))
    catalog.write_table(cfg.source_table,
                        make_transactions_table(cfg.source_rows, seed=0),
                        rows_per_file=cfg.rows_per_file)
    out = {}
    for device in ("cuda", "cpu"):
        cluster = LocalCluster(catalog, catalog.store,
                               str(tmp_path / f"dp-{device}"))
        try:
            ops.reset_launch_counts()
            res = bp.run(build_project(cfg, device=device), cluster=cluster)
            out[device] = res.read("usd_by_country", cluster)
            if device == "cuda":
                launches = ops.launch_counts()
                for k in ("block_counts", "block_compact", "groupby"):
                    assert launches[k] >= 1, launches
        finally:
            cluster.close()
    a, b = out["cuda"], out["cpu"]
    assert list(a.column("country").to_numpy()) == \
        list(b.column("country").to_numpy())
    np.testing.assert_allclose(a.column("usd").data, b.column("usd").data,
                               rtol=1e-5)
