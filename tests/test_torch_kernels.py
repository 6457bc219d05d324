"""The port's kernel wrappers (``repro_torch.kernels.ops``, plain versions on
the CPU) against the JAX package's Pallas wrappers (interpret mode) and jnp
oracles, on the same numpy inputs. Sweeps follow tests/test_kernels.py and
tests/test_shard_combine.py. Tolerances: compaction exact (count and
indices); group-by rtol/atol 1e-4 (float32 sums in another order);
combine 1e-5."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.kernels import filter_compact as jfc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import filter_compact as tfc
from repro_torch.kernels import ops, ref

FNS = ["sum", "count", "mean", "min", "max"]


def _groupby_both(vals, codes, g, fn):
    got = ops.groupby_aggregate(vals, codes, g, fn, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (g,)
    want = np.asarray(jops.groupby_aggregate(jnp.asarray(vals),
                                             jnp.asarray(codes), g, fn,
                                             block_n=256))
    return got.numpy(), want


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------


@given(st.integers(10, 3000), st.integers(1, 200), st.sampled_from(FNS))
@settings(max_examples=20, deadline=None)
def test_groupby_matches_jax(n, g, fn):
    rng = np.random.default_rng(n * 31 + g)
    vals = rng.standard_normal(n).astype(np.float32)
    codes = rng.integers(0, g, n).astype(np.int32)
    got, want = _groupby_both(vals, codes, g, fn)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    oracle = np.asarray(jref.ref_groupby(jnp.asarray(vals),
                                         jnp.asarray(codes), g, fn))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_groupby_empty_groups():
    vals = np.ones(64, np.float32)
    codes = np.zeros(64, np.int32)
    got, want = _groupby_both(vals, codes, 5, "sum")
    np.testing.assert_allclose(got, [64, 0, 0, 0, 0])
    np.testing.assert_allclose(got, want)
    for fn in ("min", "max", "mean", "count"):
        got, want = _groupby_both(vals, codes, 5, fn)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", FNS)
def test_groupby_exactly_128_groups(fn):
    """n_groups equal to the Pallas lane padding: no spare group for the
    padded rows, so they must contribute nothing."""
    rng = np.random.default_rng(128)
    vals = rng.standard_normal(1000).astype(np.float32)
    codes = rng.integers(0, 128, 1000).astype(np.int32)
    got, want = _groupby_both(vals, codes, 128, fn)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fn", ["sum", "min", "max"])
def test_groupby_drops_out_of_range_codes(fn):
    """Codes outside [0, n_groups) land in the Pallas wrapper's sliced-off
    padding groups or match no group; the port drops them the same way."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(500).astype(np.float32)
    codes = rng.integers(-3, 13, 500).astype(np.int32)
    got, want = _groupby_both(vals, codes, 10, fn)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fn", FNS)
def test_groupby_empty_input(fn):
    """No rows: the neutral element per group (the Pallas wrapper cannot
    take zero rows, so the jnp oracle is the reference here)."""
    ops.reset_launch_counts()
    got = ops.groupby_aggregate(np.zeros(0, np.float32),
                                np.zeros(0, np.int32), 4, fn, device="cpu")
    want = np.asarray(jref.ref_groupby(jnp.zeros(0, jnp.float32),
                                       jnp.zeros(0, jnp.int32), 4, fn))
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,g", [(1, 5), (3, 130), (8, 128), (11, 260)])
def test_combine_matches_jax(p, g):
    rng = np.random.default_rng(13 + p)
    vals = rng.normal(size=(p, g)).astype(np.float32)
    for fn in ("sum", "count", "min", "max"):
        neutral = {"sum": 0.0, "count": 0.0, "min": np.inf,
                   "max": -np.inf}[fn]
        parts = np.where(rng.random((p, g)) < 0.3, neutral,
                         vals).astype(np.float32)
        got = ops.combine_aggregate(parts, g, fn, device="cpu").numpy()
        want = np.asarray(jops.combine_aggregate(jnp.asarray(parts), g, fn))
        oracle = np.asarray(jref.ref_combine(jnp.asarray(parts), fn))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_combine_rejects_mean():
    with pytest.raises(ValueError):
        ops.combine_aggregate(np.zeros((2, 3), np.float32), 3, "mean",
                              device="cpu")


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _compact_both(mask, block_n):
    idx, cnt = ops.compact(mask, block_n=block_n, device="cpu")
    jidx, jcnt = jops.compact(jnp.asarray(mask), block_n=block_n)
    return idx.numpy(), int(cnt), np.asarray(jidx), int(jcnt)


@given(st.integers(1, 5000), st.floats(0.0, 1.0))
@settings(max_examples=25, deadline=None)
def test_compact_matches_jax(n, p):
    rng = np.random.default_rng(int(n * 1000 * (p + 1)))
    mask = rng.random(n) < p
    idx, cnt, jidx, jcnt = _compact_both(mask, 256)
    want = np.nonzero(mask)[0]
    assert cnt == jcnt == len(want)
    np.testing.assert_array_equal(idx[:cnt], want)
    # the tail is the wrapper's N-1 fill in both packages
    np.testing.assert_array_equal(idx, jidx)
    oracle, ocnt = ref.ref_compact(torch.from_numpy(mask))
    assert int(ocnt) == cnt
    np.testing.assert_array_equal(oracle.numpy()[:cnt], want)


@pytest.mark.parametrize("n", [512, 1000])
def test_compact_all_and_none(n):
    idx, cnt, jidx, jcnt = _compact_both(np.ones(n, bool), 128)
    assert cnt == jcnt == n
    np.testing.assert_array_equal(idx, np.arange(n))
    np.testing.assert_array_equal(idx, jidx)
    idx0, cnt0, jidx0, jcnt0 = _compact_both(np.zeros(n, bool), 128)
    assert cnt0 == jcnt0 == 0
    np.testing.assert_array_equal(idx0, jidx0)


def test_compact_empty_mask():
    idx, cnt = ops.compact(np.zeros(0, bool), device="cpu")
    jidx, jcnt = jref.ref_compact(jnp.zeros(0, bool))
    assert int(cnt) == int(jcnt) == 0
    assert tuple(idx.shape) == jidx.shape == (0,)


def test_compact_indices_host():
    mask = np.random.default_rng(3).random(2049) < 0.4
    got = ops.compact_indices(mask, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jops.compact_indices(mask)))


@pytest.mark.parametrize("n,bn", [(1024, 256), (4096, 1024), (640, 128)])
def test_block_counts_matches_pallas_kernel(n, bn):
    """The first pass on its own: per-block survivor counts."""
    mask = np.random.default_rng(n).random(n) < 0.37
    got = tfc.block_counts(torch.from_numpy(mask), bn)
    want = np.asarray(jfc.block_counts(jnp.asarray(mask), bn, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_compact_ragged_last_block():
    """A last block shorter than block_n needs no padding."""
    mask = np.random.default_rng(11).random(1000) < 0.5
    m = torch.from_numpy(mask)
    counts = tfc.block_counts(m, 256)
    assert counts.shape == (4,)
    offsets = torch.zeros(5, dtype=torch.int64)
    torch.cumsum(counts, 0, out=offsets[1:])
    idx = tfc.block_compact(m, offsets, 256).numpy()
    c = int(mask.sum())
    np.testing.assert_array_equal(idx[:c], np.nonzero(mask)[0])
    assert (idx[c:] == 999).all()


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    mask = np.random.default_rng(5).random(300) < 0.5
    ops.compact(mask, device="cpu")
    ops.groupby_aggregate(np.ones(300, np.float32),
                          np.zeros(300, np.int32), 3, "mean", device="cpu")
    ops.combine_aggregate(np.ones((2, 3), np.float32), 3, device="cpu")
    assert ops.launch_counts() == {"block_counts": 0, "block_compact": 0,
                                   "groupby": 0, "combine": 0}
