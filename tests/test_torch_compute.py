"""The port's columnar compute on its torch backend (device="cpu": the plain
versions) against the JAX package's ``backend="jax"`` (Pallas interpret
mode) and ``"numpy"``, on identical numpy inputs: filter_table, group_by,
partial_group_by + combine_group_by, and the GroupByCombine contract. Cases
follow tests/test_kernels.py:137-152 and tests/test_shard_combine.py:256-290.
Tolerances: filter exact; group-by rtol 1e-6 against numpy as in
test_kernels.py, 1e-5 against the JAX kernels (both float32, summed in
another order); combine rtol 1e-5; contract rtol 1e-4, as the reference's
own tests use."""
import numpy as np
import pytest

import repro as jbp
import repro_torch as tbp
from repro.columnar import compute as jcompute
from repro.columnar.table import ColumnTable as JTable
from repro.data.synthetic import make_transactions_table as j_transactions
from repro_torch.columnar import compute as tcompute
from repro_torch.columnar.table import from_numpy_columns
from repro_torch.data.synthetic import make_transactions_table as t_transactions
from repro_torch.kernels import ops


def _tables(data):
    """The same numpy columns as a JAX-package table and a port table."""
    return JTable.from_pydict(data), from_numpy_columns(data)


def _random_data(rng, n_rows, key_card):
    """Integer-valued columns (exact float sums), as test_shard_combine."""
    return {
        "k": rng.integers(0, key_card, n_rows).astype(np.float64),
        "v1": rng.integers(-1000, 1000, n_rows),
        "v2": rng.integers(0, 500, n_rows).astype(np.float64),
    }


def _split(rng, jt, tt, n_shards):
    n = jt.num_rows
    cuts = sorted(rng.integers(0, n + 1, n_shards - 1).tolist())
    edges = [0] + cuts + [n]
    spans = [(edges[i], edges[i + 1] - edges[i]) for i in range(n_shards)]
    return ([jt.slice(a, b) for a, b in spans],
            [tt.slice(a, b) for a, b in spans])


def _assert_same_table(t, j, rtol=0.0, ctx=""):
    assert t.column_names == j.column_names, ctx
    for c in j.column_names:
        a, b = t.column(c), j.column(c)
        if b.kind == "utf8":
            assert list(a.to_numpy()) == list(b.to_numpy()), (ctx, c)
        elif rtol == 0.0:
            np.testing.assert_array_equal(a.data, b.data, err_msg=f"{ctx} {c}")
        else:
            np.testing.assert_allclose(np.asarray(a.data, np.float64),
                                       np.asarray(b.data, np.float64),
                                       rtol=rtol, err_msg=f"{ctx} {c}")


def test_from_numpy_columns_matches_from_pydict():
    data = {"i": np.arange(5, dtype=np.int64),
            "f": np.linspace(0.0, 1.0, 5),
            "s": ["a", "bb", "", "ccc", "d"]}
    jt, tt = _tables(data)
    for c in data:
        a, b = tt.column(c), jt.column(c)
        assert a.kind == b.kind
        np.testing.assert_array_equal(a.data, b.data)
        if b.offsets is not None:
            np.testing.assert_array_equal(a.offsets, b.offsets)
    with pytest.raises(TypeError):
        from_numpy_columns({"x": [1, "a"]})


def test_synthetic_transactions_identical():
    _assert_same_table(t_transactions(3000, seed=4), j_transactions(3000, seed=4))


@pytest.mark.parametrize("predicate", ["usd > 100",
                                       "country IN ('IT','FR','DE')"])
def test_filter_table_torch_matches_jax_and_numpy(predicate):
    jt = j_transactions(20_000, seed=1)
    tt = t_transactions(20_000, seed=1)
    got = tcompute.filter_table(tt, predicate, backend="torch", device="cpu")
    _assert_same_table(got, jcompute.filter_table(jt, predicate,
                                                  backend="jax"), ctx="jax")
    _assert_same_table(got, jcompute.filter_table(jt, predicate), ctx="np")
    assert got.num_rows < tt.num_rows


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count"])
def test_group_by_torch_matches_jax_and_numpy(fn):
    jt = jcompute.filter_table(j_transactions(20_000, seed=1), "usd > 100")
    tt = tcompute.filter_table(t_transactions(20_000, seed=1), "usd > 100",
                               backend="torch", device="cpu")
    aggs = {"s": ("usd", fn)}
    got = tcompute.group_by(tt, ["country"], aggs, backend="torch",
                            device="cpu")
    jx = jcompute.group_by(jt, ["country"], aggs, backend="jax")
    npy = jcompute.group_by(jt, ["country"], aggs)
    # the device path hands back the kernels' float32, as the JAX one does
    assert got.column("s").data.dtype == jx.column("s").data.dtype
    _assert_same_table(got, jx, rtol=1e-5, ctx="jax")
    _assert_same_table(got, npy, rtol=1e-6, ctx="numpy")


def test_group_by_integer_source_and_multi_key():
    rng = np.random.default_rng(3)
    data = _random_data(rng, 2000, 17)
    data["s"] = [f"s{i}" for i in rng.integers(0, 4, 2000)]
    jt, tt = _tables(data)
    aggs = {"t": ("v1", "sum"), "lo": ("v1", "min"), "m": ("v2", "mean")}
    got = tcompute.group_by(tt, ["k", "s"], aggs, backend="torch",
                            device="cpu")
    _assert_same_table(got, jcompute.group_by(jt, ["k", "s"], aggs,
                                              backend="jax"), rtol=1e-5)
    _assert_same_table(got, jcompute.group_by(jt, ["k", "s"], aggs),
                       rtol=1e-6)
    assert got.column("t").data.dtype == np.int64     # int sums stay int


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_combine_group_by_torch_matches_jax_and_numpy(n_shards):
    rng = np.random.default_rng(17 + n_shards)
    jt, tt = _tables(_random_data(rng, 1500, 40))
    aggs = {"s": ("v1", "sum"), "m": ("v2", "mean"), "lo": ("v2", "min"),
            "n": ("v1", "count"), "hi": ("v1", "max")}
    jshards, tshards = _split(rng, jt, tt, n_shards)
    jparts = [jcompute.partial_group_by(s, ["k"], aggs) for s in jshards]
    tparts = [tcompute.partial_group_by(s, ["k"], aggs, backend="torch",
                                        device="cpu") for s in tshards]
    for a, b in zip(tparts, jparts):
        _assert_same_table(a, b, rtol=1e-6, ctx="partial")
    got = tcompute.combine_group_by(tparts, ["k"], aggs, backend="torch",
                                    device="cpu")
    jx = jcompute.combine_group_by(jparts, ["k"], aggs, backend="jax")
    npy = jcompute.combine_group_by(jparts, ["k"], aggs)
    _assert_same_table(got, jx, rtol=1e-5, ctx="jax")
    _assert_same_table(got, npy, rtol=1e-5, ctx="numpy")
    # and the combine equals the unsharded aggregate
    _assert_same_table(got, jcompute.group_by(jt, ["k"], aggs), rtol=1e-5)


def test_combine_group_by_all_empty_shards():
    jt, tt = _tables(_random_data(np.random.default_rng(2), 10, 3))
    aggs = {"s": ("v1", "sum"), "m": ("v2", "mean")}
    jparts = [jcompute.partial_group_by(jt.slice(0, 0), ["k"], aggs)] * 2
    tparts = [tcompute.partial_group_by(tt.slice(0, 0), ["k"], aggs,
                                        backend="torch", device="cpu")] * 2
    got = tcompute.combine_group_by(tparts, ["k"], aggs, backend="torch",
                                    device="cpu")
    _assert_same_table(got, jcompute.combine_group_by(jparts, ["k"], aggs,
                                                      backend="jax"))
    assert got.num_rows == 0


def test_groupby_contract_backend_torch():
    """GroupByCombine(backend="torch") runs both halves through the kernel
    wrappers; backend and device are part of the contract identity."""
    rng = np.random.default_rng(19)
    jt, tt = _tables(_random_data(rng, 1200, 30))
    aggs = {"s": ("v1", "sum"), "m": ("v2", "mean")}
    jshards, tshards = _split(rng, jt, tt, 3)
    np_c = tbp.GroupByCombine(["k"], aggs)
    cpu_c = tbp.GroupByCombine(["k"], aggs, backend="torch", device="cpu")
    cuda_c = tbp.GroupByCombine(["k"], aggs, backend="torch")
    assert len({np_c.contract_id, cpu_c.contract_id, cuda_c.contract_id}) == 3
    jx_c = jbp.GroupByCombine(["k"], aggs, backend="jax")
    ops.reset_launch_counts()
    got = cpu_c.combine([cpu_c.partial(data=s) for s in tshards])
    assert sum(ops.launch_counts().values()) == 0
    want_np = np_c.combine([np_c.partial(data=s) for s in tshards])
    want_jx = jx_c.combine([jx_c.partial(data=s) for s in jshards])
    _assert_same_table(got, want_np, rtol=1e-4)
    _assert_same_table(got, want_jx, rtol=1e-4)


def test_torch_backend_on_cuda_without_a_card_raises(monkeypatch):
    """device="cuda" never quietly runs the plain versions."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = t_transactions(100, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompute.filter_table(tt, "usd > 10", backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompute.group_by(tt, ["country"], {"s": ("usd", "sum")},
                          backend="torch", device="cuda")
