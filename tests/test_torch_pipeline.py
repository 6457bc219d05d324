"""The slice as a whole: the paper pipeline (transactions -> euro_selection
-> usd_by_country) through the port's bp.run on a port LocalCluster
(device="cpu": the kernels' plain versions) against the same DAG through
repro.run on the JAX backend, on one catalog written by the JAX package.
Unsharded, and sharded in 4 with a GroupByCombine merged in a CombineTask.
Tolerance: country keys exact, usd rtol 1e-5 (float32 sums in another
order)."""
import numpy as np
import pytest

import repro as jbp
from repro.columnar import Catalog as JCatalog
from repro.columnar import ObjectStore as JStore
from repro.columnar import compute as jcompute
from repro.core import CombineTask as JCombineTask
from repro.core import LocalCluster as JCluster
from repro.data.synthetic import make_transactions_table
from repro_torch.columnar import Catalog as TCatalog
from repro_torch.columnar import ObjectStore as TStore
from repro_torch.configs.paper_pipeline import build_project, smoke_config
from repro_torch.core import CombineTask as TCombineTask
from repro_torch.core import LocalCluster as TCluster
from repro_torch.kernels import ops

AGGS = {"usd": ("usd", "sum")}


def jax_project(cfg, combine=False):
    """The paper DAG on the JAX package's device backend. Built here, as
    repro/configs/paper_pipeline.py only builds its numpy form."""
    proj = jbp.Project(cfg.name + "-jax")
    filt = "country IN (%s)" % ",".join(f"'{c}'" for c in cfg.countries)
    combinable = (jbp.GroupByCombine(["country"], AGGS, backend="jax")
                  if combine else None)

    @proj.model(rowwise=combine)
    @proj.python(cfg.envs[0][0], dict(cfg.envs[0][1]))
    def euro_selection(data=jbp.Model(cfg.source_table,
                                      columns=list(cfg.pushdown_columns),
                                      filter=cfg.date_filter)):
        return jcompute.filter_table(data, filt, backend="jax")

    @proj.model(materialize=True, combinable=combinable)
    @proj.python(cfg.envs[1][0], dict(cfg.envs[1][1]))
    def usd_by_country(data=jbp.Model("euro_selection")):
        return jcompute.group_by(data, ["country"], AGGS, backend="jax")

    return proj


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """smoke_config() transactions, written once by the JAX package."""
    cfg = smoke_config()
    root = tmp_path_factory.mktemp("lake") / "s3"
    JCatalog(JStore(str(root))).write_table(
        cfg.source_table, make_transactions_table(cfg.source_rows, seed=0),
        rows_per_file=cfg.rows_per_file)
    return str(root)


def _run_jax(store_root, scratch, cfg, combine=False, **kw):
    catalog = JCatalog(JStore(store_root))
    cluster = JCluster(catalog, catalog.store, scratch, n_workers=4)
    try:
        res = jbp.run(jax_project(cfg, combine), cluster=cluster, **kw)
        return res, res.read("usd_by_country", cluster)
    finally:
        cluster.close()


def _run_torch(store_root, scratch, cfg, combine=False, **kw):
    import repro_torch as tbp

    catalog = TCatalog(TStore(store_root))
    cluster = TCluster(catalog, catalog.store, scratch, n_workers=4)
    try:
        res = tbp.run(build_project(cfg, device="cpu", combine=combine),
                      cluster=cluster, **kw)
        return res, res.read("usd_by_country", cluster)
    finally:
        cluster.close()


def _assert_same_result(t, j):
    assert t.column_names == j.column_names == ["country", "usd"]
    assert list(t.column("country").to_numpy()) == \
        list(j.column("country").to_numpy())
    assert t.column("usd").data.dtype == j.column("usd").data.dtype
    np.testing.assert_allclose(np.asarray(t.column("usd").data, np.float64),
                               np.asarray(j.column("usd").data, np.float64),
                               rtol=1e-5)


def test_catalog_written_by_jax_reads_back_identically(store_root):
    cfg = smoke_config()
    j = JCatalog(JStore(store_root)).read_table(cfg.source_table)
    t = TCatalog(TStore(store_root)).read_table(cfg.source_table)
    assert t.num_rows == j.num_rows == cfg.source_rows
    assert t.column_names == j.column_names
    for name in j.column_names:
        a, b = t.column(name), j.column(name)
        assert a.kind == b.kind
        assert a.data.tobytes() == b.data.tobytes()
        if b.offsets is not None:
            assert a.offsets.tobytes() == b.offsets.tobytes()


def test_colfile_bytes_identical(tmp_path):
    """Both packages write the same data files for the same table (the
    JSON metadata carries snapshot ids and times)."""
    from repro_torch.data.synthetic import make_transactions_table as t_make

    JCatalog(JStore(str(tmp_path / "j"))).write_table(
        "t", make_transactions_table(3000, seed=5), rows_per_file=1000)
    TCatalog(TStore(str(tmp_path / "t"))).write_table(
        "t", t_make(3000, seed=5), rows_per_file=1000)
    jfiles = sorted(p for p in (tmp_path / "j").rglob("*") if p.is_file()
                    and p.suffix != ".json")
    tfiles = sorted(p for p in (tmp_path / "t").rglob("*") if p.is_file()
                    and p.suffix != ".json")
    assert len(jfiles) == len(tfiles) >= 3
    for a, b in zip(tfiles, jfiles):
        assert a.relative_to(tmp_path / "t") == b.relative_to(tmp_path / "j")
        assert a.read_bytes() == b.read_bytes(), a.name


def test_pipeline_unsharded_matches_jax(store_root, tmp_path):
    cfg = smoke_config()
    ops.reset_launch_counts()
    tres, t = _run_torch(store_root, str(tmp_path / "t"), cfg)
    jres, j = _run_jax(store_root, str(tmp_path / "j"), cfg)
    _assert_same_result(t, j)
    assert sorted(t.column("country").to_numpy()) == sorted(cfg.countries)
    assert np.all(np.isfinite(t.column("usd").data))
    assert sorted(tres.plan.tasks) == sorted(jres.plan.tasks)
    assert sum(ops.launch_counts().values()) == 0      # CPU: plain versions


@pytest.mark.parametrize("combine", [False, True])
def test_cache_never_serves_one_device_to_the_other(store_root, tmp_path,
                                                    combine):
    """On one cluster a CPU run's cached results are reused by the same
    CPU DAG but never by the card's: the card DAG's functions have other
    cache keys, so it runs its kernels (and raises here, with no card)."""
    import repro_torch as tbp
    from repro_torch.core import Client

    cfg = smoke_config()
    kw = dict(shard_threshold_bytes=1, max_shards=4) if combine else {}
    catalog = TCatalog(TStore(store_root))
    cluster = TCluster(catalog, catalog.store, str(tmp_path), n_workers=2)
    try:
        cpu = build_project(cfg, device="cpu", combine=combine)
        first = tbp.run(cpu, cluster=cluster, **kw)
        client = Client()
        again = tbp.run(build_project(cfg, device="cpu", combine=combine),
                        cluster=cluster, client=client, **kw)
        hits = {e.task_id for e in client.events if e.kind == "cache_hit"}
        assert any(t.startswith("func:usd_by_country") for t in hits)
        card = build_project(cfg, device="cuda", combine=combine)
        for name, spec in card.functions.items():
            assert spec.env.env_id != cpu.functions[name].env.env_id, name
        with pytest.raises(Exception, match="(?i)cuda"):
            tbp.run(card, cluster=cluster, **kw)
        _assert_same_result(first.read("usd_by_country", cluster),
                            again.read("usd_by_country", cluster))
    finally:
        cluster.close()


def test_pipeline_sharded_combine_matches_jax(store_root, tmp_path):
    cfg = smoke_config()
    kw = dict(combine=True, shard_threshold_bytes=1, max_shards=4)
    tres, t = _run_torch(store_root, str(tmp_path / "t"), cfg, **kw)
    jres, j = _run_jax(store_root, str(tmp_path / "j"), cfg, **kw)
    assert isinstance(tres.plan.tasks["func:usd_by_country"], TCombineTask)
    assert isinstance(jres.plan.tasks["func:usd_by_country"], JCombineTask)
    partials = [k for k in tres.plan.tasks
                if k.startswith("func:usd_by_country#")]
    assert len(partials) == 4
    assert sorted(tres.plan.tasks) == sorted(jres.plan.tasks)
    _assert_same_result(t, j)
    # the sharded result is the unsharded one
    _, unsharded = _run_torch(store_root, str(tmp_path / "u"), cfg)
    _assert_same_result(t, unsharded)
