#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the script (non-zero exit, no result line):

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel of the path for sm_90a (ptxas report)
3. kernels  each CUDA kernel against its plain PyTorch version on the card,
            at N = 16,777,216 rows, ragged N, all-true / all-false masks,
            G in {6, 10, 40000, 100000}, combine P in {4, 64} x G in
            {6, 200000}: compaction exact, group-by rtol/atol 1e-4, combine
            1e-5
4. main     the paper pipeline (transactions -> euro_selection ->
            usd_by_country, 1,000,000 rows in files of 100,000 from --seed)
            through the port's bp.run on a LocalCluster on the card, then the
            same with device="cpu" and with the numpy backend: agreement to
            rtol 1e-5, and the launch counts of the card run
5. sharded  the same data in 4 shards, usd_by_country a
            GroupByCombine(backend="torch"): per-shard filter and group-by, a
            CombineTask on the card; agreement with the CPU run
6. scale    10,000,000 rows in files of 1,000,000, unsharded, on the card,
            against the numpy backend; wall time and host/device split
7. time     each kernel at the shapes the main and sharded runs gave it
            (their own inputs, checked again against the plain versions) and
            at 16M rows: kernel, bound, plain-version and library times

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Nothing of JAX is imported. Data and build outputs go under build/ in the
checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published peak
FP32_OPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
N_BIG = 16_777_216


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail(f"phase {name} failed")
    log(name, f"done in {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log("device", card)
    log("device", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                  f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    log("build", f"{', '.join(p.name for p in paths.values())} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for name, out in build.build_logs.items():
        for line in out.splitlines():
            if "Compiling entry" in line or "Used" in line:
                log("build", f"{name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _usd_like(rng, n):
    import numpy as np

    return np.round(rng.gamma(2.0, 50.0, n), 2).astype(np.float32)


def check_compaction(mask, errs, tag):
    import torch
    from repro_torch.kernels import filter_compact as fc, ops, ref

    bn = min(1024, mask.shape[0])
    counts = fc.block_counts(mask, bn)
    want_counts = ref.ref_block_counts(mask, bn)
    if not torch.equal(counts, want_counts):
        raise AssertionError(f"block_counts {tag}: differs from plain version")
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=mask.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    idx = fc.block_compact(mask, offsets, bn)
    want_idx = ref.ref_block_compact(mask, offsets, bn)
    if not torch.equal(idx, want_idx):
        raise AssertionError(f"block_compact {tag}: differs from plain version")
    got, cnt = ops.compact(mask, device=mask.device)
    oracle, ocnt = ref.ref_compact(mask)
    c = int(cnt)
    if c != int(ocnt) or not torch.equal(got[:c], oracle[:c]):
        raise AssertionError(f"ops.compact {tag}: differs from ref_compact")
    torch.cuda.synchronize()
    errs["block_counts"].append(0.0)
    errs["block_compact"].append(0.0)
    log("kernels", f"compaction {tag}: count={c} exact")


def check_groupby(vals, codes, n_groups, fn, errs, tag):
    import torch
    from repro_torch.kernels import groupby_agg as gb, ops, ref

    if fn == "mean":
        got = ops.groupby_aggregate(vals, codes, n_groups, "mean",
                                    device=vals.device)
    else:
        got = gb.groupby(vals, codes, n_groups, fn)
    want = ref.ref_groupby(vals, codes, n_groups, fn)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"groupby {tag}: empty groups differ")
    errs["groupby"].append(err)
    log("kernels", f"groupby {tag} {fn}: max abs err {err:.6g}")


def check_combine(parts, fn, errs, tag):
    import torch
    from repro_torch.kernels import groupby_agg as gb, ref

    got = gb.combine(parts, fn)
    want = ref.ref_combine(parts, fn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    errs["combine"].append(err)
    log("kernels", f"combine {tag} {fn}: max abs err {err:.6g}")


def phase_kernels(seed):
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    errs = {"block_counts": [], "block_compact": [], "groupby": [],
            "combine": []}
    dev = "cuda"
    for n, p, tag in ((N_BIG, 0.3, "N=16777216 p=0.3"),
                      (1_000_003, 0.3, "N=1000003 p=0.3"),
                      (1_000_003, 1.0, "N=1000003 all-true"),
                      (1_000_003, 0.0, "N=1000003 all-false"),
                      (777, 0.5, "N=777 p=0.5")):
        mask = torch.from_numpy(rng.random(n) < p).to(dev)
        check_compaction(mask, errs, tag)
    vals = torch.from_numpy(_usd_like(rng, N_BIG)).to(dev)
    for g in (6, 10, 40_000, 100_000):
        codes = torch.from_numpy(rng.integers(0, g, N_BIG).astype(np.int32)).to(dev)
        for fn in ("sum", "count", "min", "max", "mean"):
            check_groupby(vals, codes, g, fn, errs, f"N={N_BIG} G={g}")
    # codes outside [0, G) are dropped, as the Pallas wrapper's padding does
    n = 1_000_003
    codes = torch.from_numpy(rng.integers(-1, 12, n).astype(np.int32)).to(dev)
    for fn in ("sum", "min"):
        check_groupby(vals[:n].contiguous(), codes, 10, fn, errs,
                      f"N={n} G=10 out-of-range codes")
    for p_, g in ((4, 6), (4, 200_000), (64, 6), (64, 200_000)):
        v = rng.normal(size=(p_, g)).astype(np.float32)
        absent = rng.random((p_, g)) < 0.3
        for fn in ("sum", "count", "min", "max"):
            neutral = {"sum": 0.0, "count": 0.0, "min": np.inf,
                       "max": -np.inf}[fn]
            parts = torch.from_numpy(np.where(absent, neutral, v)
                                     .astype(np.float32)).to(dev)
            check_combine(parts, fn, errs, f"P={p_} G={g}")
    # empty inputs: neutral results, no launch
    before = ops.launch_counts()
    e = ops.groupby_aggregate(np.zeros(0, np.float32), np.zeros(0, np.int32),
                              6, "min", device=dev)
    if not bool(torch.all(e == float("inf"))):
        raise AssertionError("empty groupby is not neutral")
    idx, cnt = ops.compact(np.zeros(0, bool), device=dev)
    if idx.numel() != 0 or int(cnt) != 0:
        raise AssertionError("empty compaction is not empty")
    if ops.launch_counts() != before:
        raise AssertionError("an empty input launched a kernel")
    torch.cuda.synchronize()
    log("kernels", "every kernel matches its plain version")
    return errs


# ---------------------------------------------------------------------------
# 4-6. the pipeline through bp.run
# ---------------------------------------------------------------------------


def write_catalog(cfg, seed, root: Path):
    from repro_torch.columnar import Catalog, ObjectStore
    from repro_torch.data.synthetic import make_transactions_table

    t0 = time.perf_counter()
    if root.exists():
        shutil.rmtree(root)
    store = ObjectStore(str(root / "s3"))
    catalog = Catalog(store)
    table = make_transactions_table(n_rows=cfg.source_rows, seed=seed)
    catalog.write_table(cfg.source_table, table,
                        rows_per_file=cfg.rows_per_file)
    return catalog, store, time.perf_counter() - t0


def numpy_project(cfg):
    """The same DAG (environments included) on the numpy backend: the host
    reference."""
    import repro_torch as bp
    from repro_torch.columnar import compute

    proj = bp.Project(cfg.name + "-numpy")
    filt = "country IN (%s)" % ",".join(f"'{c}'" for c in cfg.countries)

    @proj.model()
    @proj.python(cfg.envs[0][0], dict(cfg.envs[0][1]))
    def euro_selection(data=bp.Model(cfg.source_table,
                                     columns=list(cfg.pushdown_columns),
                                     filter=cfg.date_filter)):
        return compute.filter_table(data, filt)

    @proj.model(materialize=True)
    @proj.python(cfg.envs[1][0], dict(cfg.envs[1][1]))
    def usd_by_country(data=bp.Model("euro_selection")):
        return compute.group_by(data, ["country"], {"usd": ("usd", "sum")})

    return proj


def run_pipeline(project, catalog, store, scratch: Path, n_workers=2,
                 profile=False, **run_kw):
    """One bp.run on a fresh LocalCluster, so every timed run starts with
    cold caches. Returns (table, wall seconds, RunResult, client, profiler
    or None)."""
    import torch
    import repro_torch as bp
    from repro_torch.core import Client, LocalCluster

    if scratch.exists():
        shutil.rmtree(scratch)
    cluster = LocalCluster(catalog, store, str(scratch), n_workers=n_workers)
    client = Client()
    prof = None
    try:
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        res = bp.run(project, cluster=cluster, client=client, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        table = res.read("usd_by_country", cluster)
    finally:
        cluster.close()
    return table, wall, res, client, prof


def log_tasks(phase, what, client):
    """Host wall time of each task of a run, from its task_done events."""
    for e in client.events:
        if e.kind == "task_done":
            log(phase, f"  {what} task {e.task_id}: {e.payload.get('seconds')} "
                       f"s host wall, {e.payload.get('rows')} rows")


def as_dict(table):
    import numpy as np

    keys = [str(k) for k in table.column("country").to_numpy()]
    vals = np.asarray(table.column("usd").data, dtype=np.float64)
    return dict(zip(keys, vals.tolist()))


def assert_agree(got, want, what, countries):
    import numpy as np

    if sorted(got) != sorted(want) or sorted(got) != sorted(countries):
        raise AssertionError(f"{what}: countries {sorted(got)} vs "
                             f"{sorted(want)}")
    g = np.array([got[k] for k in sorted(got)])
    w = np.array([want[k] for k in sorted(want)])
    if not np.all(np.isfinite(g)):
        raise AssertionError(f"{what}: non-finite sums {got}")
    np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=what)


class ShapeRecorder:
    """Keeps a copy of the largest CUDA input each kernel wrapper saw while
    installed, so phase 7 can check and time the kernels on the main path's
    own inputs. The wrappers (and their launch counts) run unchanged."""

    TARGETS = (("filter_compact", "block_counts"),
               ("filter_compact", "block_compact"),
               ("groupby_agg", "groupby"), ("groupby_agg", "combine"))

    def __init__(self):
        self.calls = {}
        self._orig = []

    def __enter__(self):
        import importlib

        import torch

        for mod_name, fn_name in self.TARGETS:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            orig = getattr(mod, fn_name)

            def rec(*args, _orig=orig, _name=fn_name, **kw):
                size = args[0].numel()
                if args[0].is_cuda and size >= self.calls.get(_name, (-1,))[0]:
                    self.calls[_name] = (size, [a.clone() if torch.is_tensor(a)
                                                else a for a in args])
                return _orig(*args, **kw)

            setattr(mod, fn_name, rec)
            self._orig.append((mod, fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self._orig:
            setattr(mod, fn_name, orig)


def phase_main(cfg, seed):
    from repro_torch.configs.paper_pipeline import build_project
    from repro_torch.kernels import ops

    catalog, store, secs = write_catalog(cfg, seed, WORK / "main")
    log("main", f"wrote {cfg.source_table}: {cfg.source_rows} rows in files "
                f"of {cfg.rows_per_file} ({secs:.2f} s)")
    ops.reset_launch_counts()
    with ShapeRecorder() as rec:
        card, wall_card, res, client, _ = run_pipeline(
            build_project(cfg), catalog, store, WORK / "dp-main")
    launches = ops.launch_counts()
    log("main", f"bp.run on the card: {wall_card:.3f} s, "
                f"{card.num_rows} groups, launches {launches}")
    log_tasks("main", "card", client)
    for k in ("block_counts", "block_compact", "groupby"):
        if launches[k] < 1:
            raise AssertionError(f"main path never launched {k}")
    cpu, wall_cpu, _, _, _ = run_pipeline(build_project(cfg, device="cpu"),
                                          catalog, store, WORK / "dp-cpu")
    host, wall_np, _, np_client, _ = run_pipeline(numpy_project(cfg), catalog,
                                                  store, WORK / "dp-np")
    log_tasks("main", "numpy", np_client)
    if ops.launch_counts() != launches:
        raise AssertionError("a CPU run launched a CUDA kernel")
    got = as_dict(card)
    assert_agree(got, as_dict(cpu), "card vs device='cpu'", cfg.countries)
    assert_agree(got, as_dict(host), "card vs numpy backend", cfg.countries)
    log("main", f"matches device='cpu' ({wall_cpu:.3f} s) and the numpy "
                f"backend ({wall_np:.3f} s) to rtol 1e-5: {got}")
    return catalog, store, launches, rec.calls, {
        "card_s": wall_card, "cpu_s": wall_cpu, "numpy_s": wall_np}


def phase_sharded(cfg, catalog, store):
    from repro_torch.configs.paper_pipeline import build_project
    from repro_torch.core import CombineTask
    from repro_torch.kernels import ops

    kw = dict(n_workers=4, shard_threshold_bytes=1, max_shards=4)
    ops.reset_launch_counts()
    with ShapeRecorder() as rec:
        card, wall_card, res, _, _ = run_pipeline(
            build_project(cfg, combine=True), catalog, store,
            WORK / "dp-sharded", **kw)
    launches = ops.launch_counts()
    if not isinstance(res.plan.tasks.get("func:usd_by_country"), CombineTask):
        raise AssertionError("the sharded plan has no CombineTask")
    n_partials = sum(1 for t in res.plan.tasks
                     if t.startswith("func:usd_by_country#"))
    log("sharded", f"bp.run over {n_partials} shards on the card: "
                   f"{wall_card:.3f} s, launches {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"sharded path never launched {k}")
    cpu, wall_cpu, _, _, _ = run_pipeline(
        build_project(cfg, device="cpu", combine=True), catalog, store,
        WORK / "dp-sharded-cpu", **kw)
    assert_agree(as_dict(card), as_dict(cpu), "sharded card vs device='cpu'",
                 cfg.countries)
    log("sharded", f"matches the sharded device='cpu' run ({wall_cpu:.3f} s) "
                   "to rtol 1e-5")
    return launches, rec.calls, {"card_s": wall_card, "cpu_s": wall_cpu}


def _device_time_by_name(prof):
    """Device microseconds by kernel / copy name from a profiler run, or
    None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out or None


def phase_scale(cfg, seed):
    from repro_torch.configs.paper_pipeline import build_project
    from repro_torch.kernels import ops

    big = dataclasses.replace(cfg, source_rows=10_000_000,
                              rows_per_file=1_000_000)
    catalog, store, secs = write_catalog(big, seed, WORK / "scale")
    log("scale", f"wrote {big.source_rows} rows in files of "
                 f"{big.rows_per_file} ({secs:.2f} s)")
    ops.reset_launch_counts()
    card, wall_card, _, _, _ = run_pipeline(build_project(big), catalog, store,
                                            WORK / "dp-scale")
    launches = ops.launch_counts()
    host, wall_np, _, _, _ = run_pipeline(numpy_project(big), catalog, store,
                                          WORK / "dp-scale-np")
    assert_agree(as_dict(card), as_dict(host), "scale card vs numpy backend",
                 big.countries)
    log("scale", f"bp.run on the card: {wall_card:.3f} s (numpy backend "
                 f"{wall_np:.3f} s), launches {launches}; agree to rtol 1e-5")
    # a second card run under the profiler, for the host / device split
    _, wall_prof, _, client, prof = run_pipeline(
        build_project(big), catalog, store, WORK / "dp-scale-prof",
        profile=True)
    log("scale", f"profiled run: {wall_prof:.3f} s")
    log_tasks("scale", "card", client)
    dev = _device_time_by_name(prof) if prof is not None else None
    if dev is None:
        log("scale", "device time not measured (the profiler recorded no "
                     "device activity)")
        return {"card_s": wall_card, "numpy_s": wall_np}
    busy_ms = sum(dev.values()) / 1e3
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:12]:
        log("scale", f"  device {us / 1e3:.3f} ms  {name}")
    log("scale", f"device busy {busy_ms:.3f} ms of {wall_prof * 1e3:.1f} ms "
                 f"wall: device idle {100 * (1 - busy_ms / (wall_prof * 1e3)):.2f}%")
    return {"card_s": wall_card, "numpy_s": wall_np, "device_busy_ms": busy_ms}


# ---------------------------------------------------------------------------
# 7. time
# ---------------------------------------------------------------------------


def timing(fn):
    """Times of one call of ``fn``, after warm-up, over many calls:
    ``device_ms`` is the device time of everything it launched (kernels and
    copies) from the profiler's records; ``call_ms`` is CUDA-event time per
    call, which also holds the host's launch cost wherever the device waits
    on it. Without device records from the profiler, device_ms is None."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(max(0.2 / est, 10), 500))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = _device_time_by_name(prof)
    device_ms = sum(dev.values()) / 1e3 / iters if dev else None
    return {"device_ms": device_ms, "call_ms": call_ms}


def measure(kernel, plain, library, **row):
    """A row of times: ``ms`` / ``plain_ms`` / ``library_ms`` are device
    times from the profiler, ``*_call_ms`` the CUDA-event times per call.
    Where the profiler recorded no device time, the event time stands in
    and ``*_timer`` says "cuda_events" instead of "profiler"."""
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        t = timing(fn)
        from_profiler = t["device_ms"] is not None
        row[key] = t["device_ms"] if from_profiler else t["call_ms"]
        row[key.replace("ms", "call_ms")] = t["call_ms"]
        row[key.replace("ms", "timer")] = ("profiler" if from_profiler
                                           else "cuda_events")
    return row


def kernel_rows(main_calls, big_inputs):
    """One dict of times per kernel and shape: the main path's own inputs
    (checked once more against the plain versions) and the 16M-row ones."""
    import torch
    from repro_torch.kernels import filter_compact as fc
    from repro_torch.kernels import groupby_agg as gb
    from repro_torch.kernels import ref

    def compaction(args):
        # recorded as ops.compact calls them: (mask, bn), (mask, offsets, bn)
        mask, bn = args[0], args[-1]
        n = mask.shape[0]
        nb = -(-n // bn)
        counts = fc.block_counts(mask, bn)
        offsets = torch.zeros(nb + 1, dtype=torch.int64, device=mask.device)
        torch.cumsum(counts, 0, out=offsets[1:])
        return mask, bn, n, nb, offsets

    def held(got, want, rtol, atol, what):
        """Hold a kernel's result against its plain version (exact when
        rtol = atol = 0); returns the max abs and rel error."""
        if rtol == atol == 0.0:
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: differs from its plain version")
        else:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{what}: {m}")
        got, want = got.double(), want.double()
        fin = torch.isfinite(want)
        if not bool(fin.any()):
            return {"max_abs_err": 0.0, "max_rel_err": 0.0}
        diff = (got[fin] - want[fin]).abs()
        rel = diff / want[fin].abs().clamp(min=1e-30)
        return {"max_abs_err": float(diff.max()),
                "max_rel_err": float(rel.max())}

    rows = {}
    for tag, calls in (("main", main_calls), ("16m", big_inputs)):
        mask, bn, n, nb, offsets = compaction(calls["block_counts"][1])
        if n % bn == 0:
            library = lambda: torch.count_nonzero(mask.view(nb, bn), 1)
        else:
            # ragged N: one index_add of the mask into its block's count,
            # block ids and the int32 mask made outside the timed call
            zeros = torch.zeros(nb, dtype=torch.int32, device=mask.device)
            block_ids = torch.arange(n, device=mask.device) // bn
            mask_i32 = mask.int()
            library = lambda: torch.index_add(zeros, 0, block_ids, mask_i32)
        rows[("block_counts", tag)] = measure(
            lambda: fc.block_counts(mask, bn),
            lambda: ref.ref_block_counts(mask, bn), library,
            shape=f"N={n} block={bn}",
            **held(fc.block_counts(mask, bn), ref.ref_block_counts(mask, bn),
                   0.0, 0.0, f"block_counts [{tag}]"),
            **bound(n + 4 * nb, n))

        mask, bn, n, nb, offsets = compaction(calls["block_compact"][1])
        rows[("block_compact", tag)] = measure(
            lambda: fc.block_compact(mask, offsets, bn),
            lambda: ref.ref_block_compact(mask, offsets, bn),
            lambda: torch.nonzero(mask),
            shape=f"N={n} block={bn} survivors={int(offsets[-1])}",
            **held(fc.block_compact(mask, offsets, bn),
                   ref.ref_block_compact(mask, offsets, bn), 0.0, 0.0,
                   f"block_compact [{tag}]"),
            **bound(n + 8 * (nb + 1) + 4 * n, n))

        vals, codes, g, fn = calls["groupby"][1]
        n = vals.shape[0]
        idx64 = codes.long()
        base = torch.zeros(g, dtype=torch.float32, device=vals.device)
        reduce = {"sum": "sum", "count": "sum", "min": "amin",
                  "max": "amax"}[fn]
        src = torch.ones_like(vals) if fn == "count" else vals
        rows[("groupby", tag)] = measure(
            lambda: gb.groupby(vals, codes, g, fn),
            lambda: ref.ref_groupby(vals, codes, g, fn),
            lambda: torch.scatter_reduce(base, 0, idx64, src, reduce),
            shape=f"N={n} G={g} {fn}",
            **held(gb.groupby(vals, codes, g, fn),
                   ref.ref_groupby(vals, codes, g, fn), 1e-4, 1e-4,
                   f"groupby [{tag}]"),
            **bound(8 * n + 4 * g, n))

        parts, fn = calls["combine"][1]
        p, g = parts.shape
        lib = {"sum": lambda: parts.sum(0), "count": lambda: parts.sum(0),
               "min": lambda: parts.amin(0), "max": lambda: parts.amax(0)}[fn]
        rows[("combine", tag)] = measure(
            lambda: gb.combine(parts, fn),
            lambda: ref.ref_combine(parts, fn), lib,
            shape=f"P={p} G={g} {fn}",
            **held(gb.combine(parts, fn), ref.ref_combine(parts, fn), 1e-5,
                   1e-5, f"combine [{tag}]"),
            **bound(4 * p * g + 4 * g, (p - 1) * g))
    return rows


def bound(n_bytes, n_ops):
    """The least time the card could take: the longer of each input byte
    read once and each output byte written once at HBM_BYTES_PER_S, and the
    operations (one add, compare, min or max per element) at
    FP32_OPS_PER_S."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / FP32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by}


def big_inputs(seed):
    """16M-row inputs for the compaction and group-by kernels (G = 6, the
    paper's query) and a (64, 200000) stack for the combine."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 1)
    dev = "cuda"
    mask = torch.from_numpy(rng.random(N_BIG) < 0.3).to(dev)
    vals = torch.from_numpy(_usd_like(rng, N_BIG)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 6, N_BIG).astype(np.int32)).to(dev)
    parts = torch.from_numpy(rng.normal(size=(64, 200_000))
                             .astype(np.float32)).to(dev)
    return {"block_counts": (N_BIG, [mask, 1024]),
            "block_compact": (N_BIG, [mask, None, 1024]),
            "groupby": (N_BIG, [vals, codes, 6, "sum"]),
            "combine": (parts.numel(), [parts, "sum"])}


KERNELS = (
    ("block_counts", "src/repro_torch/kernels/csrc/filter_compact.cu",
     "src/repro/kernels/filter_compact.py:27"),
    ("block_compact", "src/repro_torch/kernels/csrc/filter_compact.cu",
     "src/repro/kernels/filter_compact.py:57"),
    ("groupby", "src/repro_torch/kernels/csrc/groupby_agg.cu",
     "src/repro/kernels/groupby_agg.py:101"),
    ("combine", "src/repro_torch/kernels/csrc/groupby_agg.cu",
     "src/repro/kernels/groupby_agg.py:79"),
)


def phase_time(main_calls, sharded_calls, launches_by_path, errs, seed):
    import torch

    calls = dict(sharded_calls)
    calls.update(main_calls)          # the unsharded run's shapes first
    missing = [k for k, _, _ in KERNELS if k not in calls]
    if missing:
        raise AssertionError(f"no recorded main-path input for {missing}")
    rows = kernel_rows(calls, big_inputs(seed))
    torch.cuda.synchronize()
    out = []
    fields = ("shape", "ms", "call_ms", "timer", "plain_ms", "plain_call_ms",
              "library_ms", "library_call_ms", "bound_ms", "bound_by",
              "max_abs_err", "max_rel_err")

    def fmt(v):
        return "n/a" if v is None else f"{v:.4f} ms"

    for name, source, replaces in KERNELS:
        for tag in ("main", "16m"):
            r = rows[(name, tag)]
            log("time", f"{name} [{tag}] {r['shape']}: kernel {fmt(r['ms'])} "
                        f"({r['timer']}) "
                        f"(per call {fmt(r['call_ms'])}), bound "
                        f"{fmt(r['bound_ms'])} ({r['bound_by']}), plain "
                        f"{fmt(r['plain_ms'])}, library {fmt(r['library_ms'])}"
                        f", max abs err {r['max_abs_err']:.6g} (rel "
                        f"{r['max_rel_err']:.3g})")
        main = rows[(name, "main")]
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "call_ms": main["call_ms"],
            "timer": main["timer"], "plain_timer": main["plain_timer"],
            "library_timer": main["library_timer"],
            "max_rel_err": main["max_rel_err"],
            "max_abs_err_checks": max(errs[name]) if errs[name] else None,
            "at_16m": {k: rows[(name, "16m")][k] for k in fields},
        })
    return out


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs.paper_pipeline import get_config

    card = run_phase("device", phase_device)
    run_phase("build", phase_build)
    errs = run_phase("kernels", phase_kernels, args.seed)
    cfg = get_config()
    catalog, store, main_launches, main_calls, _ = run_phase(
        "main", phase_main, cfg, args.seed)
    sharded_launches, sharded_calls, _ = run_phase(
        "sharded", phase_sharded, cfg, catalog, store)
    shutil.rmtree(WORK / "main", ignore_errors=True)
    run_phase("scale", phase_scale, cfg, args.seed)
    shutil.rmtree(WORK, ignore_errors=True)
    launches_by_path = {"main": main_launches, "sharded": sharded_launches}
    log("time", f"launches: {launches_by_path}")
    kernels = run_phase("time", phase_time, main_calls, sharded_calls,
                        launches_by_path, errs, args.seed)
    log("total", f"{time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
