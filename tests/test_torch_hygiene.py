"""What keeps the port a port: it imports neither JAX nor the JAX package,
a CUDA tensor or device never reaches a plain version, the kernels are
hand-written (no library call stands in for one), and the build targets
sm_90a and raises rather than falling back."""
import os
import re
import stat
import subprocess
import sys
import tokenize
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import filter_compact as fc
from repro_torch.kernels import groupby_agg as gb

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import\s+(repro|jax)\b(?!_)|from\s+(repro|jax)[.\s])"
    r"|import_module\(\s*['\"](repro|jax)[.'\"]"
    r"|__import__\(\s*['\"](repro|jax)[.'\"]", re.M)


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch, repro_torch.configs.paper_pipeline, "
            "repro_torch.kernels.ops, repro_torch.core, "
            "repro_torch.columnar.compute\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(repr(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in _port_sources():
        for m in FORBIDDEN_IMPORT.finditer(path.read_text()):
            line = path.read_text()[:m.start()].count("\n") + 1
            offenders.append(f"{path.relative_to(ROOT)}:{line}")
    assert offenders == []


def test_forbidden_import_pattern():
    for bad in ("import jax", "from jax import numpy", "import repro as bp",
                "    from repro.columnar import compute",
                "from repro import api", "import_module('repro.core')"):
        assert FORBIDDEN_IMPORT.search(bad), bad
    for ok in ("import repro_torch as bp", "from repro_torch.core import x",
               "# counterpart of repro/kernels/ops.py", "import jaxtyping_x"):
        assert not FORBIDDEN_IMPORT.search(ok), ok


def test_kernel_modules_call_no_library_kernel():
    """The yardsticks that chip_smoke.py times beside the kernels are never
    the kernels themselves, nor part of the plain versions."""
    banned = {"nonzero", "count_nonzero", "scatter_reduce", "scatter_reduce_",
              "index_add", "index_add_", "bincount", "segment_reduce",
              "compile"}
    for path in sorted((PORT / "kernels").glob("*.py")):
        with open(path, "rb") as f:
            names = {tok.string for tok in tokenize.tokenize(f.readline)
                     if tok.type == tokenize.NAME}
        assert names & banned == set(), path.name


def test_compact_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mask = np.ones(16, bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.compact(mask, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.compact_indices(mask)           # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.groupby_aggregate(np.ones(4, np.float32), np.zeros(4, np.int32), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.combine_aggregate(np.ones((2, 2), np.float32), 2)
    with pytest.raises(ValueError):
        ops.compact(mask, device="meta")


def test_only_cpu_tensors_reach_the_plain_versions():
    """A tensor on any device but the CPU goes to a kernel or raises."""
    before = ops.launch_counts()
    mask = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        fc.block_counts(mask, 4)
    with pytest.raises(ValueError):
        fc.block_compact(mask, torch.zeros(3, dtype=torch.int64,
                                           device="meta"), 4)
    vals = torch.ones(8, device="meta")
    codes = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gb.groupby(vals, codes, 2)
    with pytest.raises(ValueError):
        gb.combine(torch.ones(2, 3, device="meta"))
    assert ops.launch_counts() == before


def test_nvcc_command_targets_sm_90a():
    cmd = build.nvcc_command("nvcc", "groupby_agg", Path("/x/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == "/x/lib.so"
    assert cmd[-1].endswith("csrc/groupby_agg.cu")
    for flag in ("-O3", "-shared", "-Xptxas", "-v", "-fPIC"):
        assert flag in cmd
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "build").exists()


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, "print('error: boom in kernel')\n"
                                "sys.exit(2)")
    monkeypatch.setattr(build.shutil, "which", lambda name: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom in kernel"):
        build.build_all()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_names_libraries_by_content_and_skips_fresh_ones(monkeypatch,
                                                              tmp_path):
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, (
        f"open({str(calls)!r}, 'a').write('x')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 8 registers')"))
    monkeypatch.setattr(build.shutil, "which", lambda name: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    paths = build.build_all()
    assert set(paths) == set(build.SOURCES)
    for name, path in paths.items():
        assert path.exists() and path.name.startswith(f"lib{name}_")
        assert path == build.library_path(name)
        assert "Used 8 registers" in build.build_logs[name]
    assert calls.read_text() == "x" * len(build.SOURCES)   # one nvcc each
    build.build_all()
    assert calls.read_text() == "x" * len(build.SOURCES)   # fresh: no rebuild
