"""Ephemeral environment building (paper §4.2, Table 2).

Bauplan's insight: for data pipelines, the atomic building block of an
environment is the *Python package*, not the container image layer. A worker
keeps a local, content-addressed package store; an environment is assembled in
O(100 ms) by linking package trees into a fresh ephemeral directory — no
PyPI, no layer rebuilds, no registry round-trips.

Two builders are implemented with identical semantics:

  * ``PackageLinkBuilder`` — the Bauplan way: one symlink per package from the
    store into the env's site-packages (OpenLambda-style init in a
    Docker-compatible runtime).
  * ``LayerBuilder`` — the AWS-Lambda-style baseline: the environment is an
    *image* = ordered layers; editing the package set invalidates the image,
    which must be re-assembled (tar) and re-"pushed"/"pulled" (copied), like
    an ECR update. Used by benchmarks/table2_envs.py.

Package installs themselves are simulated by generating deterministic package
trees (we are offline); the *relative* costs — link-vs-tar, cache-hit-vs-miss —
are real filesystem work, which is what Table 2 measures.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tarfile
import threading
import time
import uuid
from typing import Dict, Tuple

from repro_torch.core.spec import EnvSpec

# Rough footprint of a "data science" package tree (files x bytes/file). Real
# examples from the paper's scenario: pandas==2.0 ships ~1.5k files.
DEFAULT_FILES_PER_PACKAGE = 120
DEFAULT_BYTES_PER_FILE = 4096


def _pkg_id(name: str, version: str) -> str:
    return f"{name}-{version}"


@dataclasses.dataclass
class BuildReport:
    env_id: str
    duration_s: float
    cache_hit: bool
    packages_installed: int      # store misses paid during this build
    path: str


class PackageStore:
    """Content-addressed local store of unpacked package trees."""

    def __init__(self, root: str, files_per_package: int = DEFAULT_FILES_PER_PACKAGE,
                 bytes_per_file: int = DEFAULT_BYTES_PER_FILE,
                 simulated_pypi_latency_s: float = 0.0):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.files_per_package = files_per_package
        self.bytes_per_file = bytes_per_file
        self.pypi_latency_s = simulated_pypi_latency_s
        # one store serves every worker; concurrent env builds must not
        # install the same package tree on top of each other — but installs
        # of DIFFERENT packages stay concurrent (per-package locks)
        self._lock = threading.Lock()
        self._pkg_locks: Dict[str, threading.Lock] = {}

    def package_path(self, name: str, version: str) -> str:
        return os.path.join(self.root, _pkg_id(name, version))

    def is_installed(self, name: str, version: str) -> bool:
        return os.path.exists(os.path.join(self.package_path(name, version),
                                           ".complete"))

    def ensure(self, name: str, version: str) -> Tuple[str, bool]:
        """Install (generate) a package tree if absent. Returns (path, miss)."""
        path = self.package_path(name, version)
        if self.is_installed(name, version):
            return path, False
        with self._lock:
            pkg_lock = self._pkg_locks.setdefault(_pkg_id(name, version),
                                                  threading.Lock())
        with pkg_lock:
            if self.is_installed(name, version):     # lost the install race
                return path, False
            if self.pypi_latency_s:
                time.sleep(self.pypi_latency_s)  # the network call we CACHE away
            seed = hashlib.sha256(_pkg_id(name, version).encode()).digest()
            tmp = f"{path}.{uuid.uuid4().hex}.building"
            os.makedirs(os.path.join(tmp, name), exist_ok=True)
            blob = (seed * (self.bytes_per_file // len(seed) + 1))[:self.bytes_per_file]
            for i in range(self.files_per_package):
                sub = os.path.join(tmp, name, f"mod_{i // 32}")
                os.makedirs(sub, exist_ok=True)
                with open(os.path.join(sub, f"m{i}.py"), "wb") as f:
                    f.write(blob)
            with open(os.path.join(tmp, ".complete"), "w") as f:
                f.write(_pkg_id(name, version))
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            return path, True


class PackageLinkBuilder:
    """Assemble an ephemeral env by symlinking store packages (Bauplan path)."""

    def __init__(self, store: PackageStore, envs_root: str):
        self.store = store
        self.envs_root = os.path.abspath(envs_root)
        os.makedirs(self.envs_root, exist_ok=True)
        self._ready: Dict[str, str] = {}

    def build(self, env: EnvSpec, fresh: bool = True) -> BuildReport:
        """fresh=True rebuilds the ephemeral dir (function instances live for
        one invocation); the *store* provides all reuse, so even a fresh build
        is O(#packages) symlinks."""
        t0 = time.perf_counter()
        if not fresh and env.env_id in self._ready:
            return BuildReport(env.env_id, time.perf_counter() - t0, True, 0,
                               self._ready[env.env_id])
        misses = 0
        pkg_paths = []
        for name, version in env.packages():
            path, miss = self.store.ensure(name, version)
            misses += int(miss)
            pkg_paths.append((name, path))
        env_dir = os.path.join(self.envs_root,
                               f"{env.env_id}-{uuid.uuid4().hex}")
        site = os.path.join(env_dir, f"python{env.python_version}",
                            "site-packages")
        os.makedirs(site)
        for name, path in pkg_paths:
            os.symlink(os.path.join(path, name), os.path.join(site, name),
                       target_is_directory=True)
        with open(os.path.join(env_dir, "env.json"), "w") as f:
            f.write('{"python": "%s"}' % env.python_version)
        self._ready[env.env_id] = env_dir
        return BuildReport(env.env_id, time.perf_counter() - t0,
                           misses == 0, misses, env_dir)

    def destroy(self, report: BuildReport) -> None:
        shutil.rmtree(report.path, ignore_errors=True)
        self._ready.pop(report.env_id, None)


class LayerBuilder:
    """Image/layer baseline (Lambda-style): changing the package set requires
    re-assembling and re-distributing an image archive."""

    def __init__(self, store: PackageStore, images_root: str):
        self.store = store
        self.images_root = os.path.abspath(images_root)
        os.makedirs(self.images_root, exist_ok=True)
        self._images: Dict[str, str] = {}

    def build(self, env: EnvSpec, fresh: bool = True) -> BuildReport:
        t0 = time.perf_counter()
        image_tar = os.path.join(self.images_root, f"{env.env_id}.tar")
        misses = 0
        if env.env_id not in self._images or not os.path.exists(image_tar):
            # image rebuild: stage ALL packages, tar them ("docker build"),
            # then "push" (copy = registry upload)
            stage = os.path.join(self.images_root, f"stage-{env.env_id}")
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage)
            for name, version in env.packages():
                path, miss = self.store.ensure(name, version)
                misses += int(miss)
                shutil.copytree(os.path.join(path, name),
                                os.path.join(stage, name))
            with tarfile.open(image_tar + ".tmp", "w") as tar:
                tar.add(stage, arcname=".")
            os.replace(image_tar + ".tmp", image_tar)
            shutil.copyfile(image_tar, image_tar + ".pushed")  # registry push
            shutil.rmtree(stage, ignore_errors=True)
            self._images[env.env_id] = image_tar
        # every fresh invocation "pulls" + unpacks the image
        env_dir = os.path.join(self.images_root,
                               f"run-{env.env_id}-{time.monotonic_ns()}")
        os.makedirs(env_dir)
        with tarfile.open(image_tar + ".pushed") as tar:
            tar.extractall(env_dir, filter="data")
        return BuildReport(env.env_id, time.perf_counter() - t0, misses == 0,
                           misses, env_dir)

    def destroy(self, report: BuildReport) -> None:
        shutil.rmtree(report.path, ignore_errors=True)
