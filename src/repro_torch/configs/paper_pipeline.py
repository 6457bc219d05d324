"""The paper's own 'architecture': the Fig. 1 demo DAG as a config.

Not one of the 10 assigned LM architectures — this is the workload the paper
itself evaluates (transactions -> euro_selection -> usd_by_country), exposed
the same way the LM configs are so the CLI / benchmarks / tests can select it
(`chip_smoke.py` runs it on the card).

The port's counterpart of ``repro/configs/paper_pipeline.py``: the same
config, with a DAG whose filter and group-by run the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

ARCH_ID = "paper-fig1-pipeline"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str = ARCH_ID
    source_table: str = "transactions"
    source_rows: int = 1_000_000
    rows_per_file: int = 100_000
    date_filter: str = "eventTime BETWEEN 2023-01-01 AND 2023-02-01"
    countries: Tuple[str, ...] = ("IT", "FR", "DE", "ES", "NL", "GB")
    pushdown_columns: Tuple[str, ...] = ("id", "usd", "country")
    envs: Tuple[Tuple[str, Tuple[Tuple[str, str], ...]], ...] = (
        ("3.11", (("pandas", "2.0"),)),
        ("3.10", (("pandas", "1.5.3"),)),
    )


def get_config() -> PipelineConfig:
    return PipelineConfig()


def smoke_config() -> PipelineConfig:
    return dataclasses.replace(get_config(), source_rows=20_000,
                               rows_per_file=5_000)


def build_project(cfg: PipelineConfig, device: str = "cuda",
                  combine: bool = False):
    """Instantiate the DAG from the config, with ``euro_selection`` and
    ``usd_by_country`` on the torch backend on ``device``.

    ``combine=True`` declares the filter rowwise and the group-by a
    ``GroupByCombine``: a run over a sharded scan then filters and
    aggregates each shard where it lies and merges the per-country states
    in a CombineTask (the sharded form of the same query)."""
    import repro_torch as bp
    from repro_torch.columnar import compute

    proj = bp.Project(cfg.name)
    filt = "country IN (%s)" % ",".join(f"'{c}'" for c in cfg.countries)
    aggs = {"usd": ("usd", "sum")}
    combinable = (bp.GroupByCombine(["country"], aggs, backend="torch",
                                    device=device) if combine else None)
    # The torch build a model runs on (CUDA or CPU) is part of its
    # environment. The bodies see `device` only as a closure cell, which
    # FunctionSpec.code_hash does not hash, so without it a card run and a
    # CPU run of the same DAG would share result-cache keys.
    envs = [(version, {**dict(pip), "torch": device})
            for version, pip in cfg.envs]

    @proj.model(rowwise=combine)
    @proj.python(*envs[0])
    def euro_selection(data=bp.Model(cfg.source_table,
                                     columns=list(cfg.pushdown_columns),
                                     filter=cfg.date_filter)):
        return compute.filter_table(data, filt, backend="torch",
                                    device=device)

    @proj.model(materialize=True, combinable=combinable)
    @proj.python(*envs[1])
    def usd_by_country(data=bp.Model("euro_selection")):
        return compute.group_by(data, ["country"], aggs, backend="torch",
                                device=device)

    return proj
