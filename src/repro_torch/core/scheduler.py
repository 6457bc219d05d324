"""Compatibility façade over the event-driven ExecutionEngine.

The polling scheduler that used to live here (a 50 ms `cv.wait` loop over a
statically worker-assigned plan) is gone: dispatch is now driven by
completion events in `repro.core.engine`. `Scheduler` remains as the
synchronous one-run entry point — construct with a cluster + client, call
`run(plan)` — and delegates to the cluster's shared engine so that runs
issued through either API multiplex the same worker fleet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import defaults
from repro_torch.core.engine import ExecutionEngine, HandleMap, RunHandle, RunResult
from repro_torch.core.physical import PhysicalPlan
from repro_torch.core.runtime import Client, LocalCluster

__all__ = ["Scheduler", "RunResult", "RunHandle", "HandleMap",
           "ExecutionEngine"]


class Scheduler:
    def __init__(self, cluster: LocalCluster, client: Client,
                 max_retries: int = defaults.MAX_RETRIES,
                 journal_path: Optional[str] = None,
                 speculation_factor: float = defaults.SPECULATION_FACTOR,
                 speculation_min_s: float = defaults.SPECULATION_MIN_S):
        self.cluster = cluster
        self.client = client
        self.max_retries = max_retries
        self.journal_path = journal_path
        self.spec_factor = speculation_factor
        self.spec_min_s = speculation_min_s

    @property
    def engine(self) -> ExecutionEngine:
        return self.cluster.engine()

    def submit(self, plan: PhysicalPlan, project=None) -> RunHandle:
        return self.engine.submit(
            plan, project, client=self.client,
            journal_path=self.journal_path, max_retries=self.max_retries,
            speculation_factor=self.spec_factor,
            speculation_min_s=self.spec_min_s)

    def run(self, plan: PhysicalPlan, project=None) -> RunResult:
        return self.submit(plan, project).wait()
