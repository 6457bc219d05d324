# The paper's primary contribution: the co-designed FaaS programming model
# and data-aware runtime (logical/physical planning, zero-copy channels,
# columnar differential caching, ephemeral package-level environments,
# fault-tolerant scheduling).
from repro_torch.core.spec import (CombineContract, EnvSpec, ExchangeContract,
                                   FunctionSpec, ModelRef, ResourceHint)
from repro_torch.core.errors import (BauplanError, ContractError, LintError,
                                     PlanError)
from repro_torch.core.logical import LogicalPlan, build_logical_plan
from repro_torch.core.physical import (CombineTask, FunctionTask, GatherTask,
                                       PartitionTask, PhysicalPlan, PlacementHint,
                                       Planner, ScanTask, ShuffleMergeTask,
                                       ShuffleSampleTask, ShuffleWriteTask,
                                       WorkerProfile)
from repro_torch.core.contract import ClusterLike, TransportLike, WorkerLike
from repro_torch.core.runtime import (Client, Event, LocalCluster, TaskError,
                                      Worker, WorkerFailure, execute_run,
                                      submit_run)
from repro_torch.core.engine import (ExecutionEngine, HandleMap, RunHandle,
                                     RunResult)
from repro_torch.core.scheduler import Scheduler


def __getattr__(name):
    # repro/core/remote.py (process-isolated workers over TCP) is not ported
    if name in ("RemoteCluster", "RemoteWorker", "WorkerDaemon"):
        raise NotImplementedError(
            f"repro_torch.core.{name}: the remote cluster is not ported yet "
            "(ROADMAP.md, Queue 1 item 6: core/remote.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CombineContract", "EnvSpec", "ExchangeContract", "FunctionSpec",
    "ModelRef", "ResourceHint",
    "BauplanError", "ContractError", "LintError", "PlanError",
    "LogicalPlan", "build_logical_plan",
    "CombineTask", "FunctionTask", "GatherTask", "PartitionTask",
    "PhysicalPlan", "PlacementHint", "Planner", "ScanTask",
    "ShuffleMergeTask", "ShuffleSampleTask", "ShuffleWriteTask",
    "WorkerProfile",
    "ClusterLike", "TransportLike", "WorkerLike",
    "Client", "Event", "LocalCluster", "TaskError", "Worker", "WorkerFailure",
    "execute_run", "submit_run",
    "ExecutionEngine", "HandleMap", "RunHandle", "RunResult",
    "Scheduler",
]
