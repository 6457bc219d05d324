"""The cluster/worker contract the ExecutionEngine dispatches against.

The engine grew up against ``LocalCluster`` and quietly depended on an
implicit surface: a ``workers`` dict it can peek for group pinning, a
``healthy_workers()`` snapshot for placement, ``provision()`` for on-demand
growth, and per-worker ``execute``/``transport``/``alive``/``kill``. This
module makes that surface *explicit*, so an in-process thread fleet
(``runtime.LocalCluster``) and a process-isolated remote fleet
(``remote.RemoteCluster``) are interchangeable behind ``bp.run(cluster=...)``
and ``submit_run`` — the paper's deployment model ("cloud-based workers"
joined to one control plane) without special-casing the engine.

These are ``typing.Protocol``\\ s, not base classes: conformance is
structural (and ``runtime_checkable``, so tests can assert it), and the
data plane stays free to implement workers however it likes as long as the
control plane can drive them.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

from repro_torch.core.channels import TableHandle
from repro_torch.core.physical import WorkerProfile

if TYPE_CHECKING:
    from repro_torch.columnar.table import ColumnTable


@runtime_checkable
class TransportLike(Protocol):
    """The slice of ``DataTransport`` the engine and run results consume.

    ``get`` must resolve a handle *wherever its buffers live* (handles are
    location-addressed: flight host:port, mmap path, objectstore key), and
    ``evict`` must drop a speculation loser's buffers at their owner."""

    def get(self, handle: TableHandle,
            columns: Optional[Sequence[str]] = None,
            via: Optional[str] = None) -> "ColumnTable": ...

    def has_local(self, key: str) -> bool: ...

    def evict(self, handle: TableHandle) -> None: ...

    def close(self) -> None: ...


@runtime_checkable
class WorkerLike(Protocol):
    """One data-plane worker, local thread or remote process.

    ``execute`` runs a single plan task to a run-scoped TableHandle, streaming
    events/logs into ``client`` as they happen. ``alive`` must flip false the
    moment the worker's in-memory buffers are unrecoverable (chaos kill,
    process death, missed heartbeats) — the engine reads it on every
    placement decision. ``kill`` is the chaos hook: node loss, not shutdown."""

    worker_id: str
    profile: WorkerProfile
    alive: bool
    transport: TransportLike

    def execute(self, plan, task, handles, client, put_channel: str,
                project=None,
                edge_channels: Optional[Dict[str, str]] = None) -> TableHandle:
        ...

    def kill(self) -> None: ...


@runtime_checkable
class ClusterLike(Protocol):
    """A single-tenant data plane: the fleet the engine late-binds onto.

    ``workers`` maps worker_id -> WorkerLike and may grow concurrently with
    dispatch (``provision``), in which case the cluster must call
    ``engine.fleet_resized`` on its lazily-created engine. ``get`` raises
    KeyError for unknown non-on-demand ids (fabricating a worker would mask
    stale placements); ``kill_worker`` is the chaos hook used by fault-
    tolerance tests and demos."""

    workers: Dict[str, WorkerLike]

    def engine(self): ...

    def profiles(self) -> List[WorkerProfile]: ...

    def provision(self, profile: WorkerProfile) -> WorkerLike: ...

    def get(self, worker_id: str) -> WorkerLike: ...

    def healthy_workers(self) -> List[WorkerLike]: ...

    def kill_worker(self, worker_id: str) -> None: ...

    def close(self) -> None: ...
