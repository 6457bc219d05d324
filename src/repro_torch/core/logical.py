"""Logical plan: the parsed, validated DAG at dataframe semantics (paper §4.1).

"User code is declarative, so the platform must fill the gap between logical
requests and system operations." This module is the first of the paper's three
representations (logical -> physical -> worker execution): pure metadata — the
Control Plane never sees customer data.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.errors import PlanError
from repro_torch.core.spec import FunctionSpec, ModelRef

if TYPE_CHECKING:  # avoid circular import; Project is only a type here
    from repro_torch.api import Project

__all__ = ["PlanError", "LogicalNode", "LogicalPlan", "build_logical_plan"]


@dataclasses.dataclass
class LogicalNode:
    name: str
    kind: str                       # "source" | "function"
    spec: Optional[FunctionSpec]    # None for sources
    parents: List[str]
    # union of pushdown hints requested by children, per parent edge
    consumers: List[Tuple[str, ModelRef]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LogicalPlan:
    nodes: Dict[str, LogicalNode]
    order: List[str]                # topological
    targets: List[str]

    def function_nodes(self) -> List[LogicalNode]:
        return [self.nodes[n] for n in self.order
                if self.nodes[n].kind == "function"]

    def source_nodes(self) -> List[LogicalNode]:
        return [self.nodes[n] for n in self.order
                if self.nodes[n].kind == "source"]

    def describe(self) -> str:
        lines = []
        for name in self.order:
            node = self.nodes[name]
            if node.kind == "source":
                lines.append(f"SCAN {name}")
            else:
                mat = " MATERIALIZE" if node.spec.materialize else ""
                lines.append(f"FUNC {name}({', '.join(node.parents)}){mat} "
                             f"env={node.spec.env.env_id}")
        return "\n".join(lines)


def _toposort(names: Sequence[str], parents: Dict[str, List[str]]) -> List[str]:
    state: Dict[str, int] = {}
    order: List[str] = []

    def visit(n: str, stack: List[str]) -> None:
        st = state.get(n, 0)
        if st == 1:
            cycle = stack[stack.index(n):] + [n]
            raise PlanError(f"cycle in DAG: {' -> '.join(cycle)}")
        if st == 2:
            return
        state[n] = 1
        for p in parents.get(n, []):
            visit(p, stack + [n])
        state[n] = 2
        order.append(n)

    for n in names:
        visit(n, [])
    return order


def build_logical_plan(project: "Project",
                       targets: Optional[Sequence[str]] = None) -> LogicalPlan:
    """Parse the project registry into a validated logical DAG."""
    functions = project.functions
    if not functions:
        raise PlanError(f"project {project.name!r} has no models")
    produced: Set[str] = set(functions)
    sources: Set[str] = set()
    parents: Dict[str, List[str]] = {}
    for spec in functions.values():
        if not spec.inputs:
            raise PlanError(f"model {spec.name!r} has no Model(...) inputs; "
                            "every function maps dataframe(s) -> dataframe")
        parents[spec.name] = []
        for _, ref in spec.inputs:
            parents[spec.name].append(ref.name)
            if ref.name not in produced:
                sources.add(ref.name)
    if targets:
        unknown = [t for t in targets if t not in produced]
        if unknown:
            raise PlanError(f"unknown targets {unknown}")
        # restrict to ancestors of targets
        keep: Set[str] = set()

        def walk(n: str) -> None:
            if n in keep:
                return
            keep.add(n)
            for p in parents.get(n, []):
                walk(p)

        for t in targets:
            walk(t)
    else:
        targets = [n for n in functions
                   if not any(n in parents.get(m, []) for m in functions)]
        keep = produced | sources

    nodes: Dict[str, LogicalNode] = {}
    for s in sorted(sources & keep):
        nodes[s] = LogicalNode(s, "source", None, [])
    for name, spec in functions.items():
        if name in keep:
            nodes[name] = LogicalNode(name, "function", spec,
                                      list(parents[name]))
    # record consumer pushdown hints on every producing node
    for name, spec in functions.items():
        if name not in keep:
            continue
        for _, ref in spec.inputs:
            if ref.name in nodes:
                nodes[ref.name].consumers.append((name, ref))
    order = _toposort(sorted(nodes), {n: nodes[n].parents for n in nodes})
    return LogicalPlan(nodes=nodes, order=order, targets=list(targets))
