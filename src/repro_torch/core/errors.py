"""Unified exception taxonomy for plan-time failures — plus the one typed
*runtime* SLO failure, ``DeadlineExceeded``.

Every defect the static analyzer (``repro.analysis``) or the planner can
prove before execution is raised through one of these types, each carrying
the stable ``BPL###`` lint code, the offending model, and (when relevant)
the offending column — so callers and CI can match on structure instead of
message strings.

All plan-time types subclass ``ValueError`` so pre-existing
``except ValueError`` call sites and tests keep working.
``DeadlineExceeded`` is different: it marks a run (or serving request)
that was *cancelled by deadline enforcement*, not a defect in the
pipeline, so it subclasses ``RuntimeError`` and never carries a lint code.
"""
from __future__ import annotations

from typing import Optional


class BauplanError(ValueError):
    """Base for all plan-time diagnostics raised as exceptions.

    Attributes:
        code:   stable lint code ("BPL203"), or "" when no rule applies.
        model:  name of the model the defect was found on, or "".
        column: offending column name, or "".
    """

    def __init__(self, message: str, *, code: str = "",
                 model: str = "", column: str = "") -> None:
        super().__init__(message)
        self.code = code
        self.model = model
        self.column = column

    def __str__(self) -> str:  # "BPL203 [model]: message"
        msg = super().__str__()
        prefix = ""
        if self.code:
            prefix += self.code + " "
        if self.model:
            prefix += f"[{self.model}] "
        if prefix and not msg.startswith(prefix.rstrip()):
            return prefix + msg
        return msg


class PlanError(BauplanError):
    """The declared DAG cannot be planned: unknown targets, cycles, unknown
    columns, schema conflicts (BPL1xx)."""


class ContractError(PlanError):
    """A ``combinable=``/``exchange=`` contract is malformed or can never
    fire (BPL2xx)."""


class LintError(BauplanError):
    """A determinism / cache-safety / internal-concurrency lint finding
    escalated to an error (BPL3xx / BPL4xx)."""


class DeadlineExceeded(RuntimeError):
    """A run (or serving request) outlived its SLO deadline and was
    cancelled instead of being allowed to finish late.

    Deadlines are measured from *request arrival* at the serving front
    door (queue wait included), or from ``submit`` for directly-submitted
    engine runs.

    Attributes:
        waited_s: seconds between arrival/submission and enforcement
                  (None when the enforcer could not attribute a wait).
        run_id:   the cancelled engine run, or "" when the deadline
                  expired before any run was submitted (pure queue wait).
    """

    def __init__(self, message: str, *, waited_s: Optional[float] = None,
                 run_id: str = "") -> None:
        super().__init__(message)
        self.waited_s = waited_s
        self.run_id = run_id


def plan_error(message: str, *, code: str = "", model: str = "",
               column: str = "") -> PlanError:
    return PlanError(message, code=code, model=model, column=column)


__all__ = ["BauplanError", "PlanError", "ContractError", "LintError",
           "DeadlineExceeded", "plan_error"]
