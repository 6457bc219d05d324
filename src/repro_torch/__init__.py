"""repro_torch — the Bauplan FaaS runtime for data pipelines on PyTorch and
CUDA: the port of ``repro`` (JAX on a TPU) to an NVIDIA H100.

The SDK, planner, engine, channels and catalog are copies of the JAX
package's host layer; the device path (``backend="torch"`` in
``columnar.compute``) runs hand-written CUDA kernels. The paper's
programming model is unchanged:

    import repro_torch as bp

    @bp.model()
    @bp.python("3.11", pip={"pandas": "2.0"})
    def euro_selection(data=bp.Model("transactions",
                                     columns=["id", "usd", "country"],
                                     filter="eventTime BETWEEN 2023-01-01 AND 2023-02-01")):
        ...
        return df

Not ported yet (see ROADMAP.md): the static analyzer behind ``check``, the
serving gateway behind ``serve``, the remote cluster, and the model,
training and distribution stacks.
"""
from repro_torch.api import (GroupByCombine, GroupByExchange, JoinCombine,
                             JoinExchange, Model, Project, SortExchange,
                             StatsCombine, check, combinable, default_project,
                             exchangeable, model, python, resources, run, serve,
                             submit)
from repro_torch.core.errors import (BauplanError, ContractError,
                                     DeadlineExceeded, LintError, PlanError)
from repro_torch.core.spec import (CombineContract, EnvSpec, ExchangeContract,
                                   ModelRef, ResourceHint)

__version__ = "1.0.0"

__all__ = [
    "Model", "Project", "default_project", "model", "python", "resources",
    "run", "submit", "check", "EnvSpec", "ModelRef", "ResourceHint",
    "CombineContract", "GroupByCombine", "JoinCombine", "StatsCombine",
    "combinable",
    "ExchangeContract", "GroupByExchange", "JoinExchange", "SortExchange",
    "exchangeable",
    "BauplanError", "PlanError", "ContractError", "LintError",
    "DeadlineExceeded",
    "serve",
]
