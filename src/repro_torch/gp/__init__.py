"""repro_torch.gp — the public GP API of the port.

`GPSession`, the one front door, with `MeshTopology` for sharded runs,
the `EvalBackend` registry (`torch`: the plain tensor path; `cuda`: the
hand-written kernel) and the sklearn-style `SymbolicRegressor` /
`SymbolicClassifier`.
"""
from repro_torch.core.engine import GPConfig, GPState  # noqa: F401
from repro_torch.core.evolve import OperatorMix  # noqa: F401
from repro_torch.core.islands import IslandConfig  # noqa: F401
from repro_torch.core.fitness import (  # noqa: F401
    FitnessKernel, FitnessSpec, available_kernels, get_kernel, register_kernel,
)
from repro_torch.gp.backends import (  # noqa: F401
    EvalBackend, auto_select, available_backends, get_backend, register_backend,
)
from repro_torch.gp.estimators import SymbolicClassifier, SymbolicRegressor  # noqa: F401
from repro_torch.gp.session import GPSession, MeshTopology, make_config  # noqa: F401
