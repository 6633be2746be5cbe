"""Core GP engine, ported to PyTorch: threefry keys, heap-tree
populations, the level-sweep evaluator, fitness kernels, breeding
operators and the block generation loop."""
from repro_torch.core.engine import (  # noqa: F401
    GPConfig, GPState, evolve_block, evolve_step, init_state, run,
    sharded_evolve_block, sharded_evolve_step,
)
from repro_torch.core.evolve import OperatorMix  # noqa: F401
from repro_torch.core.fitness import (  # noqa: F401
    FitnessKernel, FitnessSpec, available_kernels, get_kernel, register_kernel,
)
from repro_torch.core.islands import IslandConfig  # noqa: F401
from repro_torch.core.trees import TreeSpec  # noqa: F401
