"""The model zoo (port of `repro/models/`): the six families (dense, moe,
ssm, hybrid, encdec, vlm) as layer patterns, the training step
(`forward_train`, `make_train_step` with gradient accumulation), prefill
and KV/SSM-cache decode, on one device or, under a ShardingPolicy, on a
mesh (`launch/sharding.py`; the MoE's expert parallelism in
`moe_apply_sharded`)."""
from repro_torch.models.model import (build_model, input_specs, make_serve_step,  # noqa: F401
                                      make_train_step)
