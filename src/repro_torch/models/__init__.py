"""The model zoo's serving path on one device (port of `repro/models/`):
the six families (dense, moe, ssm, hybrid, encdec, vlm) as layer patterns,
prefill and KV/SSM-cache decode. Training (`forward_train`,
`make_train_step`) and the mesh wait for ROADMAP A13b and A13c."""
from repro_torch.models.model import build_model, make_serve_step  # noqa: F401
