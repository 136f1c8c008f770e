"""Models of the port."""

from brpc_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    init_params,
    params_from_numpy,
)
