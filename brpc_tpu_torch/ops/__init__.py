"""Hand-written CUDA kernels of the serving path and their wrappers.

Each wrapper counts its kernel launches on an int attribute
(``wrapper.launches``); ``launch_counts``/``reset_launch_counts`` read and
zero them together.
"""

from brpc_tpu_torch.ops.attention import (  # noqa: F401
    paged_decode_attention,
    paged_prefill_attention,
    prefill_attention,
)
from brpc_tpu_torch.ops.norm import add_rms_norm, rms_norm  # noqa: F401

KERNELS = {
    "paged_decode_attention": paged_decode_attention,
    "prefill_attention": prefill_attention,
    "paged_prefill_attention": paged_prefill_attention,
    "rms_norm": rms_norm,
    "add_rms_norm": add_rms_norm,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
