"""Hand-written CUDA kernels of the port and their wrappers: the serving
path's attention (K1, K2, K4) and norms (K3), the ring-attention block
fold (K5), and the training path's backward kernels (K2b, K3b, K5b).

Each wrapper counts its kernel launches on an int attribute
(``wrapper.launches``); ``launch_counts``/``reset_launch_counts`` read and
zero them together. ``thread_launches`` also counts the launches of one
thread apart (two workers of one process, each on its own loop thread).
"""

import contextlib

from brpc_tpu_torch.ops import _build

from brpc_tpu_torch.ops.attention import (  # noqa: F401
    attention_backward,
    paged_decode_attention,
    paged_prefill_attention,
    prefill_attention,
)
from brpc_tpu_torch.ops.norm import (  # noqa: F401
    add_rms_norm,
    add_rms_norm_backward,
    rms_norm,
    rms_norm_backward,
)
from brpc_tpu_torch.ops.ring_attention import (  # noqa: F401
    ring_attention_fold,
    ring_attention_fold_backward,
)

KERNELS = {
    "paged_decode_attention": paged_decode_attention,
    "prefill_attention": prefill_attention,
    "paged_prefill_attention": paged_prefill_attention,
    "rms_norm": rms_norm,
    "add_rms_norm": add_rms_norm,
    "ring_attention_fold": ring_attention_fold,
    "attention_backward": attention_backward,
    "rms_norm_backward": rms_norm_backward,
    "add_rms_norm_backward": add_rms_norm_backward,
    "ring_attention_fold_backward": ring_attention_fold_backward,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


@contextlib.contextmanager
def thread_launches(counts: dict):
    """Inside the block, also count every launch the calling thread makes
    into ``counts`` ({kernel name: launches})."""
    prev = getattr(_build._tally, "counts", None)
    _build._tally.counts = counts
    try:
        yield counts
    finally:
        _build._tally.counts = prev
