"""brpc_tpu_torch — the serving path of brpc_tpu on PyTorch and CUDA.

A second package beside ``brpc_tpu``: the same native RPC runtime (the C++
tree under ``cpp/``, built into its own ``build/torch_native/libtpurpc.so``),
the same wire formats, and the same serving semantics, with the device
arrays held as torch tensors on an NVIDIA card and the attention and
normalisation of the serving path in hand-written CUDA kernels.

- ``brpc_tpu_torch.native`` / ``runtime``: the native builder and the ctypes
  surface the serving path needs (Server, Channel, NativeBatcher, flight
  records).
- ``brpc_tpu_torch.models.transformer``: the Llama-style model, its prefill
  and the batched paged decode step.
- ``brpc_tpu_torch.ops``: the CUDA kernels (``csrc/``), their builder and
  their wrappers, each with a plain PyTorch version beside it.
- ``brpc_tpu_torch.kv_cache``: the paged KV block pool on the device.
- ``brpc_tpu_torch.serving``: continuous-batching engine and streaming
  client over the native batcher.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that argument it raises.
The package imports neither JAX nor ``brpc_tpu``.
"""

__version__ = "0.1.0"
