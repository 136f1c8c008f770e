"""brpc_tpu_torch — brpc_tpu on PyTorch and CUDA.

A second package beside ``brpc_tpu``: the same native RPC runtime (the C++
tree under ``cpp/``, built into its own ``build/torch_native/libtpurpc.so``),
the same wire formats, and the same serving semantics, with the device
arrays held as torch tensors on an NVIDIA card and the attention and
normalisation of the serving path in hand-written CUDA kernels.

- ``brpc_tpu_torch.native`` / ``runtime``: the native builder and the
  reference runtime's whole ctypes surface (Server with stream sinks, TLS,
  the lease registry and the ``__rd`` service, Channel, writable and
  bidirectional streams, ParallelChannel, NativeBatcher, flight records,
  rpcz tracing, fault injection, the KV transfer, the host KV page store,
  the collective observatory and epoch, the redistribute shard table, the
  metrics dump).
- ``brpc_tpu_torch.param_server`` / ``checkpoint``: the TPS1 parameter
  server, and its TCK1 checkpoints streamed to a durable store that
  survives a kill -9 and serves them back.
- ``brpc_tpu_torch.redistribute``: the minimal resharding plan of a named
  array across rank processes, run over the native ``__rd`` service.
- ``brpc_tpu_torch.tracing``: rpcz span trees across RPCs, collectives,
  streams and the serving gateway, and their Chrome-trace dump.
- ``brpc_tpu_torch.workload``: seeded, byte-deterministic traffic traces
  and their open-loop replay.
- ``brpc_tpu_torch.mesh_bridge``: rank shards gathered over RPC and landed
  on the devices straight from the RPC buffer, and scattered back.
- ``brpc_tpu_torch.models.transformer``: the Llama-style model, its prefill
  (whole or layer-streamed), the paged suffix prefill of a prefix-cache hit and the batched paged
  decode step.
- ``brpc_tpu_torch.ops``: the CUDA kernels (``csrc/``), their builder and
  their wrappers, each with a plain PyTorch version beside it.
- ``brpc_tpu_torch.kv_cache``: the paged KV block pool on the device, the
  prefix index with its host tier, and the prefix resume.
- ``brpc_tpu_torch.serving``: continuous-batching engine (prefix cache and
  host tier on by default) and streaming client over the native batcher.
- ``brpc_tpu_torch.disagg`` / ``cluster``: disaggregated serving (prefill
  worker, decode worker, router) on the reference's wire, from worker
  processes whose membership is a static list or the lease registry
  (replicated, with the autoscaler and the model-mix advisor closing the
  loop).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that argument it raises.
The package imports neither JAX nor ``brpc_tpu``.
"""

__version__ = "0.1.0"
