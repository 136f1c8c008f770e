"""The port's CUDA kernels and serving engine on a card, against the port's
own plain PyTorch versions. Every test is marked ``cuda`` and skips where
no card is visible; the file imports no JAX, so it runs on a machine with
PyTorch and a card only:

    python3 -m pytest -m cuda tests/test_torch_kernels_card.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from brpc_tpu_torch import ops, serving
from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.ops import attention, norm

HEADS = [(4, 4, 32), (4, 2, 32), (8, 2, 64), (32, 8, 128)]  # (H, KV, Dh)

# |kernel - plain| <= atol + rtol |plain|. f32 differs in summation order
# only; bf16 keeps 8 significant bits and the kernels round probabilities
# before the division by the softmax sum, where the plain versions round
# after it.
CARD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _decode_inputs(H, KV, Dh, dev, dtype):
    """Five lanes at ragged positions (first row, page edges, last row of
    max_seq 128) with their pages scattered over a 3-layer pool."""
    rng = np.random.default_rng(0)
    S, L, page, max_pages = 5, 3, 16, 8
    pos = np.array([0, 15, 16, 77, 127], np.int32)
    n_blocks = 1 + sum(p // page + 1 for p in pos)
    order = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((S, max_pages), np.int32)  # unused: garbage block 0
    used = 0
    for s, p in enumerate(pos):
        n = p // page + 1
        tables[s, :n] = order[used:used + n]
        used += n

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=dev, dtype=dtype)

    pool_shape = (n_blocks, L, page, KV, Dh)
    return (normal((S, H, Dh)), normal(pool_shape), normal(pool_shape),
            torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    atol, rtol = CARD_TOL[dtype]
    dev = cuda_device
    for H, KV, Dh in HEADS:
        args = _decode_inputs(H, KV, Dh, dev, dtype)
        n = attention.paged_decode_attention.launches
        got = attention.paged_decode_attention(*args, 2)
        assert attention.paged_decode_attention.launches == n + 1
        want = attention.paged_decode_attention_plain(*args, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol, msg=f"decode {H, KV, Dh}")
        x = torch.randn((70, H, Dh), device=dev).to(dtype)
        kv = torch.randn((70, KV, Dh), device=dev).to(dtype)
        torch.testing.assert_close(
            attention.prefill_attention(x, kv, kv * 0.5, 41).float(),
            attention.prefill_attention_plain(x, kv, kv * 0.5, 41).float(),
            atol=atol, rtol=rtol, msg=f"prefill {H, KV, Dh}")
        g = torch.rand(H * Dh, device=dev) + 0.5
        rows = x.reshape(70, H * Dh)
        torch.testing.assert_close(
            norm.rms_norm(rows, g, 1e-5).float(),
            norm.rms_norm_plain(rows, g, 1e-5).float(),
            atol=atol, rtol=rtol, msg=f"rms_norm {H, KV, Dh}")

@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_engine_on_card_streams_plain_greedy(cuda_device, n_kv_heads):
    """The f32 engine on the card (kernels on every prefill and decode
    step) streams exactly the plain forward's greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(transformer.TransformerConfig.tiny(),
                              dtype=torch.float32, n_kv_heads=n_kv_heads)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(1),
        device=cuda_device)
    prompts = [[5, 11, 23], [1, 2, 3, 4, 5, 6, 7, 8, 9], [200], [17] * 16]
    ops.reset_launch_counts()
    with serving.ServingEngine(params, cfg, max_batch_size=4, slots=4,
                               max_prompt=16) as eng:
        got = [serving.generate(f"127.0.0.1:{eng.port}", p, 6, 60_000)
               for p in prompts]
        steps, prefills = eng.stats()["model_steps"], eng.stats()["prefills"]
    counts = ops.launch_counts()
    assert counts["paged_decode_attention"] == cfg.n_layers * steps
    assert counts["prefill_attention"] == cfg.n_layers * prefills
    for p, toks in zip(prompts, got):
        assert toks == transformer.greedy_reference(params, cfg, p, 6,
                                                    device=cuda_device)
