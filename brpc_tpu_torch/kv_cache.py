"""Paged KV cache on the device: the counterpart of brpc_tpu/kv_cache.py.

The pool is two device tensors ``[block, L, page_tokens, KV, Dh]``; a
sequence owns a block table (one block per page of its length so far) and
allocates blocks as it grows. Block 0 is the garbage block that inactive
decode lanes write into. The accounting (free list, refcounts, evictable
LRU, per-block versions) behaves exactly as the reference's.

Decode reads the pool through the block tables (``paged_decode_fn``): the
step writes each lane's new K/V row in place and the attention kernel walks
the lane's pages, so no dense ``[slots, L, max_seq, KV, Dh]`` view is ever
built. Pages land with an in-place ``index_copy_``.

Wire codec: transfer layer ``2l`` carries K of layer l and ``2l + 1`` its
V; each is the first ``npages`` pages, ``[npages * page, KV, Dh]`` in the
model dtype, byte-compatible with the reference's codec.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.utils import resolve_device


def pages_for(tokens: int, page_tokens: int) -> int:
    """Blocks needed to hold ``tokens`` positions (>= 1 token)."""
    return max(1, -(-int(tokens) // page_tokens))


def kv_token_bytes(cfg) -> int:
    """Bytes of KV state one token occupies across all layers (K + V)."""
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head * \
        cfg.dtype.itemsize


def host_page_bytes(cfg, page_tokens: int) -> int:
    """Bytes of one block's pages (K + V, every layer)."""
    return 2 * cfg.n_layers * page_tokens * cfg.n_kv_heads * cfg.d_head * \
        cfg.dtype.itemsize


class PagedKvPool:
    """Block pool with a free list, per-block refcounts, and LRU eviction.

    Block 0 is the reserved garbage block. ``release()`` drops a reference;
    zero-ref blocks keep their contents on an evictable LRU and are
    reclaimed, oldest-released first, when ``alloc()`` outruns the free
    list. Thread-safe."""

    def __init__(self, cfg, num_blocks: int, page_tokens: int, device=None):
        if cfg.max_seq % page_tokens != 0:
            raise ValueError(
                f"page_tokens {page_tokens} must divide max_seq "
                f"{cfg.max_seq} (block tables cover exactly max_seq)")
        if num_blocks < 2:
            raise ValueError("need at least the garbage block + 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_tokens = page_tokens
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = cfg.max_seq // page_tokens
        shape = (num_blocks, cfg.n_layers, page_tokens, cfg.n_kv_heads,
                 cfg.d_head)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        self._mu = threading.Lock()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = {}  # block -> refcount (absent = free/evictable)
        self._evictable: "OrderedDict[int, bool]" = OrderedDict()
        # Per-block reuse generation: bumps when an evictable block is
        # reclaimed, so a weak reference can tell "same contents" from
        # "recycled".
        self._version = [0] * num_blocks
        # Called outside the pool lock with the (block, version) pairs an
        # alloc() just reclaimed.
        self.on_evict: Optional[Callable[[List[Tuple[int, int]]], None]] = \
            None
        self.allocs = 0
        self.evictions = 0
        self.alloc_failures = 0

    # ---- accounting --------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            return {
                "num_blocks": self.num_blocks,
                "free_blocks": len(self._free),
                "evictable_blocks": len(self._evictable),
                "live_blocks": len(self._ref),
                "allocs": self.allocs,
                "evictions": self.evictions,
                "alloc_failures": self.alloc_failures,
            }

    def blocks_in_use(self) -> int:
        with self._mu:
            return len(self._ref)

    # ---- alloc / refcount / eviction ---------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks with refcount 1, or None when the pool is
        exhausted even after evicting every zero-ref block."""
        evicted: List[Tuple[int, int]] = []
        with self._mu:
            got: List[int] = []
            while len(got) < n:
                if self._free:
                    got.append(self._free.pop())
                elif self._evictable:
                    blk, _ = self._evictable.popitem(last=False)  # oldest
                    self.evictions += 1
                    evicted.append((blk, self._version[blk]))
                    self._version[blk] += 1
                    got.append(blk)
                else:
                    self._free.extend(reversed(got))
                    self.alloc_failures += 1
                    got = None
                    break
            if got is not None:
                for blk in got:
                    self._ref[blk] = 1
                self.allocs += n
        if evicted and self.on_evict is not None:
            self.on_evict(evicted)
        return got

    def retain(self, blocks: List[int]) -> None:
        with self._mu:
            for blk in blocks:
                if blk == 0:
                    continue
                if blk not in self._ref:
                    raise ValueError(f"retain of unowned block {blk}")
                self._ref[blk] += 1

    def try_retain(self, blk: int, version: int) -> bool:
        """Take one reference on ``blk`` if it is still generation
        ``version``, live or idling on the evictable LRU."""
        with self._mu:
            if blk <= 0 or blk >= self.num_blocks \
                    or self._version[blk] != version:
                return False
            if blk in self._ref:
                self._ref[blk] += 1
                return True
            if blk in self._evictable:
                del self._evictable[blk]
                self._ref[blk] = 1
                return True
            return False

    def refcount(self, blk: int) -> int:
        with self._mu:
            return self._ref.get(blk, 0)

    def version(self, blk: int) -> int:
        with self._mu:
            return self._version[blk]

    def entry_alive(self, blk: int, version: int) -> bool:
        with self._mu:
            return (0 < blk < self.num_blocks
                    and self._version[blk] == version
                    and (blk in self._ref or blk in self._evictable))

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block; zero-ref blocks become evictable
        (contents retained until reclaimed)."""
        with self._mu:
            for blk in blocks:
                if blk == 0:
                    continue
                ref = self._ref.get(blk)
                if ref is None:
                    continue  # already released (idempotent teardown)
                if ref > 1:
                    self._ref[blk] = ref - 1
                else:
                    del self._ref[blk]
                    self._evictable[blk] = True

    # ---- device writes -----------------------------------------------------

    def write_blocks(self, blocks: List[int], k_pages, v_pages) -> None:
        """Land pages ([n, L, page, KV, Dh]) into ``blocks``, in place."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        self.k.index_copy_(0, idx, torch.as_tensor(k_pages).to(
            device=self.device, dtype=self.cfg.dtype))
        self.v.index_copy_(0, idx, torch.as_tensor(v_pages).to(
            device=self.device, dtype=self.cfg.dtype))


# ---- paged decode ------------------------------------------------------------

def paged_decode_fn(cfg, page_tokens: int):
    """(params, tokens, pos, tables, k_pool, v_pool) -> (logits, k_pool,
    v_pool), the reference's signature: one batched decode step that writes
    each lane's K/V row in place and reads the pool through the tables.
    The returned pools are the same (updated) tensors."""

    def step(params, tokens, pos, tables, k_pool, v_pool):
        if k_pool.shape[2] != page_tokens:
            raise ValueError("pool page size differs from page_tokens")
        logits = transformer.decode_step(params, tokens, pos, tables,
                                         k_pool, v_pool, cfg)
        return logits, k_pool, v_pool

    return step


# ---- prefill -> pages ----------------------------------------------------------

def prefill_cache_pages(k_cache, v_cache, length: int, page_tokens: int):
    """Prefill KV ([L, P, KV, Dh], on the device) -> the pages covering
    ``length`` tokens, ([n, L, page, KV, Dh]) x 2 on the same device. Rows
    past the prefill bucket are zeros, as in the reference's cache (zero
    past P); rows in [length, P) hold the pad tokens' KV, as there."""
    n = pages_for(length, page_tokens)
    span = n * page_tokens

    def cut(c):
        L, P, KV, Dh = c.shape
        if P < span:
            c = torch.cat([c, c.new_zeros((L, span - P, KV, Dh))], dim=1)
        c = c[:, :span].reshape(L, n, page_tokens, KV, Dh)
        return c.transpose(0, 1).contiguous()

    return cut(k_cache), cut(v_cache)


# ---- wire codec (one transfer layer = K or V of one model layer) -----------

def _to_wire_numpy(t: torch.Tensor, cfg) -> np.ndarray:
    t = t.detach().to(device="cpu", dtype=cfg.dtype).contiguous()
    if cfg.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(cfg.wire_dtype)
    return t.numpy().astype(cfg.wire_dtype, copy=False)


def encode_layer(arr, length: int, page_tokens: int, cfg) -> bytes:
    """One prefill layer's K (or V) [P, KV, Dh] -> the page-padded wire
    bytes ([npages * page, KV, Dh], model dtype)."""
    n = pages_for(length, page_tokens)
    span = n * page_tokens
    a = torch.as_tensor(arr)[:span]
    if a.shape[0] < span:  # prompt bucket smaller than the page span
        a = torch.cat([a, a.new_zeros((span - a.shape[0],) + a.shape[1:])])
    return np.ascontiguousarray(_to_wire_numpy(a, cfg)).tobytes()


def decode_layer(buf, npages: int, page_tokens: int, cfg) -> torch.Tensor:
    """Wire bytes -> pages [npages, page, KV, Dh] (model dtype, on the
    CPU; the caller moves them to its device)."""
    raw = bytes(buf)
    want = npages * page_tokens * cfg.n_kv_heads * cfg.d_head
    if len(raw) != want * cfg.dtype.itemsize:
        raise ValueError(
            f"kv layer size mismatch: got {len(raw) // cfg.dtype.itemsize} "
            f"elems, want {want}")
    flat = torch.frombuffer(bytearray(raw), dtype=cfg.dtype)
    return flat.reshape(npages, page_tokens, cfg.n_kv_heads, cfg.d_head)
