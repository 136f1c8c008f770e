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

Prefix cache: ``PrefixIndex`` content-addresses prefilled pages by their
page-aligned token ids (weak (block, version) references over the pool's
evictable LRU); ``prefix_resume`` completes a prompt whose prefix matched,
computing only the suffix, in place through the block table (K4 on the
card), with a copy-on-write of a shared mid-page tail first. With the host
tier on, pages evicted off the LRU spill to the native host page store and
fill back on the next match; host page bytes are the reference's.

Wire codec: transfer layer ``2l`` carries K of layer l and ``2l + 1`` its
V; each is the first ``npages`` pages, ``[npages * page, KV, Dh]`` in the
model dtype, byte-compatible with the reference's codec.
``claim_into_pages`` turns a transfer the native receive pool holds into
block-major pages for ``write_blocks``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch import runtime
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


def prefix_hash(tokens) -> str:
    """Stable 64-bit hex hash of a token span, the cross-process prefix
    identity (heartbeat digests, router affinity keys)."""
    b = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
    return hashlib.blake2b(b, digest_size=8).hexdigest()


def page_key(tokens, page_tokens: int) -> int:
    """64-bit nonzero content key of the page covering ``tokens`` (the full
    token prefix through the page's last position: causal attention makes
    a page's KV a function of every token before it). Names the page in the
    host store, the pg= heartbeat digests and peer pulls. Only
    ``page_tokens`` joins the hash; readers size-check every entry, so a
    same-key page of another model geometry is a miss, never a torn fill."""
    b = (np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
         + int(page_tokens).to_bytes(4, "little"))
    k = int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(), "big")
    return k or 1


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's elements in its own dtype, C order, as bytes."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def encode_host_page(k_page, v_page) -> bytes:
    """One block's pages ([L, page, KV, Dh] x 2, tensors on any device) ->
    the host-store entry bytes: K then V, model dtype, contiguous (the
    reference's layout byte for byte)."""
    return _tensor_bytes(torch.as_tensor(k_page)) + \
        _tensor_bytes(torch.as_tensor(v_page))


def decode_host_page(buf, cfg, page_tokens: int):
    """Host-store entry bytes -> (k_page, v_page), each [L, page, KV, Dh]
    in the model dtype, on the CPU."""
    raw = bytearray(buf)
    shape = (cfg.n_layers, page_tokens, cfg.n_kv_heads, cfg.d_head)
    want = 2 * int(np.prod(shape))
    if len(raw) != want * cfg.dtype.itemsize:
        raise ValueError(
            f"host page size mismatch: {len(raw) // cfg.dtype.itemsize} "
            f"elems, want {want}")
    a = torch.frombuffer(raw, dtype=cfg.dtype)
    return a[:want // 2].reshape(shape), a[want // 2:].reshape(shape)


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

    def host_pages(self, blocks: List[int]) -> np.ndarray:
        """``blocks``' pages as host-store entries, one row of bytes per
        block (K then V, every layer, model dtype: ``encode_host_page``'s
        layout): stacked on the device, then one copy into (pinned, on a
        card) host memory."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        pages = torch.stack([self.k[idx], self.v[idx]], dim=1)
        host = torch.empty(pages.shape, dtype=pages.dtype,
                           pin_memory=self.device.type == "cuda")
        host.copy_(pages)
        return host.view(torch.uint8).reshape(len(blocks), -1).numpy()

    def copy_block(self, src: int, dst: int) -> None:
        """Copy block ``src``'s pages (every layer) into block ``dst``."""
        self.k[dst] = self.k[src]
        self.v[dst] = self.v[src]


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


# ---- cross-request prefix cache ---------------------------------------------

class _PrefixNode:
    """One cached full page in the trie (children) plus any cached partial
    tails that extend this prefix (partials). Block references are weak,
    (block, version) pairs validated against the pool at match time, so the
    LRU stays free to evict cold pages underneath the index.

    ``hkey`` (64-bit content key) names this page in the host store and on
    the peer wire. The tier is implicit: a live (block, version) is HBM
    (revive in place); a dead weak ref whose hkey the host store holds is
    HOST (fill back into the pool); neither is a miss. ``stamp`` is the last
    admit/hit time the TTL gc ages on; block -1 with hkey set marks a
    host-only entry (spilled, or landed by a peer pull)."""

    __slots__ = ("block", "version", "hits", "hash", "hkey", "stamp",
                 "children", "partials")

    def __init__(self, block: int = -1, version: int = -1, hash_: str = "",
                 hkey: int = 0, stamp: float = 0.0):
        self.block = block
        self.version = version
        self.hits = 0
        self.hash = hash_        # first-page prefix hash (depth 1 only)
        self.hkey = hkey         # host/peer-tier content key (0 = none)
        self.stamp = stamp       # last admit/hit (time.monotonic())
        self.children = {}       # full-page token bytes -> _PrefixNode
        self.partials = {}       # partial-tail token bytes ->
        #                          [blk, ver, hkey, stamp]


class PrefixIndex:
    """Content-addressed prefix store over a PagedKvPool.

    Keyed by page-aligned token ids: a trie node per cached full page (page
    i's KV depends on tokens[0:(i+1)*page]), plus partial-tail entries per
    node for prompts that end mid-page. Entries hold (block, version) weak
    references: admission never pins a page, released pages idle on the
    pool's evictable LRU with contents intact, and ``match`` revives them
    via ``try_retain``. The pool's ``on_evict`` callback prunes dead entries
    (or, with the host tier, spills them); version checks catch the rest
    lazily.

    With ``host_tier``, admissions export their pages to the native host
    store, evicted entries flip to the host tier, and ``match`` fills them
    back into fresh blocks instead of missing. Thread-safe; the pool lock is
    only taken under the index lock."""

    def __init__(self, pool: PagedKvPool, page_tokens: int,
                 token_bytes: int, host_tier: bool = False,
                 host_budget_bytes: int = 0):
        self.pool = pool
        self.page = page_tokens
        self.token_bytes = token_bytes  # KV bytes per cached token
        self.host_tier = host_tier
        self._page_bytes = host_page_bytes(pool.cfg, page_tokens)
        self._mu = threading.Lock()
        self._root = _PrefixNode()
        self._by_block = {}  # block -> [(parent_node, key, kind)]
        pool.on_evict = self._on_evict
        # telemetry (mirrored onto the native kv_prefix_* counters)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_shared = 0
        self.blocks_shared = 0
        self.cow_copies = 0
        self.gc_evictions = 0    # entries aged out by the TTL sweep
        self.host_hits = 0       # matches that filled >= 1 page from host
        self._mirrored = {}
        if host_tier:
            runtime.kv_host_configure(host_budget_bytes)
        # The kv_prefix_* series exist from the start, at 0.
        for name in self.counters():
            runtime.app_counter_add(f"kv_prefix_{name}", 0)

    # ---- host-tier plumbing ------------------------------------------------

    def _host_has(self, hkey: int) -> bool:
        """Host-tier presence with the exact byte size this index's page
        geometry expects (the store is process-wide)."""
        if not self.host_tier or not hkey:
            return False
        return runtime.kv_host_entry_bytes(hkey) == self._page_bytes

    def _put_pages(self, todo) -> None:
        """Copy [(hkey, blk)] pages into the host store: one batched
        device-to-host read, then one put per page (best-effort)."""
        rows = self.pool.host_pages([blk for _hk, blk in todo])
        for n, (hk, _blk) in enumerate(todo):
            runtime.kv_host_put(hk, rows[n])

    # ---- reverse-ref bookkeeping (self._mu held) ---------------------------

    def _ref_locked(self, blk: int, ref) -> None:
        self._by_block.setdefault(blk, []).append(ref)

    def _unref_locked(self, blk: int, ref) -> None:
        lst = self._by_block.get(blk)
        if lst is None:
            return
        try:
            lst.remove(ref)
        except ValueError:
            pass
        if not lst:
            del self._by_block[blk]

    def _detach_locked(self, node: _PrefixNode) -> None:
        """Unreachable subtree: drop every descendant's reverse refs. Each
        detached entry counts as an eviction (a prefix is only matchable
        through its ancestors)."""
        for key, child in node.children.items():
            self._unref_locked(child.block, (node, key, "f"))
            self.evictions += 1
            self._detach_locked(child)
        for key, ent in node.partials.items():
            self._unref_locked(ent[0], (node, key, "p"))
            self.evictions += 1
        node.children.clear()
        node.partials.clear()

    def serves_other(self, blk: int, keep: int, rows) -> bool:
        """Whether an entry on ``blk`` serves one of the page's rows from
        ``keep`` on with another token than ``rows`` (the prompt's tokens
        a resume is about to write there, in place, from row ``keep`` on),
        or serves a row past them: the sequence's decode writes those
        rows with tokens not known yet. Writing either would change what
        that entry serves."""
        rows = np.asarray(rows, np.int32)
        with self._mu:
            for _parent, key, _kind in self._by_block.get(blk, ()):
                toks = np.frombuffer(key, np.int32)[keep:]
                if len(toks) > len(rows) or not np.array_equal(
                        toks, rows[:len(toks)]):
                    return True
        return False

    def _drop_child_locked(self, parent: _PrefixNode, key: bytes) -> None:
        child = parent.children.pop(key, None)
        if child is None:
            return
        self._unref_locked(child.block, (parent, key, "f"))
        self._detach_locked(child)
        self.evictions += 1

    def _drop_partial_locked(self, parent: _PrefixNode, key: bytes) -> None:
        ent = parent.partials.pop(key, None)
        if ent is not None:
            self._unref_locked(ent[0], (parent, key, "p"))
            self.evictions += 1

    def _on_evict(self, evicted) -> None:
        """The pool reclaimed blocks (called outside the pool lock, before
        the new owner writes: contents are still readable). With the host
        tier, indexed pages spill to the host store and their entries flip
        to the host tier (block -1); otherwise, or when the spill cannot be
        stored, the entries are pruned. Pages exported at admit time flip
        with one key lookup; the rest are read in one batched copy."""
        with self._mu:
            cand: List = []  # (blk, ref, hkey, entry)
            for blk, ver in evicted:
                for ref in list(self._by_block.get(blk, ())):
                    parent, key, kind = ref
                    if kind == "f":
                        child = parent.children.get(key)
                        if child is None or child.block != blk \
                                or child.version != ver:
                            continue
                        if self.host_tier and child.hkey:
                            cand.append((blk, ref, child.hkey, child))
                        else:
                            self._drop_child_locked(parent, key)
                    else:
                        ent = parent.partials.get(key)
                        if ent is None or ent[0] != blk or ent[1] != ver:
                            continue
                        if self.host_tier and ent[2]:
                            cand.append((blk, ref, ent[2], ent))
                        else:
                            self._drop_partial_locked(parent, key)
            if not cand:
                return
            need = [c for c in cand
                    if runtime.kv_host_entry_bytes(c[2]) != self._page_bytes]
            datas = {}
            if need:
                blks = sorted({c[0] for c in need})
                rows = self.pool.host_pages(blks)
                at = {b: i for i, b in enumerate(blks)}
                for c in need:
                    datas[c[2]] = rows[at[c[0]]]
            for blk, ref, hkey, obj in cand:
                stored = (runtime.kv_host_put(hkey, datas[hkey]) == 0
                          if hkey in datas else True)
                parent, key, kind = ref
                if stored:
                    if kind == "f":
                        obj.block, obj.version = -1, -1
                    else:
                        obj[0], obj[1] = -1, -1
                    self._unref_locked(blk, ref)
                elif kind == "f":
                    self._drop_child_locked(parent, key)
                else:
                    self._drop_partial_locked(parent, key)

    # ---- the two verbs -----------------------------------------------------

    def match(self, tokens, max_tokens: int):
        """Longest cached prefix of ``tokens``, capped at ``max_tokens``
        positions (callers pass len-1: the last prompt token is always
        recomputed, its logits are the first output token).

        Walks full pages, then the longest partial tail extending them;
        every matched block is ``try_retain``'d and owned by the caller on
        return. With the host tier, a dead weak ref whose hkey the host
        store holds is a fill: the pages land back into fresh blocks (one
        batched write) and the entries return to the HBM tier. Stale entries
        found on the way are pruned. Returns (blocks, use): blocks cover
        positions [0, use), the last one possibly only partially trusted."""
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        blocks: List = []
        matched = 0
        fill_plan: List = []  # (blocks_idx, parent, key, kind, hkey)
        now = time.monotonic()
        with self._mu:
            node = self._root
            i = 0
            while (i + 1) * page <= len(tokens) and i * page < max_tokens:
                key = tokens[i * page:(i + 1) * page].tobytes()
                child = node.children.get(key)
                if child is None:
                    break
                if self.pool.try_retain(child.block, child.version):
                    blocks.append(child.block)
                elif self._host_has(child.hkey):
                    # Host tier: plan a fill; the placeholder is patched
                    # by _fill.
                    if child.block > 0:
                        self._unref_locked(child.block, (node, key, "f"))
                    child.block, child.version = -1, -1
                    fill_plan.append((len(blocks), node, key, "f",
                                      child.hkey))
                    blocks.append(None)
                else:
                    self._drop_child_locked(node, key)
                    break
                matched = (i + 1) * page
                child.hits += 1
                child.stamp = now
                node = child
                i += 1
            if matched == i * page and matched < max_tokens:
                # the longest partial tail at this node that prefixes the
                # remaining tokens
                remaining = tokens[matched:]
                best_key, best_nt = None, 0
                for key in node.partials:
                    nt = len(key) // 4
                    if nt > best_nt and nt <= len(remaining) \
                            and remaining[:nt].tobytes() == key:
                        best_key, best_nt = key, nt
                if best_key is not None:
                    ent = node.partials[best_key]
                    if self.pool.try_retain(ent[0], ent[1]):
                        blocks.append(ent[0])
                        matched += best_nt
                        ent[3] = now
                    elif self._host_has(ent[2]):
                        if ent[0] > 0:
                            self._unref_locked(ent[0],
                                               (node, best_key, "p"))
                        ent[0], ent[1] = -1, -1
                        fill_plan.append((len(blocks), node, best_key, "p",
                                          ent[2]))
                        blocks.append(None)
                        matched += best_nt
                        ent[3] = now
                    else:
                        self._drop_partial_locked(node, best_key)
            use = min(matched, max_tokens)
            need = pages_for(use, page) if use > 0 else 0
            surplus = blocks[need:]
            blocks = blocks[:need]
            fill_plan = [f for f in fill_plan if f[0] < need]
            if use > 0:
                self.hits += 1
                self.bytes_shared += use * self.token_bytes
                self.blocks_shared += len(blocks)
            else:
                self.misses += 1
        if surplus:
            self.pool.release([b for b in surplus if b is not None])
        if fill_plan:
            blocks, use = self._fill(blocks, use, fill_plan)
        return blocks, use

    def _fill(self, blocks, use: int, plan) -> tuple:
        """Land the planned host pages into fresh blocks (outside the index
        lock: the alloc may itself evict and spill other pages) and flip
        their entries back to the HBM tier. A page the store dropped
        between the phases, or a dry pool, truncates the match at the first
        unfillable page: everything before it is still a valid prefix."""
        t0 = time.monotonic()
        page = self.page
        fresh = self.pool.alloc(len(plan))
        filled = []  # (blocks_idx, parent, key, kind, hkey, blk, k, v)
        cut_at = None  # first blocks index that could not be filled
        for n, (bidx, parent, key, kind, hkey) in enumerate(plan):
            if fresh is None:
                cut_at = bidx
                break
            data = runtime.kv_host_get(hkey)
            if data is None or len(data) != self._page_bytes:
                cut_at = bidx
                self.pool.release(fresh[n:])
                break
            k_page, v_page = decode_host_page(data, self.pool.cfg, page)
            filled.append((bidx, parent, key, kind, hkey, fresh[n],
                           k_page, v_page))
        if filled:
            self.pool.write_blocks(
                [f[5] for f in filled],
                torch.stack([f[6] for f in filled]),
                torch.stack([f[7] for f in filled]))
            runtime.kv_tier_note_fill(
                int((time.monotonic() - t0) * 1e6), peer=False)
        with self._mu:
            self.host_hits += 1 if filled else 0
            for bidx, parent, key, kind, hkey, blk, _k, _v in filled:
                blocks[bidx] = blk
                ver = self.pool.version(blk)
                if kind == "f":
                    child = parent.children.get(key)
                    if child is not None and child.hkey == hkey \
                            and not self.pool.entry_alive(child.block,
                                                          child.version):
                        child.block, child.version = blk, ver
                        self._ref_locked(blk, (parent, key, "f"))
                else:
                    ent = parent.partials.get(key)
                    if ent is not None and ent[2] == hkey \
                            and not self.pool.entry_alive(ent[0], ent[1]):
                        ent[0], ent[1] = blk, ver
                        self._ref_locked(blk, (parent, key, "p"))
        if cut_at is not None:
            self.pool.release([b for b in blocks[cut_at:] if b is not None])
            blocks = blocks[:cut_at]
            use = min(use, cut_at * page)
        return blocks, use

    def admit(self, tokens, blocks: List[int]) -> None:
        """Register a prefilled sequence's pages: every full page becomes a
        trie entry, a partial tail a partial entry. Idempotent: an existing
        live entry wins, and admission takes no references. The caller
        holds a reference on ``blocks`` for the duration of the call. With
        the host tier, fresh entries' pages are also exported to the host
        store (idempotent per content key)."""
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        ntok = len(tokens)
        now = time.monotonic()
        export: List = []  # (hkey, blk) for fresh entries
        with self._mu:
            node = self._root
            for i, blk in enumerate(blocks):
                if (i + 1) * page <= ntok:
                    key = tokens[i * page:(i + 1) * page].tobytes()
                    child = node.children.get(key)
                    if child is not None and self.pool.entry_alive(
                            child.block, child.version):
                        # hot re-admit (every finished turn re-walks its
                        # whole conversation): no content hash needed
                        child.stamp = now
                        node = child
                        continue
                    hkey = page_key(tokens[:(i + 1) * page], page)
                    if child is not None and self._host_has(child.hkey):
                        # host-tier entry: back to HBM with our live block
                        if child.block > 0:
                            self._unref_locked(child.block,
                                               (node, key, "f"))
                        child.block = blk
                        child.version = self.pool.version(blk)
                        child.stamp = now
                        self._ref_locked(blk, (node, key, "f"))
                        node = child
                        continue
                    if child is not None:  # stale: replace with ours
                        self._drop_child_locked(node, key)
                    child = _PrefixNode(
                        blk, self.pool.version(blk),
                        prefix_hash(tokens[:page]) if i == 0 else "",
                        hkey=hkey, stamp=now)
                    node.children[key] = child
                    self._ref_locked(blk, (node, key, "f"))
                    export.append((hkey, blk))
                    node = child
                else:
                    nt = ntok - i * page
                    if nt <= 0 or nt >= page:
                        break
                    key = tokens[i * page:ntok].tobytes()
                    cur = node.partials.get(key)
                    if cur is not None and self.pool.entry_alive(
                            cur[0], cur[1]):
                        cur[3] = now
                        break
                    hkey = page_key(tokens[:ntok], page)
                    if cur is not None and self._host_has(cur[2]):
                        if cur[0] > 0:
                            self._unref_locked(cur[0], (node, key, "p"))
                        cur[0] = blk
                        cur[1] = self.pool.version(blk)
                        cur[3] = now
                        self._ref_locked(blk, (node, key, "p"))
                        break
                    if cur is not None:
                        self._drop_partial_locked(node, key)
                    node.partials[key] = [blk, self.pool.version(blk),
                                          hkey, now]
                    self._ref_locked(blk, (node, key, "p"))
                    export.append((hkey, blk))
                    break
        if self.host_tier and export:
            self._export(export)

    def _export(self, entries) -> None:
        """Copy freshly admitted pages into the host store (outside the
        index lock; the caller's references keep the blocks stable)."""
        todo = [(hk, blk) for hk, blk in entries
                if not runtime.kv_host_has(hk)]
        if todo:
            self._put_pages(todo)

    def plan_peer_fill(self, tokens, max_tokens: int) -> List:
        """Full pages of tokens[:max_tokens] that no local tier can serve,
        [(page_index, content_key)] in chain order: the pull list for the
        peer tier. Empty when the local tiers cover every page."""
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        F = min(len(tokens), max_tokens) // page
        out: List = []
        with self._mu:
            node = self._root
            for i in range(F):
                hkey = page_key(tokens[:(i + 1) * page], page)
                child = None if node is None else node.children.get(
                    tokens[i * page:(i + 1) * page].tobytes())
                if child is not None and (
                        self.pool.entry_alive(child.block, child.version)
                        or self._host_has(child.hkey)):
                    node = child
                    continue
                out.append((i, hkey))
                node = child  # may be None: deeper pages all need pulls
        return out

    def admit_host(self, tokens, n_tokens: int) -> None:
        """Register host-only entries for tokens[:n_tokens]: pages whose
        bytes just landed in the local host store (a peer pull) without
        ever living in this pool. ``match`` fills them on the next walk."""
        tokens = np.asarray(tokens, np.int32)
        page = self.page
        now = time.monotonic()
        with self._mu:
            node = self._root
            i = 0
            while (i + 1) * page <= n_tokens:
                key = tokens[i * page:(i + 1) * page].tobytes()
                hkey = page_key(tokens[:(i + 1) * page], page)
                child = node.children.get(key)
                if child is None:
                    child = _PrefixNode(
                        -1, -1,
                        prefix_hash(tokens[:page]) if i == 0 else "",
                        hkey=hkey, stamp=now)
                    node.children[key] = child
                else:
                    child.hkey = child.hkey or hkey
                    child.stamp = now
                node = child
                i += 1
            nt = n_tokens - i * page
            if 0 < nt < page:
                key = tokens[i * page:n_tokens].tobytes()
                cur = node.partials.get(key)
                if cur is None:
                    node.partials[key] = [
                        -1, -1, page_key(tokens[:n_tokens], page), now]
                else:
                    cur[2] = cur[2] or page_key(tokens[:n_tokens], page)
                    cur[3] = now

    # ---- TTL gc --------------------------------------------------------------

    def gc(self, max_age_s: float, now: Optional[float] = None) -> int:
        """Age out entries idle past ``max_age_s`` (no hit or admit) and
        their host pages: pool eviction only demotes to the host tier, so
        without the sweep a cold prefix would hold host budget forever.
        Returns the number of entries dropped (kv_prefix_gc_evictions)."""
        if now is None:
            now = time.monotonic()
        edge = now - max_age_s
        dead_hkeys: List[int] = []

        def sweep(node) -> int:
            dropped = 0
            for key in list(node.children):
                child = node.children[key]
                if child.stamp < edge:
                    if child.hkey:
                        self._collect_hkeys_locked(child, dead_hkeys)
                    n = 1 + self._count_entries(child)
                    self._drop_child_locked(node, key)
                    # _drop_child counts plain evictions; count them as gc
                    self.evictions -= n
                    dropped += n
                else:
                    dropped += sweep(child)
            for key in list(node.partials):
                ent = node.partials[key]
                if ent[3] < edge:
                    if ent[2]:
                        dead_hkeys.append(ent[2])
                    self._drop_partial_locked(node, key)
                    self.evictions -= 1
                    dropped += 1
            return dropped

        with self._mu:
            dropped = sweep(self._root)
            self.gc_evictions += dropped
        if self.host_tier:
            for hk in dead_hkeys:
                runtime.kv_host_drop(hk)
        self.sync_native()
        return dropped

    def _collect_hkeys_locked(self, node, out: List[int]) -> None:
        if node.hkey:
            out.append(node.hkey)
        for child in node.children.values():
            self._collect_hkeys_locked(child, out)
        for ent in node.partials.values():
            if ent[2]:
                out.append(ent[2])

    def _count_entries(self, node) -> int:
        n = len(node.partials)
        for child in node.children.values():
            n += 1 + self._count_entries(child)
        return n

    # ---- drain-time bulk spill / migration handoff -------------------------

    def spill(self) -> int:
        """Export every live indexed page not yet in the host store now
        (the first leg of a role migration), with the blocks retained for
        the read. Returns the pages newly exported."""
        if not self.host_tier:
            return 0
        todo: List = []   # (hkey, blk)
        retained: List = []
        with self._mu:
            stack = [self._root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    stack.append(child)
                    if (child.hkey and child.block >= 0
                            and runtime.kv_host_entry_bytes(child.hkey)
                            != self._page_bytes
                            and self.pool.try_retain(child.block,
                                                     child.version)):
                        retained.append(child.block)
                        todo.append((child.hkey, child.block))
                for ent in node.partials.values():
                    if (ent[2] and ent[0] >= 0
                            and runtime.kv_host_entry_bytes(ent[2])
                            != self._page_bytes
                            and self.pool.try_retain(ent[0], ent[1])):
                        retained.append(ent[0])
                        todo.append((ent[2], ent[0]))
        try:
            if todo:
                self._put_pages(todo)
        finally:
            if retained:
                self.pool.release(retained)
        if todo:
            runtime.app_counter_add("kv_prefix_drain_spills", len(todo))
        return len(todo)

    def export_chains(self, max_chains: int = 256) -> List[np.ndarray]:
        """Token chains (page-aligned prefixes, plus their partial tails)
        whose pages the host store fully holds, longest first per trie
        path: the handoff list a successor worker grafts with
        ``admit_host``. Call after ``spill()``."""
        if not self.host_tier:
            return []

        def covered(hkey: int) -> bool:
            return bool(hkey) and \
                runtime.kv_host_entry_bytes(hkey) == self._page_bytes

        out: List[np.ndarray] = []
        with self._mu:
            stack = [(self._root, b"")]
            while stack and len(out) < max_chains:
                node, prefix = stack.pop()
                extended = False
                for key, child in node.children.items():
                    if covered(child.hkey):
                        stack.append((child, prefix + key))
                        extended = True
                for key, ent in node.partials.items():
                    if covered(ent[2]) and len(out) < max_chains:
                        out.append(np.frombuffer(prefix + key,
                                                 np.int32).copy())
                if not extended and prefix and len(out) < max_chains:
                    out.append(np.frombuffer(prefix, np.int32).copy())
        return out

    # ---- telemetry ---------------------------------------------------------

    def digest(self, k: int = 8) -> str:
        """Top-k hottest first-page prefix hashes, comma-joined (the
        heartbeat's cache-affinity summary)."""
        with self._mu:
            top = sorted(self._root.children.values(),
                         key=lambda n: -n.hits)[:k]
            return ",".join(n.hash for n in top if n.hash)

    def page_digest(self, k: int = 16) -> str:
        """Top-k content keys of the hottest trie pages the host store
        holds, hex, comma-joined (the pg= heartbeat tag). The walk visits at
        most 1024 nodes, breadth first, to bound the index-lock hold."""
        if not self.host_tier:
            return ""
        cand: List = []
        budget = 1024
        with self._mu:
            frontier = [self._root]
            while frontier and budget > 0:
                nxt: List = []
                for node in frontier:
                    for child in node.children.values():
                        if budget <= 0:
                            break
                        budget -= 1
                        if child.hkey:
                            cand.append((child.hits, child.stamp,
                                         child.hkey))
                        nxt.append(child)
                frontier = nxt
        cand.sort(key=lambda c: (-c[0], -c[1]))
        out = []
        for _hits, _stamp, hk in cand:
            if runtime.kv_host_has(hk):
                out.append(f"{hk:016x}")
                if len(out) >= k:
                    break
        return ",".join(out)

    def counters(self) -> dict:
        with self._mu:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes_shared": self.bytes_shared,
                "blocks_shared": self.blocks_shared,
                "cow_copies": self.cow_copies,
                "gc_evictions": self.gc_evictions,
                "host_hits": self.host_hits,
            }

    def sync_native(self) -> None:
        """Mirror counter deltas onto the process-wide kv_prefix_* app
        counters (/vars, the metrics dump)."""
        for name, val in self.counters().items():
            delta = val - self._mirrored.get(name, 0)
            if delta:
                runtime.app_counter_add(f"kv_prefix_{name}", delta)
                self._mirrored[name] = val


# ---- suffix (resume) prefill over the paged pool -----------------------------

def suffix_bucket(n: int) -> int:
    """The reference's static suffix shape: the smallest power-of-two
    bucket >= max(8, n). The port computes only the n real rows; the bucket
    bounds what ``can_resume`` admits, as in the reference."""
    b = 8
    while b < n:
        b <<= 1
    return b


def can_resume(cfg, use: int, length: int) -> bool:
    """Whether the suffix bucket fits the cache window (it always does for
    prompts within max_prompt <= max_seq/2; the guard covers odd configs)."""
    return use > 0 and use + suffix_bucket(length - use) <= cfg.max_seq


def paged_resume_fn(cfg, page_tokens: int, suffix_len: int,
                    view_pages: int, out_start: int, out_pages: int):
    """(params, suffix_tokens [>= length - start], start, length, table
    [view_pages], k_pool, v_pool) -> (logits, k_pages, v_pages), the
    reference's signature and return: runs ``transformer.prefill_resume``
    in place through ``table`` (the destination blocks: a copy-on-write
    tail must already point at its copy) and returns copies of the pages
    it wrote ([out_pages, L, page, KV, Dh], page out_start onward).
    ``suffix_len`` is the reference's bucket, checked against the rows."""

    def run(params, suffix_tokens, start, length, table, k_pool, v_pool):
        start, length = int(start), int(length)
        if (k_pool.shape[2] != page_tokens or len(table) != view_pages
                or not 0 < length - start <= suffix_len):
            raise ValueError("paged_resume_fn: table, page size or suffix "
                             "length differs from the function's shape")
        table = torch.as_tensor(table, dtype=torch.int32,
                                device=k_pool.device)
        logits = transformer.prefill_resume(
            params, torch.as_tensor(suffix_tokens, device=k_pool.device),
            start, length, table, k_pool, v_pool, cfg)
        idx = table[out_start:out_start + out_pages].long()
        return logits, k_pool[idx], v_pool[idx]

    return run


def prefix_resume(pool: PagedKvPool, params, cfg, page_tokens: int,
                  prompt, shared: List[int], use: int,
                  index: Optional[PrefixIndex] = None):
    """Complete a prompt whose first ``use`` tokens are cached in
    ``shared`` (blocks retained by ``PrefixIndex.match``): compute the
    suffix from position ``use`` through the block table, writing its rows
    in place. A mid-page tail that another holder still references
    (refcount > 1 after our retain), or on which ``index`` keeps an entry
    that serves one of the rows the resume writes with another token, or
    a row past the prompt (which the sequence's decode writes next), is
    copied first into a fresh block (copy-on-write) and the table points
    at the copy before any suffix row lands, so the other holder's page
    stays byte-unchanged. Otherwise we write into the tail in place. (The
    reference writes in place whenever the refcount is 1, which corrupts
    a page that an earlier resume admitted onto the same block once no
    sequence holds it: the prompt p, then p + x and p + y with p's
    sequence gone, then p + x again; or p, then p + x + z, then p + x
    decoding past its prompt, then p + x + z + w.)

    Returns (first_token_logits, blocks): the sequence's full block list,
    one caller-owned reference per block. On pool exhaustion releases
    ``shared`` and returns None."""
    prompt = np.asarray(prompt, np.int32)
    P = len(prompt)
    page = page_tokens
    n_keep = pages_for(use, page)
    total = pages_for(P, page)
    tail_in_shared = use % page != 0
    keep = use % page
    cow = tail_in_shared and (
        pool.refcount(shared[-1]) > 1
        or (index is not None and index.serves_other(
            shared[-1], keep, prompt[use:use - keep + page])))
    n_fresh = total - n_keep
    alloc_n = n_fresh + (1 if cow else 0)
    fresh = pool.alloc(alloc_n) if alloc_n else []
    if fresh is None:
        pool.release(shared)
        return None
    blocks = list(shared)
    if cow:
        blocks[-1] = fresh.pop(0)
        pool.copy_block(shared[-1], blocks[-1])
    blocks.extend(fresh)
    dev = pool.device
    logits = transformer.prefill_resume(
        params, torch.from_numpy(prompt[use:]).to(dev), use, P,
        torch.tensor(blocks, dtype=torch.int32, device=dev), pool.k, pool.v,
        cfg)
    if cow:
        pool.release([shared[-1]])  # ours is the copy
        if index is not None:
            with index._mu:
                index.cow_copies += 1
    return logits, blocks


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


def claim_into_pages(handle: int, length: int, page_tokens: int, cfg,
                     timeout_ms: int):
    """Claim a committed transfer out of the native receive pool and decode
    it into block-major pages, (k_pages, v_pages) each [npages, L, page,
    KV, Dh] in the model dtype on the CPU (the caller's ``write_blocks``
    moves them to its device). A layer count other than the model's is
    EREQUEST. The claim is always released: the bytes are copied out."""
    npages = pages_for(length, page_tokens)
    n_layers = runtime.kv_recv_claim(handle, timeout_ms)
    try:
        if n_layers != 2 * cfg.n_layers:
            raise runtime.RpcError(
                runtime.EREQUEST,
                f"kv transfer has {n_layers} wire layers, model wants "
                f"{2 * cfg.n_layers}")
        ks, vs = [], []
        for layer in range(cfg.n_layers):
            ks.append(decode_layer(runtime.kv_recv_layer(handle, 2 * layer),
                                   npages, page_tokens, cfg))
            vs.append(decode_layer(
                runtime.kv_recv_layer(handle, 2 * layer + 1), npages,
                page_tokens, cfg))
        return torch.stack(ks, dim=1), torch.stack(vs, dim=1)
    finally:
        runtime.kv_recv_release(handle)
