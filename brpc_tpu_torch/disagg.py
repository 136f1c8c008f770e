"""Disaggregated prefill/decode serving on PyTorch: the counterpart of
brpc_tpu/disagg.py's workers and static-list router, speaking the same
wire, so torch and JAX routers and workers mix in one fleet.

  client --generate--> DisaggRouter (batcher lanes, deadline cull, ELIMIT)
      --prefill RPC--> PrefillWorker (layer-wise prefill; each layer's K/V
                       pages go out over the native KV transfer as soon as
                       the layer has computed them)
      --KV handle----> DecodeWorker (claims the transferred pages into its
                       paged pool and joins the continuous decode batch)
      <--token stream-- relayed through the router unchanged: the client
                       is a stock ServingClient.

A failed prefill, transfer or adopt before any relayed token re-prefills
on another worker with a fresh handle; a decode worker that dies mid
generation is re-dispatched too, and the router suppresses the tokens the
client already has (greedy decode re-derives them), so the stream stays
byte-exact. Prefill workers shed with ELIMIT under their limiter; the
router bounces that to a sibling.

Prefix caching: a prefill worker reuses its own cached pages to compute
only a prompt's suffix (K4; the transfer still ships every page); a decode
worker indexes the pages it adopts by the prompt the adopt carries, skips
the claim when its own tiers already cover a prompt, and serves SPLICE
requests off its cache (or answers EREJECT, and the router falls back to
a prefill worker on the same attempt).

Each worker runs its device work on its own loop thread and, on a card,
its own CUDA stream, so a decode step never queues behind a whole prefill
on one stream; a worker's kernel launches are counted apart in its
``launches``. Only the read-only params are shared between workers.

Worker processes: ``_worker_main`` (spawned from ``_WORKER_SRC``) pulls
its model's weights at start-up from the ``ParamServer`` group(s) named on
its argv (TPS1 over the RPC wire: a torch worker cannot rebuild JAX's
seeded weights), then serves one worker under a ``WorkerRunner``, whose
Admin service drains, flips, retargets, swaps adapters and retires it.
``DisaggCluster`` serves the weights, spawns the workers and fronts them
with a router. After each batch a worker adds its kernel launches to the
process's app counters (``torch_launches_<kernel>``), which a parent reads
off the worker's ``/vars``.

Membership is a static worker list or the lease registry
(``cluster.py``): with ``registry=`` the router's pools follow the
registry's watches, workers started with ``--registry`` hold a TTL lease
whose heartbeats carry their live load (and may carry role advice, which
a worker with ``--accept-advice`` acts on), and ``DisaggCluster(
use_registry=True)`` runs the registry in process or, with
``registry_replicas``, as replica subprocesses. Its ``Autoscaler``
replaces expelled workers and scales on the leader's ``/fleet``
aggregates; its ``ModelMixAdvisor`` moves workers between models.

Wire payloads (little-endian):
  Prefill.run request:  <u64 handle> <i64 budget_us> <u32 prompt_len>
                        <u32 max_new> <u16 addr_len> <addr utf8>
                        <prompt_len x u32>
  Prefill.run delivery: 'd' <u32 first_token>, then the terminal 'f'
  Decode.adopt request: <u8 kind=1> <u64 handle> <i64 budget_us>
                        <u32 length> <u32 last_token> <u32 left>
                        <length x u32 prompt>
  Decode.adopt (splice): <u8 kind=2> <i64 budget_us> <u8 n_peers>
                        n_peers x (<u16 len> <addr utf8>) <serving request>
  Decode.adopt delivery: the serving 'd'/'f' token contract, relayed 1:1
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import secrets
import select
import struct
import subprocess
import sys
import threading
import time
import traceback
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from brpc_tpu_torch import cluster, kv_cache, ops, param_server, runtime
from brpc_tpu_torch import serving
from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.utils import resolve_device

PREFILL_SERVICE = "Prefill"
PREFILL_METHOD = "run"          # interactive lane: overtakes queued batch work
PREFILL_METHOD_BATCH = "run_batch"
DECODE_SERVICE = "Decode"
DECODE_METHOD = "adopt"

_PREFILL_HDR = struct.Struct("<QqIIH")
_ADOPT_HDR = struct.Struct("<QqIII")
_SPLICE_HDR = struct.Struct("<q")

ADOPT_KIND_PAGES = 1   # adopt transferred pages (prompt rides along)
ADOPT_KIND_SPLICE = 2  # serve off the local prefix cache, or EREJECT


def encode_prefill_request(handle: int, budget_us: int, prompt, max_new: int,
                           decode_addr: str) -> bytes:
    addr = decode_addr.encode()
    toks = np.asarray(prompt, dtype="<u4")
    return (_PREFILL_HDR.pack(handle, budget_us, len(toks), max_new,
                              len(addr)) + addr + toks.tobytes())


def decode_prefill_request(payload: bytes):
    if len(payload) < _PREFILL_HDR.size:
        raise ValueError("prefill request too short")
    handle, budget_us, n, max_new, alen = _PREFILL_HDR.unpack_from(payload)
    off = _PREFILL_HDR.size
    addr = payload[off:off + alen].decode()
    off += alen
    body = payload[off:off + 4 * n]
    if len(body) != 4 * n:
        raise ValueError("prefill request truncated")
    prompt = np.frombuffer(body, dtype="<u4").astype(np.int32)
    return handle, budget_us, prompt, max_new, addr


def encode_adopt_request(handle: int, budget_us: int, prompt,
                         last_token: int, left: int) -> bytes:
    """kind-1 adopt: the prompt rides along so the decode worker can index
    the adopted pages by content."""
    toks = np.asarray(prompt, dtype="<u4")
    return (bytes([ADOPT_KIND_PAGES])
            + _ADOPT_HDR.pack(handle, budget_us, len(toks), last_token,
                              left) + toks.tobytes())


def decode_adopt_request(payload: bytes):
    """payload after the kind byte -> (handle, budget_us, prompt,
    last_token, left)."""
    if len(payload) < _ADOPT_HDR.size:
        raise ValueError("adopt request malformed")
    handle, budget_us, n, last_token, left = _ADOPT_HDR.unpack_from(payload)
    if len(payload) != _ADOPT_HDR.size + 4 * n:
        raise ValueError("adopt request malformed")
    body = payload[_ADOPT_HDR.size:]
    prompt = np.frombuffer(body, dtype="<u4").astype(np.int32)
    return handle, budget_us, prompt, last_token, left


def encode_splice_request(budget_us: int, prompt, max_new: int,
                          peers: Sequence[str] = ()) -> bytes:
    """Splice request. ``peers`` are decode workers whose page digests
    advertise this prompt's pages: a worker whose own tiers miss pulls the
    missing pages from them before its hit-or-EREJECT verdict."""
    body = bytes([ADOPT_KIND_SPLICE]) + _SPLICE_HDR.pack(budget_us)
    body += bytes([min(len(peers), 255)])
    for p in list(peers)[:255]:
        pe = p.encode()
        body += struct.pack("<H", len(pe)) + pe
    return body + serving.encode_request(prompt, max_new)


def decode_splice_request(payload: bytes):
    """payload after the kind byte -> (budget_us, prompt, max_new,
    peers)."""
    if len(payload) < _SPLICE_HDR.size + 1:
        raise ValueError("splice request malformed")
    (budget_us,) = _SPLICE_HDR.unpack_from(payload)
    off = _SPLICE_HDR.size
    n_peers = payload[off]
    off += 1
    peers: List[str] = []
    for _ in range(n_peers):
        if len(payload) < off + 2:
            raise ValueError("splice request malformed")
        (plen,) = struct.unpack_from("<H", payload, off)
        off += 2
        raw = payload[off:off + plen]
        if len(raw) != plen:
            raise ValueError("splice request malformed")
        peers.append(raw.decode(errors="replace"))
        off += plen
    prompt, max_new = serving.decode_request(payload[off:])
    return budget_us, prompt, max_new, peers


def _mint_handle() -> int:
    h = 0
    while h == 0:
        h = secrets.randbits(64)
    return h


# ---- the workers' device context ----------------------------------------------

def _worker_stream(cfg, device: torch.device) -> Optional[torch.cuda.Stream]:
    """A worker's own CUDA stream (None on the CPU). The RoPE tables, which
    every worker of the process reads, are built here on the caller's
    stream, before any worker stream exists."""
    transformer._rope_tables(cfg, device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


LAUNCH_COUNTER_PREFIX = "torch_launches_"
DEVICE_MEMORY_COUNTER = "torch_cuda_reserved_bytes"


def _publish_counters(worker) -> None:
    """Add ``worker``'s kernel launches since the last call to the
    process's app counters (``torch_launches_<kernel>``) and, on a card,
    bring ``torch_cuda_reserved_bytes`` to the memory the process's
    allocator holds there: how a parent reads a worker process's launches
    and device memory, off its ``/vars``."""
    published = worker._published
    now = dict(worker.launches)
    if worker.device.type == "cuda":
        now[DEVICE_MEMORY_COUNTER] = torch.cuda.memory_reserved(
            worker.device)
    for name, n in now.items():
        delta = n - published.get(name, 0)
        if delta:
            runtime.app_counter_add(
                name if name == DEVICE_MEMORY_COUNTER
                else LAUNCH_COUNTER_PREFIX + name, delta)
            published[name] = n


@contextlib.contextmanager
def _worker_scope(stream: Optional[torch.cuda.Stream], launches: dict):
    """A loop thread's device context: its worker's stream, made to wait
    first for what the default stream holds (the params' and the pool's
    initialisation), and its own kernel-launch tally."""
    with contextlib.ExitStack() as scope:
        if stream is not None:
            stream.wait_stream(torch.cuda.default_stream(stream.device))
            scope.enter_context(torch.cuda.stream(stream))
        scope.enter_context(ops.thread_launches(launches))
        yield


# ---- prefill worker -----------------------------------------------------------

class PrefillWorker(serving.DrainMixin):
    """Prefill-role node: admits Prefill.run through a batcher lane (limiter
    "auto" sheds with ELIMIT under overload), prefills, and streams the
    prompt's K/V pages to the decode worker named in the request; the
    delivery stream returns the first token. The router's handle is the
    rendezvous key on the decode side.

    Three routes: a prefix hit resumes the suffix through the local pool
    (K4) and streams the pages out of the pool; ``layerwise`` runs
    ``transformer.prefill_stream`` and sends each layer as it exists; else
    one ``transformer.prefill`` and then the layers. ``layerwise=None`` is
    on for a CUDA device. ``device`` defaults to ``cuda`` (raises without
    a card); the other options are the reference's, with its defaults."""

    def __init__(self, params, cfg, *, max_prompt: Optional[int] = None,
                 kv_page_tokens: int = 16, kv_chunk_bytes: int = -1,
                 limiter: str = "auto", max_queue_len: int = 256,
                 kv_timeout_ms: int = 20_000,
                 layerwise: Optional[bool] = None,
                 prefix_cache: bool = True, kv_host_tier: bool = True,
                 kv_blocks: Optional[int] = None, port: int = 0,
                 autostart: bool = True, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        # Layer-wise prefill lets layer l's transfer start while layer l+1
        # computes, which takes a device's asynchronous launches; on the
        # CPU the one-shot prefill (same wire bytes) is cheaper.
        self.layerwise = (layerwise if layerwise is not None
                          else self.device.type == "cuda")
        self.page_tokens = kv_page_tokens
        self.kv_chunk_bytes = kv_chunk_bytes
        self.kv_timeout_ms = kv_timeout_ms
        self.max_prompt = (max_prompt if max_prompt is not None
                           else max(8, cfg.max_seq // 2))
        self.prefills = 0
        self.kv_sends_failed = 0
        self.prefix_hits = 0
        # Timing of the handled prefills (host wall, synchronised): the
        # compute route up to the first token, the parts of it spent
        # waiting for layers' K/V on the host (layer-wise) and handing
        # layers to the sender, the local cache admission after it, the
        # transfer from its first layer sent to its commit acknowledged,
        # and the commit's own wait.
        self.prefill_seconds = 0.0
        self.layer_stall_seconds = 0.0
        self.send_seconds = 0.0
        self.cache_seconds = 0.0
        self.layers_streamed = 0
        self.transfer_seconds = 0.0
        self.commit_seconds = 0.0
        self.transfer_bytes = 0
        self.launches: Dict[str, int] = {}
        self._published: Dict[str, int] = {}
        self.draining = False
        self.drain_reason = ""
        self.drain_sheds = 0
        self._inflight_handles = 0
        self._prefill_ema_s = 0.0
        # Local prefix store: computed pages stay (evictable) so the next
        # prompt sharing a prefix prefills only its suffix.
        self.pool = None
        self.prefix = None
        if prefix_cache:
            max_blocks = cfg.max_seq // kv_page_tokens
            nblocks = (kv_blocks if kv_blocks is not None
                       else 8 * max_blocks + 1)
            self.pool = kv_cache.PagedKvPool(cfg, nblocks, kv_page_tokens,
                                             device=self.device)
            self.prefix = kv_cache.PrefixIndex(
                self.pool, kv_page_tokens,
                token_bytes=kv_cache.kv_token_bytes(cfg),
                host_tier=kv_host_tier)
        self._stream = _worker_stream(cfg, self.device)

        self.server = runtime.Server()
        self.batcher = runtime.NativeBatcher(
            max_batch_size=4, max_queue_delay_us=500,
            max_queue_len=max_queue_len, limiter=limiter)
        self.batcher.add_method(self.server, PREFILL_SERVICE, PREFILL_METHOD,
                                runtime.LANE_INTERACTIVE)
        # Bulk prompts ride the batch lane, so a queued long prefill never
        # delays an interactive one.
        self.batcher.add_method(self.server, PREFILL_SERVICE,
                                PREFILL_METHOD_BATCH, runtime.LANE_BATCH)
        self.port = self.server.start(port)
        self._channels = {}
        self._mu = threading.Lock()
        self._running = False
        self._thread = None
        if autostart:
            self.start()

    def _channel(self, addr: str) -> runtime.Channel:
        with self._mu:
            ch = self._channels.get(addr)
            if ch is None:
                # Chunk RPCs ride backoff-spaced retries; the kv layer adds
                # its own re-posts of dropped frames.
                ch = runtime.Channel(
                    addr, timeout_ms=self.kv_timeout_ms,
                    retry_policy=runtime.RetryPolicy(
                        max_retry=3, backoff_base_ms=20, backoff_max_ms=500))
                self._channels[addr] = ch
            return ch

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="prefill-loop")
        self._thread.start()

    def _loop(self) -> None:
        with _worker_scope(self._stream, self.launches):
            while self._running:
                batch = self.batcher.next_batch(wait_us=100_000)
                if batch is None:
                    self._running = False
                    return
                for req_id, payload, _prio, remaining_us in batch:
                    if self.draining:
                        self.batcher.finish(req_id, runtime.ELIMIT,
                                            self.drain_shed_text())
                        self.drain_sheds += 1
                        runtime.app_counter_add("serving_drain_sheds", 1)
                        continue
                    self._inflight_handles += 1
                    t0 = time.monotonic()
                    try:
                        self._handle(req_id, payload, remaining_us)
                        dt = time.monotonic() - t0
                        self._prefill_ema_s = (
                            dt if self._prefill_ema_s == 0.0
                            else 0.8 * self._prefill_ema_s + 0.2 * dt)
                    except Exception as e:  # noqa: BLE001 — fail the one
                        self.batcher.finish(req_id, runtime.EAPP,
                                            f"prefill failed: {e}")
                    finally:
                        self._inflight_handles -= 1
                _publish_counters(self)

    # ---- drain state machine (verbs shared via serving.DrainMixin) ---------

    def drain_live(self) -> int:
        """Prefills inside _handle (queued work sheds itself)."""
        return self._inflight_handles

    def drain_eta_ms(self) -> int:
        """Queued and in-handler prefills x the observed prefill time,
        clamped to [25, 30000] ms."""
        try:
            depth = int(self.batcher.stats().get("queue_depth", 0))
        except Exception:  # noqa: BLE001 — telemetry must not fail a shed
            depth = 0
        work = depth + self._inflight_handles
        ema = self._prefill_ema_s if self._prefill_ema_s > 0 else 0.05
        return max(25, min(int(work * ema * 1000), 30_000))

    def _handle(self, req_id: int, payload: bytes,
                remaining_us: int) -> None:
        try:
            handle, budget_us, prompt, max_new, addr = (
                decode_prefill_request(payload))
        except ValueError as e:
            self.batcher.finish(req_id, runtime.EREQUEST, str(e))
            return
        if len(prompt) == 0 or len(prompt) > self.max_prompt:
            self.batcher.finish(req_id, runtime.EREQUEST,
                                f"prompt length {len(prompt)} not in "
                                f"[1, {self.max_prompt}]")
            return
        length = len(prompt)
        cfg, page = self.cfg, self.page_tokens
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_START)
        t_start = time.monotonic()
        sender = runtime.KvSender(
            self._channel(addr), handle, total_layers=2 * cfg.n_layers,
            chunk_bytes=self.kv_chunk_bytes)
        send_err = []
        t_first_send = []

        def send(layer: int, k_bytes: bytes, v_bytes: bytes) -> None:
            t0 = time.monotonic()
            if not t_first_send:
                t_first_send.append(t0)
            try:
                sender.send_layer(2 * layer, k_bytes)
                sender.send_layer(2 * layer + 1, v_bytes)
            except runtime.RpcError as e:
                send_err.append(e)
            self.send_seconds += time.monotonic() - t0

        shared, use = [], 0
        if self.prefix is not None:
            shared, use = self.prefix.match(prompt, length - 1)
            if use and not kv_cache.can_resume(cfg, use, length):
                self.pool.release(shared)
                shared, use = [], 0
        hit_out = None
        if use:
            hit_out = kv_cache.prefix_resume(
                self.pool, self.params, cfg, page, prompt, shared, use,
                index=self.prefix)

        cache_blocks = None
        if hit_out is not None:
            # Prefix hit: only the suffix was computed; every page (cached
            # prefix and fresh suffix) streams out of the local pool.
            logits, cache_blocks = hit_out
            self.prefix_hits += 1
            idx = torch.tensor(cache_blocks, dtype=torch.long,
                               device=self.device)
            kp, vp = self.pool.k[idx].cpu(), self.pool.v[idx].cpu()
            span = len(cache_blocks) * page
            kv_shape = (span, cfg.n_kv_heads, cfg.d_head)
            for layer in range(cfg.n_layers):
                if send_err:
                    break
                send(layer,
                     kv_cache.encode_layer(kp[:, layer].reshape(kv_shape),
                                           length, page, cfg),
                     kv_cache.encode_layer(vp[:, layer].reshape(kv_shape),
                                           length, page, cfg))
        else:
            padded = np.zeros(serving.prompt_bucket(length, self.max_prompt),
                              np.int32)
            padded[:length] = prompt
            tokens = torch.from_numpy(padded).to(self.device)
            if self.layerwise:
                kept = [] if self.prefix is not None else None

                def on_layer(layer, k, v):
                    # Layer l's pages go to the sender before layer l + 1
                    # is enqueued. Encoding waits on the host for layer l's
                    # K/V, and send_layer blocks once the sender's chunk
                    # window is full.
                    if send_err:
                        return
                    t0 = time.monotonic()
                    kb = kv_cache.encode_layer(k, length, page, cfg)
                    vb = kv_cache.encode_layer(v, length, page, cfg)
                    self.layer_stall_seconds += time.monotonic() - t0
                    self.layers_streamed += 1
                    if kept is not None:
                        kept.append((k, v))  # the device copy, for caching
                    send(layer, kb, vb)

                logits = transformer.prefill_stream(
                    self.params, tokens, length, cfg, on_layer)
                if kept is not None and len(kept) == cfg.n_layers:
                    cache_blocks = self._cache_pages(
                        prompt, torch.stack([k for k, _ in kept]),
                        torch.stack([v for _, v in kept]))
            else:
                # One prefill, then the finished layers (the chunk window
                # still pipelines them on the wire).
                logits, k, v = transformer.prefill(self.params, tokens,
                                                   length, cfg)
                kc, vc = k.cpu(), v.cpu()
                for layer in range(cfg.n_layers):
                    if send_err:
                        break
                    send(layer,
                         kv_cache.encode_layer(kc[layer], length, page, cfg),
                         kv_cache.encode_layer(vc[layer], length, page, cfg))
                if self.prefix is not None:
                    cache_blocks = self._cache_pages(prompt, k, v)
        tok = int(logits.argmax())  # synchronises: the compute is done
        t_computed = time.monotonic()
        self.prefill_seconds += t_computed - t_start
        if self.prefix is not None:
            if cache_blocks:
                # Admit, then release: the pages idle on the evictable LRU
                # until the next shared-prefix prompt revives them.
                self.prefix.admit(prompt, cache_blocks)
                self.pool.release(cache_blocks)
            self.prefix.sync_native()
        self.prefills += 1
        self.cache_seconds += time.monotonic() - t_computed
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_DONE)
        if hit_out is not None:
            runtime.flight_route(req_id, runtime.ROUTE_HBM_HIT)
        t_commit = time.monotonic()
        try:
            if send_err:
                raise send_err[0]
            sender.commit()
        except runtime.RpcError as e:
            self.kv_sends_failed += 1
            self.batcher.finish(req_id, e.code,
                                f"kv transfer failed: {e.text}")
            return
        t_done = time.monotonic()
        self.commit_seconds += t_done - t_commit
        self.transfer_seconds += t_done - t_first_send[0]
        self.transfer_bytes += sender.bytes_sent
        runtime.flight_stamp(req_id, runtime.FLIGHT_KV_TRANSFER)
        # Link attribution: the transfer's wire bytes and destination.
        runtime.flight_note_once(
            req_id, f"kv w={sender.bytes_sent} l={addr}")
        rc = self.batcher.emit(req_id, struct.pack("<I", tok))
        if rc != 0:
            self.batcher.finish(req_id, rc, "router went away")
            return
        self.batcher.finish(req_id, 0, "")

    def _cache_pages(self, prompt, k, v) -> Optional[list]:
        """Land a prefill's pages (k/v [L, P, KV, Dh] on the device) in the
        local pool. Returns the blocks (the caller admits and releases
        them) or None when the pool cannot fit them: caching is
        best-effort, never a request failure."""
        blocks = self.pool.alloc(kv_cache.pages_for(len(prompt),
                                                    self.page_tokens))
        if blocks is None:
            return None
        k_pages, v_pages = kv_cache.prefill_cache_pages(
            k, v, len(prompt), self.page_tokens)
        self.pool.write_blocks(blocks, k_pages, v_pages)
        return blocks

    def stats(self) -> dict:
        s = self.batcher.stats()
        s.update(prefills=self.prefills, prefix_hits=self.prefix_hits,
                 kv_sends_failed=self.kv_sends_failed,
                 prefill_seconds=self.prefill_seconds,
                 layer_stall_seconds=self.layer_stall_seconds,
                 send_seconds=self.send_seconds,
                 layers_streamed=self.layers_streamed,
                 cache_seconds=self.cache_seconds,
                 transfer_seconds=self.transfer_seconds,
                 commit_seconds=self.commit_seconds,
                 transfer_bytes=self.transfer_bytes,
                 drain_sheds=self.drain_sheds)
        return s

    def close(self) -> None:
        self._running = False
        self.server.stop()
        self.batcher.stop()
        if not serving.join_loop(self._thread, type(self).__name__):
            return
        self._thread = None
        if self._stream is not None:
            self._stream.synchronize()
        self.batcher.close()
        self.server.close()
        with self._mu:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- decode worker ------------------------------------------------------------

class DecodeWorker(serving.ServingEngine):
    """Decode-role node: a ServingEngine whose admission ADOPTS a
    transferred KV instead of prefilling. Decode.adopt claims the handle
    from the native receive pool, lands the pages in the paged block pool,
    and the sequence joins the continuous decode batch; its tokens go back
    on the adopt stream (the router relays them).

    Adopted pages are admitted to the prefix index under the prompt the
    adopt carries. An adopt whose prompt the local tiers already cover
    resumes off them and releases the transfer unclaimed. A SPLICE request
    (kind 2) is served entirely off the cache (cached pages retained into
    a fresh block table, the suffix prefilled with K4); less than
    ``splice_min_hit_tokens`` cached answers a terminal EREJECT."""

    service = DECODE_SERVICE
    lanes = ((DECODE_METHOD, runtime.LANE_INTERACTIVE),)

    def __init__(self, params, cfg, *, kv_claim_timeout_ms: int = 1_000,
                 splice_min_hit_tokens: Optional[int] = None,
                 peer_pull_timeout_ms: int = 800,
                 peer_pull_window: int = 4,
                 peer_fill_budget_ms: int = 1_500, **kwargs):
        # The router commits the transfer before the adopt, so the claim
        # normally succeeds at once; the claim runs on the engine thread,
        # where a long wait would stall every live sequence.
        self.kv_claim_timeout_ms = kv_claim_timeout_ms
        self.splice_min_hit_tokens = splice_min_hit_tokens
        # Peer pulls also run on the engine thread: a short per-pull
        # deadline, no channel retry, a dead-peer memo and a whole-fill
        # budget bound the stall near one timeout.
        self.peer_pull_timeout_ms = peer_pull_timeout_ms
        self.peer_pull_window = peer_pull_window
        self.peer_fill_budget_ms = peer_fill_budget_ms
        self.adopts = 0
        self.adopt_failures = 0
        self.adopt_local_skips = 0  # adopts served off the local tiers
        self.splices = 0
        self.splice_rejects = 0
        self.peer_fill_pages = 0    # pages landed from peers
        self.launches: Dict[str, int] = {}
        self._published: Dict[str, int] = {}
        self._peer_mu = threading.Lock()
        self._peer_channels: Dict[str, runtime.Channel] = {}
        self._stream = _worker_stream(cfg,
                                      resolve_device(kwargs.get("device")))
        super().__init__(params, cfg, **kwargs)

    def _loop(self) -> None:
        with _worker_scope(self._stream, self.launches):
            super()._loop()

    def step(self, wait_us: int = 50_000) -> int:
        active = super().step(wait_us)
        _publish_counters(self)
        return active

    def _peer_channel(self, addr: str) -> runtime.Channel:
        with self._peer_mu:
            ch = self._peer_channels.get(addr)
            if ch is None:
                ch = runtime.Channel(addr,
                                     timeout_ms=self.peer_pull_timeout_ms,
                                     max_retry=0)
                self._peer_channels[addr] = ch
            return ch

    def _peer_fill(self, prompt, peers: List[str]) -> int:
        """Pull this prompt's locally missing pages from ``peers`` into the
        local host tier, a window of pulls at a time; the next match fills
        them into the pool like any spilled page. Only the contiguous head
        of the chain is admitted. Failure is never an error: the splice
        just misses. Returns the pages landed."""
        if self.prefix is None or not peers:
            return 0
        plan = self.prefix.plan_peer_fill(prompt, len(prompt) - 1)
        if not plan:
            return 0
        page_bytes = kv_cache.host_page_bytes(self.cfg, self.page_tokens)
        t0 = time.monotonic()
        budget_s = self.peer_fill_budget_ms / 1000.0
        dead: set = set()  # peers that failed at transport in this fill

        def pull_one(hkey: int):
            for addr in peers:
                if addr in dead:
                    continue
                try:
                    data = runtime.kv_pull(self._peer_channel(addr), hkey,
                                           page_bytes)
                except runtime.RpcError:
                    dead.add(addr)  # one window of timeouts per dead peer
                    continue
                if data is not None and len(data) == page_bytes:
                    return data, addr
            return None, None

        window = max(1, min(self.peer_pull_window, len(plan)))
        results = []
        with ThreadPoolExecutor(max_workers=window,
                                thread_name_prefix="kv-peer-pull") as ex:
            for base_i in range(0, len(plan), window):
                if base_i and time.monotonic() - t0 > budget_s:
                    break
                if len(dead) >= len(peers):
                    break  # every source is gone
                batch = plan[base_i:base_i + window]
                results.extend(ex.map(pull_one, [hk for _i, hk in batch]))
        landed = 0
        served_by: dict = {}
        cut_page = plan[len(results)][0] if len(results) < len(plan) \
            else None
        for (i, hkey), (data, addr) in zip(plan, results):
            if data is None:
                cut_page = i
                break
            runtime.kv_host_put(hkey, data)
            served_by[addr] = served_by.get(addr, 0) + 1
            landed += 1
        if landed:
            self._last_peer_fill_addr = max(served_by, key=served_by.get)
            covered = (cut_page if cut_page is not None
                       else (len(prompt) - 1) // self.page_tokens)
            self.prefix.admit_host(prompt, covered * self.page_tokens)
            runtime.kv_tier_note_fill(
                int((time.monotonic() - t0) * 1e6), peer=True)
            self.peer_fill_pages += landed
        return landed

    def _admit(self, req_id: int, payload: bytes, remaining_us: int,
               slot: int) -> bool:
        kind = payload[0] if payload else 0
        if kind == ADOPT_KIND_SPLICE:
            return self._admit_splice(req_id, payload[1:], remaining_us,
                                      slot)
        if kind == ADOPT_KIND_PAGES:
            return self._admit_adopt(req_id, payload[1:], remaining_us,
                                     slot)
        self.batcher.finish(req_id, runtime.EREQUEST,
                            f"unknown adopt kind {kind}")
        return False

    def _admit_splice(self, req_id: int, payload: bytes, remaining_us: int,
                      slot: int) -> bool:
        try:
            budget_us, prompt, max_new, peers = \
                decode_splice_request(payload)
        except ValueError as e:
            self.batcher.finish(req_id, runtime.EREQUEST, str(e))
            return False
        budgets = [b for b in (budget_us, remaining_us) if b >= 0]
        rem = min(budgets) if budgets else -1
        min_hit = self.splice_min_hit_tokens
        if min_hit is None:
            # At least one full reused page, or everything reusable for a
            # short prompt.
            min_hit = min(max(len(prompt) - 1, 1), self.page_tokens)
        if self.prefix is None:
            self.splice_rejects += 1
            self.batcher.finish(req_id, runtime.EREJECT,
                                "prefix cache disabled")
            return False
        runtime.flight_route(req_id, runtime.ROUTE_SPLICE)
        if peers:
            # Pages the local tiers miss come from the advertising peers
            # before the verdict; a dead peer just leaves the miss.
            try:
                landed = self._peer_fill(prompt, peers)
                if landed > 0:
                    runtime.flight_route(req_id, runtime.ROUTE_PEER_PULL)
                    page_bytes = kv_cache.host_page_bytes(self.cfg,
                                                          self.page_tokens)
                    src = getattr(self, "_last_peer_fill_addr", peers[0])
                    runtime.flight_note_once(
                        req_id,
                        f"kv pull w={landed * page_bytes} l={src}")
            except Exception:  # noqa: BLE001 — pulls must never fail a req
                pass
        ok = self._admit_prompt(req_id, prompt, max_new, rem, slot,
                                min_hit_tokens=min_hit, emit_first=True)
        if ok:
            self.splices += 1
        return ok

    def _admit_adopt(self, req_id: int, payload: bytes, remaining_us: int,
                     slot: int) -> bool:
        try:
            handle, budget_us, prompt, last_token, left = (
                decode_adopt_request(payload))
        except ValueError as e:
            self.batcher.finish(req_id, runtime.EREQUEST, str(e))
            return False
        length = len(prompt)
        if length < 1 or length >= self.cfg.max_seq or left < 1:
            self.batcher.finish(req_id, runtime.EREQUEST,
                                "adopt coordinates out of range")
            return False
        budgets = [b for b in (budget_us, remaining_us) if b >= 0]
        deadline = (time.monotonic() + min(budgets) / 1e6
                    if budgets else None)
        left = min(left, self.cfg.max_seq - 1 - length)
        seq = {
            "id": req_id,
            "pos": length,
            "last": last_token,
            "left": left,
            "deadline": deadline,
            "tokens": [int(t) for t in prompt],
        }
        if self.prefix is not None and left >= 1:
            # When the local tiers cover all but the recomputed last token,
            # resume off them and drop the transfer unclaimed; greedy
            # decode re-derives the same first token.
            shared, use = self.prefix.match(prompt, length - 1)
            if use >= length - 1 and kv_cache.can_resume(self.cfg, use,
                                                         length):
                t_resume = time.monotonic()
                out = kv_cache.prefix_resume(
                    self.pool, self.params, self.cfg, self.page_tokens,
                    prompt, shared, use, index=self.prefix)
                if out is not None:
                    logits, blocks = out
                    logits.argmax().item()  # synchronises: resume done
                    self.resumes += 1
                    self.resume_seconds += time.monotonic() - t_resume
                    try:  # free the redundant transfer's pages now
                        runtime.kv_recv_claim(handle, 0)
                        runtime.kv_recv_release(handle)
                    except runtime.RpcError:
                        pass  # not landed yet: pressure eviction covers it
                    self.adopts += 1
                    self.adopt_local_skips += 1
                    runtime.flight_route(req_id, runtime.ROUTE_HBM_HIT)
                    # Admit before activation: the host export reads the
                    # pages while our references are held.
                    self.prefix.admit(prompt, blocks)
                    self.prefix.sync_native()
                    return self._activate_seq(slot, seq, blocks,
                                              emit_first=False)
                # pool exhausted mid-resume: fall through to the claim
            elif shared:
                self.pool.release(shared)
        claim_ms = self.kv_claim_timeout_ms
        if remaining_us >= 0:
            claim_ms = min(claim_ms, max(1, remaining_us // 1000))
        runtime.flight_route(req_id, runtime.ROUTE_DISAGG)
        try:
            k_pages, v_pages = kv_cache.claim_into_pages(
                handle, length, self.page_tokens, self.cfg, claim_ms)
        except runtime.RpcError as e:
            self.adopt_failures += 1
            self.batcher.finish(req_id, e.code,
                                f"kv claim failed: {e.text}")
            return False
        runtime.flight_stamp(req_id, runtime.FLIGHT_KV_TRANSFER)
        blocks = self.pool.alloc(len(k_pages))
        if blocks is None:
            self.adopt_failures += 1
            self.batcher.finish(req_id, runtime.ELIMIT,
                                "kv block pool exhausted")
            return False
        self.adopts += 1
        self.pool.write_blocks(blocks, k_pages, v_pages)
        if self.prefix is not None:
            # Index the adopted pages (after the write, before activation:
            # the host export needs our references still held).
            self.prefix.admit(prompt, blocks)
            self.prefix.sync_native()
        # emit_first=False: the router already delivered the prefill token.
        return self._activate_seq(slot, seq, blocks, emit_first=False)

    def stats(self) -> dict:
        s = super().stats()
        s.update(adopts=self.adopts, adopt_failures=self.adopt_failures,
                 adopt_local_skips=self.adopt_local_skips,
                 splices=self.splices, splice_rejects=self.splice_rejects,
                 peer_fill_pages=self.peer_fill_pages)
        return s

    def close(self) -> None:
        super().close()
        if self._thread is not None:  # the loop still runs: see join_loop
            return
        if self._stream is not None:
            self._stream.synchronize()
        with self._peer_mu:
            for ch in self._peer_channels.values():
                ch.close()
            self._peer_channels.clear()


# ---- worker pool (per role) ---------------------------------------------------

class _WorkerPool:
    """The worker set of one role, with the signals the pick weighs:
    router-local inflight per worker, recent p99 TTFT measured at the
    router, and a short-TTL failure score (half-life 2 s, gone after 10 s)
    under which a worker failing repeatedly drains: it takes no fresh
    traffic while alternatives exist.

    pick() minimises
      (1 + inflight + reported_qd) / capacity
        x (1 + p99_ttft_s) x (1 + fail_score) [x AFFINITY_WEIGHT]
    where a worker whose prefix digest holds the request's affinity key is
    scaled by AFFINITY_WEIGHT. Membership is the static list given at
    construction, or what ``update_members`` installs from a registry
    watch.

    Static stability: ``set_stale(True)`` (the watch lost the whole
    control plane) freezes the member set and ignores its reported queue
    depths and TTFTs, so picks and ``load_snapshot`` run on router-local
    signals (inflight, measured TTFT, the failure score) until a fresh
    watch reconciles."""

    FAIL_HALF_LIFE_S = 2.0
    FAIL_TTL_S = 10.0
    DRAIN_SCORE = 2.0
    AFFINITY_WEIGHT = 0.3

    def __init__(self, addrs: Sequence[str] = ()):
        self._mu = threading.Lock()
        self._members: Dict[str, cluster.Member] = {
            a: cluster.Member(addr=a) for a in addrs}
        self._inflight: Dict[str, int] = {}
        self._fail: Dict[str, tuple] = {}   # addr -> (score, stamp)
        self._ttft: Dict[str, deque] = {}   # addr -> recent seconds samples
        self.drained_picks = 0  # picks that skipped a draining worker
        self.warming_skips = 0  # picks that skipped a not-yet-ready worker
        self.affinity_picks = 0  # picks the prefix-locality term decided
        self._stale = False     # control plane unreachable: frozen set

    def update_members(self, members: List[cluster.Member]) -> None:
        """Install a fresh member set. Local signals of workers that stay
        carry over; an expelled worker's are dropped (a re-registered one
        is a new process). Requests in flight to a dropped worker run on:
        ``note_done`` tolerates a missing key."""
        with self._mu:
            fresh = {m.addr: m for m in members}
            for gone in set(self._members) - set(fresh):
                self._fail.pop(gone, None)
                self._ttft.pop(gone, None)
                self._inflight.pop(gone, None)
            self._members = fresh

    def set_stale(self, stale: bool) -> None:
        """The control-plane outage toggle (see the class docstring)."""
        with self._mu:
            self._stale = stale

    @property
    def stale(self) -> bool:
        with self._mu:
            return self._stale

    def addrs(self) -> List[str]:
        with self._mu:
            return list(self._members)

    def note_done(self, addr: str) -> None:
        with self._mu:
            if addr in self._inflight:
                self._inflight[addr] = max(self._inflight[addr] - 1, 0)

    def note_failure(self, addr: str) -> None:
        now = time.monotonic()
        with self._mu:
            if addr not in self._members:
                return
            self._fail[addr] = (self._fail_score_locked(addr, now) + 1.0,
                                now)

    def note_ttft(self, addr: str, seconds: float) -> None:
        with self._mu:
            if addr not in self._members:
                return
            dq = self._ttft.get(addr)
            if dq is None:
                dq = self._ttft[addr] = deque(maxlen=32)
            dq.append(seconds)

    def _fail_score_locked(self, addr: str, now: float) -> float:
        entry = self._fail.get(addr)
        if entry is None:
            return 0.0
        score, stamp = entry
        age = now - stamp
        if age >= self.FAIL_TTL_S:
            del self._fail[addr]
            return 0.0
        return score * 0.5 ** (age / self.FAIL_HALF_LIFE_S)

    def _p99_ttft_s_locked(self, addr: str, member) -> float:
        dq = self._ttft.get(addr)
        if dq:
            return sorted(dq)[max(int(len(dq) * 0.99) - 1, 0)]
        if self._stale:
            return 0.0  # the heartbeat value describes a frozen world
        return member.p99_ttft_us / 1e6

    def fail_score(self, addr: str) -> float:
        with self._mu:
            return self._fail_score_locked(addr, time.monotonic())

    def load_snapshot(self) -> dict:
        """(inflight + reported queue depth, capacity) totals: the
        pressure gate's overload signal. A draining worker's capacity does
        not count; its load does. While stale, only the local inflight
        counts."""
        with self._mu:
            load = sum(self._inflight.get(a, 0) +
                       (0 if self._stale else m.queue_depth)
                       for a, m in self._members.items())
            cap = sum(max(m.capacity, 1) for m in self._members.values()
                      if not m.draining)
            return {"load": load, "capacity": cap}

    def holds_prefix(self, addr: str, key: Optional[str]) -> bool:
        """Does ``addr``'s prefix digest claim the prefix ``key``?"""
        if not key:
            return False
        with self._mu:
            m = self._members.get(addr)
            return m is not None and m.holds_prefix(key)

    def page_holders(self, key: Optional[str],
                     model: str = "") -> List[str]:
        """Workers whose page digest advertises page ``key`` (same model
        only, with ``model`` set): candidate peer-pull sources."""
        if not key:
            return []
        with self._mu:
            return [a for a, m in self._members.items()
                    if m.holds_page(key)
                    and (not model or m.model == model)]

    def pick(self, exclude=(),
             affinity_key: Optional[str] = None,
             model: str = "") -> Optional[str]:
        now = time.monotonic()
        picked_by_affinity = False
        with self._mu:
            best, best_score, draining = None, None, []
            warming = []
            best_plain = None  # who would have won without affinity
            excluded = []
            for addr, m in self._members.items():
                if model and m.model != model:
                    continue  # wrong weights are never a fallback
                fail = self._fail_score_locked(addr, now)
                reported_qd = 0 if self._stale else m.queue_depth
                score = ((1.0 + self._inflight.get(addr, 0) + reported_qd)
                         / max(m.capacity, 1)
                         * (1.0 + self._p99_ttft_s_locked(addr, m))
                         * (1.0 + fail))
                plain = score
                if affinity_key is not None and m.holds_prefix(affinity_key):
                    score *= self.AFFINITY_WEIGHT
                if addr in exclude:
                    excluded.append((score, addr))
                    continue
                if not m.ready:
                    warming.append((score, addr))
                    continue
                if m.draining or fail >= self.DRAIN_SCORE:
                    draining.append((score, addr))
                    continue
                if best_score is None or score < best_score:
                    best, best_score = addr, score
                    picked_by_affinity = score < plain
                if best_plain is None or plain < best_plain[0]:
                    best_plain = (plain, addr)
            if picked_by_affinity and best_plain is not None \
                    and best_plain[1] != best:
                self.affinity_picks += 1
            if best is None and warming:
                best = min(warming)[1]
            elif warming:
                self.warming_skips += 1
            if best is None and draining:
                # The least-bad draining worker beats failing the request.
                best = min(draining)[1]
            elif draining:
                self.drained_picks += 1
            if best is None and excluded:
                # Every member already failed this request: retry the
                # least-bad one, so a one-worker role stays retriable.
                best = min(excluded)[1]
            if best is not None:
                self._inflight[best] = self._inflight.get(best, 0) + 1
            return best


# ---- router -------------------------------------------------------------------

class _TierStats:
    """Per-SLO-tier attribution at the router (the one place that sees
    every tier's admission verdict): completions, sheds, errors, delivered
    tokens, and a TTFT reservoir per tier. A registry-fed router's own
    lease carries ``series()`` as its sr= tail, so the leader's /fleet
    has per-tier TTFT and goodput."""

    WINDOW = 512

    def __init__(self):
        self._mu = threading.Lock()
        self._ttft = {t: deque(maxlen=self.WINDOW) for t in serving.TIERS}
        self.ok = {t: 0 for t in serving.TIERS}
        self.shed = {t: 0 for t in serving.TIERS}
        self.errors = {t: 0 for t in serving.TIERS}
        self.good_tokens = {t: 0 for t in serving.TIERS}
        self._t0 = time.monotonic()

    def note_ok(self, tier: str, ttft_s: Optional[float],
                tokens: int) -> None:
        with self._mu:
            self.ok[tier] += 1
            self.good_tokens[tier] += tokens
            if ttft_s is not None:
                self._ttft[tier].append(ttft_s)

    def note_shed(self, tier: str) -> None:
        with self._mu:
            self.shed[tier] += 1

    def note_error(self, tier: str) -> None:
        with self._mu:
            self.errors[tier] += 1

    @staticmethod
    def _p99_us(dq) -> int:
        if not dq:
            return 0
        s = sorted(dq)
        return int(s[max(int(len(s) * 0.99) - 1, 0)] * 1e6)

    def ttft_p99_us(self, tier: str) -> int:
        with self._mu:
            return self._p99_us(self._ttft[tier])

    def series(self) -> str:
        """The sr= heartbeat tail, 'name:val|...' (12 metrics): per tier
        the TTFT p99 in us, the cumulative ok and shed totals, and the
        goodput since the router started in tokens/s x1000."""
        up_s = max(time.monotonic() - self._t0, 1e-3)
        parts = []
        with self._mu:
            for t in serving.TIERS:
                tps = int(self.good_tokens[t] / up_s * 1000)
                parts += [
                    f"serving_tier_{t}_ttft_p99_us:"
                    f"{self._p99_us(self._ttft[t])}",
                    f"serving_tier_{t}_ok_total:{self.ok[t]}",
                    f"serving_tier_{t}_shed_total:{self.shed[t]}",
                    f"serving_tier_{t}_goodput_tps_x1000:{tps}"]
        return "|".join(parts)

    def snapshot(self) -> dict:
        with self._mu:
            return {t: {"ok": self.ok[t], "shed": self.shed[t],
                        "errors": self.errors[t],
                        "good_tokens": self.good_tokens[t]}
                    for t in serving.TIERS}


class DisaggRouter:
    """The front door: owns the Serve.generate batcher (the colocated
    engine's admission: lanes, deadline cull, ELIMIT), picks a prefill and
    a decode worker, and relays the decode worker's token stream to the
    client 1:1, so ``ServingClient.generate`` works unchanged against it.

    Membership: static ``prefill_addrs``/``decode_addrs``, or a
    ``registry`` address (several replicas comma-separated), whose two
    longpoll watches feed the pools: a worker whose lease expires stops
    being picked within one watch round trip, a fresh one takes traffic
    once its first heartbeat lands, and while the whole control plane is
    unreachable the pools serve on the frozen set (``registry_stale`` in
    ``stats()``). The router then holds a lease of its own, role
    ``router``, whose renews carry the per-tier series tail.

    Admission charges per-tenant token budgets (``tenants.set_budget``)
    and a pressure gate over decode load that sheds the batch lane first
    with a retriable ELIMIT and a retry_after_ms hint; the gate arms with
    a registry (members report real capacities) or explicit thresholds.

    A failed prefill, transfer or adopt before any relayed token
    re-prefills on another worker with a fresh handle; a decode worker
    dying mid generation is re-dispatched with the delivered tokens
    suppressed, so the client's stream stays byte-exact with no
    duplicates."""

    def __init__(self, prefill_addrs: Optional[Sequence[str]] = None,
                 decode_addrs: Optional[Sequence[str]] = None, *,
                 registry: Optional[str] = None,
                 max_batch_size: int = 16, max_queue_delay_us: int = 1000,
                 max_queue_len: int = 1024, limiter: str = "",
                 retries: int = 2, worker_timeout_ms: int = 60_000,
                 max_concurrency: int = 64,
                 tenant_rate: float = 0.0,
                 shed_batch_pressure: Optional[float] = None,
                 shed_standard_pressure: Optional[float] = None,
                 shed_interactive_pressure: Optional[float] = None,
                 membership_wait_s: float = 5.0,
                 page_tokens: int = 16,
                 prefix_affinity: bool = True,
                 prefix_splice: bool = True,
                 port: int = 0, autostart: bool = True):
        if registry is None and (not prefill_addrs or not decode_addrs):
            raise ValueError(
                "need a registry or at least one prefill and one decode node")
        self.registry = registry
        self.retries = retries
        self.worker_timeout_ms = worker_timeout_ms
        # page_tokens must match the workers': the affinity key names the
        # prompt's first page.
        self.page_tokens = page_tokens
        self.prefix_affinity = prefix_affinity
        self.prefix_splice = prefix_splice
        self.re_prefills = 0        # attempts after a failed first attempt
        self.relayed_tokens = 0
        self.shed_overload = 0      # pressure-gate ELIMIT rejections
        self.shed_tenant = 0        # tenant-budget ELIMIT rejections
        self.resumed_streams = 0    # mid-generation re-dispatches
        self.spliced_streams = 0    # served off a decode worker's cache
        self.splice_rejects = 0     # splice tried, the worker said miss
        self.drain_bounces = 0      # attempts bounced off a draining worker

        self.prefills = _WorkerPool(prefill_addrs or ())
        self.decodes = _WorkerPool(decode_addrs or ())
        self.tenants = cluster.TenantGovernor(default_rate=tenant_rate)
        # Static members default to capacity 1, which would understate an
        # 8-slot worker and shed real traffic: without a registry the gate
        # arms only when a threshold is given.
        if registry is None and shed_batch_pressure is None \
                and shed_standard_pressure is None \
                and shed_interactive_pressure is None:
            self.shed_batch_pressure = float("inf")
            self.shed_standard_pressure = float("inf")
            self.shed_interactive_pressure = float("inf")
        else:
            self.shed_batch_pressure = (
                1.5 if shed_batch_pressure is None else shed_batch_pressure)
            self.shed_standard_pressure = (
                2.5 if shed_standard_pressure is None
                else shed_standard_pressure)
            self.shed_interactive_pressure = (
                4.0 if shed_interactive_pressure is None
                else shed_interactive_pressure)

        self._mu = threading.Lock()
        self._channels = {}
        self._watchers: List[cluster.MembershipWatcher] = []
        self.tier_stats = _TierStats()
        self._lease: Optional[cluster.WorkerLease] = None
        try:
            if registry is not None:
                # A lost control plane flips a pool into static stability
                # (frozen set, local signals); a reconciled watch flips it
                # back, and update_members refreshes the set without
                # dropping work in flight.
                self._watchers = [
                    cluster.MembershipWatcher(
                        registry, role, pool.update_members,
                        on_stale=pool.set_stale)
                    for role, pool in (("prefill", self.prefills),
                                       ("decode", self.decodes))]
                deadline = time.monotonic() + membership_wait_s
                while ((not self.prefills.addrs()
                        or not self.decodes.addrs())
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
            self.server = runtime.Server()
            self.batcher = runtime.NativeBatcher(
                max_batch_size=max_batch_size,
                max_queue_delay_us=max_queue_delay_us,
                max_queue_len=max_queue_len, limiter=limiter)
            self.batcher.add_method(self.server, serving.SERVICE,
                                    serving.METHOD_INTERACTIVE,
                                    runtime.LANE_INTERACTIVE)
            self.batcher.add_method(self.server, serving.SERVICE,
                                    serving.METHOD_BATCH, runtime.LANE_BATCH)
            self.port = self.server.start(port)
            if registry is not None:
                # The router's own lease: its renews carry the per-tier
                # series to the leader's /fleet. The role is outside the
                # prefill/decode pair, so no advice ever flips it.
                self._lease = cluster.WorkerLease(
                    registry, "router", f"127.0.0.1:{self.port}",
                    capacity=max_concurrency, ttl_ms=2000,
                    load_fn=lambda: {"series": self.tier_stats.series()})
        except BaseException:
            # A half-built router is out of close()'s reach.
            for w in self._watchers:
                w.close()
            if self._lease is not None:
                self._lease.close()
            raise
        self._pool = ThreadPoolExecutor(max_workers=max_concurrency,
                                        thread_name_prefix="disagg-router")
        self._running = False
        self._thread = None
        if autostart:
            self.start()

    # ---- plumbing ----------------------------------------------------------

    @property
    def prefill_addrs(self) -> List[str]:
        return self.prefills.addrs()

    @property
    def decode_addrs(self) -> List[str]:
        return self.decodes.addrs()

    def _channel(self, addr: str) -> runtime.Channel:
        with self._mu:
            ch = self._channels.get(addr)
            if ch is None:
                ch = runtime.Channel(
                    addr, timeout_ms=self.worker_timeout_ms,
                    retry_policy=runtime.RetryPolicy(
                        max_retry=2, backoff_base_ms=20, backoff_max_ms=500))
                self._channels[addr] = ch
            return ch

    def _kv_abort(self, decode_addr: str, handle: int) -> None:
        """Best-effort: free a committed transfer nobody will adopt."""
        try:
            runtime.kv_abort(self._channel(decode_addr), handle)
        except Exception:  # noqa: BLE001 — cleanup must never fail a request
            pass

    # ---- serving loop ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="disagg-router-loop")
        self._thread.start()

    def _loop(self) -> None:
        while self._running:
            batch = self.batcher.next_batch(wait_us=100_000)
            if batch is None:
                self._running = False
                return
            for item in batch:
                self._pool.submit(self._serve_guarded, *item)

    def _serve_guarded(self, req_id, payload, prio, remaining_us):
        try:
            self._serve(req_id, payload, prio, remaining_us)
        except Exception as e:  # noqa: BLE001 — one request, loud terminal
            self.batcher.finish(req_id, runtime.EAPP,
                                f"router error: {e}")

    @staticmethod
    def _retriable(code: int) -> bool:
        # Transport failures, shed load and cancelled workers re-route;
        # EREQUEST-class verdicts are final.
        return (code in runtime.RETRIABLE_ERRNOS
                or code in (runtime.ELIMIT, runtime.ECANCELED))

    def _prefill_once(self, addr: str, method: str, req) -> int:
        """One prefill attempt; returns the first token. Raises RpcError on
        any failure (the retriable ones re-route)."""
        rs = self._channel(addr).open_stream_rx(
            PREFILL_SERVICE, method, req)
        try:
            budget_s = self.worker_timeout_ms / 1000.0 + 5.0
            while True:
                try:
                    msg = rs.read(timeout=budget_s)
                except TimeoutError:
                    raise runtime.RpcError(
                        runtime.ENORESPONSE,
                        "prefill stream silent past its budget") from None
                if msg is None:
                    raise runtime.RpcError(
                        runtime.ECLOSE, "prefill worker died mid-request")
                if not msg:
                    continue
                if msg[:1] == b"d":
                    return struct.unpack("<I", msg[1:5])[0]
                if msg[:1] == b"f":
                    status = struct.unpack("<I", msg[1:5])[0]
                    if status == 0:
                        # A clean terminal without the token frame: the 'd'
                        # frame was lost; retriable.
                        raise runtime.RpcError(
                            runtime.ENORESPONSE,
                            "prefill terminal arrived without a token")
                    raise runtime.RpcError(
                        status,
                        msg[5:].decode(errors="replace") or "prefill failed")
        finally:
            rs.close()

    def _shed_check(self, prio: int, tenant: str, cost: float,
                    tier: str = ""):
        """Admission-time degradation, before any dispatch. None admits;
        (errno, text) sheds. The pressure gate runs first, in strict tier
        order (batch, then standard, then interactive; untagged requests
        take their lane's edge tier), so a pressure-shed request debits no
        tenant budget. Both sheds are retriable ELIMIT with a
        retry_after_ms hint."""
        snap = self.decodes.load_snapshot()
        if snap["capacity"] > 0:
            pressure = snap["load"] / snap["capacity"]
            if tier == "standard":
                threshold = self.shed_standard_pressure
            elif tier == "interactive":
                threshold = self.shed_interactive_pressure
            elif tier == "batch":
                threshold = self.shed_batch_pressure
            else:
                threshold = (self.shed_batch_pressure
                             if prio != runtime.LANE_INTERACTIVE
                             else self.shed_interactive_pressure)
            if pressure > threshold:
                self.shed_overload += 1
                retry_ms = max(50, min(int(200 * (pressure - threshold + 1)),
                                       5000))
                return (runtime.ELIMIT,
                        f"cluster overloaded (pressure {pressure:.1f}x); "
                        f"retry_after_ms={retry_ms}")
        ok, retry_ms = self.tenants.charge(tenant, cost)
        if not ok:
            self.shed_tenant += 1
            return (runtime.ELIMIT,
                    f"tenant budget exhausted; retry_after_ms={retry_ms}")
        return None

    def _serve(self, req_id: int, payload: bytes, prio: int,
               remaining_us: int) -> None:
        try:
            prompt, max_new, tenant, tier, model = \
                serving.decode_request_meta(payload)
        except ValueError as e:
            self.batcher.finish(req_id, runtime.EREQUEST, str(e))
            return
        if len(prompt) == 0 or max_new < 1:
            self.batcher.finish(req_id, runtime.EREQUEST,
                                "empty prompt or max_new_tokens < 1")
            return
        if tier not in serving.TIERS:
            tier = ""  # unknown tier tag: untagged
        # Untagged requests take their lane's edge tier for attribution.
        eff_tier = tier or ("batch" if prio == runtime.LANE_BATCH
                            else "interactive")
        runtime.flight_tier(req_id, serving.tier_code(eff_tier))
        shed = self._shed_check(prio, tenant, len(prompt) + max_new,
                                tier=tier)
        if shed is not None:
            self.tier_stats.note_shed(eff_tier)
            self.batcher.finish(req_id, shed[0], shed[1])
            return
        t_admit = time.monotonic()
        deadline = (time.monotonic() + remaining_us / 1e6
                    if remaining_us >= 0 else None)

        def budget_us() -> int:
            if deadline is None:
                return -1
            return int((deadline - time.monotonic()) * 1e6)

        last_err: Optional[runtime.RpcError] = None
        failed_prefills: set = set()
        failed_decodes: set = set()
        # Across attempts: the delivered prefill token (or None) and the
        # decode tokens already relayed, which a resumed attempt
        # suppresses before relaying the tail.
        state = {"first_tok": None, "decode_relayed": 0}
        # Cache affinity: the prompt's first full page names its prefix
        # family; shorter prompts have nothing shareable.
        affinity_key = (kv_cache.prefix_hash(prompt[:self.page_tokens])
                        if self.prefix_affinity
                        and len(prompt) > self.page_tokens else None)
        # Peer tier: the first page's content key, as page digests
        # advertise it.
        page_hex = None
        if self.prefix_splice and len(prompt) > self.page_tokens:
            page_hex = "{:016x}".format(
                kv_cache.page_key(prompt[:self.page_tokens],
                                  self.page_tokens))
        for attempt in range(self.retries + 1):
            if deadline is not None and budget_us() <= 0:
                self.tier_stats.note_error(eff_tier)
                self.batcher.finish(req_id, runtime.ERPCTIMEDOUT,
                                    "budget exhausted while routing")
                return
            if attempt > 0:
                self.re_prefills += 1
            handle = _mint_handle()
            prefill_addr = self.prefills.pick(failed_prefills, model=model)
            decode_addr = self.decodes.pick(failed_decodes,
                                            affinity_key=affinity_key,
                                            model=model)
            if attempt > 0:
                # The re-dispatch phase, with the failed worker and its
                # replacement in the note.
                runtime.flight_stamp(req_id, runtime.FLIGHT_REDISPATCH)
                runtime.flight_route(req_id, runtime.ROUTE_REDISPATCH)
                role = getattr(last_err, "failed_role", "prefill") \
                    if last_err is not None else "prefill"
                prev_p, prev_d = state.get("last_pick", (None, None))
                prev = prev_d if role == "decode" else prev_p
                new = decode_addr if role == "decode" else prefill_addr
                if prev is not None and new is not None:
                    runtime.flight_note(
                        req_id, f"redispatch {role} {prev}->{new}")
            state["last_pick"] = (prefill_addr, decode_addr)
            if prefill_addr is None or decode_addr is None:
                if prefill_addr is not None:
                    self.prefills.note_done(prefill_addr)
                if decode_addr is not None:
                    self.decodes.note_done(decode_addr)
                self.tier_stats.note_error(eff_tier)
                self.batcher.finish(
                    req_id, runtime.EHOSTDOWN,
                    f"no live prefill/decode workers for model "
                    f"'{model}'" if model
                    else "no live prefill/decode workers")
                return
            # Splice when the picked worker's digest claims the prefix, or
            # siblings advertise its pages for a peer pull.
            splice_peers = [a for a in self.decodes.page_holders(
                                page_hex, model=model)
                            if a != decode_addr][:3]
            try_splice = (self.prefix_splice
                          and (self.decodes.holds_prefix(decode_addr,
                                                         affinity_key)
                               or bool(splice_peers)))
            try:
                self._attempt(req_id, handle, prompt, max_new, prio,
                              prefill_addr, decode_addr, budget_us, state,
                              try_splice=try_splice,
                              splice_peers=splice_peers)
                delivered = ((0 if state["first_tok"] is None else 1)
                             + state["decode_relayed"])
                t_first = state.get("t_first")
                self.tier_stats.note_ok(
                    eff_tier,
                    (t_first - t_admit) if t_first is not None else None,
                    delivered)
                return
            except runtime.RpcError as e:
                last_err = e
                if e.code == runtime.ELIMIT and "draining" in e.text:
                    runtime.flight_route(req_id, runtime.ROUTE_DRAIN)
                    self.drain_bounces += 1
                # Blame the phase that failed, and keep the blame across
                # requests (the short-TTL failure score).
                if getattr(e, "failed_role", "prefill") == "decode":
                    failed_decodes.add(decode_addr)
                    self.decodes.note_failure(decode_addr)
                else:
                    failed_prefills.add(prefill_addr)
                    self.prefills.note_failure(prefill_addr)
                if not self._retriable(e.code):
                    self.tier_stats.note_error(eff_tier)
                    self.batcher.finish(req_id, e.code, e.text)
                    return
            finally:
                self.prefills.note_done(prefill_addr)
                self.decodes.note_done(decode_addr)
        err = last_err or runtime.RpcError(runtime.EINTERNAL, "no attempt ran")
        self.tier_stats.note_error(eff_tier)
        self.batcher.finish(req_id, err.code, err.text)

    def _splice_once(self, req_id, prompt, max_new, decode_addr,
                     budget_us, state, peers=()):
        """Serve the request off ``decode_addr``'s prefix cache (no prefill
        RPC, no transfer). True/False as ``_attempt``'s contract, or None
        on the worker's EREJECT (a cache miss: the standard path serves
        the same attempt). Transport errors raise with failed_role
        decode."""
        req = encode_splice_request(budget_us(), prompt, max_new, peers)
        t0 = time.monotonic()
        try:
            rs = self._channel(decode_addr).open_stream_rx(
                DECODE_SERVICE, DECODE_METHOD, req)
        except runtime.RpcError as e:
            e.failed_role = "decode"
            raise
        # Tokens an earlier attempt delivered are re-derived: swallow them.
        suppress = ((0 if state["first_tok"] is None else 1)
                    + state["decode_relayed"])
        if suppress > 0:
            self.resumed_streams += 1
        first_noted = False
        try:
            budget_s = self.worker_timeout_ms / 1000.0 + 5.0
            while True:
                try:
                    msg = rs.read(timeout=budget_s)
                except TimeoutError:
                    raise runtime.RpcError(
                        runtime.ENORESPONSE,
                        "splice stream silent past its budget") from None
                if msg is None:
                    raise runtime.RpcError(
                        runtime.ECLOSE, "decode worker died mid-splice")
                if not msg:
                    continue
                kind = msg[:1]
                if kind == b"d":
                    if not first_noted:
                        self.decodes.note_ttft(decode_addr,
                                               time.monotonic() - t0)
                        first_noted = True
                        runtime.flight_route(req_id, runtime.ROUTE_SPLICE)
                    if suppress > 0:
                        suppress -= 1
                        continue
                    rc = self.batcher.emit(req_id, msg[1:])
                    if rc != 0:
                        return False  # client gone
                    tok = struct.unpack("<I", msg[1:5])[0]
                    if state["first_tok"] is None:
                        state["first_tok"] = tok
                        state.setdefault("t_first", time.monotonic())
                    else:
                        state["decode_relayed"] += 1
                    self.relayed_tokens += 1
                elif kind == b"f":
                    status = struct.unpack("<I", msg[1:5])[0]
                    text = msg[5:].decode(errors="replace")
                    if status == runtime.EREJECT:
                        self.splice_rejects += 1
                        runtime.flight_route(req_id,
                                             runtime.ROUTE_DEGRADED)
                        return None  # cache miss: standard path, same try
                    delivered = (state["first_tok"] is not None
                                 or state["decode_relayed"] > 0)
                    if status != 0 and self._retriable(status) and not (
                            delivered and status == runtime.ERPCTIMEDOUT):
                        raise runtime.RpcError(status, text)
                    self.batcher.finish(req_id, status, text)
                    if status == 0:
                        self.spliced_streams += 1
                    return True
        except runtime.RpcError as e:
            e.failed_role = "decode"
            raise
        finally:
            rs.close()

    def _attempt(self, req_id, handle, prompt, max_new, prio, prefill_addr,
                 decode_addr, budget_us, state, try_splice=False,
                 splice_peers=()) -> bool:
        """One prefill + adopt + relay attempt. True = the request finished
        (terminal sent); False = the client went away. Raises RpcError
        when the attempt failed and a re-dispatch is safe: ``state`` holds
        the tokens already delivered, and a resumed attempt suppresses
        exactly that many. With ``try_splice`` the decode worker's cache
        is offered the request first; a miss falls through."""
        if try_splice:
            done = self._splice_once(req_id, prompt, max_new, decode_addr,
                                     budget_us, state, peers=splice_peers)
            if done is not None:
                return done
        req = encode_prefill_request(handle, budget_us(), prompt, max_new,
                                     decode_addr)
        method = (PREFILL_METHOD if prio == runtime.LANE_INTERACTIVE
                  else PREFILL_METHOD_BATCH)
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_START)
        runtime.flight_route(req_id, runtime.ROUTE_DISAGG)
        t0 = time.monotonic()
        try:
            first_tok = self._prefill_once(prefill_addr, method, req)
        except runtime.RpcError as e:
            # A prefill that failed sending its pages is the destination's
            # failure (the worker marks it "kv transfer failed:"): blame
            # decode, so the retry avoids the dead destination.
            e.failed_role = ("decode" if e.text.startswith("kv transfer "
                                                           "failed")
                             else "prefill")
            raise
        self.prefills.note_ttft(prefill_addr, time.monotonic() - t0)
        # The prefill worker commits the transfer before answering.
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_DONE)
        runtime.flight_stamp(req_id, runtime.FLIGHT_KV_TRANSFER)

        if state["first_tok"] is None:
            rc = self.batcher.emit(req_id, struct.pack("<I", first_tok))
            if rc != 0:
                self._kv_abort(decode_addr, handle)  # client gone
                return False
            state["first_tok"] = first_tok
            state.setdefault("t_first", time.monotonic())
            self.relayed_tokens += 1
        left = max_new - 1
        if left <= 0:
            self.batcher.finish(req_id, 0, "")
            self._kv_abort(decode_addr, handle)  # nothing will adopt it
            return True

        adopt = encode_adopt_request(handle, budget_us(), prompt,
                                     first_tok, left)
        try:
            rs = self._channel(decode_addr).open_stream_rx(
                DECODE_SERVICE, DECODE_METHOD, adopt)
        except runtime.RpcError as e:
            e.failed_role = "decode"
            self._kv_abort(decode_addr, handle)
            raise
        # Tokens a previous attempt relayed are re-derived: swallow them.
        suppress = state["decode_relayed"]
        if suppress > 0:
            self.resumed_streams += 1
        relayed_any = suppress > 0
        try:
            budget_s = self.worker_timeout_ms / 1000.0 + 5.0
            while True:
                try:
                    msg = rs.read(timeout=budget_s)
                except TimeoutError:
                    raise runtime.RpcError(
                        runtime.ENORESPONSE,
                        "decode stream silent past its budget") from None
                if msg is None:
                    raise runtime.RpcError(
                        runtime.ECLOSE, "decode worker died mid-stream")
                if not msg:
                    continue
                kind = msg[:1]
                if kind == b"d":
                    if suppress > 0:
                        suppress -= 1
                        continue
                    rc = self.batcher.emit(req_id, msg[1:])
                    if rc != 0:
                        return False  # client gone; decode reclaims
                    relayed_any = True
                    state["decode_relayed"] += 1
                    self.relayed_tokens += 1
                elif kind == b"f":
                    status = struct.unpack("<I", msg[1:5])[0]
                    text = msg[5:].decode(errors="replace")
                    # A retriable terminal re-dispatches, except a deadline
                    # cut mid generation: the budget is the request's.
                    if status != 0 and self._retriable(status) and not (
                            relayed_any
                            and status == runtime.ERPCTIMEDOUT):
                        raise runtime.RpcError(status, text)
                    self.batcher.finish(req_id, status, text)
                    return True
        except runtime.RpcError as e:
            e.failed_role = "decode"
            self._kv_abort(decode_addr, handle)  # best-effort cleanup
            raise
        finally:
            rs.close()

    # ---- telemetry / teardown ---------------------------------------------

    def stats(self) -> dict:
        s = self.batcher.stats()
        s.update(re_prefills=self.re_prefills,
                 relayed_tokens=self.relayed_tokens,
                 shed_overload=self.shed_overload,
                 shed_tenant=self.shed_tenant,
                 resumed_streams=self.resumed_streams,
                 spliced_streams=self.spliced_streams,
                 splice_rejects=self.splice_rejects,
                 drain_bounces=self.drain_bounces,
                 warming_skips=(self.prefills.warming_skips
                                + self.decodes.warming_skips),
                 affinity_picks=self.decodes.affinity_picks,
                 prefill_workers=len(self.prefills.addrs()),
                 decode_workers=len(self.decodes.addrs()),
                 # Serving on the frozen member set (static stability);
                 # reconnects grow by backoff steps during an outage.
                 registry_stale=int(self.prefills.stale
                                    or self.decodes.stale),
                 watch_reconnects=sum(w.reconnects
                                      for w in self._watchers),
                 tiers=self.tier_stats.snapshot())
        return s

    def close(self) -> None:
        self._running = False
        if self._lease is not None:
            self._lease.close()
            self._lease = None
        for w in self._watchers:
            w.close()
        self._watchers = []
        self.server.stop()
        self.batcher.stop()
        if not serving.join_loop(self._thread, type(self).__name__):
            return
        self._thread = None
        self._pool.shutdown(wait=True, cancel_futures=True)
        self.batcher.close()
        self.server.close()
        with self._mu:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- worker processes: the TPS1 cold start, the runner, the cluster -------------

_WORKER_SRC = """
import sys
from brpc_tpu_torch import disagg
disagg._worker_main(sys.argv[1:])
"""

# The deadline of one call of a weight fetch: a range, or a whole blob (up
# to param_server.MAX_BLOB_BYTES) from a server without ranges.
FETCH_TIMEOUT_MS = 600_000
# From a worker's spawn to its READY line: the interpreter, torch, the
# device and the weight fetch (about 50 s for Llama-3-8B on an H100 host).
READY_TIMEOUT_S = 600.0


def _model_cfg(cfg_name: str) -> transformer.TransformerConfig:
    """Named model shape -> TransformerConfig (a model id's part before
    any '.' names one of these). ``llama3_8b`` is the port's own name; an
    unknown name takes the default config. ``BRPC_TPU_F32`` in the
    environment switches the dtype to f32."""
    TC = transformer.TransformerConfig
    if cfg_name == "tiny":
        cfg = TC.tiny()
    elif cfg_name == "mid":
        # The bench's serving shape: tiny widths but a 256-position window,
        # so long prompts have a genuinely expensive prefill bucket.
        cfg = TC(vocab=256, d_model=128, n_layers=2, n_heads=4,
                 n_kv_heads=4, d_ff=256, max_seq=256)
    elif cfg_name == "deep":
        # The prefix/flip bench shape: deep enough that a full-prompt
        # prefill clearly dominates TTFT over the fixed RPC/queue overhead.
        cfg = TC(vocab=256, d_model=256, n_layers=4, n_heads=4,
                 n_kv_heads=4, d_ff=512, max_seq=256)
    elif cfg_name == "llama3_8b":
        cfg = TC.llama3_8b()
    else:
        cfg = TC()
    if os.environ.get("BRPC_TPU_F32"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg


def _flatten_params(params: dict, prefix: str = "") -> Dict[str, object]:
    """Params tree -> flat {'a/b': leaf} dict, the shape the TPS1 codec
    speaks. Torch tensors stay tensors; other leaves become numpy arrays."""
    flat: Dict[str, object] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update(_flatten_params(v, prefix + k + "/"))
        else:
            flat[prefix + k] = (v if isinstance(v, torch.Tensor)
                                else np.asarray(v))
    return flat


def _unflatten_params(flat: Dict[str, object]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _parse_param_map(spec: str) -> Dict[str, str]:
    """``--params`` -> {model id: "addr1+addr2+..."}: a model's weights in
    one ParamServer per group (``param_server.groups``)."""
    out = {}
    for tok in spec.split(","):
        if "=" in tok:
            name, addrs = tok.split("=", 1)
            out[name] = addrs
    return out


def _land(a, device: torch.device) -> torch.Tensor:
    """A decoded blob entry (a read-only view) -> a tensor of its own on
    ``device``."""
    if not isinstance(a, torch.Tensor):
        with warnings.catch_warnings():
            # Read-only memory: torch warns that it cannot guard writes;
            # the copy below is what is kept.
            warnings.simplefilter("ignore", UserWarning)
            a = torch.from_numpy(a)
    return a.to(device, copy=True)


# The hot windowed metrics a worker's heartbeat window-tail delta carries
# to the registry leader (the /fleet history and federated /metrics
# source): the current windowed readings.
SERIES_METRICS = (
    "serving_ttft_us_latency_p50", "serving_ttft_us_latency_p99",
    "serving_ttft_us_qps", "serving_queue_wait_us_latency_p99",
    "serving_prefill_us_latency_p99", "serving_queue_depth",
    "serving_batch_occupancy_latency", "serving_culled_requests",
    "serving_shed_requests",
    "kv_tier_fill_us_latency_p99", "kv_tier_host_pages", "kv_tier_spills",
    # Transport health: bytes moved, summed EWMA egress MB/s and credit
    # stalls.
    "coll_link_bytes", "coll_link_tx_mbps", "coll_link_credit_stalls",
)


def series_tail(metric_values: dict) -> str:
    """Render the 'sr=' heartbeat token ("name:val|name:val") from a
    runtime.metrics() snapshot."""
    toks = []
    for k in SERIES_METRICS:
        v = metric_values.get(k)
        if v is not None:
            toks.append(f"{k}:{v:g}")
    return "|".join(toks)


def _worker_load_fn(worker, model: str = ""):
    """Live load of a worker for a lease's heartbeat (ROADMAP A 4b):
    batcher queue depth, paged-pool occupancy, mean batch occupancy, the
    local p99 TTFT, the prefix and page digests, the windowed-series tail,
    the model tag and the drain state."""
    def load() -> dict:
        s = worker.batcher.stats()
        occ = (s["occupancy_sum"] * 100 // s["occupancy_samples"]
               if s["occupancy_samples"] else 0)
        kv = 0
        pool = getattr(worker, "pool", None)
        if pool is not None:
            kv = int(pool.stats().get("live_blocks", 0))
        ttft = 0
        series = ""
        try:
            m = runtime.metrics()
            ttft = int(m.get("serving_ttft_us_latency_p99", 0))
            series = series_tail(m)
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass
        digest = ""
        page_digest = ""
        prefix = getattr(worker, "prefix", None)
        if prefix is not None:
            digest = prefix.digest()
            page_digest = prefix.page_digest()
        return {"queue_depth": int(s["queue_depth"]), "kv_pages_in_use": kv,
                "occupancy_x100": int(occ), "p99_ttft_us": ttft,
                "prefix_digest": digest, "page_digest": page_digest,
                "series": series, "model": model,
                "state": "drain" if getattr(worker, "draining", False)
                         else ""}
    return load


class _WorkerFactory:
    """Role -> worker constructor for one worker process, holding the
    model it builds workers for: ``params`` (on ``device``), ``cfg`` and
    ``model_id``. ``load`` pulls a model's weights over the TPS1 wire from
    its ParamServer group(s) in ``param_addrs`` (model id -> "a+b+...");
    the worker's cold start and ``retarget`` both go through it.
    ``apply_adapter`` adds a small pulled delta onto the current weights.
    ``port`` lets a flip or retarget rebuild on the same port. Calling the
    factory returns (worker, default capacity).

    Flags read from ``args`` (the worker's argv): ``--page-tokens``;
    prefill ``--chunk-bytes``, ``--kv-timeout``, ``--limiter``,
    ``--layerwise``, ``--max-prompt``; decode ``--batch``, ``--slots``;
    ``--kv-blocks`` sizes both roles' pools (the reference sizes only the
    decode worker's); ``--layers`` cuts every config's depth."""

    def __init__(self, args: dict, params, cfg, model_id: str = "",
                 param_addrs: Optional[Dict[str, str]] = None, device=None):
        self.args = args
        self.params = params
        self.cfg = cfg
        self.model_id = model_id
        self.param_addrs = dict(param_addrs or {})
        self.device = resolve_device(device)
        self.fetch_wire_bytes = 0       # TPS1 blob bytes over the wire
        self.fetch_effective_bytes = 0  # sum of decoded array nbytes

    def __call__(self, role: str, port: int = 0):
        args = self.args
        page = int(args.get("--page-tokens", "16"))
        kv_blocks = int(args.get("--kv-blocks", "0")) or None
        if role == "prefill":
            lw = int(args.get("--layerwise", "-1"))
            worker = PrefillWorker(
                self.params, self.cfg, kv_page_tokens=page,
                kv_chunk_bytes=int(args.get("--chunk-bytes", "-1")),
                kv_timeout_ms=int(args.get("--kv-timeout", "20000")),
                limiter=args.get("--limiter", "auto"),
                layerwise=None if lw < 0 else bool(lw),
                max_prompt=int(args.get("--max-prompt", "0")) or None,
                kv_blocks=kv_blocks, port=port, device=self.device)
            return worker, 4
        if role == "decode":
            worker = DecodeWorker(
                self.params, self.cfg, kv_page_tokens=page,
                max_batch_size=int(args.get("--batch", "8")),
                slots=int(args.get("--slots", "8")),
                kv_blocks=kv_blocks, port=port, device=self.device)
            return worker, worker.slots
        raise ValueError(f"unknown role {role!r}")

    def config(self, cfg_name: str) -> transformer.TransformerConfig:
        """``_model_cfg(cfg_name)``, its depth cut to ``--layers``."""
        cfg = _model_cfg(cfg_name)
        layers = int(self.args.get("--layers", "0"))
        return dataclasses.replace(cfg, n_layers=layers) if layers else cfg

    def _pull(self, model_id: str) -> Dict[str, torch.Tensor]:
        """Every group of ``model_id``'s weights (``pull_blob``: ranges
        over several connections), each landed on the device before the
        next is fetched, merged into one flat dict."""
        spec = self.param_addrs.get(model_id)
        if not spec:
            raise ValueError(f"no param server for model {model_id!r}")
        t0 = time.monotonic()
        flat: Dict[str, torch.Tensor] = {}
        addrs = spec.split("+")
        for addr in addrs:
            client = param_server.ParamClient(addr, retries=4,
                                              timeout_ms=FETCH_TIMEOUT_MS)
            try:
                blob = client.pull_blob()
            finally:
                client.close()
            effective = self._land_blob(blob, flat)
            self.fetch_wire_bytes += len(blob)
            self.fetch_effective_bytes += effective
            runtime.app_counter_add("cluster_model_fetch_wire_bytes",
                                    len(blob))
            runtime.app_counter_add("cluster_model_fetch_effective_bytes",
                                    effective)
            del blob
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        runtime.app_counter_add("cluster_model_fetch_us",
                                int((time.monotonic() - t0) * 1e6))
        runtime.app_counter_add("cluster_model_fetch_groups", len(addrs))
        return flat

    def _land_blob(self, blob, flat: dict) -> int:
        """Every array of a TPS1 blob, landed on the device into ``flat``;
        returns their bytes. The blob's views die with this call."""
        arrays = param_server.decode_arrays(blob, copy=False)
        flat.update((k, _land(v, self.device)) for k, v in arrays.items())
        return sum(v.numel() * v.element_size()
                   if isinstance(v, torch.Tensor) else int(v.nbytes)
                   for v in arrays.values())

    def load(self, model_id: str, cfg) -> None:
        """Pull ``model_id``'s full weights and install them, with
        ``cfg``, as the build state. Pulls before touching the current
        state: a failed fetch leaves the factory on the old model."""
        flat = self._pull(model_id)
        self.params = transformer.params_from_numpy(
            _unflatten_params(flat), cfg, self.device)
        self.cfg = cfg
        self.model_id = model_id

    def retarget(self, model_id: str) -> None:
        """Cold-start weight fetch of another model; its id's part before
        any '.' names its config."""
        self.load(model_id, self.config(model_id.split(".", 1)[0]))
        runtime.app_counter_add("cluster_model_retargets", 1)

    def apply_adapter(self, adapter_id: str) -> None:
        """LoRA-style adapter swap: pull a small delta dict (flat keys, a
        subset of the model's) and add it, in f32, onto the current
        weights. The model id grows a '.adapter' suffix."""
        delta = self._pull(adapter_id)
        flat = _flatten_params(self.params)
        for k, v in delta.items():
            if k not in flat:
                raise ValueError(f"adapter key {k!r} not in model")
            p = flat[k]
            flat[k] = (p.float() + v.float()).to(p.dtype)
        self.params = _unflatten_params(flat)
        base = self.model_id.split(".", 1)[0] or "base"
        self.model_id = f"{base}.{adapter_id}"
        runtime.app_counter_add("cluster_model_adapter_swaps", 1)


def _make_worker_factory(args: dict, params, cfg, model_id: str = "",
                         param_addrs: Optional[Dict[str, str]] = None,
                         device=None) -> _WorkerFactory:
    return _WorkerFactory(args, params, cfg, model_id=model_id,
                          param_addrs=param_addrs, device=device)


class WorkerRunner:
    """The drain state machine and the role-flip / retarget / retire
    executor around one worker.

    States (``state``):
      active    serving normally
      draining  admissions shed (retriable ELIMIT with a live ETA);
                in-flight work runs to completion (stragglers past the
                drain timeout are cut with a retriable error, and the
                router re-dispatches them byte-exactly)
      spilling  resident prefix pages spill to the host tier and the
                covered token chains are snapshotted
      flipping  the worker is rebuilt under the new role (or model) on
                the same port, the host chains are grafted into its fresh
                index (``admit_host``), and the lease re-registers under
                the new role (replace by address: one atomic change for
                subscribers; hb=0 holds router traffic until the first
                heartbeat of the new role)
      active    again, or ``retired`` (drained, the lease left; the
                process exits).

    Ops arrive over the Admin RPC face, or with ``accept_advice`` from
    the registry's role advice, and run one at a time on an executor
    thread. The Admin server is apart from the worker's data server, so
    its port (``admin=`` in the READY line) survives flips.

    With ``registry_addr`` the runner holds the worker's lease there
    (``capacity`` 0 takes the worker's default: a decode worker's slots,
    4 for a prefill worker), renewed every ``ttl_ms / 3`` with the live
    load of ``_load``."""

    DRAIN_TIMEOUT_S = 60.0

    def __init__(self, role: str, make_worker, *,
                 registry_addr: Optional[str] = None, capacity: int = 0,
                 ttl_ms: int = 2000, accept_advice: bool = False,
                 drain_timeout_s: float = DRAIN_TIMEOUT_S):
        import queue

        self.role = role
        self.make_worker = make_worker
        self.capacity = capacity
        self.accept_advice = accept_advice
        self.drain_timeout_s = drain_timeout_s
        self.state = "active"
        self.flips = 0
        self.retired = False
        self.spilled_pages = 0
        self.grafted_chains = 0
        self.worker, default_cap = make_worker(role)
        self.retargets = 0  # model retargets + adapter swaps executed
        self.lease: Optional[cluster.WorkerLease] = None
        self._ops: "queue.Queue" = queue.Queue()
        self.stopped = threading.Event()
        self._exec = threading.Thread(target=self._run_ops, daemon=True,
                                      name="worker-runner")
        self._exec.start()
        self.admin = runtime.Server()
        for name in ("flip", "retire", "drain", "undrain", "status",
                     "retarget", "adapter"):
            self.admin.add_method("Admin", name,
                                  getattr(self, f"_rpc_{name}"))
        self.admin_port = self.admin.start(0)
        if registry_addr:
            try:
                self.lease = cluster.WorkerLease(
                    registry_addr, role, f"127.0.0.1:{self.worker.port}",
                    capacity=capacity or default_cap, ttl_ms=ttl_ms,
                    load_fn=self._load,
                    on_advice=self._on_advice if accept_advice else None)
            except BaseException:  # no lease: nothing may keep serving
                self.close()
                raise

    # ---- heartbeat plumbing ------------------------------------------------

    def _load(self) -> dict:
        """The lease's load_fn. Mid flip, while the old worker is closed
        and its successor is being built, the heartbeat goes on with
        st=drain and no load sample: the lease must not lapse."""
        model = getattr(self.make_worker, "model_id", "")
        try:
            return _worker_load_fn(self.worker, model)()
        except Exception:  # noqa: BLE001 — mid-swap: report drain, renew
            return {"state": "drain", "model": model}

    def _on_advice(self, advice_role: str) -> None:
        """Registry role advice (on the lease's renew thread, once per
        suggestion): schedule the flip."""
        if advice_role and advice_role != self.role:
            self.request_flip(advice_role)

    # ---- admin RPC face ----------------------------------------------------

    def _rpc_flip(self, req: bytes) -> bytes:
        role = req.decode().strip()
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role == self.role and self.state == "active":
            return b"noop"
        self.request_flip(role)
        return b"ok"

    def _rpc_retire(self, req: bytes) -> bytes:
        self.request_retire()
        return b"ok"

    def _rpc_drain(self, req: bytes) -> bytes:
        self.worker.begin_drain(req.decode().strip() or "drain")
        if self.state == "active":
            self.state = "draining"  # status must not claim health
        return b"ok"

    def _rpc_undrain(self, req: bytes) -> bytes:
        """Reverse an operator Admin.drain (a flip or retire mid-execution
        is not reversible)."""
        if self.state not in ("active", "draining"):
            raise ValueError(f"cannot undrain mid-{self.state}")
        w = self.worker
        w.draining = False
        w.drain_reason = ""
        self.state = "active"
        return b"ok"

    def _rpc_retarget(self, req: bytes) -> bytes:
        """Model retarget: pull the named model's weights, drain, rebuild
        on the same port."""
        model = req.decode().strip()
        if not model:
            raise ValueError("empty model id")
        if model == getattr(self.make_worker, "model_id", "") \
                and self.state == "active":
            return b"noop"
        self._ops.put(("retarget", model))
        return b"ok"

    def _rpc_adapter(self, req: bytes) -> bytes:
        """Adapter swap: pull the small delta, apply it, rebuild."""
        adapter = req.decode().strip()
        if not adapter:
            raise ValueError("empty adapter id")
        self._ops.put(("adapter", adapter))
        return b"ok"

    def _rpc_status(self, req: bytes) -> bytes:
        w = self.worker
        try:
            active = w.in_flight() if hasattr(w, "in_flight") \
                else w._inflight_handles
        except Exception:  # noqa: BLE001 — mid-swap
            active = -1
        return (f"role={self.role} state={self.state} active={active} "
                f"flips={self.flips} sheds={getattr(w, 'drain_sheds', 0)} "
                f"spilled={self.spilled_pages} "
                f"grafted={self.grafted_chains} "
                f"retargets={self.retargets} "
                f"model={getattr(self.make_worker, 'model_id', '') or '-'}"
                ).encode()

    # ---- op execution ------------------------------------------------------

    def request_flip(self, role: str) -> None:
        self._ops.put(("flip", role))

    def request_retire(self) -> None:
        self._ops.put(("retire", ""))

    def _run_ops(self) -> None:
        while True:
            op = self._ops.get()
            if op is None:
                return
            kind, arg = op
            try:
                if kind == "flip":
                    self._do_flip(arg)
                elif kind in ("retarget", "adapter"):
                    self._do_retarget(arg, adapter=(kind == "adapter"))
                elif kind == "retire":
                    self._do_retire()
                    return
            except Exception:  # noqa: BLE001 — a failed op must not kill
                traceback.print_exc()  # the executor
                w = self.worker
                if getattr(w, "_running", False):
                    # Still serving (the op failed before teardown): a
                    # healthy worker must not shed forever.
                    w.draining = False
                    w.drain_reason = ""
                    self.state = "active"
                else:
                    self.state = "failed"

    def _rebuild(self, role: str) -> int:
        """Close the drained worker and build its successor on the same
        port (a new port, and the lease's address with it, if that one
        cannot be bound again); returns the successor's default
        capacity."""
        w = self.worker
        port = w.port
        w.close()  # stragglers get a retriable error -> re-dispatch
        try:
            self.worker, default_cap = self.make_worker(role, port)
        except OSError:
            self.worker, default_cap = self.make_worker(role, 0)
            if self.lease is not None:
                self.lease.addr = f"127.0.0.1:{self.worker.port}"
        return default_cap

    def _reregister(self, role: str, default_cap: int) -> None:
        """The lease's last step of a flip or retarget: the successor's
        capacity, re-registered under ``role`` (hb=0 again)."""
        if self.lease is None:
            return
        self.lease.capacity = self.capacity or default_cap
        try:
            self.lease.set_role(role)
        except Exception:  # noqa: BLE001 — registry briefly down: the
            traceback.print_exc()  # renew loop re-registers anyway

    def _do_flip(self, new_role: str) -> None:
        if new_role == self.role or self.retired:
            return
        w = self.worker
        self.state = "draining"
        w.begin_drain(f"flip:{new_role}")
        w.drain_wait(self.drain_timeout_s)
        # The hot prefix set survives the flip: resident pages spill to
        # the process-wide host store, which outlives the worker object.
        self.state = "spilling"
        chains = []
        prefix = getattr(w, "prefix", None)
        if prefix is not None and getattr(prefix, "host_tier", False):
            self.spilled_pages += prefix.spill()
            chains = prefix.export_chains()
        self.state = "flipping"
        default_cap = self._rebuild(new_role)
        try:
            new_prefix = getattr(self.worker, "prefix", None)
            if chains and new_prefix is not None \
                    and getattr(new_prefix, "host_tier", False):
                for ch in chains:
                    new_prefix.admit_host(ch, len(ch))
                new_prefix.sync_native()
                self.grafted_chains += len(chains)
        except Exception:  # noqa: BLE001 — a failed graft just means the
            traceback.print_exc()  # hot prefix re-prefills
        self.role = new_role
        self.flips += 1
        runtime.app_counter_add("serving_role_flips", 1)
        self._reregister(new_role, default_cap)
        self.state = "active"

    def _do_retarget(self, model_id: str, adapter: bool = False) -> None:
        """A flip with the role held and the weights swapped, without the
        spill and graft: the resident pages hold the old model's KV."""
        if self.retired:
            return
        f = self.make_worker
        # Fetch first, while the old model still serves: a failed pull
        # leaves this worker active on its current weights.
        if adapter:
            f.apply_adapter(model_id)
        else:
            f.retarget(model_id)
        self.state = "draining"
        self.worker.begin_drain(f"retarget:{f.model_id}")
        self.worker.drain_wait(self.drain_timeout_s)
        self.state = "flipping"
        default_cap = self._rebuild(self.role)
        self.retargets += 1
        runtime.app_counter_add("serving_model_flips", 1)
        # Same role: the first heartbeat after hb=0 carries the new md=.
        self._reregister(self.role, default_cap)
        self.state = "active"

    def _do_retire(self) -> None:
        """Drain, leave the lease (routers stop picking at once, with no
        TTL wait), then exit: new admissions bounce retriably, in-flight
        generations run out."""
        self.retired = True
        self.state = "draining"
        self.worker.begin_drain("retire")
        if self.lease is not None:
            self.lease.close()
            self.lease = None
        self.worker.drain_wait(self.drain_timeout_s)
        self.state = "retired"
        self.stopped.set()

    # ---- teardown ----------------------------------------------------------

    def close(self) -> None:
        self._ops.put(None)
        if self.lease is not None:
            self.lease.close()
            self.lease = None
        self.admin.stop()
        self.admin.close()
        self.worker.close()
        self.stopped.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _worker_main(argv: List[str]) -> None:
    """Subprocess entry: --role prefill|decode --cfg NAME --model ID
    --params ID=ADDR[+ADDR...][,ID2=...] [--device cpu]
    [--page-tokens N] [--chunk-bytes N] [--kv-timeout MS] [--limiter SPEC]
    [--layerwise 0|1] [--max-prompt N] [--batch N] [--slots N]
    [--kv-blocks N] [--kv-pool PAGE_BYTES:MAX_PAGES] [--layers N]
    [--registry ADDR[,ADDR...] [--capacity N] [--ttl MS]
     [--accept-advice 0|1]].

    Pulls the weights of ``--model`` (id "" for a cluster's one unnamed
    model) from its ParamServer group(s), builds the worker on ``cuda``
    (``--device cpu`` for tests), prints "READY <port> admin=<port>" and
    serves until stdin closes or an Admin.retire drains it out. Any
    failure before that (no weights source, no card, a failed pull, a
    registry that takes no lease) prints "FAILED <reason>" instead and
    exits 1; nothing falls back to a local random init or to the CPU.

    With ``--registry`` the worker holds a lease there, registered after
    the weights have landed; a SIGKILL leaves it to expire, which is how
    the fleet learns. With ``--accept-advice 1`` the registry's role
    advice is acted on: drain, spill, rebuild under the advised role on
    the same port, re-register."""
    args = dict(zip(argv[::2], argv[1::2]))
    try:
        role = args.get("--role", "decode")
        model_id = args.get("--model", "")
        factory = _make_worker_factory(
            args, None, None, model_id=model_id,
            param_addrs=_parse_param_map(args.get("--params", "")),
            device=args.get("--device") or None)
        cfg = factory.config(args.get("--cfg")
                             or (model_id.split(".", 1)[0] or "tiny"))
        if cfg.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
        if args.get("--kv-pool"):
            page_bytes, max_pages = args["--kv-pool"].split(":")
            runtime.kv_pool_configure(int(page_bytes), int(max_pages))
        factory.load(model_id, cfg)
        runner = WorkerRunner(
            role, factory, registry_addr=args.get("--registry") or None,
            capacity=int(args.get("--capacity", "0")),
            ttl_ms=int(args.get("--ttl", "2000")),
            accept_advice=bool(int(args.get("--accept-advice", "0"))))
    except Exception as e:  # noqa: BLE001 — reported on the READY line
        traceback.print_exc()
        print(f"FAILED {type(e).__name__}: {e}", flush=True)
        raise SystemExit(1)
    print(f"READY {runner.worker.port} admin={runner.admin_port}",
          flush=True)

    def stdin_watch():
        try:
            while sys.stdin.read(1):
                pass
        except Exception:  # noqa: BLE001 — pipe torn down
            pass
        runner.stopped.set()

    threading.Thread(target=stdin_watch, daemon=True,
                     name="stdin-watch").start()
    try:
        runner.stopped.wait()
    except KeyboardInterrupt:
        pass
    runner.close()


def _reap(p: subprocess.Popen) -> None:
    """Kill a worker process (if it still runs), wait for it and close its
    pipes."""
    try:
        p.kill()
        p.wait(timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        pass  # teardown is best-effort
    for f in (p.stdin, p.stdout):
        f.close()


# ---- the closed loop: fleet telemetry, autoscaler, model-mix advisor ----------

def fetch_fleet(registry_addr: str, span_s: int = 60,
                timeout_s: float = 3.0) -> Optional[dict]:
    """The registry leader's /fleet?format=json aggregates (qps-weighted
    TTFT p50/p99, fleet queue depth, mean occupancy, per-member series).
    ``registry_addr`` may name several replicas: the first that answers
    with leader:true wins (a follower's /fleet is not the fleet's). None
    when no leader answers."""
    import json
    import urllib.request

    for addr in registry_addr.split(","):
        addr = addr.strip()
        if not addr:
            continue
        try:
            body = urllib.request.urlopen(
                f"http://{addr}/fleet?format=json&window_s={span_s}",
                timeout=timeout_s).read().decode()
            doc = json.loads(body)
        except Exception:  # noqa: BLE001 — replica down: try the next
            continue
        if doc.get("leader"):
            return doc
    return None


class Autoscaler:
    """The fleet controller of the closed loop: reads the registry's live
    membership of ``role`` and the leader's /fleet aggregates, and spawns
    (``spawn_fn(role)``) or retires (``retire_fn(addr)``, through the
    worker's drain state machine, so scale-down sheds nothing) workers.

      - Replacement: below ``min_workers`` live (a worker died and was
        expelled) it spawns at once, guarded only by the cooldown.
      - Scale up: ``confirm`` consecutive hot polls (TTFT p99 over
        ``scale_up_p99_ms`` or queue pressure over ``scale_up_pressure``)
        and an expired ``up_cooldown_s``.
      - Scale down: idle (pressure under ``scale_down_pressure``, TTFT
        healthy) for ``scale_down_idle_s`` without a break, and
        ``down_cooldown_s``; the least-loaded retirable worker goes.
      - Never below ``min_workers`` or above ``max_workers``.

    With ``lead_time_s`` > 0 the pressure is evaluated where the qps
    trend (a least-squares slope over recent polls) puts it
    ``lead_time_s`` ahead, so a rising edge spawns before the queue
    builds. ``trace`` holds (t, workers, qps, ttft_p99_us) per poll and
    ``actions`` (t, "up"/"replace"/"down", addr) per action."""

    def __init__(self, registry_addr: str, spawn_fn, retire_fn=None, *,
                 role: str = "decode",
                 scale_up_p99_ms: float = 250.0,
                 scale_up_pressure: float = 1.25,
                 scale_down_pressure: float = 0.5,
                 scale_down_idle_s: float = 6.0,
                 up_cooldown_s: float = 4.0, down_cooldown_s: float = 8.0,
                 min_workers: int = 1, max_workers: int = 8,
                 confirm: int = 2, lead_time_s: float = 0.0,
                 poll_s: float = 0.5, autostart: bool = True):
        self.registry_addr = registry_addr
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.role = role
        self.scale_up_p99_ms = scale_up_p99_ms
        self.scale_up_pressure = scale_up_pressure
        self.scale_down_pressure = scale_down_pressure
        self.scale_down_idle_s = scale_down_idle_s
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.confirm = confirm
        self.lead_time_s = lead_time_s
        self.poll_s = poll_s
        self.scale_ups = 0
        self.scale_downs = 0
        self.trace: deque = deque(maxlen=8192)   # (t, n, qps, ttft_p99_us)
        self.actions: deque = deque(maxlen=1024)  # (t, kind, addr)
        self._qps_hist: deque = deque(maxlen=32)  # (t, qps) slope window
        self._hot_polls = 0
        self._idle_since: Optional[float] = None
        self._cooldown_until = 0.0
        # Workers whose retire failed for good: never picked again, or an
        # idle fleet would pick the same phantom every window.
        self._unretirable: set = set()
        self._eps = cluster._Endpoints(registry_addr, timeout_ms=2000)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # ---- sensors -----------------------------------------------------------

    def _members(self) -> List[cluster.Member]:
        body = self._eps.call("list", self.role.encode(),
                              wait=self._stop.wait).decode()
        return cluster.parse_members(body)[1]

    def _qps_slope(self) -> float:
        """Least-squares slope (qps per second) over the sample window."""
        pts = list(self._qps_hist)
        if len(pts) < 3 or pts[-1][0] - pts[0][0] < 1.0:
            return 0.0
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [q for _, q in pts]
        n = len(pts)
        mx, my = sum(xs) / n, sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return 0.0
        return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den

    # ---- one control decision ---------------------------------------------

    def _act_up(self, now: float, kind: str) -> str:
        addr = self.spawn_fn(self.role)
        self.scale_ups += 1
        self.actions.append((now, kind, addr))
        self._cooldown_until = now + self.up_cooldown_s
        return "up"

    def poll_once(self) -> Optional[str]:
        """One sense -> decide -> act pass: "up" or "down" when an action
        fired, else None."""
        now = time.monotonic()
        try:
            members = self._members()
        except Exception:  # noqa: BLE001 — control plane down: never
            return None    # scale blind
        live = [m for m in members if not m.draining]
        n = len(live)
        pressure = (sum(m.queue_depth for m in live)
                    / max(sum(max(m.capacity, 1) for m in live), 1))
        fleet = fetch_fleet(self.registry_addr, span_s=5) or {}
        agg = fleet.get("aggregate", {})
        qps = float(agg.get("qps", 0.0))
        ttft_p99_us = float(agg.get("ttft_p99_us", 0.0))
        self._qps_hist.append((now, qps))
        self.trace.append((now, n, qps, ttft_p99_us))

        # Predictive lead: the pressure scaled by the projected qps ratio,
        # capped, and only on a real qps base (a trough's near-zero qps
        # would amplify one queued request into a hot poll).
        eff_pressure = pressure
        if self.lead_time_s > 0 and qps >= 0.5:
            projected = max(qps + self._qps_slope() * self.lead_time_s,
                            0.0)
            eff_pressure = pressure * min(projected / qps, 3.0)

        if n < self.min_workers and n < self.max_workers:
            # Replacement: below the floor, no confirm streak; only the
            # cooldown guards a crash loop.
            if now >= self._cooldown_until:
                return self._act_up(now, "replace")
            return None

        hot = (eff_pressure > self.scale_up_pressure
               or (ttft_p99_us > 0
                   and ttft_p99_us > self.scale_up_p99_ms * 1000))
        idle = (pressure < self.scale_down_pressure
                and (ttft_p99_us <= 0
                     or ttft_p99_us <= self.scale_up_p99_ms * 1000))
        if hot:
            self._hot_polls += 1
            self._idle_since = None
        else:
            self._hot_polls = 0
            if idle and self._idle_since is None:
                self._idle_since = now
            elif not idle:
                self._idle_since = None

        if (hot and self._hot_polls >= self.confirm
                and now >= self._cooldown_until and n < self.max_workers):
            action = self._act_up(now, "up")
            self._hot_polls = 0
            return action
        if (self.retire_fn is not None and self._idle_since is not None
                and now - self._idle_since >= self.scale_down_idle_s
                and now >= self._cooldown_until and n > self.min_workers):
            cands = [m for m in live if m.addr not in self._unretirable]
            if not cands:
                return None
            victim = min(cands, key=lambda m: m.queue_depth).addr
            # The retire runs off this thread past a short grace (a drain
            # can take tens of seconds, and the loop must keep sensing);
            # fast outcomes land inline.
            box: dict = {}

            def run_retire():
                try:
                    self.retire_fn(victim)
                    box["ok"] = True
                except Exception:  # noqa: BLE001 — phantom/unreachable
                    box["ok"] = False

            t = threading.Thread(target=run_retire, daemon=True,
                                 name="autoscale-retire")
            t.start()
            t.join(timeout=1.0)
            self._cooldown_until = now + self.down_cooldown_s
            self._idle_since = None
            if box.get("ok") is False:
                self._unretirable.add(victim)
                return None
            self.scale_downs += 1
            self.actions.append((now, "down", victim))
            return "down"
        return None

    # ---- loop / teardown ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — a failed poll (a spawn that
                traceback.print_exc()  # failed) must not kill the loop

    def stats(self) -> dict:
        return {"scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "workers": self.trace[-1][1] if self.trace else 0,
                "actions": list(self.actions)}

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._eps.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ModelMixAdvisor:
    """The model-mix side of the closed loop: where the Autoscaler changes
    how many workers serve, this changes what they serve. Each poll groups
    the registry's members of ``role`` by their md= model tag and computes
    each model's pressure (reported queue depth over the capacity of its
    non-draining workers). When one model runs hot (over
    ``hot_pressure``) while another idles (a gap over ``gap``) for
    ``confirm`` consecutive polls, and the cooldown has passed, it moves
    one worker, the cold model's least loaded, with
    ``retarget_fn(addr, hot_model)`` (the cluster's Admin.retarget: a
    drain and a cold start of the hot model's weights). ``min_workers``
    keeps a floor under every model. ``trace`` holds (t, pressures,
    counts) per poll and ``actions`` (t, addr, cold, hot) per move."""

    def __init__(self, registry_addr: str, retarget_fn, *,
                 role: str = "decode",
                 hot_pressure: float = 1.0, gap: float = 0.75,
                 confirm: int = 3, cooldown_s: float = 8.0,
                 min_workers: int = 1, poll_s: float = 0.5,
                 autostart: bool = True):
        self.registry_addr = registry_addr
        self.retarget_fn = retarget_fn
        self.role = role
        self.hot_pressure = hot_pressure
        self.gap = gap
        self.confirm = confirm
        self.cooldown_s = cooldown_s
        self.min_workers = min_workers
        self.poll_s = poll_s
        self.moves = 0
        self.trace: deque = deque(maxlen=8192)
        self.actions: deque = deque(maxlen=1024)
        self._streak = 0
        self._cooldown_until = 0.0
        # Workers whose retarget failed for good: never picked again.
        self._unmovable: set = set()
        self._eps = cluster._Endpoints(registry_addr, timeout_ms=2000)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    def _members(self) -> List[cluster.Member]:
        body = self._eps.call("list", self.role.encode(),
                              wait=self._stop.wait).decode()
        return cluster.parse_members(body)[1]

    def poll_once(self) -> Optional[tuple]:
        """One sense -> decide -> act round: (addr, hot model) when a move
        was made, else None."""
        members = self._members()
        by_model: Dict[str, List[cluster.Member]] = {}
        for m in members:
            if m.model:
                by_model.setdefault(m.model, []).append(m)
        now = time.monotonic()
        if len(by_model) < 2:
            self._streak = 0
            return None
        press = {}
        for mdl, ms in by_model.items():
            cap = sum(max(m.capacity, 1) for m in ms if not m.draining)
            press[mdl] = (sum(m.queue_depth for m in ms) / cap
                          if cap > 0 else float("inf"))
        hot = max(press, key=lambda k: press[k])
        cold = min(press, key=lambda k: press[k])
        self.trace.append((now, dict(press),
                           {m: len(v) for m, v in by_model.items()}))
        donors = [m for m in by_model[cold]
                  if not m.draining and m.addr not in self._unmovable]
        if (press[hot] < self.hot_pressure
                or press[hot] - press[cold] < self.gap
                or len(by_model[cold]) <= self.min_workers
                or not donors):
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.confirm or now < self._cooldown_until:
            return None
        victim = min(donors, key=lambda m: m.queue_depth)
        try:
            self.retarget_fn(victim.addr, hot)
        except Exception:  # noqa: BLE001 — dead/unknown donor: skip it
            self._unmovable.add(victim.addr)
            return None
        self.moves += 1
        self.actions.append((now, victim.addr, cold, hot))
        # The move takes a drain and a cold start to land: deciding again
        # off the pre-move pressure would over-steal.
        self._cooldown_until = now + self.cooldown_s
        self._streak = 0
        return (victim.addr, hot)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — registry failover window:
                pass           # the next poll rotates endpoints

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="model-mix-advisor")
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._eps.close()


class DisaggCluster:
    """N prefill and M decode workers as subprocesses, fronted by an
    in-process DisaggRouter.

    Membership is static lists, or with ``use_registry`` the lease
    registry: in process, or with ``registry_replicas`` N as N replica
    subprocesses (``cluster.RegistryCluster``, each with its own WAL).
    Every worker then holds a lease of ``registry_ttl_ms`` (and with
    ``accept_advice`` acts on role advice), the router follows the
    registry's watches, a SIGKILLed worker is expelled when its lease
    expires, and ``start_autoscaler`` / ``start_model_advisor`` close the
    loop (spawn and retire workers, move them between models).

    The cluster serves every model's canonical weights itself, from one
    ParamServer per group (``param_server.groups``), and each worker
    pulls its model's at start-up. ``weights`` ({model id: flat dict,
    ``_flatten_params``' names}) gives them; the cluster takes each entry
    out of ``weights`` as it serves it, so a caller that keeps no other
    reference does not hold a large model twice. A model without an
    entry gets the port's seeded ``init_params`` (a CPU generator: not
    the JAX package's weights for the same seed). Without ``models`` the
    cluster serves one model, id ``""``, of ``cfg_name`` and ``seed``.
    With ``models`` ({id: (cfg_name, seed)}; the first is the default),
    ``spawn_worker(model=)`` picks a worker's model and ``retarget_worker``/``adapter_worker``
    move it through the worker's drain state machine.

    ``device`` "cpu" runs the workers on the CPU (tests); the default is
    the card. ``n_layers`` cuts every model's depth, ``decode_kv_blocks``
    sizes both roles' pools, ``max_prompt`` the prefill worker's,
    ``kv_pool`` (page bytes, max pages) each worker's KV receive pool.
    Workers start at once. One that fails before READY, or does not
    print it within ``READY_TIMEOUT_S``, makes the cluster raise with its
    line."""

    def __init__(self, n_prefill: int = 1, n_decode: int = 2, *,
                 cfg_name: str = "tiny", seed: int = 0,
                 page_tokens: int = 16, decode_slots: int = 8,
                 decode_kv_blocks: int = 0, max_prompt: int = 0,
                 n_layers: int = 0,
                 kv_chunk_bytes: int = -1, kv_timeout_ms: int = 20_000,
                 prefill_limiter: str = "auto",
                 use_registry: bool = False, registry_ttl_ms: int = 1500,
                 registry_replicas: int = 0, accept_advice: bool = False,
                 f32: bool = False,
                 models: Optional[Dict[str, tuple]] = None,
                 weights: Optional[Dict[str, dict]] = None,
                 kv_pool: Optional[tuple] = None,
                 device: Optional[str] = None,
                 **router_kwargs):
        self.procs: List[subprocess.Popen] = []
        self.prefill_addrs: List[str] = []
        self.decode_addrs: List[str] = []
        # addr -> (subprocess, admin addr)
        self.workers: Dict[str, tuple] = {}
        self.spawn_seconds: Dict[str, float] = {}
        self.models: Dict[str, tuple] = dict(models or {})
        self.param_servers: Dict[str, List[param_server.ParamServer]] = {}
        self._param_addrs: Dict[str, str] = {}
        self.router = None
        self.registry = None
        self.autoscaler: Optional[Autoscaler] = None
        self.model_advisor: Optional[ModelMixAdvisor] = None
        served = self.models or {"": (cfg_name, seed)}
        weights = {} if weights is None else weights
        unknown = set(weights) - set(served)
        if unknown:
            raise KeyError(f"weights for unknown models {sorted(unknown)}")
        env = dict(os.environ)
        if f32:
            env["BRPC_TPU_F32"] = "1"
        self.default_model = next(iter(served))
        self._spawn_cfg = {
            "env": env, "cfg_name": cfg_name,
            "page_tokens": page_tokens, "decode_slots": decode_slots,
            "repo": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "registry_ttl_ms": registry_ttl_ms,
            "accept_advice": accept_advice,
            "extra": ("--chunk-bytes", str(kv_chunk_bytes),
                      "--kv-timeout", str(kv_timeout_ms),
                      "--limiter", prefill_limiter,
                      "--kv-blocks", str(decode_kv_blocks),
                      "--max-prompt", str(max_prompt),
                      "--layers", str(n_layers),
                      *(("--device", device) if device else ()),
                      *(("--kv-pool", f"{kv_pool[0]}:{kv_pool[1]}")
                        if kv_pool else ())),
        }
        router_kwargs.setdefault("page_tokens", page_tokens)
        try:
            if use_registry and registry_replicas > 0:
                # The replicated, persistent control plane as subprocesses
                # that can be SIGKILLed like pods; workers and the router
                # take the whole endpoint list and fail over themselves.
                self.registry = cluster.RegistryCluster(
                    registry_replicas, default_ttl_ms=registry_ttl_ms)
            elif use_registry:
                self.registry = cluster.Registry(
                    default_ttl_ms=registry_ttl_ms)
            for mid, (m_cfg, m_seed) in served.items():
                flat = weights.pop(mid, None)
                if flat is None:
                    cfg = _model_cfg(m_cfg)
                    if f32:
                        cfg = dataclasses.replace(cfg, dtype=torch.float32)
                    if n_layers:
                        cfg = dataclasses.replace(cfg, n_layers=n_layers)
                    flat = _flatten_params(transformer.init_params(
                        cfg, torch.Generator().manual_seed(m_seed),
                        device="cpu"))
                self._serve(mid, flat)
                del flat
            # Every worker starts (and pulls its weights) at once.
            started = [self._start(role) for role in
                       ["prefill"] * n_prefill + ["decode"] * n_decode]
            for role, p, t0 in started:
                addrs = (self.prefill_addrs if role == "prefill"
                         else self.decode_addrs)
                addrs.append(self._await_ready(role, p, t0))
            if self.registry is not None:
                self.router = DisaggRouter(registry=self.registry.addr,
                                           **router_kwargs)
            else:
                self.router = DisaggRouter(self.prefill_addrs,
                                           self.decode_addrs, **router_kwargs)
        except BaseException:
            self.close()
            raise
        self.port = self.router.port

    def _serve(self, model_id: str, flat: Dict[str, object]) -> None:
        """One ParamServer per group of ``flat``, named on every later
        worker's argv as ``model_id=addr1+addr2+...``."""
        servers = []
        groups = param_server.groups(flat)
        try:
            while groups:
                servers.append(param_server.ParamServer(groups.pop(0)))
                servers[-1].start(0)
        except BaseException:
            for ps in servers:
                ps.close()
            raise
        self.param_servers[model_id] = servers
        self._param_addrs[model_id] = "+".join(
            f"127.0.0.1:{ps._srv.port}" for ps in servers)

    def spawn_worker(self, role: str, model: Optional[str] = None) -> str:
        """Start one more worker subprocess serving ``model`` (default:
        the cluster's default model); returns its address once it printed
        READY. Both roles' flags ride every argv, so a flip rebuilds the
        successor with its role's configuration. With a registry the new
        worker registers itself and the router's watch picks it up: the
        Autoscaler's spawn actuator."""
        return self._await_ready(*self._start(role, model))

    def _start(self, role: str, model: Optional[str] = None) -> tuple:
        sc = self._spawn_cfg
        mid = self.default_model if model is None else model
        if mid not in self._param_addrs:
            raise KeyError(f"unknown model {mid!r}")
        cfg_name = self.models[mid][0] if mid in self.models \
            else sc["cfg_name"]
        param_map = ",".join(f"{m}={a}" for m, a in self._param_addrs.items())
        reg_args = (("--registry", self.registry.addr,
                     "--ttl", str(sc["registry_ttl_ms"]),
                     "--accept-advice", str(int(sc["accept_advice"])))
                    if self.registry is not None else ())
        t0 = time.monotonic()
        p = subprocess.Popen(
            [sys.executable, "-c", _WORKER_SRC, "--role", role,
             "--cfg", cfg_name, "--model", mid, "--params", param_map,
             "--page-tokens", str(sc["page_tokens"]),
             "--slots", str(sc["decode_slots"]), *sc["extra"], *reg_args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=sc["repo"], env=sc["env"])
        self.procs.append(p)  # close() reaps it whatever happens next
        return role, p, t0

    def _await_ready(self, role: str, p: subprocess.Popen,
                     t0: float) -> str:
        timeout_s = READY_TIMEOUT_S
        ready, _, _ = select.select(
            [p.stdout], [], [], max(0.0, t0 + timeout_s - time.monotonic()))
        line = p.stdout.readline().strip() if ready else ""
        if not line.startswith("READY "):
            self.procs.remove(p)
            _reap(p)
            raise RuntimeError(
                f"{role} worker failed to start: {line!r}" if ready else
                f"{role} worker printed no READY within {timeout_s} s")
        parts = line.split()
        addr = f"127.0.0.1:{parts[1]}"
        admin_addr = ""
        for tok in parts[2:]:
            if tok.startswith("admin="):
                admin_addr = f"127.0.0.1:{tok[6:]}"
        self.workers[addr] = (p, admin_addr)
        self.spawn_seconds[addr] = time.monotonic() - t0
        return addr

    def _admin_call(self, addr: str, method: str, req: bytes = b"",
                    timeout_ms: int = 5000) -> bytes:
        """One RPC on a worker's Admin server (stable across flips)."""
        _p, admin_addr = self.workers[addr]
        if not admin_addr:
            raise RuntimeError(f"worker {addr} has no admin server")
        ch = runtime.Channel(admin_addr, timeout_ms=timeout_ms)
        try:
            return ch.call("Admin", method, req)
        finally:
            ch.close()

    def flip_worker(self, addr: str, role: str) -> None:
        """Ask ``addr``'s runner to migrate to ``role``. Returns at once;
        poll ``worker_status(addr)`` for completion."""
        self._admin_call(addr, "flip", role.encode())

    def retire_worker(self, addr: str, wait_s: float = 75.0) -> None:
        """Drain ``addr`` through its runner (which leaves its lease) and
        reap the process: the Autoscaler's retire actuator. ``wait_s``
        must outlast the runner's drain timeout (60 s). Raises KeyError
        for an address this cluster never spawned."""
        if addr not in self.workers:
            raise KeyError(f"unknown worker addr {addr} "
                           "(flipped to a fallback port?)")
        p, _admin = self.workers[addr]
        try:
            self._admin_call(addr, "retire")
        except runtime.RpcError:
            pass  # already dead: reaped below
        try:
            p.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:  # drain overran: hard stop
            p.kill()
            p.wait(timeout=10)
        self.workers.pop(addr, None)

    def retarget_worker(self, addr: str, model: str) -> None:
        """Move ``addr`` to ``model`` (its weights pulled over TPS1).
        Returns at once; poll ``worker_status(addr)["model"]``."""
        if addr not in self.workers:
            raise KeyError(f"unknown worker addr {addr}")
        if model not in self.models:
            raise KeyError(f"unknown model {model!r}")
        self._admin_call(addr, "retarget", model.encode())

    def adapter_worker(self, addr: str, adapter: str) -> None:
        """Swap in the delta published as ``adapter`` (``add_adapter``)
        on ``addr``'s current weights; it serves as <base>.<adapter>."""
        if addr not in self.workers:
            raise KeyError(f"unknown worker addr {addr}")
        self._admin_call(addr, "adapter", adapter.encode())

    def add_adapter(self, adapter_id: str,
                    delta: Dict[str, object]) -> None:
        """Publish a LoRA-style delta (flat 'a/b' keys, a subset of a
        model's). Workers spawned before this call cannot find it."""
        self._serve(adapter_id, dict(delta))

    def worker_status(self, addr: str) -> dict:
        """The runner's status line as a dict (role, state, active,
        flips, sheds, spilled, grafted, retargets, model)."""
        body = self._admin_call(addr, "status").decode()
        out: dict = {}
        for tok in body.split():
            k, _, v = tok.partition("=")
            out[k] = int(v) if v.lstrip("-").isdigit() else v
        return out

    def start_autoscaler(self, **kw) -> Autoscaler:
        """An Autoscaler on this cluster's registry, acting through
        ``spawn_worker`` and ``retire_worker``; ``kw`` passes its knobs."""
        if self.registry is None:
            raise RuntimeError("autoscaling needs use_registry=True")
        if self.autoscaler is None:
            self.autoscaler = Autoscaler(
                self.registry.addr, self.spawn_worker, self.retire_worker,
                **kw)
        return self.autoscaler

    def stop_autoscaler(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.close()
            self.autoscaler = None

    def start_model_advisor(self, **kw) -> ModelMixAdvisor:
        """A ModelMixAdvisor on this cluster's registry, acting through
        ``retarget_worker``; ``kw`` passes its knobs."""
        if self.registry is None:
            raise RuntimeError("model-mix advice needs use_registry=True")
        if not self.models:
            raise RuntimeError("model-mix advice needs models={...}")
        if self.model_advisor is None:
            self.model_advisor = ModelMixAdvisor(
                self.registry.addr, self.retarget_worker, **kw)
        return self.model_advisor

    def stop_model_advisor(self) -> None:
        if self.model_advisor is not None:
            self.model_advisor.close()
            self.model_advisor = None

    def kill_prefill(self, index: int = 0) -> None:
        """SIGKILL one prefill worker."""
        self.procs[index].kill()

    def kill_decode(self, index: int = 0) -> None:
        """SIGKILL one decode worker."""
        self.procs[len(self.prefill_addrs) + index].kill()

    def close(self) -> None:
        self.stop_autoscaler()
        self.stop_model_advisor()
        if self.router is not None:
            self.router.close()
            self.router = None
        for p in self.procs:
            _reap(p)
        self.procs = []
        for servers in self.param_servers.values():
            for ps in servers:
                ps.close()
        self.param_servers = {}
        if self.registry is not None:
            self.registry.close()
            self.registry = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
