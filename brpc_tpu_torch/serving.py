"""Serving gateway on PyTorch: continuous batching with streamed tokens, the
counterpart of brpc_tpu/serving.py, speaking the same wire.

The native batcher coalesces concurrent ``generate`` RPCs into batches
(``max_batch_size`` OR ``max_queue_delay_us``) with priority lanes and
deadline culling; ``ServingEngine`` runs prefill for each admitted request
and one batched paged decode step per iteration over every slot, on the
device, and emits each token to its client as soon as it exists. A
sequence's KV lives in the paged pool (``kv_cache.PagedKvPool``): it owns a
block table, allocates pages as it grows, and releases them on finish, so
slots vacated mid-flight are refilled by newly admitted requests.

Prefix cache (on by default, as in the reference): a prompt that shares a
cached prefix retains the cached pages and prefills only from the first
uncached position (``kv_cache.prefix_resume``); finished sequences are
admitted for the next chat turn. With the host tier (also on by default),
pages evicted off the pool's LRU spill to the native host page store and
fill back on the next match.

Wire protocol (unchanged):
    request   <u32le max_new_tokens> <u32le prompt_len> <prompt_len x u32le>
              [optional <u16 len><utf8> tags: tenant, tier, model]
    stream    'd' <u32le token>                one generated token
              'f' <u32le status> <utf8 text>   terminal; status 0 = clean end

The client budget is the RPC deadline (``timeout_ms``): queued requests
whose budget expires are culled without a model step, and a generation
that outlives it is cut off with ERPCTIMEDOUT.

All device work runs on the engine's loop thread.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
import traceback
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from brpc_tpu_torch import kv_cache, runtime
from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.utils import resolve_device

SERVICE = "Serve"
METHOD_INTERACTIVE = "generate"
METHOD_BATCH = "generate_batch"

_HDR = struct.Struct("<II")

# How long close() waits for a loop thread to end. A thread still alive
# after that keeps its native batcher and server: a leak on a wedged close
# is better than a use-after-free in the thread's next native call.
CLOSE_JOIN_S = 10.0


def join_loop(thread: Optional[threading.Thread], owner: str) -> bool:
    """Join a loop thread (whose batcher and server were stopped first) for
    at most CLOSE_JOIN_S; True once it has ended (or never started)."""
    if thread is None:
        return True
    thread.join(timeout=CLOSE_JOIN_S)
    if not thread.is_alive():
        return True
    logging.getLogger(__name__).warning(
        "%s.close: loop thread %s still running after %.1f s; its native "
        "batcher and server are left open", owner, thread.name, CLOSE_JOIN_S)
    return False

# SLO product tiers, cheapest-to-shed first; interactive and standard ride
# the interactive lane, batch the batch lane.
TIERS = ("interactive", "standard", "batch")


def tier_lane(tier: str) -> int:
    """tier name -> batcher lane (unknown/empty tiers ride interactive)."""
    return runtime.LANE_BATCH if tier == "batch" else runtime.LANE_INTERACTIVE


def tier_code(tier: str) -> int:
    """tier name -> flight-record tier byte (runtime.TIER_*)."""
    return {"interactive": runtime.TIER_INTERACTIVE,
            "standard": runtime.TIER_STANDARD,
            "batch": runtime.TIER_BATCH}.get(tier, runtime.TIER_NONE)


def prompt_bucket(length: int, max_prompt: int) -> int:
    """Prefill shape for a prompt: the smallest power-of-two bucket >=
    max(8, length), capped at max_prompt."""
    b = 8
    while b < length:
        b <<= 1
    return min(b, max_prompt)


def encode_request(prompt: Sequence[int], max_new_tokens: int,
                   tenant: str = "", tier: str = "",
                   model: str = "") -> bytes:
    toks = np.asarray(prompt, dtype="<u4")
    body = _HDR.pack(int(max_new_tokens), len(toks)) + toks.tobytes()
    # Optional trailing tags, each <u16 length><utf8>, in fixed order
    # (tenant, tier, model); an empty earlier tag is a zero-length
    # placeholder when a later one is present.
    tags = [tenant, tier, model]
    while tags and not tags[-1]:
        tags.pop()
    for tag in tags:
        t = tag.encode()
        body += struct.pack("<H", len(t)) + t
    return body


def decode_request(payload: bytes):
    if len(payload) < _HDR.size:
        raise ValueError("serving request too short")
    max_new, n = _HDR.unpack_from(payload)
    body = payload[_HDR.size:_HDR.size + 4 * n]
    if len(body) != 4 * n:
        raise ValueError("serving request truncated")
    return np.frombuffer(body, dtype="<u4").astype(np.int32), int(max_new)


def decode_request_meta(payload: bytes):
    """decode_request + the optional trailing tags: (prompt, max_new,
    tenant, tier, model); "" = untagged."""
    prompt, max_new = decode_request(payload)
    off = _HDR.size + 4 * len(prompt)
    tags = []
    while len(tags) < 3 and len(payload) >= off + 2:
        (tl,) = struct.unpack_from("<H", payload, off)
        raw = payload[off + 2:off + 2 + tl]
        if len(raw) != tl:
            break  # truncated tag: ignore it and everything after
        tags.append(raw.decode(errors="replace"))
        off += 2 + tl
    tags += [""] * (3 - len(tags))
    return prompt, max_new, tags[0], tags[1], tags[2]


class DrainMixin:
    """The drain state machine's shared verbs. Subclasses provide
    ``drain_live()`` and ``drain_eta_ms()`` and consult ``self.draining``
    on their admission paths."""

    draining = False
    drain_reason = ""

    def drain_live(self) -> int:
        raise NotImplementedError

    def drain_eta_ms(self) -> int:
        raise NotImplementedError

    def drain_shed_text(self) -> str:
        """The shed response text; routers key their drain accounting off
        the literal "draining" in it."""
        return (f"worker draining ({self.drain_reason or 'drain'});"
                f" retry_after_ms={self.drain_eta_ms()}")

    def begin_drain(self, reason: str = "drain") -> None:
        """Enter DRAINING: new admissions shed with a retriable ELIMIT and
        a live ETA hint; in-flight work runs to completion. Idempotent."""
        if not self.draining:
            self.drain_reason = reason
            self.draining = True
            runtime.app_counter_add("serving_drains", 1)

    def drain_wait(self, timeout_s: float = 30.0) -> bool:
        """Block until every in-flight work unit finished; False on
        timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.drain_live() == 0:
                return True
            time.sleep(0.02)
        return self.drain_live() == 0


class ServingEngine(DrainMixin):
    """Continuous-batching server over this package's transformer params.

    ``slots`` decode lanes run concurrently; each lane's KV lives in the
    paged block pool. ``step()`` runs one admit + prefill + decode
    iteration; with ``autostart`` a daemon thread loops it. ``device``
    defaults to ``cuda`` (raises without a card); the tests pass
    ``device="cpu"``. The other options are the reference's, with its
    defaults.
    """

    service = SERVICE
    lanes = ((METHOD_INTERACTIVE, runtime.LANE_INTERACTIVE),
             (METHOD_BATCH, runtime.LANE_BATCH))

    def __init__(self, params, cfg, *, max_batch_size: int = 8,
                 max_queue_delay_us: int = 2000, max_queue_len: int = 1024,
                 slots: Optional[int] = None,
                 max_prompt: Optional[int] = None,
                 eos_token: Optional[int] = None,
                 kv_page_tokens: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 kv_host_tier: bool = True,
                 kv_host_budget_bytes: int = 0,
                 prefix_ttl_s: Optional[float] = 600.0,
                 prefix_gc_interval_s: float = 30.0,
                 admit_finished: bool = True,
                 limiter: str = "",
                 port: int = 0, autostart: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.eos_token = eos_token
        self.slots = slots if slots is not None else max_batch_size
        self.max_prompt = (max_prompt if max_prompt is not None
                           else max(8, cfg.max_seq // 2))
        if self.max_prompt >= cfg.max_seq:
            raise ValueError("max_prompt must leave room to decode")
        self.page_tokens = kv_page_tokens
        # Default capacity lets every lane reach max_seq (+ the garbage
        # block); size it down to the real need at large widths.
        max_blocks = cfg.max_seq // kv_page_tokens
        nblocks = (kv_blocks if kv_blocks is not None
                   else self.slots * max_blocks + 1)
        self.pool = kv_cache.PagedKvPool(cfg, nblocks, kv_page_tokens,
                                         device=self.device)
        # Cross-request prefix cache over the pool; with the host tier,
        # pages evicted off the LRU spill to the host store.
        self.prefix = (kv_cache.PrefixIndex(
            self.pool, kv_page_tokens,
            token_bytes=kv_cache.kv_token_bytes(cfg),
            host_tier=kv_host_tier,
            host_budget_bytes=kv_host_budget_bytes)
            if prefix_cache else None)
        # Multi-turn seam: a finished sequence's pages (prompt + reply) are
        # admitted at vacate time, so the next turn resumes off them.
        self.admit_finished = admit_finished
        # TTL gc beyond the pool's LRU: ages out cold index entries and
        # their host pages on a periodic sweep.
        self.prefix_ttl_s = prefix_ttl_s
        self.prefix_gc_interval_s = prefix_gc_interval_s
        self._last_gc = time.monotonic()
        self._decode = kv_cache.paged_decode_fn(cfg, kv_page_tokens)
        # slot i's block table row; unused entries point at garbage block 0
        self._tables = np.zeros((self.slots, max_blocks), np.int32)
        # slot i: None when free, else the live request's state
        self._seq = [None] * self.slots

        self.model_steps = 0      # decode invocations
        self.decode_seconds = 0.0  # wall time of those steps (synchronised)
        self.prefill_seconds = 0.0  # wall time of the prefills (synchronised)
        self.prefills = 0         # cold prefills (K2)
        self.resume_seconds = 0.0  # wall time of the resumes (synchronised)
        self.resumes = 0          # suffix prefills off a prefix hit (K4)
        self.tokens_out = 0
        self.reclaimed_slots = 0  # vacated because the client went away
        self.draining = False
        self.drain_reason = ""
        self.drain_sheds = 0
        self.drained_generations = 0
        self._token_ema_s = 0.0   # EMA of step() wall time (token cadence)

        self.server = runtime.Server()
        self.batcher = runtime.NativeBatcher(
            max_batch_size=max_batch_size,
            max_queue_delay_us=max_queue_delay_us,
            max_queue_len=max_queue_len, limiter=limiter)
        for method, lane in self.lanes:
            self.batcher.add_method(self.server, self.service, method, lane)
        self.port = self.server.start(port)

        self._running = False
        self._thread = None
        if autostart:
            self.start()

    # ---- serving loop ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-loop")
        self._thread.start()

    def _loop(self) -> None:
        try:
            while self._running:
                self.step()
        except Exception:  # noqa: BLE001 — a dead loop must fail loudly
            traceback.print_exc()
            # New admissions get ELIMIT; queued requests get terminal
            # frames at close() instead of hanging to their deadlines.
            self._running = False
            self.batcher.stop()

    def _activate_seq(self, slot: int, seq: dict, blocks: list,
                      emit_first: bool = True) -> bool:
        """Emit the prefill's token and seat the sequence in ``slot``;
        False when it already finished (or its client left)."""
        row = self._tables[slot]
        row[:] = 0
        row[:len(blocks)] = blocks
        seq["blocks"] = blocks
        tok = seq["last"]
        if emit_first and not self._emit_token(seq, tok):
            self.pool.release(blocks)
            row[:] = 0
            return False
        if seq["left"] <= 0 or (self.eos_token is not None
                                and tok == self.eos_token):
            self.batcher.finish(seq["id"], 0, "")
            self.pool.release(blocks)
            row[:] = 0
            return False
        self._seq[slot] = seq
        return True

    def _vacate(self, slot: int, admit: bool = True) -> None:
        """Free ``slot``'s pages and table row (the sequence already got
        its terminal frame). With ``admit`` (and admit_finished) the pages,
        prompt and generated tokens, are admitted to the prefix index first,
        so the next chat turn can resume off them."""
        seq = self._seq[slot]
        if seq is not None and seq.get("blocks"):
            if (admit and self.admit_finished and self.prefix is not None
                    and len(seq.get("tokens", ())) == seq["pos"]):
                self.prefix.admit(seq["tokens"], seq["blocks"])
                self.prefix.sync_native()
            self.pool.release(seq["blocks"])
        if seq is not None and self.draining:
            self.drained_generations += 1
        self._tables[slot][:] = 0
        self._seq[slot] = None

    def _admit(self, req_id: int, payload: bytes, remaining_us: int,
               slot: int) -> bool:
        """Prefill one admitted request into ``slot``. False = rejected."""
        try:
            prompt, max_new = decode_request(payload)
        except ValueError as e:
            self.batcher.finish(req_id, runtime.EREQUEST, str(e))
            return False
        return self._admit_prompt(req_id, prompt, max_new, remaining_us,
                                  slot)

    def _admit_prompt(self, req_id: int, prompt, max_new: int,
                      remaining_us: int, slot: int, *,
                      min_hit_tokens: int = -1,
                      emit_first: bool = True) -> bool:
        """Admit one prompt into ``slot``, reusing cached prefix pages.

        A prefix hit retains the cached pages into this sequence's block
        table and prefills only from the first uncached position (K4 over
        the table); a mid-page hit copies the shared tail page when another
        holder still references it. ``min_hit_tokens >= 0`` demands a hit
        of at least that many tokens and rejects with EREJECT otherwise
        (the disaggregated splice path)."""
        if len(prompt) == 0 or len(prompt) > self.max_prompt:
            self.batcher.finish(req_id, runtime.EREQUEST,
                                f"prompt length {len(prompt)} not in "
                                f"[1, {self.max_prompt}]")
            return False
        if max_new < 1:
            self.batcher.finish(req_id, runtime.EREQUEST,
                                "max_new_tokens must be >= 1")
            return False
        max_new = min(max_new, self.cfg.max_seq - len(prompt))
        P = len(prompt)
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_START)
        shared, use = [], 0
        host_fill = False
        if self.prefix is not None:
            # The last prompt token is always recomputed: its logits are
            # the first output token.
            hh0 = self.prefix.host_hits
            shared, use = self.prefix.match(prompt, P - 1)
            host_fill = self.prefix.host_hits > hh0
            if use and not kv_cache.can_resume(self.cfg, use, P):
                self.pool.release(shared)
                shared, use = [], 0
        if min_hit_tokens >= 0 and use < min_hit_tokens:
            if shared:
                self.pool.release(shared)
            self.splice_rejects = getattr(self, "splice_rejects", 0) + 1
            self.batcher.finish(req_id, runtime.EREJECT,
                                f"prefix miss: {use}/{P} tokens cached")
            return False
        t_prefill = time.monotonic()
        if use:
            runtime.flight_route(
                req_id, runtime.ROUTE_HOST_FILL if host_fill
                else runtime.ROUTE_HBM_HIT)
            out = kv_cache.prefix_resume(
                self.pool, self.params, self.cfg, self.page_tokens, prompt,
                shared, use, index=self.prefix)
            if out is None:
                self.batcher.finish(req_id, runtime.ELIMIT,
                                    "kv block pool exhausted")
                return False
            logits, blocks = out
            tok = int(logits.argmax())  # synchronises: the resume is done
            self.resumes += 1
            self.resume_seconds += time.monotonic() - t_prefill
        else:
            blocks = self.pool.alloc(kv_cache.pages_for(P, self.page_tokens))
            if blocks is None:
                self.batcher.finish(req_id, runtime.ELIMIT,
                                    "kv block pool exhausted")
                return False
            padded = np.zeros(prompt_bucket(P, self.max_prompt), np.int32)
            padded[:P] = prompt
            logits, k, v = transformer.prefill(
                self.params, torch.from_numpy(padded).to(self.device), P,
                self.cfg)
            k_pages, v_pages = kv_cache.prefill_cache_pages(
                k, v, P, self.page_tokens)
            self.pool.write_blocks(blocks, k_pages, v_pages)
            tok = int(logits.argmax())  # synchronises: the prefill is done
            self.prefills += 1
            self.prefill_seconds += time.monotonic() - t_prefill
        runtime.flight_stamp(req_id, runtime.FLIGHT_PREFILL_DONE)
        deadline = (time.monotonic() + remaining_us / 1e6
                    if remaining_us >= 0 else None)
        seq = {
            "id": req_id,
            "pos": P,               # decode writes here next
            "last": tok,
            "left": max_new,
            "deadline": deadline,
            # Every token whose KV the pages hold (grows as decode feeds
            # tokens): the admission key of the finished sequence.
            "tokens": [int(t) for t in prompt],
        }
        if self.prefix is not None:
            # Admit before activation: admit reads the pages (host export)
            # while our references are held, and activation may release
            # them (client gone, immediate finish).
            self.prefix.admit(prompt, blocks)
            self.prefix.sync_native()
        return self._activate_seq(slot, seq, blocks, emit_first=emit_first)

    def _emit_token(self, seq: dict, tok: int) -> bool:
        """Emit one token; False = the client is gone (slot reclaimable)."""
        rc = self.batcher.emit(seq["id"], struct.pack("<I", tok))
        if rc != 0:
            self.batcher.finish(seq["id"], rc, "client went away")
            self.reclaimed_slots += 1
            return False
        self.tokens_out += 1
        seq["left"] -= 1
        return True

    def step(self, wait_us: int = 50_000) -> int:
        """One engine iteration: admit into free slots, then one batched
        decode step over every slot. Returns the active count.

        Blocks up to ``wait_us`` for admissions only when fully idle; with
        sequences in flight the admission poll is non-blocking, so decode
        cadence never waits on the queue."""
        if self.prefix is not None and self.prefix_ttl_s is not None:
            now = time.monotonic()
            if now - self._last_gc >= self.prefix_gc_interval_s:
                self._last_gc = now
                self.prefix.gc(self.prefix_ttl_s)
        active = [i for i, s in enumerate(self._seq) if s is not None]
        free = [i for i, s in enumerate(self._seq) if s is None]
        if self.draining:
            batch = self.batcher.next_batch(
                wait_us=0 if active else wait_us)
            if batch is None:
                self._running = False
                return len(active)
            if batch:
                text = self.drain_shed_text()
                for req_id, _payload, _prio, _rem in batch:
                    self.batcher.finish(req_id, runtime.ELIMIT, text)
                self.drain_sheds += len(batch)
                runtime.app_counter_add("serving_drain_sheds", len(batch))
        elif free:
            batch = self.batcher.next_batch(
                max_items=len(free), wait_us=0 if active else wait_us)
            if batch is None:  # stopped and drained
                self._running = False
                return len(active)
            for (req_id, payload, _prio, remaining_us), slot in zip(
                    batch, free):
                if self._admit(req_id, payload, remaining_us, slot):
                    active.append(slot)
        if not active:
            return 0

        tokens = np.zeros(self.slots, np.int32)
        pos = np.zeros(self.slots, np.int32)
        for i in list(active):
            seq = self._seq[i]
            # Grow the block table to cover the position this step writes.
            need = seq["pos"] // self.page_tokens + 1
            while len(seq["blocks"]) < need:
                fresh = self.pool.alloc(1)
                if fresh is None:
                    self.batcher.finish(seq["id"], runtime.ELIMIT,
                                        "kv block pool exhausted")
                    self._vacate(i)
                    active.remove(i)
                    break
                seq["blocks"].extend(fresh)
                self._tables[i][len(seq["blocks"]) - 1] = fresh[0]
            else:
                tokens[i] = seq["last"]
                pos[i] = seq["pos"]
                seq["tokens"].append(int(seq["last"]))
        if not active:
            return 0
        # One step over the whole slot pool: free slots decode garbage
        # through the reserved block 0. Only the table columns in play go to
        # the device: K1 plans its split-K over the table's width.
        width = max(len(self._seq[i]["blocks"]) for i in active)
        tables = np.ascontiguousarray(self._tables[:, :width])
        t_step = time.monotonic()
        dev = self.device
        logits, self.pool.k, self.pool.v = self._decode(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(tables).to(dev),
            self.pool.k, self.pool.v)
        self.model_steps += 1
        self.batcher.note_occupancy(len(active))
        # argmax on the device; only [slots] ints cross to the host.
        next_tok = logits.argmax(dim=-1).tolist()
        dt = time.monotonic() - t_step
        self.decode_seconds += dt
        self._token_ema_s = (dt if self._token_ema_s == 0.0
                             else 0.8 * self._token_ema_s + 0.2 * dt)

        now = time.monotonic()
        for i in list(active):
            seq = self._seq[i]
            if seq["deadline"] is not None and now >= seq["deadline"]:
                self.batcher.finish(seq["id"], runtime.ERPCTIMEDOUT,
                                    "budget exhausted mid-generation")
                self._vacate(i)
                continue
            tok = int(next_tok[i])
            seq["pos"] += 1
            seq["last"] = tok
            if self.eos_token is not None and tok == self.eos_token:
                self.batcher.finish(seq["id"], 0, "")
                self._vacate(i)
                continue
            if not self._emit_token(seq, tok):
                self._vacate(i)
                continue
            if seq["left"] <= 0 or seq["pos"] >= self.cfg.max_seq - 1:
                self.batcher.finish(seq["id"], 0, "")
                self._vacate(i)
        return sum(s is not None for s in self._seq)

    # ---- drain state machine ----------------------------------------------

    def in_flight(self) -> int:
        return sum(s is not None for s in self._seq)

    def drain_live(self) -> int:
        return self.in_flight()

    def token_cadence_s(self) -> float:
        """Observed per-token cadence: the freshest finished flight
        record's inter-token pace, else the step-time EMA, else 50 ms.
        Cached for a second (the flight lookup dumps the native ring)."""
        now = time.monotonic()
        cached = getattr(self, "_cadence_cache", None)
        if cached is not None and now - cached[1] < 1.0:
            return cached[0]
        val = self._token_ema_s if self._token_ema_s > 0 else 0.05
        for r in runtime.flight_records(max_items=8, oldest_first=False):
            toks = int(r.get("tokens", 0))
            fe = int(r.get("first_emit_us", 0))
            lt = int(r.get("last_token_us", 0))
            if toks >= 2 and lt > fe > 0:
                val = max((lt - fe) / (toks - 1) / 1e6, 1e-4)
                break
        self._cadence_cache = (val, now)
        return val

    def drain_eta_ms(self) -> int:
        """The longest remaining in-flight generation x the token cadence,
        clamped to [25, 30000] ms."""
        left = max((s["left"] for s in self._seq if s is not None),
                   default=0)
        return max(25, min(int(left * self.token_cadence_s() * 1000),
                           30_000))

    # ---- telemetry / teardown ---------------------------------------------

    def stats(self) -> dict:
        s = self.batcher.stats()
        s.update(
            model_steps=self.model_steps,
            decode_seconds=self.decode_seconds,
            prefill_seconds=self.prefill_seconds,
            prefills=self.prefills,
            resume_seconds=self.resume_seconds,
            resumes=self.resumes,
            tokens_out=self.tokens_out,
            reclaimed_slots=self.reclaimed_slots,
            active_slots=sum(x is not None for x in self._seq),
            draining=int(self.draining),
            drain_sheds=self.drain_sheds,
            drained_generations=self.drained_generations,
            mean_batch_occupancy=(
                s["occupancy_sum"] / s["occupancy_samples"]
                if s["occupancy_samples"] else 0.0),
        )
        for k, v in self.pool.stats().items():
            s[f"kv_{k}"] = v
        if self.prefix is not None:
            for k, v in self.prefix.counters().items():
                s[f"kv_prefix_{k}"] = v
            if self.prefix.host_tier:
                s.update(runtime.kv_tier_stats())
        return s

    def close(self) -> None:
        self._running = False
        self.server.stop()       # no new admissions arrive
        self.batcher.stop()      # wake any next_batch waiter
        if not join_loop(self._thread, type(self).__name__):
            return               # the loop still runs: its handles stay
        self._thread = None
        for i, seq in enumerate(self._seq):  # cut off in-flight generations
            if seq is not None:
                self.batcher.finish(seq["id"], runtime.ECANCELED,
                                    "engine shut down")
                self._vacate(i, admit=False)
        self.batcher.close()     # queued leftovers get ECANCELED terminals
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ServingClient:
    """Streaming client: ``generate()`` yields tokens as the server decodes
    them. ``timeout_ms`` is the whole-request budget (the RPC deadline). A
    retriable transport failure before the first token is resubmitted up to
    ``retries`` times; after the first token the error surfaces."""

    def __init__(self, addr: str, timeout_ms: int = 30_000,
                 interactive: bool = True, retries: int = 2,
                 read_slack_s: float = 30.0, tenant: str = "",
                 tier: str = "", model: str = ""):
        self.addr = addr
        self.timeout_ms = timeout_ms
        if tier:
            self.method = (METHOD_BATCH if tier_lane(tier) == runtime.LANE_BATCH
                           else METHOD_INTERACTIVE)
        else:
            self.method = METHOD_INTERACTIVE if interactive else METHOD_BATCH
        self.retries = retries
        self.tenant = tenant
        self.tier = tier
        self.model = model
        # Extra wait past the budget before declaring a silent stream dead.
        self.read_slack_s = read_slack_s
        self.last_trace_id = 0
        self._ch = runtime.Channel(addr, timeout_ms=timeout_ms, max_retry=0)

    def _resubmittable(self, e: runtime.RpcError) -> bool:
        # A spent deadline cannot fit a replay either.
        return e.retriable and e.code != runtime.ERPCTIMEDOUT

    def _open(self, payload: bytes, attempt_box: list):
        while True:
            attempt_box[0] += 1
            try:
                rs = self._ch.open_stream_rx(SERVICE, self.method, payload)
                self.last_trace_id = rs.trace_id
                return rs
            except runtime.RpcError as e:
                if (self._resubmittable(e)
                        and attempt_box[0] <= self.retries):
                    continue
                raise

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 on_first_token=None) -> Iterator[int]:
        payload = encode_request(prompt, max_new_tokens, self.tenant,
                                 self.tier, self.model)
        attempt_box = [0]
        # Open eagerly: the request queues (and its deadline runs) as soon
        # as generate() is called, not at the first next().
        rs = self._open(payload, attempt_box)
        return self._gen_iter(rs, payload, attempt_box, on_first_token)

    def _gen_iter(self, rs, payload: bytes, attempt_box: list,
                  on_first_token) -> Iterator[int]:
        read_budget_s = self.timeout_ms / 1000.0 + self.read_slack_s
        got_any = False
        try:
            while True:
                try:
                    for tok in self._read_stream(rs, read_budget_s,
                                                 on_first_token):
                        got_any = True
                        yield tok
                    return
                except runtime.RpcError as e:
                    # Resubmit only a tokenless request: replaying half a
                    # generation would duplicate output.
                    if (got_any or not self._resubmittable(e)
                            or attempt_box[0] > self.retries):
                        raise
                    rs.close()
                    rs = self._open(payload, attempt_box)
        finally:
            rs.close()

    def _read_stream(self, rs, budget_s: float, on_first_token):
        first = True
        while True:
            try:
                msg = rs.read(timeout=budget_s)
            except TimeoutError:
                raise runtime.RpcError(
                    runtime.ENORESPONSE,
                    "stream silent past the request budget") from None
            if msg is None:
                raise runtime.RpcError(
                    runtime.ECLOSE, "stream closed without terminal frame")
            if not msg:
                continue
            kind = msg[:1]
            if kind == b"d":
                if first and on_first_token is not None:
                    on_first_token()
                first = False
                yield struct.unpack("<I", msg[1:5])[0]
            elif kind == b"f":
                status = struct.unpack("<I", msg[1:5])[0]
                if status != 0:
                    raise runtime.RpcError(
                        status, msg[5:].decode(errors="replace"))
                return

    def close(self) -> None:
        self._ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def generate(addr: str, prompt: Sequence[int], max_new_tokens: int,
             timeout_ms: int = 30_000, interactive: bool = True):
    """One-shot convenience: the full token list (streamed underneath)."""
    with ServingClient(addr, timeout_ms=timeout_ms,
                       interactive=interactive) as c:
        return list(c.generate(prompt, max_new_tokens))
