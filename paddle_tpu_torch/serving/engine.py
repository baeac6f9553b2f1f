"""ServingEngine — continuous batching over a paged KV cache, on the card.

Port of ``paddle_tpu/serving/engine.py`` in its plain configuration:

    engine = ServingEngine(model, ServingConfig(num_slots=8))
    rid = engine.submit(prompt_ids, SamplingParams(max_new_tokens=32))
    for ev in engine.run_until_done():   # or step() / stream(rid)
        ...

The SCHEDULE — admission, slot packing, preemption — is host-side Python
(serving/scheduler.py) and changes every iteration; the COMPUTE is one
slot-batched decode step over the paged KV pools (models/gpt.py
forward_paged, through the paged-attention kernel) at one fixed shape:
[num_slots, 1] tokens, [num_slots] positions, [num_slots, max_blocks]
block tables.

Prefill pads each prompt up to a length bucket and runs the model's
contiguous-cache forward (causal attention through the flash kernel from
128 tokens up); the prompt's KV is then scattered into its pool blocks. A
prompt longer than every bucket runs at its exact length (counted in
``prefill_fallbacks``). With greedy sampling the emitted stream equals a
solo ``generate`` call's.

Unlike the JAX engine, which threads new pools through a pure function,
this engine updates its KV pools IN PLACE: every write lands in the
tensors ``init_kv_pools`` allocated (or their int8 conversion). Writes of
padding rows and idle slots go to the reserved null block 0 (see
quantization/kv.py).

Quantized serving (``quantize_weights``, ``quantize_kv``): at build, before
the first step, the engine swaps the linears of its own copy of the model
for int8 ones (per-out-channel scales, dequantized on use) and converts its
KV pools to int8 with per-row scales. Prefill still attends its contiguous
fp KV and then scatters it, quantized, into the pool; decode reads the int8
pools through the int8 branch of the paged-attention kernel.
"""
from __future__ import annotations

import copy
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..compile.buckets import bucket_for, default_ladder, normalize_buckets
from ..framework import random as fw_random
from ..framework.device import resolve_device
from ..ops import flash_attention as _flash
from ..ops import paged_attention as _paged
from ..quantization import kv as kvq
from ..quantization.weights import quantize_linears, quantized_bytes_saved
from .errors import QueueFull, RequestError
from .kv_block import KVBlockManager
from .metrics import ServingMetrics
from .scheduler import Request, RequestState, SamplingParams, Scheduler

__all__ = ["ServingConfig", "TokenEvent", "ServingEngine"]

#: terminal requests kept for output()/full_output() before the oldest are
#: dropped, so sustained traffic cannot grow host memory without bound
RETAIN_DONE = 1024


class ServingConfig:
    def __init__(self, num_slots: int = 4, block_size: int = 16,
                 num_blocks: int = 64,
                 max_blocks_per_seq: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 quantize_weights: bool = False,
                 quantize_kv: bool = False):
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        # bound on one sequence's block table — fixes the decode step's
        # [num_slots, max_blocks] table shape
        self.max_blocks_per_seq = (int(max_blocks_per_seq)
                                   if max_blocks_per_seq is not None
                                   else self.num_blocks - 1)
        # waiting-queue bound — submit raises QueueFull beyond it
        self.max_queue = None if max_queue is None else int(max_queue)
        # prefill bucket lengths (rounded up to whole blocks); None -> a
        # geometric ladder up to the per-sequence capacity
        self.prefill_buckets = (None if prefill_buckets is None
                                else [int(b) for b in prefill_buckets])
        # int8 per-out-channel linear weights, dequantized on use (the
        # engine quantizes its own copy of the model)
        self.quantize_weights = bool(quantize_weights)
        # int8 paged-KV pools with per-row absmax scales in a side pool;
        # decode reads them through the paged kernel's int8 branch
        self.quantize_kv = bool(quantize_kv)


class TokenEvent(NamedTuple):
    req_id: int
    token: int
    finished: bool


class ServingEngine:
    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.config = c = config or ServingConfig()
        model.eval()
        self._mcfg = model.gpt.cfg
        self.metrics = ServingMetrics()
        self.blocks = KVBlockManager(c.num_blocks, c.block_size)
        self.scheduler = Scheduler(self.blocks, c.num_slots)
        self._kpools, self._vpools = model.gpt.init_kv_pools(
            c.num_blocks, c.block_size)
        # quantized serving: once, here, before the first step; the
        # counters record the bytes the int8 layouts free (KV: against
        # the fp pools; weights: against f32, as the JAX engine counts)
        if c.quantize_kv:
            fp_bytes = sum(kvq.pool_bytes(p)
                           for p in self._kpools + self._vpools)
            self._kpools = [kvq.quantize_pool(p) for p in self._kpools]
            self._vpools = [kvq.quantize_pool(p) for p in self._vpools]
            saved = fp_bytes - sum(kvq.pool_bytes(p)
                                   for p in self._kpools + self._vpools)
            self.metrics.kv_quant_bytes_saved.inc(max(0, saved))
        if c.quantize_weights:
            model = copy.deepcopy(model)
            quantize_linears(model)
            self.metrics.weight_quant_bytes_saved.inc(
                quantized_bytes_saved(model))
        self.model = model
        self._requests: Dict[int, Request] = {}
        self._next_id = 0
        self._done_ids = deque()  # terminal req ids, retirement order
        cap = min(c.max_blocks_per_seq,
                  self.blocks.usable_blocks) * c.block_size
        if self._mcfg.position_embedding == "learned":
            cap = min(cap, self._mcfg.max_position_embeddings)
        self._buckets = (normalize_buckets(c.prefill_buckets, c.block_size,
                                           cap)
                         if c.prefill_buckets is not None
                         else default_ladder(c.block_size, cap))

    # -- requests -----------------------------------------------------------
    def submit(self, prompt_ids, params: Optional[SamplingParams] = None,
               **kw) -> int:
        """Queue a request; returns its id. kw is shorthand for
        SamplingParams fields (max_new_tokens=..., top_k=..., ...)."""
        if params is None:
            params = SamplingParams(**kw)
        elif kw:
            raise ValueError("pass SamplingParams or kwargs, not both")
        c = self.config
        if (c.max_queue is not None
                and self.scheduler.queue_depth >= c.max_queue):
            self.metrics.requests_rejected.inc()
            raise QueueFull(self.scheduler.queue_depth, c.max_queue)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        total = prompt.size + params.max_new_tokens
        need = self.blocks.blocks_for_tokens(total)
        cap = min(c.max_blocks_per_seq, self.blocks.usable_blocks)
        if need > cap:
            raise ValueError(
                f"request needs {need} KV blocks for {total} tokens; "
                f"capacity per sequence is {cap} "
                f"({c.block_size}-token blocks)")
        if (self._mcfg.position_embedding == "learned"
                and total > self._mcfg.max_position_embeddings):
            raise ValueError(
                f"serving: {total} tokens exceed max_position_embeddings="
                f"{self._mcfg.max_position_embeddings}")
        req = Request(self._next_id, prompt, params)
        self._next_id += 1
        req.t_submit = time.perf_counter()
        self._requests[req.req_id] = req
        self.scheduler.submit(req)
        self.metrics.requests_submitted.inc()
        return req.req_id

    def note_logit_drift(self, drift: float) -> None:
        """Record an observed |quantized - fp32| logit drift (checks report
        theirs here); the gauge keeps the worst value seen."""
        g = self.metrics.quant_logit_drift_max
        g.set(max(float(g.value), float(drift)))

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self) -> List[TokenEvent]:
        """One engine iteration: admit and prefill whatever fits, then one
        slot-batched decode step over the running set. Returns the tokens
        emitted this iteration. A prefill that raises fails only its own
        request."""
        events: List[TokenEvent] = []
        self.scheduler.admit()
        for _, req in self.scheduler.running():
            if not req.prefilling:
                continue
            try:
                events.extend(self._prefill(req))
            except Exception as e:  # isolate to this request
                self._fail(req, f"prefill error: {e!r}")
        if self.scheduler.num_running:
            events.extend(self._decode_once())
        self.metrics.flash_fwd_launches.set(_flash.KERNEL.launches)
        self.metrics.paged_attention_launches.set(_paged.KERNEL.launches)
        self.metrics.paged_attention_int8_launches.set(
            _paged.INT8_KERNEL.launches)
        return events

    def run_until_done(self) -> List[TokenEvent]:
        """Drive step() until every submitted request has finished."""
        events: List[TokenEvent] = []
        while self.has_work():
            events.extend(self.step())
        return events

    def stream(self, req_id: int) -> Iterator[int]:
        """Yield request `req_id`'s completion tokens as they are emitted,
        stepping the engine (and serving everything else in flight) as
        needed. Raises RequestError if the request FAILED."""
        req = self._requests[req_id]
        served = 0
        while True:
            while served < len(req.out_tokens):
                yield req.out_tokens[served]
                served += 1
            if req.done:
                if req.state is RequestState.FAILED:
                    raise RequestError(req.req_id, req.state, req.error or "")
                return
            self.step()

    def output(self, req_id: int) -> np.ndarray:
        """Completion tokens emitted so far (int32 [T])."""
        return np.asarray(self._requests[req_id].out_tokens, np.int32)

    def full_output(self, req_id: int) -> np.ndarray:
        """prompt + completion, the `generate` return layout."""
        req = self._requests[req_id]
        return np.concatenate([req.prompt,
                               np.asarray(req.out_tokens, np.int32)])

    def request(self, req_id: int) -> Request:
        return self._requests[req_id]

    def _retire(self, req: Request) -> None:
        """Terminal bookkeeping + retention: beyond RETAIN_DONE retired
        requests, the oldest are released."""
        self._done_ids.append(req.req_id)
        while len(self._done_ids) > RETAIN_DONE:
            self._requests.pop(self._done_ids.popleft(), None)

    def _fail(self, req: Request, why: str) -> None:
        if self.scheduler.abort(req, why):
            self.metrics.requests_failed.inc()
            self._retire(req)

    # -- prefill ------------------------------------------------------------
    def _prefill(self, req: Request) -> List[TokenEvent]:
        """Prefill one admitted request at its bucket length (or its exact
        length when no bucket holds it) and sample its first token."""
        t0 = time.perf_counter()
        S = req.prompt.size
        L = bucket_for(S, self._buckets)
        if L is None:
            self.metrics.prefill_fallbacks.inc()
            L = S
        lg = self._prefill_padded(req, L)
        req.num_cached = S
        req.prefilling = False
        self.metrics.prefills.inc()
        events = self._emit([(req, 0)], lg)
        self.metrics.observe_prefill(L, time.perf_counter() - t0)
        return events

    @torch.inference_mode()
    def _prefill_padded(self, req: Request, L: int) -> torch.Tensor:
        """Contiguous-cache forward over the prompt padded to L, the KV
        scattered block-wise into the request's pool blocks, and the f32
        logits [1, V] of the last REAL token. Causality makes the pad
        inert: rows < S never attend rows >= S. Pad KV lands in the tail of
        the last real block (positions >= num_cached, never visible to
        decode) and in the null block the padded table tail points at."""
        c = self.config
        S = req.prompt.size
        ids = torch.zeros((1, L), dtype=torch.int64)
        ids[0, :S] = torch.from_numpy(req.prompt.astype(np.int64))
        caches = self.model.gpt.init_caches(1, L)
        h, caches = self.model.gpt(ids.to(self.device), caches=caches, pos=0)
        nblk = -(-L // c.block_size)
        table = torch.zeros(nblk, dtype=torch.int64)
        table[:len(req.block_table)] = torch.as_tensor(req.block_table)
        table = table.to(self.device)
        pad = nblk * c.block_size - L
        for i in range(self._mcfg.num_layers):
            for pools, kv in ((self._kpools, "k"), (self._vpools, "v")):
                val = caches[i][kv][0]  # [L, H, D]
                if pad:
                    val = torch.nn.functional.pad(val, (0, 0, 0, 0, 0, pad))
                kvq.set_block_rows(
                    pools[i], table,
                    val.reshape(nblk, c.block_size, *val.shape[1:]))
        return self.model.forward_head(h[:, S - 1:S])[:, -1].float()

    # -- decode -------------------------------------------------------------
    def _decode_once(self) -> List[TokenEvent]:
        c = self.config
        t0 = time.perf_counter()
        preempted = self.scheduler.ensure_decode_blocks()
        self.metrics.preemptions.inc(len(preempted))
        ready = [(s, r) for s, r in self.scheduler.running()
                 if not r.prefilling]
        if not ready:
            return []
        tokens = np.zeros((c.num_slots, 1), np.int64)
        positions = np.zeros((c.num_slots,), np.int32)
        tables = np.zeros((c.num_slots, c.max_blocks_per_seq), np.int32)
        for slot, req in ready:
            tokens[slot, 0] = req.last_token
            positions[slot] = req.num_cached
            tables[slot, :len(req.block_table)] = req.block_table
        dev = self.device
        with torch.inference_mode():
            h, _, _ = self.model.gpt.forward_paged(
                torch.from_numpy(tokens).to(dev), self._kpools,
                self._vpools, torch.from_numpy(tables).to(dev),
                torch.from_numpy(positions).to(dev), c.block_size)
            lg = self.model.forward_head(h)[:, -1].float()
        self.metrics.decode_steps.inc()
        for _, req in ready:
            req.num_cached += 1
        events = self._emit([(req, slot) for slot, req in ready], lg)
        self.metrics.decode_step_s.observe(time.perf_counter() - t0)
        return events

    # -- sampling / bookkeeping ---------------------------------------------
    def _emit(self, rows, lg: torch.Tensor) -> List[TokenEvent]:
        """Advance each (request, logits row) pair. Greedy picks and the
        non-finite guard for every row cross to the host in one copy."""
        with torch.inference_mode():
            picks = torch.stack([lg.argmax(-1),
                                 torch.isfinite(lg).all(-1).long()]).cpu()
        events: List[TokenEvent] = []
        for req, row in rows:
            events.extend(self._advance(req, lg[row:row + 1],
                                        int(picks[0, row]),
                                        bool(picks[1, row])))
        return events

    def _advance(self, req: Request, lg, greedy: int,
                 finite: bool) -> List[TokenEvent]:
        """Consume one step's logits row for `req`: replay a forced token
        (post-preemption recompute — already emitted; the sampling stream
        still advances) or sample, emit, and maybe finish."""
        p = req.params
        if req.forced:
            tok = int(req.forced.popleft())
            if p.top_k > 0:
                fw_random.draw(req.generator, 1)
            req.last_token = tok
            return []
        # a poisoned row fails ONLY its own request
        if not finite:
            self._fail(req, "non-finite logits")
            return []
        tok = greedy if p.top_k <= 0 else self._sample(req, lg)
        req.out_tokens.append(tok)
        req.last_token = tok
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
            self.metrics.ttft_s.observe(now - req.t_submit)
        else:
            self.metrics.inter_token_s.observe(now - req.t_last)
        req.t_last = now
        self.metrics.tokens_emitted.inc()
        done = (len(req.out_tokens) >= p.max_new_tokens
                or (p.eos_token_id is not None and tok == p.eos_token_id))
        if done:
            self.scheduler.finish(req)
            self.metrics.requests_finished.inc()
            self._retire(req)
        return [TokenEvent(req.req_id, tok, done)]

    def _sample(self, req: Request, lg) -> int:
        """Top-k draw on a [1, V] logits row — generate()'s math."""
        p = req.params
        return int(fw_random.sample_top_k(lg, p.top_k, p.temperature,
                                          req.generator)[0])
