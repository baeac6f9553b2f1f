"""Continuous-batching scheduler (waiting/running queues over batch slots).

Iteration-level scheduling: every engine iteration re-packs the active
sequences into a FIXED number of batch slots (so the slot-batched decode
step keeps one shape), admits waiting prefills whenever a slot and enough
KV blocks are free, retires sequences the moment they hit EOS or
max_new_tokens, and — when the block pool runs dry mid-decode — preempts
the NEWEST running sequence back to the waiting queue (recompute-style
preemption: its blocks are freed; on re-admission the prompt is
re-prefilled and the already-emitted tokens are replayed as forced decode
steps, which keeps the emitted stream identical to an uninterrupted run).

The scheduler is pure bookkeeping: it owns Request state transitions and
the KVBlockManager, and never touches the model — serving/engine.py asks
it what to prefill/decode and executes the math.
"""
from __future__ import annotations

import bisect
import enum
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..framework import random as fw_random
from .kv_block import KVBlockManager

__all__ = ["RequestState", "TERMINAL_STATES", "SamplingParams", "Request",
           "Scheduler"]

#: head-of-line relief: how many over-budget waiting requests an admissible
#: later request may jump past (the JAX engine's default)
ADMIT_LOOKPAST = 2


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"    # completed normally (EOS / max_new_tokens)
    FAILED = "failed"        # isolated error (e.g. non-finite logits)


#: States a request never leaves; its KV blocks and slot are released.
TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.FAILED})


class SamplingParams:
    """Per-request decode parameters (mirrors GPTForCausalLM.generate).
    Greedy when top_k == 0, else top-k sampling from a generator seeded
    with `seed`."""

    def __init__(self, max_new_tokens: int = 16, temperature: float = 1.0,
                 top_k: int = 0, seed=None, eos_token_id=None):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = seed
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)

    def __repr__(self):
        return (f"SamplingParams(max_new_tokens={self.max_new_tokens}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"seed={self.seed}, eos_token_id={self.eos_token_id})")


class Request:
    """One in-flight generation request."""

    def __init__(self, req_id: int, prompt_ids: np.ndarray,
                 params: SamplingParams):
        self.req_id = req_id
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.params = params
        self.state = RequestState.WAITING
        self.out_tokens: List[int] = []     # emitted completion tokens
        self.forced = deque()               # replay queue after preemption
        self.block_table: List[int] = []    # pool block ids, in order
        self.num_cached = 0                 # tokens currently in the KV pool
        self.prefilling = False             # prompt not fully in the pool yet
        self.slot: Optional[int] = None
        self.arrival: Optional[int] = None  # admission priority (FIFO)
        self.last_token: Optional[int] = None  # next decode step's input
        self.preempt_count = 0
        self.generator = None               # top-k sampling stream
        self.reset_rng()
        self.error: Optional[str] = None    # why FAILED
        self.t_submit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None

    def reset_rng(self) -> None:
        """Rewind the sampling stream to its submission state (top-k
        requests only; greedy requests draw nothing)."""
        if self.params.top_k > 0:
            self.generator = fw_random.seed(self.params.seed)

    @property
    def finished(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def done(self) -> bool:
        """Terminal (finished or failed)."""
        return self.state in TERMINAL_STATES

    def __repr__(self):
        return (f"Request(id={self.req_id}, state={self.state.value}, "
                f"prompt={self.prompt.size}, out={len(self.out_tokens)}, "
                f"slot={self.slot}, blocks={len(self.block_table)})")


class Scheduler:
    def __init__(self, blocks: KVBlockManager, num_slots: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.blocks = blocks
        self.num_slots = int(num_slots)
        self.waiting: deque = deque()
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self.preempted_log: List[int] = []  # req ids, in preemption order
        self._arrival_counter = 0

    # -- queue state --------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return sum(r is not None for r in self.slots)

    def running(self) -> List[Tuple[int, Request]]:
        """(slot, request) pairs in slot order."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    # -- transitions --------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrival = self._arrival_counter
        self._arrival_counter += 1
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def admit(self) -> List[Request]:
        """Pop admissible waiting requests into free slots, allocating
        their prompt blocks. FIFO with bounded look-past: an over-budget
        prompt at the queue front does not starve everything behind it —
        up to ADMIT_LOOKPAST later admissible requests may jump it.
        Returns requests to prefill."""
        admitted = []
        while self.waiting:
            try:
                slot = self.slots.index(None)
            except ValueError:
                break
            pick = None
            for idx in range(min(len(self.waiting), ADMIT_LOOKPAST + 1)):
                nblk = self.blocks.blocks_for_tokens(
                    self.waiting[idx].prompt.size)
                if self.blocks.can_alloc(nblk):
                    pick = idx
                    break
            if pick is None:
                break
            req = self.waiting[pick]
            del self.waiting[pick]
            req.block_table = self.blocks.alloc(nblk, owner=req.req_id)
            req.num_cached = 0
            req.prefilling = True
            req.slot = slot
            req.state = RequestState.RUNNING
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    def ensure_decode_blocks(self) -> List[Request]:
        """Before a decode iteration: every decoding sequence gets a block
        for its next token, preempting the newest running sequence(s)
        while the pool is dry. Sequences still prefilling are skipped
        (their prompt blocks were allocated at admission). Returns the
        preempted requests (possibly a requester itself)."""
        preempted: List[Request] = []
        for req in [r for r in self.slots if r is not None]:
            if req.state is not RequestState.RUNNING:
                continue  # preempted by an earlier iteration of this loop
            if req.prefilling:
                continue
            need = (self.blocks.blocks_for_tokens(req.num_cached + 1)
                    - len(req.block_table))
            if need <= 0:
                continue  # current block still has room
            while not self.blocks.can_alloc(need):
                victim = self._newest_running()
                self._preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
            if req.state is RequestState.RUNNING:
                req.block_table.extend(
                    self.blocks.alloc(need, owner=req.req_id))
        return preempted

    def finish(self, req: Request) -> None:
        self._release(req)
        req.state = RequestState.FINISHED

    def abort(self, req: Request, error: str = "") -> bool:
        """Terminal FAILED transition: frees exactly the request's own
        blocks and slot — co-batched requests are untouched. Returns False
        (no-op) if already terminal."""
        if req.state in TERMINAL_STATES:
            return False
        if req.state is RequestState.WAITING:
            self.waiting.remove(req)
        self._release(req)
        req.forced = deque()
        req.state = RequestState.FAILED
        req.error = error or req.error
        return True

    def _release(self, req: Request) -> None:
        if req.block_table:
            self.blocks.free(req.block_table, owner=req.req_id)
            req.block_table = []
        req.num_cached = 0
        req.prefilling = False
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None

    # -- preemption ---------------------------------------------------------
    def _newest_running(self) -> Request:
        live = [r for r in self.slots if r is not None]
        return max(live, key=lambda r: r.arrival)

    def _preempt(self, req: Request) -> None:
        """Recompute-preemption: drop the KV state, keep the emitted tokens
        as a forced-replay queue, and re-queue by original arrival order."""
        self._release(req)
        req.state = RequestState.WAITING
        req.forced = deque(req.out_tokens)
        req.last_token = None
        # rewind the sampling stream: forced replay draws once per replayed
        # token, so sampling after replay sees exactly the stream position
        # an uninterrupted run would
        req.reset_rng()
        req.preempt_count += 1
        self.preempted_log.append(req.req_id)
        idx = bisect.bisect_left([w.arrival for w in self.waiting],
                                 req.arrival)
        self.waiting.insert(idx, req)
