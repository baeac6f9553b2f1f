"""Paged KV pool reads and writes (fp pools).

Port of the fp paths of ``paddle_tpu/quantization/kv.py``. Pools are
[num_blocks, block_size, H, D] tensors and the writes here update them IN
PLACE (the JAX package returns new pools instead).

Null-block invariant: padding rows, idle slots and rows past a block table
are routed to block 0, so one write may scatter several rows to the same
(0, offset). On CUDA, ``index_put_`` with duplicate indices writes in no
fixed order; that is harmless only because block 0 is never read as real
context. Callers never route a real row there.
"""
from __future__ import annotations

import torch

__all__ = ["write_rows", "set_block_rows", "gather_blocks", "copy_block"]


def write_rows(pool: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
               values: torch.Tensor) -> None:
    """Write ``values`` [..., H, D] at pool rows (blk, off) — the
    decode-step scatter; blk and off share values' leading shape."""
    pool[blk.long(), off.long()] = values.to(pool.dtype)


def set_block_rows(pool: torch.Tensor, table: torch.Tensor,
                   values: torch.Tensor) -> None:
    """Whole-block scatter (prefill): ``values`` [nblk, BS, H, D] written
    at block ids ``table`` [nblk]."""
    pool[table.long()] = values.to(pool.dtype)


def gather_blocks(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows at block ids ``table`` (shape table.shape + [BS, H, D])."""
    return pool[table.long()]


def copy_block(pool: torch.Tensor, src: int, dst: int) -> None:
    """Duplicate one block's rows (copy-on-write fork)."""
    pool[dst] = pool[src]
