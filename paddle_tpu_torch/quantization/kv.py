"""Paged KV pools, fp or int8 with a per-row f32 scales side-pool: their
reads and writes.

Port of ``paddle_tpu/quantization/kv.py``. An fp pool is a
[num_blocks, block_size, H, D] tensor; a quantized pool is
``QuantizedKV(data=int8 [NB, BS, H, D], scale=f32 [NB, BS, H, 1])``, one
absmax scale per (pool row, head) reduced over the head dim and addressed
by the same (block, offset) coordinates as the payload, so every
block-granular operation carries the scales with the rows. Every helper
takes either kind; on an fp pool it is the plain op of the fp engine.

Unlike the JAX package, which returns new pools, the writes here update
the pools IN PLACE: payload and scales land in the tensors that
``quantize_pool`` or ``init_kv_pools`` allocated. Values narrower than the
pool's head dim (pools allocated at the next head dim the kernels are
built for) are zero-padded on write.

Null-block invariant: padding rows, idle slots and rows past a block table
are routed to block 0, so one write may scatter several rows to the same
(0, offset). On CUDA, ``index_put_`` with duplicate indices writes in no
fixed order (and a quantized pool's payload and scale of such a row may
come from different writers); that is harmless only because block 0 is
never read as real context. Callers never route a real row there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.comm_compress import dequant_absmax, quant_absmax

__all__ = ["QuantizedKV", "copy_block", "gather_blocks", "is_quantized",
           "pool_block_bytes", "pool_bytes", "quantize_pool",
           "rows_to_host", "set_block_rows", "set_rows_from_host",
           "write_rows"]


class QuantizedKV(NamedTuple):
    """Int8 KV pool and its scales side-pool."""

    data: torch.Tensor   # int8 [num_blocks, block_size, H, D]
    scale: torch.Tensor  # f32  [num_blocks, block_size, H, 1]

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):  # element type of the logical pool
        return self.data.dtype

    @property
    def device(self):
        return self.data.device


def is_quantized(pool) -> bool:
    return isinstance(pool, QuantizedKV)


def _tensors(pool):
    """The tensors that hold a pool: (data, scale), or the fp pool."""
    return tuple(pool) if is_quantized(pool) else (pool,)


def quantize_pool(pool, bits: int = 8) -> QuantizedKV:
    """One-time conversion of an fp pool (at engine build: the all-zero
    pool quantizes to exact zeros)."""
    if is_quantized(pool):
        return pool
    return QuantizedKV(*quant_absmax(pool, bits=bits, axis=-1))


def _fit(values: torch.Tensor, pool) -> torch.Tensor:
    """values zero-padded on the head dim to the pool's."""
    extra = pool.shape[-1] - values.shape[-1]
    return torch.nn.functional.pad(values, (0, extra)) if extra else values


def write_rows(pool, blk: torch.Tensor, off: torch.Tensor,
               values: torch.Tensor) -> None:
    """Write ``values`` [..., H, D] at pool rows (blk, off) — the
    decode-step scatter; blk and off share values' leading shape. A
    quantized pool takes each row quantized (absmax over D), payload and
    scale at the same coordinates."""
    idx = (blk.long(), off.long())
    values = _fit(values, pool)
    if not is_quantized(pool):
        pool[idx] = values.to(pool.dtype)
        return
    q, s = quant_absmax(values, axis=-1)
    pool.data[idx] = q
    pool.scale[idx] = s


def set_block_rows(pool, table: torch.Tensor, values: torch.Tensor) -> None:
    """Whole-block scatter (prefill): ``values`` [nblk, BS, H, D] fp rows
    written at block ids ``table`` [nblk], quantized per row for a
    quantized pool."""
    idx = table.long()
    values = _fit(values, pool)
    if not is_quantized(pool):
        pool[idx] = values.to(pool.dtype)
        return
    q, s = quant_absmax(values, axis=-1)
    pool.data[idx] = q
    pool.scale[idx] = s


def gather_blocks(pool, table: torch.Tensor) -> torch.Tensor:
    """Rows at block ids ``table`` (shape table.shape + [BS, H, D]):
    as stored for an fp pool, dequantized to f32 for a quantized one."""
    idx = table.long()
    if not is_quantized(pool):
        return pool[idx]
    return dequant_absmax(pool.data[idx], pool.scale[idx])


def copy_block(pool, src: int, dst: int) -> None:
    """Duplicate one block's rows (copy-on-write fork): payload and
    scales, so the fork is bit-identical to its parent."""
    for t in _tensors(pool):
        t[dst] = t[src]


def rows_to_host(pool, table: torch.Tensor):
    """Host copy of the rows at ``table`` (a handoff payload): an ndarray
    for an fp pool, {"data", "scale"} ndarrays for a quantized one, so the
    scales travel verbatim."""
    idx = table.long()
    if not is_quantized(pool):
        return pool[idx].cpu().numpy()
    return {"data": pool.data[idx].cpu().numpy(),
            "scale": pool.scale[idx].cpu().numpy()}


def set_rows_from_host(pool, table: torch.Tensor, val) -> None:
    """Write a handoff payload's rows at ``table``. A quantized payload
    into a quantized pool is a verbatim copy of payload and scales; an fp
    payload into a quantized pool is quantized; a quantized payload into
    an fp pool is dequantized; fp into fp is the plain scatter."""
    idx = table.long()
    dev = pool.device
    if isinstance(val, dict):
        data = torch.as_tensor(np.asarray(val["data"]), device=dev)
        scale = torch.as_tensor(np.asarray(val["scale"]), device=dev)
        if is_quantized(pool):
            pool.data[idx] = data.to(pool.data.dtype)
            pool.scale[idx] = scale.to(pool.scale.dtype)
        else:
            pool[idx] = dequant_absmax(data, scale).to(pool.dtype)
        return
    rows = torch.as_tensor(np.asarray(val), device=dev)
    if is_quantized(pool):
        set_block_rows(pool, table, rows)
    else:
        pool[idx] = rows.to(pool.dtype)


def pool_bytes(pool) -> int:
    """Device bytes of a pool (payload and scales)."""
    return sum(t.numel() * t.element_size() for t in _tensors(pool))


def pool_block_bytes(pool) -> int:
    """Device bytes per block (payload and scales): the admission signal's
    cost of one more block."""
    return pool_bytes(pool) // max(pool.shape[0], 1)
