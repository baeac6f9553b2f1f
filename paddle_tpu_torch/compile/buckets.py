"""Prefill shape buckets.

Every prompt is padded up to one of a small set of bucket lengths, so the
prefill runs at a bounded set of shapes however many distinct prompt
lengths arrive. Framework-free: plain integers in, plain integers out.

- ``bucket_for`` — the smallest bucket that holds a length, or None when
  the length overflows the set (the caller's exact-length fallback).
- ``normalize_buckets`` — the validator every bucket source goes through.
- ``default_ladder`` — the geometric ladder used before any traffic has
  been seen: each bucket twice the last, capped.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

__all__ = ["bucket_for", "default_ladder", "normalize_buckets"]


def _ceil_to(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n overflows the set."""
    for b in buckets:
        if n <= b:
            return int(b)
    return None


def normalize_buckets(lengths: Iterable[int], multiple: int,
                      cap: int) -> List[int]:
    """Round each length up to a whole ``multiple`` (a KV-block boundary),
    drop non-positive and over-``cap`` entries, dedupe, sort ascending."""
    out = set()
    for b in lengths:
        r = _ceil_to(b, multiple)
        if 0 < int(b) and r <= int(cap):
            out.add(r)
    return sorted(out)


def default_ladder(multiple: int, cap: int) -> List[int]:
    """Geometric ladder: multiple, 2x, 4x, ... capped at (and always
    including) ``cap`` rounded to the multiple, so every admissible length
    has a bucket."""
    cap = _ceil_to(max(int(cap), int(multiple)), multiple)
    out: List[int] = []
    b = int(multiple)
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out
