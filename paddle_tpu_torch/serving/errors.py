"""Typed serving failures — the engine's error contract.

- `QueueFull`    — admission rejected: the bounded waiting queue is at
                   capacity. The request was never created.
- `RequestError` — a single request reached a terminal failure state
                   (FAILED); carries `req_id` and `state`. Raised by
                   `stream()`; polling callers read `request(rid).state`
                   and `.error` instead.
"""
from __future__ import annotations

__all__ = ["ServingError", "QueueFull", "RequestError"]


class ServingError(RuntimeError):
    """Base class for all serving-layer failures."""


class QueueFull(ServingError):
    def __init__(self, depth: int, limit: int):
        self.depth = depth
        self.limit = limit
        super().__init__(
            f"admission queue full: {depth} waiting >= max_queue={limit}")


class RequestError(ServingError):
    def __init__(self, req_id: int, state, error: str = ""):
        self.req_id = req_id
        self.state = state
        self.error = error
        super().__init__(
            f"request {req_id} {getattr(state, 'value', state)}"
            + (f": {error}" if error else ""))
