"""Continuous-batching GPT serving over a paged KV cache."""
from .engine import ServingConfig, ServingEngine, TokenEvent
from .errors import QueueFull, RequestError, ServingError
from .kv_block import NULL_BLOCK, BlockError, KVBlockManager
from .scheduler import Request, RequestState, SamplingParams, Scheduler

__all__ = ["ServingConfig", "ServingEngine", "TokenEvent", "QueueFull",
           "RequestError", "ServingError", "NULL_BLOCK", "BlockError",
           "KVBlockManager", "Request", "RequestState", "SamplingParams",
           "Scheduler"]
