"""Serving metrics: the counters and latency histograms the engine's loop
touches, in a plain per-engine registry (engines in one process never
share counters)."""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "ServingMetrics"]


class Counter:
    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """count and sum are exact; percentiles come from the newest `window`
    observations, so a long run keeps bounded memory."""

    def __init__(self, name: str, window: int = 4096):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._recent = deque(maxlen=int(window))

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += float(v)
        self._recent.append(float(v))

    def summary(self) -> dict:
        if not self._recent:
            return {"count": 0}
        a = np.asarray(self._recent)
        return {"count": self.count, "mean": self.sum / self.count,
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}


class ServingMetrics:
    def __init__(self):
        # latency (seconds)
        self.ttft_s = Histogram("ttft_s")                # submit -> first token
        self.inter_token_s = Histogram("inter_token_s")  # gap between tokens
        # device-complete step times (each ends in a host copy of the
        # sampled tokens): one decode step, and one prefill per bucket
        self.decode_step_s = Histogram("decode_step_s")
        self.prefill_s = {}  # bucket length -> Histogram
        # counters
        self.requests_submitted = Counter("requests_submitted")
        self.requests_finished = Counter("requests_finished")
        self.requests_rejected = Counter("requests_rejected")
        self.requests_failed = Counter("requests_failed")
        self.tokens_emitted = Counter("tokens_emitted")
        self.prefills = Counter("prefills")
        self.decode_steps = Counter("decode_steps")
        self.preemptions = Counter("preemptions")
        # prompts longer than the largest bucket take the exact-length
        # path; a growing number means the bucket set is too small
        self.prefill_fallbacks = Counter("prefill_fallbacks")
        # process-wide launches of the attention kernels, read after
        # every engine step (they stay 0 on the CPU, where the plain
        # versions run)
        self.flash_fwd_launches = Gauge("flash_fwd_launches")
        self.paged_attention_launches = Gauge("paged_attention_launches")
        self.paged_attention_int8_launches = Gauge(
            "paged_attention_int8_launches")
        # quantized serving: device bytes the int8 layouts freed, recorded
        # once at engine build (0 while quantization is off), and the
        # worst |quantized - fp32| logit drift a check has reported
        # (ServingEngine.note_logit_drift)
        self.kv_quant_bytes_saved = Counter("kv_quant_bytes_saved")
        self.weight_quant_bytes_saved = Counter("weight_quant_bytes_saved")
        self.quant_logit_drift_max = Gauge("quant_logit_drift_max")

    def observe_prefill(self, bucket: int, seconds: float) -> None:
        h = self.prefill_s.get(bucket)
        if h is None:
            h = self.prefill_s[bucket] = Histogram(f"prefill_s_{bucket}")
        h.observe(seconds)

    def summary_dict(self) -> dict:
        out = {}
        for m in vars(self).values():
            if isinstance(m, dict):
                out["prefill_s"] = {k: h.summary()
                                    for k, h in sorted(m.items())}
            elif isinstance(m, Histogram):
                out[m.name] = m.summary()
            else:
                out[m.name] = m.value
        return out
