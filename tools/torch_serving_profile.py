#!/usr/bin/env python3
"""Where the time of the PyTorch port's GPT serving goes, on one GPU.

Run from the root of the repository on a machine with a CUDA card:

    python tools/torch_serving_profile.py [--steps 32] [--quantize]
                                          [--json PATH]

GPT-350M in bf16 (random weights from seed 0) behind ServingEngine with the
serving configuration of chip_smoke.py; with --quantize the engine serves
int8 linears and int8 KV pools (quantize_weights, quantize_kv). Eight requests with prompts of
512..1000 tokens fill the eight slots; after a warm-up it measures

  decode — `steps` engine steps that each run one slot-batched decode step:
           wall ms per step (each step ends in the sampled tokens' copy to
           the host), then the same number of steps under torch.profiler:
           device time per kernel name and kernel launches per step;
  prefill — bucket-1024 prefills the same way.

The device's busy share is its kernel time over the UNPROFILED wall time
(the profiler's own host cost inflates the profiled window's wall time,
which is printed too).

It prints one line per finding and, with --json, writes them all to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GPT350M = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_heads=16, max_position_embeddings=2048, dropout=0.0)
SERVE = dict(num_slots=8, block_size=16, num_blocks=1024,
             max_blocks_per_seq=128)


def _device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def wall_ms(fn, n: int) -> float:
    """Wall ms per call of fn() (each call ends in a host copy)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_window(fn, n: int) -> dict:
    """Run fn() n times unprofiled, then n times under torch.profiler:
    wall ms per call, device ms per call by kernel name, launches, and
    the busy share (device ms / unprofiled wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wall = wall_ms(fn, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = wall_ms(fn, n)
    kernels = []
    for avg in prof.key_averages():
        us = _device_us(avg)
        if us > 0 and avg.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((avg.key, us, avg.count))
    kernels.sort(key=lambda k: -k[1])
    device = sum(us for _, us, _ in kernels) / n / 1e3
    return {"wall_ms_per_call": wall,
            "profiled_wall_ms_per_call": profiled,
            "device_ms_per_call": device,
            "device_busy_share": device / wall if device else None,
            "launches_per_call": sum(c for _, _, c in kernels) / n,
            "top_kernels": [{"name": k[:90], "ms_per_call": us / n / 1e3,
                             "launches_per_call": c / n}
                            for k, us, c in kernels[:12]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weights and int8 KV pools")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, SamplingParams,
                                  ServingConfig, ServingEngine)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = GPTConfig(**GPT350M)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    conf = ServingConfig(**SERVE, quantize_weights=args.quantize,
                         quantize_kv=args.quantize)
    eng = ServingEngine(model, conf, device=dev)
    for n in np.linspace(512, 1000, 8).astype(int):
        eng.submit(rng.integers(0, cfg.vocab_size, n),
                   SamplingParams(max_new_tokens=3 * args.steps + 8))
    eng.step()  # admits and prefills all eight, then one decode step
    for _ in range(4):
        eng.step()  # warm-up
    result = {"card": card, "torch": torch.__version__,
              "quantize": args.quantize,
              "decode": profile_window(eng.step, args.steps)}

    eng2 = ServingEngine(model, conf, device=dev)
    prompt = rng.integers(0, cfg.vocab_size, 1000)

    def one_prefill():
        rid = eng2.submit(prompt, SamplingParams(max_new_tokens=1))
        eng2.step()  # the prefill samples the only token
        if not eng2.request(rid).finished:
            raise RuntimeError(f"prefill request {rid} did not finish")

    one_prefill()  # warm-up
    result["prefill_1024"] = profile_window(one_prefill, 8)

    for phase in ("decode", "prefill_1024"):
        r = result[phase]
        share = r["device_busy_share"]
        print(f"[{card}] {'int8 ' if args.quantize else ''}{phase}: wall {r['wall_ms_per_call']:.3f} ms "
              f"({r['profiled_wall_ms_per_call']:.3f} ms profiled), "
              f"device {r['device_ms_per_call']:.3f} ms, busy share "
              f"{'not measured' if share is None else f'{share:.3f}'}, "
              f"{r['launches_per_call']:.0f} launches per call")
        for k in r["top_kernels"]:
            print(f"[{card}]   {k['ms_per_call']:.4f} ms "
                  f"x{k['launches_per_call']:.0f} {k['name']}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
