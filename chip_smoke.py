#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every CUDA kernel of the serving path with nvcc, all
               sources at once, and print the build seconds;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card at the serving path's shapes; print max-abs error,
               tolerance, kernel ms, plain ms, the bound and the time of
               PyTorch's own attention call where one computes the same;
  3. serve   — 16 requests (prompts of 100..1000 tokens, 64 greedy new
               tokens each) through ServingEngine on GPT-350M in bf16
               (random weights from a seed); print prefill ms per bucket,
               decode-step ms, decode tokens/s and the launches of each
               kernel during this phase, which must all be > 0;
  4. parity  — the engine against the port's own generate() for 3 requests
               in fp32 with TF32 off: greedy streams must be identical.

Every line before the last two carries the card's name and power limit.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this file, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# GPT-350M (GPT-3 Medium: d_model 1024, 24 layers, 16 heads of 64)
GPT350M = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_heads=16, max_position_embeddings=2048, dropout=0.0)
SERVE = dict(num_slots=8, block_size=16, num_blocks=1024,
             max_blocks_per_seq=128)
# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# bf16 outputs: both sides round an f32 result to bf16, whose step is
# 2^-6 = 0.0156 for |x| in [2, 4); attention outputs are convex sums of
# v ~ N(0, 1), so |x| < 4 and one rounding step bounds the difference
BF16_ATOL = 1.6e-2
# lse is f32 from the same bf16 inputs: only the summation order differs
LSE_ATOL = 1e-3

TAG = ""


def say(*parts) -> None:
    print(TAG, *parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fns, iters: int = 20) -> float:
    """Mean ms per call over `iters` calls, cycling through `fns` (one
    closure per copy of the inputs, so the copies together exceed the
    50 MB L2 and each call finds its inputs cold)."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(100e6 / max(nbytes, 1)))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases --
def phase_build():
    from paddle_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build_all()
    say(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for src, info in built.items():
        say(f"build: {src} {info['seconds']:.1f} s -> {info['library']}")
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"build:   {line.strip()}")


def phase_kernels(dev):
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cpu").manual_seed(0)
    H, D = 16, 64
    results = {}

    # -- flash forward: the prefill buckets' shapes, one ragged with bias
    flash_rows = []
    for L, ragged in ((128, False), (512, False), (1024, False),
                      (1000, True)):
        nbytes_in = 3 * L * H * D * 2
        n = copies_for(nbytes_in)
        sets = []
        for _ in range(n):
            q, k, v = (torch.randn(1, L, H, D, generator=gen)
                       .to(dev, torch.bfloat16) for _ in range(3))
            bias = None
            if ragged:  # key padding: the last 24 keys masked (bool -> -1e9)
                bias = torch.zeros(1, L)
                bias[:, L - 24:] = -1e9
                bias = bias.to(dev)
            sets.append((q, k, v, bias))
        q, k, v, bias = sets[0]
        out, lse = fa.flash_attention_fwd(q, k, v, bias, causal=True)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, bias,
                                                    causal=True)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= BF16_ATOL and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash L={L}: max_abs_err {err} (tol "
                                 f"{BF16_ATOL}), lse {lse_err} (tol "
                                 f"{LSE_ATOL})")
        ms = cuda_ms([lambda s=s: fa.flash_attention_fwd(
            s[0], s[1], s[2], s[3], causal=True) for s in sets])
        plain_ms = cuda_ms([lambda s=s: fa.flash_attention_plain(
            s[0], s[1], s[2], s[3], causal=True) for s in sets], iters=5)
        # yardstick: PyTorch's fused attention on [B, H, S, D] copies
        lib_sets = []
        for q_, k_, v_, b_ in sets:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q_, k_, v_))
            mask = None
            if b_ is not None:
                causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
                mask = torch.where(causal, 0.0, float("-inf")) + b_[:, None, None, :]
                mask = mask.to(torch.bfloat16)
            lib_sets.append((qt, kt, vt, mask))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms([
            (lambda s=s: sdpa(s[0], s[1], s[2], attn_mask=s[3])) if s[3] is not None
            else (lambda s=s: sdpa(s[0], s[1], s[2], is_causal=True))
            for s in lib_sets])
        nbytes = 4 * L * H * D * 2 + H * L * 4 + (L * 4 if ragged else 0)
        flops = 4 * D * H * (L * (L + 1) // 2)  # the causal half only
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(L=L, kv_bias=ragged, max_abs_err=err, lse_err=lse_err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        flash_rows.append(row)
        say(f"kernel flash_fwd [1,{L},16,64] bf16 causal"
            f"{' +kv_bias' if ragged else ''}: max_abs_err {err:.3g} "
            f"(tol {BF16_ATOL}) lse_err {lse_err:.3g} (tol {LSE_ATOL}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms {lib_ms:.4f} "
            f"bound_ms {b_ms:.5f} ({b_by})")
    results["flash_fwd"] = flash_rows

    # -- paged attention: one decode step of the serving shape
    B, BS, M = 8, 16, 128
    # visible columns per slot: a full table, an overrun row past the
    # table (its pages past M are masked), mixed lengths, an idle slot
    positions = [2047, M * BS + 37, 1500, 1023, 700, 333, 17, 0]
    NB = 1 + B * M
    perm = torch.randperm(NB - 1, generator=gen) + 1
    table = torch.zeros(B, M, dtype=torch.int32)
    for b, p in enumerate(positions):
        if b == B - 1:
            continue  # idle slot: table all null block, pos 0
        used = min(M, p // BS + 1)
        table[b, :used] = perm[b * M:b * M + used].to(torch.int32)
    table = table.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)[:, None]
    pool_bytes = 2 * NB * BS * H * D * 2
    n = copies_for(pool_bytes)
    sets = []
    for _ in range(n):
        q = torch.randn(B, 1, H, D, generator=gen).to(dev, torch.bfloat16)
        kp = torch.randn(NB, BS, H, D, generator=gen).to(dev, torch.bfloat16)
        vp = torch.randn(NB, BS, H, D, generator=gen).to(dev, torch.bfloat16)
        sets.append((q, kp, vp))
    q, kp, vp = sets[0]
    out = pa.paged_attention(q, kp, vp, table, pos, block_size=BS)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, table, pos, block_size=BS)
    err = (out.float() - ref.float()).abs().max().item()
    # a pos = -1 row sees no column and must come out as zeros
    z = pa.paged_attention(q[:1], kp, vp, table[:1],
                           torch.full((1, 1), -1, dtype=torch.int32,
                                      device=dev), block_size=BS)
    zero_err = z.float().abs().max().item()
    if not (err <= BF16_ATOL and zero_err == 0.0):
        raise AssertionError(f"paged: max_abs_err {err} (tol {BF16_ATOL}), "
                             f"pos=-1 row max |out| {zero_err} (want 0)")
    ms = cuda_ms([lambda s=s: pa.paged_attention(
        s[0], s[1], s[2], table, pos, block_size=BS) for s in sets])
    plain_ms = cuda_ms([lambda s=s: pa.paged_attention_plain(
        s[0], s[1], s[2], table, pos, block_size=BS) for s in sets], iters=5)
    n_tok = sum(min(M * BS, p + 1) for p in positions)
    nbytes = (2 * n_tok * H * D * 2 + 2 * B * H * D * 2 + B * M * 4 + B * 4)
    flops = 4 * n_tok * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    results["paged_attention"] = [dict(
        B=B, M=M, visible_tokens=n_tok, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)]
    say(f"kernel paged_attention q [8,1,16,64] bf16, pools [{NB},16,16,64], "
        f"{n_tok} visible tokens: max_abs_err {err:.3g} (tol {BF16_ATOL}) "
        f"pos=-1 row max|out| {zero_err} ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}) "
        f"achieved {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    return results


def _prompts(rng, lengths, vocab):
    return [rng.integers(0, vocab, size=n).astype("int32") for n in lengths]


def phase_serve(dev):
    import numpy as np
    import torch

    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, SamplingParams,
                                  ServingConfig, ServingEngine)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    cfg = GPTConfig(**GPT350M)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serve: GPT-350M bf16 ({n_params / 1e6:.1f} M parameters) built "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    warm = ServingEngine(model, ServingConfig(**SERVE), device=dev)
    warm.submit(_prompts(rng, [130], cfg.vocab_size)[0],
                SamplingParams(max_new_tokens=4))
    warm.run_until_done()
    del warm

    lengths = np.linspace(100, 1000, 16).astype(int)
    prompts = _prompts(rng, lengths, cfg.vocab_size)
    eng = ServingEngine(model, ServingConfig(**SERVE), device=dev)
    fa.KERNEL.launches = 0
    pa.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, SamplingParams(max_new_tokens=64))
            for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.KERNEL.launches,
                "paged_attention": pa.KERNEL.launches}
    m = eng.metrics
    for rid in rids:
        req = eng.request(rid)
        out = eng.output(rid)
        if not req.finished or out.size != 64:
            raise AssertionError(f"request {rid}: {req.state} with "
                                 f"{out.size} tokens ({req.error})")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: token out of range")
    if launches["flash_fwd"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    want_flash = cfg.num_layers * m.prefills.value  # every bucket >= 128
    want_paged = cfg.num_layers * m.decode_steps.value
    if launches != {"flash_fwd": want_flash, "paged_attention": want_paged}:
        raise AssertionError(f"launches {launches}, expected flash "
                             f"{want_flash} and paged {want_paged}")
    summary = m.summary_dict()
    for L, h in summary["prefill_s"].items():
        say(f"serve: prefill bucket {L}: {h['count']} prefills, mean "
            f"{h['mean'] * 1e3:.3f} ms, max {h['max'] * 1e3:.3f} ms")
    dec = summary["decode_step_s"]
    decode_tokens = m.tokens_emitted.value - m.prefills.value
    decode_s = m.decode_step_s.sum
    say(f"serve: {m.decode_steps.value} decode steps, mean "
        f"{dec['mean'] * 1e3:.3f} ms, p50 {dec['p50'] * 1e3:.3f} ms, p99 "
        f"{dec['p99'] * 1e3:.3f} ms; decode {decode_tokens / decode_s:.1f} "
        f"tokens/s; {m.tokens_emitted.value} tokens in {wall:.2f} s "
        f"({m.tokens_emitted.value / wall:.1f} tokens/s end to end)")
    ttft, gap = summary["ttft_s"], summary["inter_token_s"]
    say(f"serve: {m.requests_submitted.value} requests sent, "
        f"{m.requests_finished.value} finished, {m.requests_failed.value} "
        f"failed; ttft p50 {ttft['p50'] * 1e3:.1f} ms max "
        f"{ttft['max'] * 1e3:.1f} ms; inter-token p50 "
        f"{gap['p50'] * 1e3:.2f} ms p99 {gap['p99'] * 1e3:.2f} ms")
    say(f"serve: launches during serving {launches} (flash: 24 per "
        f"prefill, paged: 24 per decode step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, summary


def phase_parity(dev):
    import numpy as np
    import torch

    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, SamplingParams,
                                  ServingConfig, ServingEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**GPT350M)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, [150, 333, 700], cfg.vocab_size)
    new = 16
    solo = [model.generate(p[None, :], max_new_tokens=new)[0, p.size:]
            .numpy() for p in prompts]
    eng = ServingEngine(model, ServingConfig(**SERVE), device=dev)
    rids = [eng.submit(p, SamplingParams(max_new_tokens=new))
            for p in prompts]
    eng.run_until_done()
    for rid, want in zip(rids, solo):
        got = eng.output(rid)
        if not np.array_equal(got, want):
            raise AssertionError(f"request {rid}: engine {got.tolist()} "
                                 f"!= generate {want.tolist()}")
    say(f"parity: fp32 engine == generate for {len(prompts)} greedy "
        f"streams of {new} tokens (prompts {[p.size for p in prompts]})")


def main() -> int:
    global TAG
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not importable beside "
              f"{__file__}: {e}", file=sys.stderr)
        return 2
    card = card_line()
    TAG = f"[{card}]"
    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    try:
        phase_build()
        kernels = phase_kernels(dev)
        launches, _ = phase_serve(dev)
        phase_parity(dev)
    except Exception:
        traceback.print_exc()
        say("FAILED")
        return 1
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    f = max(kernels["flash_fwd"], key=lambda r: r["L"])
    p = kernels["paged_attention"][0]
    summary = {"card": card, "kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_attention.py:155",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in kernels["flash_fwd"]),
         "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
         "bound_by": f["bound_by"], "library_ms": f["library_ms"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:151",
         "launches": launches["paged_attention"],
         "max_abs_err": p["max_abs_err"], "ms": p["ms"],
         "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
         "bound_by": p["bound_by"], "library_ms": None},
    ]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
