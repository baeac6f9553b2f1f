#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py [--parent DIR]

(--parent: a checkout of the parent commit; phase 2 then also times its
dQ and paged kernels, built from DIR's sources, in turns with this tree's
on the same inputs.)

Phases (any failure exits non-zero):
  1. build   — compile every CUDA kernel (flash forward, flash backward,
               paged attention) with nvcc, all sources at once; print the
               build seconds and each kernel's registers and spills, and
               require HMMA (tensor-core) instructions in the SASS of every
               bf16 / f16 flash kernel that is built for them (the dQ
               kernel's six instantiations among them) and none in the
               CUDA-core ones, and no spills in the dQ tensor-core kernel
               and the cluster paged kernel;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card at the serving and training paths' shapes (the paged
               kernel's fp and int8 branches at the decode step's shape,
               with a long and a short context, and the cluster size it
               launches with); print max-abs error, tolerance, kernel ms
               (the flash backward kernels also without dropout; the paged
               kernel's from CUDA-graph replays, as its wrapper's host time
               exceeds it), plain ms, the bound and the time of PyTorch's own attention call
               where one computes the same (for the backward kernels also
               its backward alone); read every flash kernel's dropout mask
               back, in f32 and in bf16, and require it bit-identical to
               the plain version's;
               run fp16 and a head dim of 80 (zero-padded to 128) through
               every kernel against the plain versions;
  3. train   — ERNIE-base in bf16 (random weights from a seed), batch 32,
               seq 512, through pretraining_loss, backward and AdamW for
               10 steps; print steps/s, samples/s, tokens/s, MFU, peak
               memory, the loss of every step (finite), the launches of
               each flash kernel (12 per step each) and the top kernels of
               one profiled step;
  4. train parity — one fp32 step (TF32 off) of a 2-layer full-width ERNIE
               with attention dropout 0.1, on the card and on the CPU from
               the same weights and dropout seeds: losses and gradients
               must agree;
  5. serve   — 16 requests (prompts of 100..1000 tokens, 64 greedy new
               tokens each) through ServingEngine on GPT-350M in bf16
               (random weights from a seed); print prefill ms per bucket,
               decode-step ms, decode tokens/s and the launches of each
               kernel during this phase, which must all be > 0;
  6. parity  — the engine against the port's own generate() for 3 requests
               in fp32 with TF32 off: greedy streams must be identical;
  7. quantized serve — phase 5's requests through ServingEngine with
               quantize_weights and quantize_kv (int8 linears, int8 KV pools
               with f32 scales, decode through the paged kernel's int8
               branch); print the same metrics and the bytes saved; the
               int8 branch must launch 24 times per decode step;
  8. quantized parity — a 2-layer GPT-350M-width model in fp32 with TF32
               off, quantized engines on the card and on the CPU: greedy
               streams identical, logits within tolerance.

Before each path's run every launch count is set to 0, and after it every
kernel of the path must have launched.

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
# ERNIE-base pretraining as bench.py runs it on a chip: ErnieConfig.base()
# in bf16, AdamW(lr 1e-4), batch 32, seq 512, no attention mask
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 32, 512, 10, 1e-4
ATTN_DROPOUT = 0.1
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
# f32 runs of the same kernels: only the summation order differs (out),
# three products deep for the gradients; a dropout mask that differed in
# one entry would move an output by ~p / (1 - p) / S ~ 2e-4 at S = 512
F32_ATOL, F32_GRAD_ATOL = 1e-5, 1e-4
# bf16 gradients: one bf16 step of the value on top of the output's atol
BF16_GRAD_RTOL = 2.0 ** -7
# f16 outputs: one f16 step, 2^-9 for |x| in [2, 4); f16 gradients one f16
# step of the value (2^-10) on top of 4e-3
F16_ATOL, F16_GRAD_ATOL, F16_GRAD_RTOL = 2e-3, 4e-3, 2.0 ** -10
# quantized parity (fp32, TF32 off, card vs CPU): both dequantize the same
# int8 weights; logits differ by summation order through 2 layers
QPARITY_RTOL = 1e-4

TAG = ""


def say(*parts) -> None:
    print(TAG, *parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fns, iters: int = 20, graph: bool = False) -> float:
    """Mean ms per call over `iters` calls, cycling through `fns` (one
    closure per copy of the inputs, so the copies together exceed the
    50 MB L2 and each call finds its inputs cold). With `graph`, the
    `iters` calls are captured in one CUDA graph and timed as its replays:
    the device's time for kernels shorter than their wrapper's host time."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    reps = 1
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        torch.cuda.synchronize()
        run, reps = g.replay, 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(100e6 / max(nbytes, 1)))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases --
_TYPE_NAMES = {"f": "f32", "__nv_bfloat16": "bf16", "__half": "f16",
               "a": "int8"}


def _kernel_label(mangled: str) -> str:
    """'flash_fwd_mma_kernel<bf16, 64>' from a mangled kernel name."""
    import re

    for i in range(len(mangled)):  # <length><name>, at any digit
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            continue
        start = i + m.end()
        name = mangled[start:start + int(m.group())]
        t = re.match(r"I(\w+?)Li(\d+)E", mangled[start + len(name):])
        if name.endswith("_kernel") and t:
            break
    else:
        return mangled[:80]
    types, rest = [], t.group(1)
    while rest:  # <length><name> for a class, S_ / S<n>_ for a name
        n = re.match(r"\d+", rest)  # given before, one letter for a builtin
        r = re.match(r"S\d*_", rest)
        if n:
            end = n.end() + int(n.group())
            types.append(rest[n.end():end])
            rest = rest[end:]
        elif r:
            types.append("same")
            rest = rest[r.end():]
        else:
            types.append(rest[0])
            rest = rest[1:]
    args = [_TYPE_NAMES.get(x, x) for x in types] + [t.group(2)]
    return f"{name}<{', '.join(args)}>"


def _kernel_resources(report: str):
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function, from nvcc's -Xptxas -v report."""
    import re

    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((_kernel_label(name), int(m.group(1))) + spills)
            name = None
    return rows


def _hmma_counts(library: str):
    """{kernel: number of HMMA (tensor-core) instructions} in the
    library's SASS, or None where the toolkit has no cuobjdump."""
    from paddle_tpu_torch.ops import _cuda

    exe = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_label(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def phase_build():
    """Build every kernel; print each kernel's registers and spills, and
    require HMMA instructions in every tensor-core flash kernel and none
    in the CUDA-core ones."""
    from paddle_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build_all()
    say(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    resources = {}
    for src, info in built.items():
        say(f"build: {src} {info['seconds']:.1f} s -> {info['library']}")
        for name, regs, st, ld in _kernel_resources(info["report"]):
            resources[name] = dict(registers=regs, spill_stores=st,
                                   spill_loads=ld)
            say(f"build:   {name}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        counts = _hmma_counts(built[src]["library"])
        if counts is None:
            if src == "flash_bwd.cu":
                raise AssertionError("no cuobjdump: the dQ kernel's HMMA "
                                     "instructions cannot be counted")
            say(f"build: {src}: no cuobjdump, HMMA count not measured")
            continue
        say(f"build: {src} HMMA instructions per kernel: {counts}")
        wrong = {n: c for n, c in counts.items()
                 if (c > 0) != ("_mma_kernel" in n)}
        if wrong:
            raise AssertionError(f"{src}: tensor-core instructions where "
                                 f"not expected, or missing: {wrong}")
        if src == "flash_bwd.cu":
            dq = [n for n in counts if n.startswith("flash_bwd_dq_mma_")]
            if len(dq) != 6:  # bf16 and f16 at D = 32, 64 and 128
                raise AssertionError(f"dQ tensor-core kernels: {dq}")
    # the dQ tensor-core kernel and the cluster paged kernel: every
    # instantiation built, none spilling (nvcc reports only on a build: a
    # library built before this run, in this checkout, was checked then)
    if not (built["flash_bwd.cu"]["report"]
            and built["paged_attention.cu"]["report"]):
        say("build: libraries built before this run: registers and spills "
            "not measured here")
        return resources
    watched = {n: r for n, r in resources.items()
               if n.startswith(("flash_bwd_dq_mma_kernel",
                                "paged_attention_kernel"))}
    spilled = {n: r for n, r in watched.items()
               if r["spill_stores"] or r["spill_loads"]}
    if len(watched) != 6 + 18 or spilled:
        raise AssertionError(f"dQ / paged kernels: {len(watched)} of 24 "
                             f"instantiations, spills {spilled}")
    return resources


# --parent DIR: a checkout of the parent commit whose flash_bwd.cu and
# paged_attention.cu (same C ABI) are built beside this tree's, so that
# phase 2 times the two versions in turns on the same inputs
PARENT_KERNELS = {}


def _bind_parent(parent_dir: str) -> None:
    from paddle_tpu_torch.ops import _cuda
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    out = os.path.join(ROOT, "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for src in ("flash_bwd.cu", "paged_attention.cu"):
        lib = os.path.join(out, src.replace(".cu", ".so"))
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib,
               os.path.join(parent_dir, "paddle_tpu_torch", "csrc", src)]
        procs[src] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for src, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {src}: nvcc failed\n{report}")
    for kern in (fa.DQ_KERNEL, pa.KERNEL, pa.INT8_KERNEL):
        PARENT_KERNELS[kern.symbol] = _cuda.CudaKernel(
            kern.source, kern.symbol, kern.argtypes,
            library=procs[kern.source][0])
    say(f"parent: {parent_dir}: flash_bwd.cu and paged_attention.cu built "
        "for the A/B timings of phase 2")


def ab_ms(fns, module, attr: str, graph: bool = False):
    """(ms, parent ms or None): `fns` timed by `cuda_ms` with
    `module.attr`, a kernel, as it is and, with --parent, as the parent's
    twin, in the turns parent, change, change, parent; each number is the
    mean of its turns."""
    own = getattr(module, attr)
    twin = PARENT_KERNELS.get(own.symbol)
    if twin is None:
        return cuda_ms(fns, graph=graph), None
    turns = {"parent": [], "change": []}
    for turn in ("parent", "change", "change", "parent"):
        setattr(module, attr, twin if turn == "parent" else own)
        try:
            turns[turn].append(cuda_ms(fns, graph=graph))
        finally:
            setattr(module, attr, own)
    return (sum(turns["change"]) / 2, sum(turns["parent"]) / 2)


def _vs_parent(ms, parent_ms) -> str:
    return "" if parent_ms is None else f" (parent {parent_ms:.4f})"


def phase_kernels(dev):
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

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

    # -- paged attention: one decode step of the serving shape (the
    # serving config's 128-page table), fp and int8 pools, at a long
    # context and at a short one
    B, BS, M = 8, 16, 128
    # visible columns per slot: a full table, an overrun row past the
    # table (its pages past M are masked), mixed lengths, an idle slot
    long_pos = [2047, M * BS + 37, 1500, 1023, 700, 333, 17, 0]
    short_pos = [97, 103, 88, 110, 95, 101, 92, 106]
    for quantized in (False, True):
        name = "paged_attention_int8" if quantized else "paged_attention"
        long_row = _paged_case(dev, gen, long_pos, M, BS, H, D, quantized)
        short_row = _paged_case(dev, gen, short_pos, M, BS, H, D, quantized)
        results[name] = [dict(long_row, short_context=short_row)]
    return results


def _paged_cluster_size(B, s, H, D, M, BS, quantized) -> int:
    """The cluster size the bf16 paged kernel launches with here."""
    import ctypes

    import torch

    from paddle_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(_cuda.build_all(["paged_attention.cu"])
                      ["paged_attention.cu"]["library"])
    return lib.paged_attention_cluster_size(
        B, s, H, D, M, BS, _cuda.DTYPE_CODES[torch.bfloat16], int(quantized))


def _paged_case(dev, gen, positions, M, BS, H, D, quantized):
    """One decode step (q [B, 1, H, D] bf16) over pools holding just the
    pages the table uses (copies cycled past the L2): the kernel against
    the plain version, a pos = -1 row that must give zeros, the kernel's
    device time (and the parent's, with --parent), the plain version's,
    the bound."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.quantization import kv as kvq

    B = len(positions)
    used = [min(M, p // BS + 1) for p in positions]
    NB = 1 + sum(used)
    perm = torch.randperm(NB - 1, generator=gen) + 1
    table = torch.zeros(B, M, dtype=torch.int32)
    at = 0
    for b, u in enumerate(used):
        if positions[b] == 0 and b == B - 1:
            continue  # idle slot: table all null block, pos 0
        table[b, :u] = perm[at:at + u].to(torch.int32)
        at += u
    table = table.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)[:, None]
    row_bytes = D + 4 if quantized else 2 * D  # int8 + f32 scale, or bf16
    sets = []
    for _ in range(copies_for(2 * NB * BS * H * row_bytes)):
        q = torch.randn(B, 1, H, D, generator=gen).to(dev, torch.bfloat16)
        pools = [torch.randn(NB, BS, H, D, generator=gen).to(
            dev, torch.bfloat16) for _ in range(2)]
        kw = {}
        if quantized:
            kq, vq = (kvq.quantize_pool(p_) for p_ in pools)
            pools, kw = [kq.data, vq.data], dict(k_scale=kq.scale,
                                                 v_scale=vq.scale)
        sets.append((q, *pools, kw))
    q, kp, vp, kw = sets[0]
    out = pa.paged_attention(q, kp, vp, table, pos, block_size=BS, **kw)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, table, pos, block_size=BS,
                                   **kw)
    err = (out.float() - ref.float()).abs().max().item()
    z = pa.paged_attention(q[:1], kp, vp, table[:1],
                           torch.full((1, 1), -1, dtype=torch.int32,
                                      device=dev), block_size=BS, **kw)
    zero_err = z.float().abs().max().item()
    name = "paged_attention_int8" if quantized else "paged_attention"
    n_tok = sum(min(M * BS, p + 1) for p in positions)
    if not (err <= BF16_ATOL and zero_err == 0.0):
        raise AssertionError(f"{name} ({n_tok} tokens): max_abs_err {err} "
                             f"(tol {BF16_ATOL}), pos=-1 row max |out| "
                             f"{zero_err} (want 0)")
    # a CUDA graph of the calls: the wrapper's host time (~20 us of Python
    # checks) is longer than the kernel's
    ms, parent_ms = ab_ms([lambda s=s: pa.paged_attention(
        s[0], s[1], s[2], table, pos, block_size=BS, **s[3])
        for s in sets], pa, "INT8_KERNEL" if quantized else "KERNEL",
        graph=True)
    plain_ms = cuda_ms([lambda s=s: pa.paged_attention_plain(
        s[0], s[1], s[2], table, pos, block_size=BS, **s[3])
        for s in sets], iters=5)
    # every visible key and value row read once (int8: payload plus one
    # f32 scale per token, head and {k, v}), q and out, the table, pos
    nbytes = (2 * n_tok * H * row_bytes + 2 * B * H * D * 2 + B * M * 4
              + B * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * n_tok * H * D)
    cluster = _paged_cluster_size(B, 1, H, D, M, BS, quantized)
    pools = ("int8 pools + f32 scales" if quantized else "bf16 pools")
    say(f"kernel {name} q [{B},1,{H},{D}] bf16, {pools} [{NB},{BS},{H},"
        f"{D}], table [{B},{M}], {n_tok} visible tokens, cluster of "
        f"{cluster}: max_abs_err {err:.3g} (tol {BF16_ATOL}) pos=-1 row "
        f"max|out| {zero_err} ms {ms:.4f}{_vs_parent(ms, parent_ms)} "
        f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}) achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    return dict(B=B, M=M, visible_tokens=n_tok, cluster=cluster,
                max_abs_err=err, ms=ms, parent_ms=parent_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def phase_variant_kernels(dev):
    """fp16 and a head dim of 80 through every kernel: the flash forward
    and both backward kernels through scaled_dot_product_attention under
    autograd (D = 80 zero-padded to 128 at the scale 1 / sqrt(80)), and
    the paged kernel's fp and int8 branches over pools allocated as the
    model allocates them (D = 80 at 128, the extra columns zero); each
    against its plain version. Returns one row per case."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.quantization import kv as kvq

    gen = torch.Generator(device="cpu").manual_seed(5)
    tols = {torch.bfloat16: (BF16_ATOL, BF16_ATOL, BF16_GRAD_RTOL),
            torch.float16: (F16_ATOL, F16_GRAD_ATOL, F16_GRAD_RTOL)}
    rows = []
    kernels = (fa.KERNEL, fa.DKV_KERNEL, fa.DQ_KERNEL)
    B, S, H = 2, 512, 16
    for dtype, D in ((torch.float16, 64), (torch.bfloat16, 80),
                     (torch.float16, 80)):
        atol, g_atol, g_rtol = tols[dtype]
        base = [torch.randn(B, S, H, D, generator=gen).to(dev, dtype)
                for _ in range(4)]
        ours = [t.clone().requires_grad_(True) for t in base[:3]]
        ref = [t.clone().requires_grad_(True) for t in base[:3]]
        before = [k.launches for k in kernels]
        out = F.scaled_dot_product_attention(*ours, is_causal=True)
        out.backward(base[3])
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        want, _ = fa.flash_attention_plain(*ref, causal=True)
        want.backward(base[3])
        err = _max_excess(out, want, atol)
        g_err = {n: _max_excess(a.grad, b.grad, g_atol, g_rtol)
                 for n, a, b in zip(("dq", "dk", "dv"), ours, ref)}
        if launched != [1, 1, 1] or err[1] > 0 or any(
                e[1] > 0 for e in g_err.values()):
            raise AssertionError(f"flash {dtype} D={D}: launches "
                                 f"{launched}, out {err}, grads {g_err}")
        q, k, v = (t.detach() for t in base[:3])
        ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True)])
        plain_ms = cuda_ms([lambda: fa.flash_attention_plain(
            q, k, v, causal=True)], iters=5)
        name = str(dtype).replace("torch.", "")
        rows.append(dict(kernel="flash_fwd+bwd", dtype=name, D=D,
                         shape=[B, S, H, D], max_abs_err=err[0],
                         grad_err={n: e[0] for n, e in g_err.items()},
                         tol=atol, fwd_ms=ms, fwd_plain_ms=plain_ms))
        say(f"kernel variant flash [{B},{S},{H},{D}] {name} causal via "
            f"SDPA + autograd: out max_abs_err {err[0]:.3g} (tol {atol}), "
            + ", ".join(f"{n} {e[0]:.3g}" for n, e in g_err.items())
            + f" (tol {g_atol} + {g_rtol:.4g}|x|); forward ms {ms:.4f} "
            f"plain {plain_ms:.4f}")
        del base, ours, ref, out, want

    Bq, BS, M = 8, 16, 64
    NB = 1 + Bq * M
    table = (torch.randperm(NB - 1, generator=gen)[:Bq * M] + 1).reshape(
        Bq, M).to(torch.int32).to(dev)
    pos = torch.tensor([[M * BS - 1], [M * BS + 9], [700], [333], [64],
                        [17], [0], [-1]], dtype=torch.int32, device=dev)
    for dtype, D, quantized in ((torch.float16, 64, False),
                                (torch.bfloat16, 80, False),
                                (torch.float16, 64, True),
                                (torch.bfloat16, 80, True)):
        atol = tols[dtype][0]
        Dp = 128 if D == 80 else D
        q = torch.randn(Bq, 1, H, D, generator=gen).to(dev, dtype)
        pools = [torch.randn(NB, BS, H, D, generator=gen).to(dev, dtype)
                 for _ in range(2)]
        wide = [torch.nn.functional.pad(p_, (0, Dp - D)) for p_ in pools]
        kw, wkw = {}, {}
        if quantized:
            pools = [kvq.quantize_pool(p_) for p_ in pools]
            wide = [kvq.quantize_pool(p_) for p_ in wide]
            kw = dict(k_scale=pools[0].scale, v_scale=pools[1].scale)
            wkw = dict(k_scale=wide[0].scale, v_scale=wide[1].scale)
            pools, wide = [p_.data for p_ in pools], [p_.data for p_ in wide]
        kern = pa.INT8_KERNEL if quantized else pa.KERNEL
        before = kern.launches
        got = pa.paged_attention(q, *wide, table, pos, block_size=BS, **wkw)
        torch.cuda.synchronize()
        launched = kern.launches - before
        want = pa.paged_attention_plain(q, *pools, table, pos,
                                        block_size=BS, **kw)
        err = (got.float() - want.float()).abs().max().item()
        if launched != 1 or err > atol or bool((got[-1] != 0).any()):
            raise AssertionError(f"paged {dtype} D={D} int8={quantized}: "
                                 f"{launched} launches, max_abs_err {err} "
                                 f"(tol {atol})")
        ms = cuda_ms([lambda: pa.paged_attention(q, *wide, table, pos,
                                                 block_size=BS, **wkw)],
                     graph=True)
        name = str(dtype).replace("torch.", "")
        kname = "paged_attention_int8" if quantized else "paged_attention"
        rows.append(dict(kernel=kname, dtype=name, D=D, pool_D=Dp,
                         shape=[Bq, 1, H, D], max_abs_err=err, tol=atol,
                         ms=ms))
        say(f"kernel variant {kname} q [{Bq},1,{H},{D}] {name}, pools "
            f"[{NB},{BS},{H},{Dp}]{' int8' if quantized else ''}: "
            f"max_abs_err {err:.3g} (tol {atol}) ms {ms:.4f}")
        del q, pools, wide, got, want
    return rows


def _max_excess(got, want, atol, rtol=0.0):
    """(max |got - want|, max of |got - want| - (atol + rtol |want|)):
    the second is <= 0 when every entry is within tolerance."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d - atol - rtol * want.float().abs()).max().item()


def phase_train_kernels(dev):
    """The flash kernels at the ERNIE-base training shape (dropout 0.1,
    non-causal) and a sliding-window shape, against their plain versions,
    plus a read-back of every kernel's dropout mask."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cpu").manual_seed(1)
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, 12, 64
    p, seed = ATTN_DROPOUT, -123456789
    kw = dict(dropout_p=p, seed=seed)
    rows = {}

    # masks: each kernel's against dropout_keep, over every (b, h, row,
    # col); f32 reads the CUDA-core kernels, bf16 the tensor-core ones
    want = fa._keep_bhqk(seed, p, B, H, S, S, dev)
    kept = want.float().mean().item()
    for dtype in (torch.float32, torch.bfloat16):
        masks = fa.probe_dropout_masks(B, H, S, p, seed, dev, dtype)
        same = {n: bool(torch.equal(m, want)) for n, m in masks.items()}
        del masks
        if not all(same.values()):
            raise AssertionError(f"{dtype} dropout masks differ from "
                                 f"dropout_keep: {same}")
        say(f"kernel dropout masks [{B},{H},{S},{S}] {dtype} p={p} "
            f"seed={seed}: fwd, dkv and dq bit-identical to dropout_keep "
            f"{same}; kept share {kept:.5f}")
    del want

    def inputs(dtype, n=1, shape=(B, S, H, D)):
        return [[torch.randn(*shape, generator=gen).to(dev, dtype)
                 for _ in range(4)] for _ in range(n)]

    # f32 at the training shape: tight tolerances on out, lse and grads
    q, k, v, do = inputs(torch.float32)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, None, False, None, **kw)
    r_out, r_lse = fa.flash_attention_plain(q, k, v, None, False, None, **kw)
    f32_err = {"out": _max_excess(out, r_out, F32_ATOL),
               "lse": _max_excess(lse, r_lse, LSE_ATOL)}
    grads = fa.flash_attention_bwd(q, k, v, None, out, lse, do, **kw)
    r_grads = fa.flash_attention_bwd_plain(q, k, v, None, out, lse, do, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), grads, r_grads):
        f32_err[name] = _max_excess(g, r, F32_GRAD_ATOL)
    torch.cuda.synchronize()
    del q, k, v, do, out, lse, r_out, r_lse, grads, r_grads
    shape = f"[{B},{S},{H},{D}]"
    say(f"kernel flash f32 {shape} dropout {p} vs plain: " + ", ".join(
        f"{n} max_abs_err {e[0]:.3g}" for n, e in f32_err.items())
        + f" (tol out {F32_ATOL}, lse {LSE_ATOL}, grads {F32_GRAD_ATOL})")
    if any(e[1] > 0 for e in f32_err.values()):
        raise AssertionError(f"f32 flash kernels disagree: {f32_err}")

    # bf16 at the training shape: the path's dtype, timed
    elem = B * S * H * D
    sets = inputs(torch.bfloat16, copies_for(4 * elem * 2))
    q, k, v, do = sets[0]
    out, lse = fa.flash_attention_fwd(q, k, v, None, False, None, **kw)
    r_out, r_lse = fa.flash_attention_plain(q, k, v, None, False, None, **kw)
    err_out = _max_excess(out, r_out, BF16_ATOL)
    err_lse = _max_excess(lse, r_lse, LSE_ATOL)
    delta = fa.delta_of(out, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, None, lse, delta, do,
                                        False, None, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, None, lse, delta, do, False,
                                   None, **kw)
    r_dq, r_dk, r_dv = fa.flash_attention_bwd_plain(q, k, v, None, out, lse,
                                                    do, False, None, **kw)
    errs = {n: _max_excess(g, r, BF16_ATOL, BF16_GRAD_RTOL)
            for n, g, r in (("dk", dk, r_dk), ("dv", dv, r_dv),
                            ("dq", dq, r_dq))}
    del r_out, r_lse, r_dq, r_dk, r_dv
    if err_out[1] > 0 or err_lse[1] > 0 or any(e[1] > 0
                                               for e in errs.values()):
        raise AssertionError(f"bf16 flash kernels disagree: out {err_out} "
                             f"lse {err_lse} grads {errs}")
    prep = []
    for q_, k_, v_, do_ in sets:
        o_, l_ = fa.flash_attention_fwd(q_, k_, v_, None, False, None, **kw)
        prep.append((q_, k_, v_, do_, l_, fa.delta_of(o_, do_), o_))
    fwd_ms = cuda_ms([lambda s=s: fa.flash_attention_fwd(
        s[0], s[1], s[2], None, False, None, **kw) for s in prep])
    dkv_ms = cuda_ms([lambda s=s: fa.flash_attention_bwd_dkv(
        s[0], s[1], s[2], None, s[4], s[5], s[3], False, None, **kw)
        for s in prep])
    dq_ms, dq_parent_ms = ab_ms([lambda s=s: fa.flash_attention_bwd_dq(
        s[0], s[1], s[2], None, s[4], s[5], s[3], False, None, **kw)
        for s in prep], fa, "DQ_KERNEL")
    # the same calls without dropout: what the mask's hash costs
    nd = dict(dropout_p=0.0, seed=seed)
    fwd_nd_ms = cuda_ms([lambda s=s: fa.flash_attention_fwd(
        s[0], s[1], s[2], None, False, None, **nd) for s in prep])
    dkv_nd_ms = cuda_ms([lambda s=s: fa.flash_attention_bwd_dkv(
        s[0], s[1], s[2], None, s[4], s[5], s[3], False, None, **nd)
        for s in prep])
    dq_nd_ms, dq_nd_parent_ms = ab_ms([
        lambda s=s: fa.flash_attention_bwd_dq(
            s[0], s[1], s[2], None, s[4], s[5], s[3], False, None, **nd)
        for s in prep], fa, "DQ_KERNEL")
    plain_fwd_ms = cuda_ms([lambda s=s: fa.flash_attention_plain(
        s[0], s[1], s[2], None, False, None, **kw) for s in prep], iters=3)
    plain_bwd_ms = cuda_ms([lambda s=s: fa.flash_attention_bwd_plain(
        s[0], s[1], s[2], None, s[6], s[4], s[3], False, None, **kw)
        for s in prep], iters=3)
    # yardstick: PyTorch's fused attention with dropout on [B, H, S, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = [[t.transpose(1, 2).contiguous() for t in s[:4]] for s in prep]
    lib_fwd_ms = cuda_ms([lambda s=s: sdpa(s[0], s[1], s[2], dropout_p=p)
                          for s in lib])
    for s_ in lib:
        for t in s_[:3]:
            t.requires_grad_(True)

    def lib_step(s_):
        o = sdpa(s_[0], s_[1], s_[2], dropout_p=p)
        torch.autograd.grad(o, s_[:3], s_[3])

    lib_fb_ms = cuda_ms([lambda s=s: lib_step(s) for s in lib])
    # SDPA's backward alone: autograd.grad over a retained graph (the
    # same dropout mask every call), like for like with dkv + dq
    graphs = [(s_, sdpa(s_[0], s_[1], s_[2], dropout_p=p)) for s_ in lib]
    lib_bwd_ms = cuda_ms([lambda s=s_, o=o: torch.autograd.grad(
        o, s[:3], s[3], retain_graph=True) for s_, o in graphs])
    del graphs, lib, prep, sets
    io = elem * 2
    stats = B * H * S * 4
    flop1 = 2 * B * H * S * S * D  # one S x S x D product
    fwd_b = bound_ms(4 * io + stats, 2 * flop1)
    dkv_b = bound_ms(6 * io + 2 * stats, 4 * flop1)
    dq_b = bound_ms(5 * io + 2 * stats, 3 * flop1)
    pair_b = bound_ms(7 * io + 2 * stats, 5 * flop1)
    rows["fwd_dropout"] = dict(
        shape=[B, S, H, D], max_abs_err=err_out[0], lse_err=err_lse[0],
        ms=fwd_ms, ms_no_dropout=fwd_nd_ms, plain_ms=plain_fwd_ms,
        library_ms=lib_fwd_ms, bound_ms=fwd_b[0], bound_by=fwd_b[1])
    rows["dkv"] = dict(shape=[B, S, H, D], max_abs_err=errs["dk"][0],
                       dv_err=errs["dv"][0], ms=dkv_ms,
                       ms_no_dropout=dkv_nd_ms, plain_ms=plain_bwd_ms,
                       library_ms=lib_fb_ms,
                       library_bwd_ms=lib_bwd_ms, bound_ms=dkv_b[0],
                       bound_by=dkv_b[1])
    rows["dq"] = dict(shape=[B, S, H, D], max_abs_err=errs["dq"][0],
                      ms=dq_ms, ms_no_dropout=dq_nd_ms,
                      parent_ms=dq_parent_ms,
                      parent_ms_no_dropout=dq_nd_parent_ms,
                      plain_ms=plain_bwd_ms, library_ms=lib_fb_ms,
                      library_bwd_ms=lib_bwd_ms, bound_ms=dq_b[0],
                      bound_by=dq_b[1])
    say(f"kernel flash_fwd {shape} bf16 dropout {p}: max_abs_err "
        f"{err_out[0]:.3g} (tol {BF16_ATOL}) lse_err {err_lse[0]:.3g} "
        f"(tol {LSE_ATOL}) ms {fwd_ms:.4f} (without dropout "
        f"{fwd_nd_ms:.4f}) plain_ms {plain_fwd_ms:.4f} "
        f"sdpa_ms {lib_fwd_ms:.4f} bound_ms {fwd_b[0]:.5f} ({fwd_b[1]}) "
        f"achieved {2 * flop1 / (fwd_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    say(f"kernel flash_bwd_dkv {shape} bf16 dropout {p}: max_abs_err "
        f"dk {errs['dk'][0]:.3g} dv {errs['dv'][0]:.3g} (tol {BF16_ATOL} + "
        f"{BF16_GRAD_RTOL:.4g}|x|) ms {dkv_ms:.4f} (without dropout "
        f"{dkv_nd_ms:.4f}) bound_ms "
        f"{dkv_b[0]:.5f} ({dkv_b[1]}) achieved "
        f"{4 * flop1 / (dkv_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    say(f"kernel flash_bwd_dq {shape} bf16 dropout {p}: max_abs_err "
        f"{errs['dq'][0]:.3g} (tol {BF16_ATOL} + {BF16_GRAD_RTOL:.4g}|x|) "
        f"ms {dq_ms:.4f}{_vs_parent(dq_ms, dq_parent_ms)} (without dropout "
        f"{dq_nd_ms:.4f}{_vs_parent(dq_nd_ms, dq_nd_parent_ms)}) bound_ms "
        f"{dq_b[0]:.5f} ({dq_b[1]}) achieved "
        f"{3 * flop1 / (dq_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    say(f"kernel flash backward pair: {dkv_ms + dq_ms:.4f} ms (+ delta) vs "
        f"plain backward {plain_bwd_ms:.4f} ms, sdpa fwd+bwd "
        f"{lib_fb_ms:.4f} ms, sdpa bwd alone {lib_bwd_ms:.4f} ms; bound of "
        f"the least backward work (5 products) {pair_b[0]:.5f} ms "
        f"({pair_b[1]})")

    # sliding window: causal, S = 1024, window 256, forward and backward
    Bw, Sw, W = 4, 1024, 256
    wk = dict(dropout_p=0.0, seed=0, window=W)
    q, k, v, do = inputs(torch.bfloat16, 1, (Bw, Sw, H, D))[0]
    out, lse = fa.flash_attention_fwd(q, k, v, None, True, None, **wk)
    r_out, r_lse = fa.flash_attention_plain(q, k, v, None, True, None, **wk)
    w_err = _max_excess(out, r_out, BF16_ATOL)
    w_lse = _max_excess(lse, r_lse, LSE_ATOL)
    grads = fa.flash_attention_bwd(q, k, v, None, out, lse, do, True, None,
                                   **wk)
    r_grads = fa.flash_attention_bwd_plain(q, k, v, None, out, lse, do, True,
                                           None, **wk)
    w_grad = max(_max_excess(g, r, BF16_ATOL, BF16_GRAD_RTOL)[1]
                 for g, r in zip(grads, r_grads))
    if w_err[1] > 0 or w_lse[1] > 0 or w_grad > 0:
        raise AssertionError(f"window flash kernels disagree: out {w_err} "
                             f"lse {w_lse} grad excess {w_grad}")
    w_ms = cuda_ms([lambda: fa.flash_attention_fwd(q, k, v, None, True,
                                                   None, **wk)])
    w_plain = cuda_ms([lambda: fa.flash_attention_plain(
        q, k, v, None, True, None, **wk)], iters=3)
    mask = torch.ones(Sw, Sw, dtype=torch.bool, device=dev).tril()
    mask &= ~torch.ones(Sw, Sw, dtype=torch.bool, device=dev).tril(-W - 1)
    lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    w_lib = cuda_ms([lambda: sdpa(lq, lk, lv, attn_mask=mask)])
    entries = sum(min(r, W) + 1 for r in range(Sw))
    w_b = bound_ms(4 * Bw * Sw * H * D * 2 + Bw * H * Sw * 4,
                   4 * D * entries * Bw * H)
    rows["fwd_window"] = dict(
        shape=[Bw, Sw, H, D], window=W, max_abs_err=w_err[0],
        lse_err=w_lse[0], ms=w_ms, plain_ms=w_plain, library_ms=w_lib,
        bound_ms=w_b[0], bound_by=w_b[1])
    say(f"kernel flash_fwd [{Bw},{Sw},{H},{D}] bf16 causal window {W}: "
        f"max_abs_err {w_err[0]:.3g} (tol {BF16_ATOL}) lse_err "
        f"{w_lse[0]:.3g}; backward within tolerance; ms {w_ms:.4f} "
        f"plain_ms {w_plain:.4f} sdpa_ms (band mask) {w_lib:.4f} bound_ms "
        f"{w_b[0]:.5f} ({w_b[1]})")
    return rows


def _ernie_batch(cfg, batch, seq, seed):
    """ids and labels as bench.py draws them: RandomState(seed)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    labels = rng.randint(0, cfg.vocab_size, (batch, seq))
    return torch.from_numpy(ids), torch.from_numpy(labels)


def phase_train(dev):
    import torch

    from paddle_tpu_torch import AdamW, ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = ErnieConfig.base()
    t0 = time.perf_counter()
    model = ErnieForPretraining(cfg, device=dev, dtype=torch.bfloat16,
                                seed=0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(model.named_parameters(), learning_rate=TRAIN_LR,
                device=dev)
    ids, labels = (t.to(dev) for t in _ernie_batch(cfg, TRAIN_BATCH,
                                                   TRAIN_SEQ, 0))
    say(f"train: ERNIE-base bf16 ({n_params} parameters) built in "
        f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} seq "
        f"{TRAIN_SEQ}, AdamW lr {TRAIN_LR}, attention dropout "
        f"{cfg.attention_probs_dropout_prob}, hidden dropout "
        f"{cfg.hidden_dropout_prob}")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.pretraining_loss(ids, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(2):  # warm-up: cuBLAS handles, kernel libraries, allocator
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = {"flash_fwd": fa.KERNEL, "flash_bwd_dkv": fa.DKV_KERNEL,
               "flash_bwd_dq": fa.DQ_KERNEL}
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in kernels.items()}
    losses = [x.item() for x in losses]
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    want = cfg.num_hidden_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"train: launches {launches}, expected {want} "
                             "of each")
    steps_s = TRAIN_STEPS / wall
    # bench.py's analytic MFU: 6 FLOPs per parameter per token + attention
    l, h, s = cfg.num_hidden_layers, cfg.hidden_size, TRAIN_SEQ
    flops_step = (6 * n_params + 12 * l * h * s) * TRAIN_BATCH * TRAIN_SEQ
    name = torch.cuda.get_device_name(dev)
    peak_flops = 756e12 if "PCIe" in name else BF16_FLOP_PER_S
    mfu = flops_step * steps_s / peak_flops
    say(f"train: {TRAIN_STEPS} steps in {wall:.3f} s: {steps_s:.3f} steps/s, "
        f"{steps_s * TRAIN_BATCH:.2f} samples/s, "
        f"{steps_s * TRAIN_BATCH * TRAIN_SEQ:.0f} tokens/s, "
        f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step; MFU {mfu:.4f} "
        f"({flops_step / 1e12:.2f} TFLOP/step against "
        f"{peak_flops / 1e12:.0f} TFLOP/s); peak memory "
        f"{peak / 2**30:.2f} GiB")
    say(f"train: losses {[round(x, 5) for x in losses]}")
    say(f"train: launches {launches} ({cfg.num_hidden_layers} per step each)")

    # one profiled step, after the counted run: device time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # device kernels only: not the CPU ops above them, not the ranges that
    # record_function annotations (the optimizer's step) draw on the card
    kernels_only = sorted(
        (e for e in prof.key_averages()
         if _device_us(e) > 0 and "cuda" in str(
             getattr(e, "device_type", "")).lower()
         and not getattr(e, "is_user_annotation", False)
         and "#" not in e.key),
        key=_device_us, reverse=True)
    if not kernels_only:
        say("train: profile: no device time recorded (not measured)")
    else:
        ktotal = sum(_device_us(e) for e in kernels_only) / 1e3
        say(f"train: profiled step: {prof_wall * 1e3:.1f} ms wall, "
            f"{ktotal:.2f} ms of kernel time in {len(kernels_only)} kernels "
            f"(device busy share {ktotal / (prof_wall * 1e3):.3f}); "
            f"launches {sum(e.count for e in kernels_only)}")
        for e in kernels_only[:12]:
            say(f"train:   {_device_us(e) / 1e3:9.3f} ms {e.count:5d}x "
                f"{e.key[:90]}")
    return launches, dict(steps_s=steps_s, mfu=mfu, losses=losses,
                          peak_gib=peak / 2**30)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def phase_train_parity(dev):
    """One fp32 step on the card and on the CPU from the same weights and
    the same attention-dropout seeds (hidden dropout 0: a CUDA and a CPU
    generator draw different bits)."""
    import torch

    from paddle_tpu_torch import AdamW, ErnieConfig, ErnieForPretraining

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ErnieConfig(num_hidden_layers=2, hidden_dropout_prob=0.0)
    ids, labels = _ernie_batch(cfg, 2, TRAIN_SEQ, 1)
    results = []
    for where in (dev, torch.device("cpu")):
        model = ErnieForPretraining(cfg, device=where, seed=3)
        model.train()
        opt = AdamW(model.named_parameters(), learning_rate=TRAIN_LR,
                    device=where)
        loss = model.pretraining_loss(ids.to(where), labels.to(where))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        opt.step()
        params = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        results.append((loss.item(), grads, params))
        del model, opt
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = results
    if set(g_gpu) != set(g_cpu):
        raise AssertionError("train parity: different parameters got grads")
    # each tensor's error over its largest entry, floored at 1e-3 of the
    # largest entry of all: a gradient that is 0 in exact arithmetic
    # (the k_proj bias: softmax ignores a per-row shift) is rounding noise
    # on both sides and has no scale of its own
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst = max(((g_gpu[n] - g_cpu[n]).abs().max().item()
                 / max(g_cpu[n].abs().max().item(), 1e-3 * top), n)
                for n in g_cpu)
    step_diff = max((p_gpu[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    say(f"train parity: fp32 2-layer ERNIE-base width, batch 2 seq 512, "
        f"attention dropout {cfg.attention_probs_dropout_prob}: loss card "
        f"{l_gpu:.7f} cpu {l_cpu:.7f} (rel {loss_rel:.2e}, tol 1e-5); "
        f"worst gradient error {worst[0]:.2e} of its tensor's largest "
        f"entry, floored at 1e-3 of the largest of all ({worst[1]}; tol "
        f"1e-3); {len(g_cpu)} gradients; largest "
        f"parameter difference after the AdamW step {step_diff:.2e} "
        f"(tol {2 * TRAIN_LR:.0e}: a near-zero gradient whose sign "
        "differs moves its weight by at most 2 lr on the first step)")
    if not (loss_rel <= 1e-5 and worst[0] <= 1e-3
            and step_diff <= 2 * TRAIN_LR + 1e-6):
        raise AssertionError("train parity: card and CPU disagree")


def _prompts(rng, lengths, vocab):
    return [rng.integers(0, vocab, size=n).astype("int32") for n in lengths]


def phase_serve(dev, quantize: bool = False):
    """Phase 5 (bf16) or, with ``quantize``, phase 7 (int8 weights and int8
    KV pools): 16 requests through ServingEngine on GPT-350M; every launch
    count is set to 0 just before the requests are driven and read just
    after."""
    import numpy as np
    import torch

    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, SamplingParams,
                                  ServingConfig, ServingEngine)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    tag = "serve-int8" if quantize else "serve"
    conf = dict(SERVE, quantize_weights=quantize, quantize_kv=quantize)
    t0 = time.perf_counter()
    cfg = GPTConfig(**GPT350M)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{tag}: GPT-350M bf16 ({n_params / 1e6:.1f} M parameters) built "
        f"in {time.perf_counter() - t0:.1f} s"
        + ("; the engine quantizes its linears to int8 and its KV pools "
           "to int8 with f32 scales" if quantize else ""))
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    warm = ServingEngine(model, ServingConfig(**conf), device=dev)
    warm.submit(_prompts(rng, [130], cfg.vocab_size)[0],
                SamplingParams(max_new_tokens=4))
    warm.run_until_done()
    del warm

    lengths = np.linspace(100, 1000, 16).astype(int)
    prompts = _prompts(rng, lengths, cfg.vocab_size)
    eng = ServingEngine(model, ServingConfig(**conf), device=dev)
    if quantize:
        del model  # the engine serves its own int8 copy
    kernels = {"flash_fwd": fa.KERNEL, "paged_attention": pa.KERNEL,
               "paged_attention_int8": pa.INT8_KERNEL}
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rids = [eng.submit(p, SamplingParams(max_new_tokens=64))
            for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kern.launches for n, kern in kernels.items()}
    m = eng.metrics
    for rid in rids:
        req = eng.request(rid)
        out = eng.output(rid)
        if not req.finished or out.size != 64:
            raise AssertionError(f"request {rid}: {req.state} with "
                                 f"{out.size} tokens ({req.error})")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: token out of range")
    if m.requests_finished.value != len(prompts):
        raise AssertionError(f"{m.requests_finished.value} of "
                             f"{len(prompts)} requests finished")
    paged = "paged_attention_int8" if quantize else "paged_attention"
    want = {"flash_fwd": cfg.num_layers * m.prefills.value,  # buckets >= 128
            "paged_attention": 0, "paged_attention_int8": 0}
    want[paged] = cfg.num_layers * m.decode_steps.value
    if launches["flash_fwd"] == 0 or launches[paged] == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    summary = m.summary_dict()
    for L, h in summary["prefill_s"].items():
        say(f"{tag}: prefill bucket {L}: {h['count']} prefills, mean "
            f"{h['mean'] * 1e3:.3f} ms, max {h['max'] * 1e3:.3f} ms")
    dec = summary["decode_step_s"]
    decode_tokens = m.tokens_emitted.value - m.prefills.value
    decode_s = m.decode_step_s.sum
    say(f"{tag}: {m.decode_steps.value} decode steps, mean "
        f"{dec['mean'] * 1e3:.3f} ms, p50 {dec['p50'] * 1e3:.3f} ms, p99 "
        f"{dec['p99'] * 1e3:.3f} ms; decode {decode_tokens / decode_s:.1f} "
        f"tokens/s; {m.tokens_emitted.value} tokens in {wall:.2f} s "
        f"({m.tokens_emitted.value / wall:.1f} tokens/s end to end)")
    ttft, gap = summary["ttft_s"], summary["inter_token_s"]
    say(f"{tag}: {m.requests_submitted.value} requests sent, "
        f"{m.requests_finished.value} finished, {m.requests_failed.value} "
        f"failed; ttft p50 {ttft['p50'] * 1e3:.1f} ms max "
        f"{ttft['max'] * 1e3:.1f} ms; inter-token p50 "
        f"{gap['p50'] * 1e3:.2f} ms p99 {gap['p99'] * 1e3:.2f} ms")
    if quantize:
        say(f"{tag}: kv_quant_bytes_saved {m.kv_quant_bytes_saved.value} "
            f"(against the bf16 pools), weight_quant_bytes_saved "
            f"{m.weight_quant_bytes_saved.value} (against f32 weights)")
    say(f"{tag}: launches during serving {launches} (flash: 24 per "
        f"prefill, {paged}: 24 per decode step); peak memory "
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


def phase_quant_parity(dev):
    """A 2-layer GPT-350M-width model in fp32 with TF32 off, the same
    weights on the card and on the CPU, each behind a quantized engine:
    the greedy streams must be identical, and the int8-weight models'
    logits over the prompts and their completions must agree within
    QPARITY_RTOL of the largest |logit|."""
    import numpy as np
    import torch

    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, SamplingParams,
                                  ServingConfig, ServingEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**dict(GPT350M, num_layers=2))
    prompts = _prompts(np.random.default_rng(2), [150, 333, 700],
                       cfg.vocab_size)
    new = 16
    runs = []
    for where in (dev, torch.device("cpu")):
        model = GPTForCausalLM(cfg, device=where, dtype=torch.float32,
                               seed=2)
        eng = ServingEngine(model, ServingConfig(
            **SERVE, quantize_weights=True, quantize_kv=True), device=where)
        rids = [eng.submit(p, SamplingParams(max_new_tokens=new))
                for p in prompts]
        eng.run_until_done()
        streams = [eng.output(r) for r in rids]
        with torch.inference_mode():
            logits = [eng.model(torch.from_numpy(
                eng.full_output(r)[None].astype(np.int64)).to(where))[0]
                .cpu() for r in rids]
            fp = [model(torch.from_numpy(
                eng.full_output(r)[None].astype(np.int64)).to(where))[0]
                .cpu() for r in rids]
        drift = max((a - b).abs().max().item() for a, b in zip(logits, fp))
        eng.note_logit_drift(drift)
        runs.append((streams, logits, eng.metrics.quant_logit_drift_max.value))
        del model, eng
    (s_gpu, l_gpu, d_gpu), (s_cpu, l_cpu, d_cpu) = runs
    for i, (a, b) in enumerate(zip(s_gpu, s_cpu)):
        if not np.array_equal(a, b):
            raise AssertionError(f"quant parity: request {i}: card "
                                 f"{a.tolist()} != cpu {b.tolist()}")
    top = max(x.abs().max().item() for x in l_cpu)
    err = max((a - b).abs().max().item() for a, b in zip(l_gpu, l_cpu))
    say(f"quant parity: fp32 2-layer GPT-350M width, int8 weights and KV: "
        f"card == cpu greedy streams for {len(prompts)} requests of {new} "
        f"tokens (prompts {[p.size for p in prompts]}); logits max abs "
        f"diff {err:.3g} against largest |logit| {top:.3g} (tol "
        f"{QPARITY_RTOL} of it); int8-vs-fp logit drift card {d_gpu:.4g} "
        f"cpu {d_cpu:.4g}")
    if err > QPARITY_RTOL * top:
        raise AssertionError("quant parity: card and CPU logits disagree")


def main() -> int:
    global TAG
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: phase 2 also "
                         "times its dQ and paged kernels, in turns with "
                         "this tree's, on the same inputs")
    args = ap.parse_args()
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
        resources = phase_build()
        if args.parent:
            _bind_parent(args.parent)
        kernels = phase_kernels(dev)
        variants = phase_variant_kernels(dev)
        kernels.update(phase_train_kernels(dev))
        train_launches, _ = phase_train(dev)
        phase_train_parity(dev)
        launches, _ = phase_serve(dev)
        phase_parity(dev)
        q_launches, _ = phase_serve(dev, quantize=True)
        phase_quant_parity(dev)
    except Exception:
        traceback.print_exc()
        say("FAILED")
        return 1
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    fd = kernels["fwd_dropout"]
    p = kernels["paged_attention"][0]
    p8 = kernels["paged_attention_int8"][0]
    flash_errs = [r["max_abs_err"] for r in kernels["flash_fwd"]] + [
        fd["max_abs_err"], kernels["fwd_window"]["max_abs_err"]]

    def row(name, src, replaces, n, r, err=None):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{src}",
                "replaces": f"paddle_tpu/ops/pallas/{replaces}",
                "launches": n,
                "max_abs_err": r["max_abs_err"] if err is None else err,
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    # flash_fwd: launches in every path; times at the training shape.
    # "variants": the fp16 and head-dim-80 checks of phase 2.
    summary = {"card": card, "kernels": [
        dict(row("flash_fwd", "flash_fwd.cu", "flash_attention.py:155",
                 launches["flash_fwd"] + train_launches["flash_fwd"]
                 + q_launches["flash_fwd"], fd, max(flash_errs)),
             launches_by_path={"serve": launches["flash_fwd"],
                               "train": train_launches["flash_fwd"],
                               "serve_int8": q_launches["flash_fwd"]}),
        dict(row("flash_bwd_dkv", "flash_bwd.cu", "flash_attention.py:272",
                 train_launches["flash_bwd_dkv"], kernels["dkv"]),
             library_bwd_ms=kernels["dkv"]["library_bwd_ms"]),
        dict(row("flash_bwd_dq", "flash_bwd.cu", "flash_attention.py:318",
                 train_launches["flash_bwd_dq"], kernels["dq"]),
             **{k: kernels["dq"][k] for k in (
                 "library_bwd_ms", "ms_no_dropout", "parent_ms",
                 "parent_ms_no_dropout")}),
        dict(row("paged_attention", "paged_attention.cu",
                 "paged_attention.py:151", launches["paged_attention"], p),
             **{k: p[k] for k in ("cluster", "parent_ms", "short_context")}),
        dict(row("paged_attention_int8", "paged_attention.cu",
                 "paged_attention.py:151", q_launches["paged_attention_int8"],
                 p8), branch="quantized=True (dequant at :185-187)",
             **{k: p8[k] for k in ("cluster", "parent_ms", "short_context")}),
    ], "variants": variants, "resources": resources}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
