"""paddle_tpu_torch's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA card (the kernels have no CPU mode) and
skips without one. The file imports only torch, numpy and the port, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 inputs differ from the plain version only in summation
order (1e-5); bf16 outputs may differ by one bf16 rounding step (2^-6 for
|x| < 4, and attention outputs are convex sums of N(0, 1) values), f16
outputs by one f16 step (2^-9 for |x| < 4, so 2e-3); lse is f32 on both
sides (1e-4). Gradients: f32 1e-4 (three products deep, each summed in
another order), bf16 one bf16 step of the value (rtol 2^-7) plus 1.6e-2,
f16 one f16 step (rtol 2^-10) plus 4e-3. The bf16 / f16 forward,
dK/dV and dQ kernels run on the tensor cores and also round p (and dS) to
the input type before their second product, half a step of a value below 1
spread over the row's sum, inside the same tolerances. Dropout masks are
integer hashes: bit-identical. The int8 paged branch dequantizes the same int8
payloads and f32 scales on both sides, so it takes the fp tolerances of
q's dtype.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.quantization import kv as tkv

torch.set_num_threads(1)

TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 1.6e-2),
        (torch.float16, 2e-3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("S,causal,padded", [(200, True, True),
                                             (256, False, False),
                                             (128, True, False)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, S, causal,
                                    padded, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, 4, D))
                                .astype(np.float32)).to(cuda_device, dtype)
               for _ in range(3))
    kvb = None
    if padded:  # batch 0 masks its last 40 keys, batch 1 every key
        b = np.zeros((2, S), np.float32)
        b[0, S - 40:] = -1e9
        b[1] = -np.inf
        kvb = torch.from_numpy(b).to(cuda_device)
    before = tfa.KERNEL.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, kvb, causal=causal)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    want_out, want_lse = tfa.flash_attention_plain(q, k, v, kvb, causal)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    if padded:
        assert bool((out[1] == 0).all())


# (D, BS, M): short tables, whose walk the kernel splits over 1, 2 and 4
# blocks of a cluster, and long ones (128 pages of 16 tokens) split over 8
PAGED_SHAPES = [(32, 4, 8), (64, 16, 8), (128, 32, 8),
                (32, 16, 128), (64, 16, 128), (128, 16, 128)]


def _paged_positions(M, BS, s):
    """Short tables: row 0 overruns the table, row 2 ends in a null-block
    tail; long: rows near 2,000 and ~1,000 tokens and one of 18, whose
    walk leaves most cluster ranks without a visible token. The last query
    of row 3 has pos = -1 and sees nothing: zeros."""
    start = ([M * BS - 2, 3 * BS + 1, 2 * BS, 0] if M == 8
             else [1990, 1003, 17, 0])
    pos = (np.array(start)[:, None] + np.arange(s)[None, :]).astype(np.int32)
    pos[3, -1] = -1
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("D,BS,M", PAGED_SHAPES)
def test_paged_kernel_matches_plain(cuda_device, dtype, atol, s, D, BS, M):
    rng = np.random.default_rng(s + D if M == 8 else 1000 + s + D)
    B, H, NB = 4, 4, 40
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, H, D)).astype(np.float32)
    table = rng.integers(1, NB, (B, M)).astype(np.int32)
    table[2, 5:] = 0                           # null-block tail
    pos = _paged_positions(M, BS, s)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (q, kp, vp)]
    table_t = torch.from_numpy(table).to(cuda_device)
    pos_t = torch.from_numpy(pos).to(cuda_device)
    before = tpa.KERNEL.launches
    got = tpa.paged_attention(*args, table_t, pos_t, block_size=BS)
    torch.cuda.synchronize()
    assert tpa.KERNEL.launches == before + 1
    want = tpa.paged_attention_plain(*args, table_t, pos_t, block_size=BS)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert bool((got[3, -1] == 0).all())


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 128, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros(2, 1, 2, 64, device=cuda_device)
    pool = torch.zeros(4, 4, 2, 64, device=cuda_device)
    table = torch.zeros(2, 3, dtype=torch.int64, device=cuda_device)
    pos = torch.zeros(2, 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, pool, pool, table, pos, block_size=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("D,BS,M", PAGED_SHAPES)
def test_int8_paged_kernel_matches_plain(cuda_device, dtype, atol, s, D, BS,
                                         M):
    """The int8 branch: pools quantized per row (absmax over D) with f32
    scales; the positions of `_paged_positions`, a null-block tail, a
    pos = -1 row that must come out as zeros."""
    rng = np.random.default_rng(100 + s + D if M == 8 else 1100 + s + D)
    B, H, NB = 4, 4, 40
    q = torch.from_numpy(rng.standard_normal((B, s, H, D)).astype(
        np.float32)).to(cuda_device, dtype)
    kq, vq = (tkv.quantize_pool(torch.from_numpy(rng.standard_normal(
        (NB, BS, H, D)).astype(np.float32)).to(cuda_device))
        for _ in range(2))
    table = rng.integers(1, NB, (B, M)).astype(np.int32)
    table[2, 5:] = 0
    pos = _paged_positions(M, BS, s)
    args = (q, kq.data, vq.data, torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(pos).to(cuda_device))
    kw = dict(block_size=BS, k_scale=kq.scale, v_scale=vq.scale)
    before = (tpa.KERNEL.launches, tpa.INT8_KERNEL.launches)
    got = tpa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (tpa.KERNEL.launches, tpa.INT8_KERNEL.launches) == (
        before[0], before[1] + 1)
    want = tpa.paged_attention_plain(*args, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert bool((got[3, -1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 80),
                                     (torch.bfloat16, 80),
                                     (torch.float16, 64),
                                     (torch.float16, 80)])
def test_sdpa_takes_head_dim_80_and_fp16_through_the_kernels(
        cuda_device, dtype, D):
    """scaled_dot_product_attention at S = 200, causal: D = 80 runs the
    kernels zero-padded to 128 at the scale 1 / sqrt(80), fp16 runs their
    f16 instantiation; forward and backward against the plain version
    under autograd."""
    atol, g_atol, g_rtol = {torch.float32: (1e-5, 1e-4, 0.0),
                            torch.bfloat16: (1.6e-2, 1.6e-2, 2.0 ** -7),
                            torch.float16: (2e-3, 4e-3, 2.0 ** -10)}[dtype]
    rng = np.random.default_rng(D)
    base = [torch.from_numpy(rng.standard_normal((2, 200, 4, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(4)]
    do = base[3]
    ours = [t.clone().requires_grad_(True) for t in base[:3]]
    ref = [t.clone().requires_grad_(True) for t in base[:3]]
    kernels = (tfa.KERNEL, tfa.DKV_KERNEL, tfa.DQ_KERNEL)
    before = [k.launches for k in kernels]
    out = tF.scaled_dot_product_attention(*ours, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    want, _ = tfa.flash_attention_plain(*ref, causal=True)
    want.backward(do)
    assert out.shape == want.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   atol=g_atol, rtol=g_rtol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,quantized", [
    (torch.bfloat16, 80, False), (torch.bfloat16, 80, True),
    (torch.float16, 64, False), (torch.float16, 80, True)])
def test_paged_takes_head_dim_80_and_fp16(cuda_device, dtype, D, quantized):
    """Pools as the model allocates them for D = 80 (at 128, the extra
    columns zero), fp or int8, and f16 queries: the kernel against the
    plain version over the unpadded pools."""
    atol = {torch.bfloat16: 1.6e-2, torch.float16: 2e-3}[dtype]
    rng = np.random.default_rng(D + quantized)
    B, H, NB, M, BS = 4, 4, 40, 8, 16
    Dp = 128 if D == 80 else D
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(
        np.float32)).to(cuda_device, dtype)
    pools = [torch.from_numpy(rng.standard_normal((NB, BS, H, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2)]
    wide = [torch.nn.functional.pad(p, (0, Dp - D)) for p in pools]
    kw, wkw = {}, {}
    if quantized:
        pools = [tkv.quantize_pool(p) for p in pools]
        wide = [tkv.quantize_pool(p) for p in wide]
        kw = dict(k_scale=pools[0].scale, v_scale=pools[1].scale)
        wkw = dict(k_scale=wide[0].scale, v_scale=wide[1].scale)
        pools = [p.data for p in pools]
        wide = [p.data for p in wide]
    table = torch.from_numpy(rng.integers(1, NB, (B, M)).astype(
        np.int32)).to(cuda_device)
    pos = torch.tensor([[M * BS - 1], [40], [3], [-1]], dtype=torch.int32,
                       device=cuda_device)
    kern = tpa.INT8_KERNEL if quantized else tpa.KERNEL
    before = kern.launches
    got = tpa.paged_attention(q, *wide, table, pos, block_size=BS, **wkw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = tpa.paged_attention_plain(q, *pools, table, pos, block_size=BS,
                                     **kw)
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert bool((got[3] == 0).all())


BWD_TOLS = [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 1.6e-2, 2.0 ** -7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", BWD_TOLS)
@pytest.mark.parametrize("S,causal,p,window,padded", [
    (256, False, 0.1, 0, False), (200, True, 0.0, 0, True),
    (200, False, 0.1, 0, True), (256, True, 0.1, 64, False)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_forward_and_backward_kernels_match_plain(
        cuda_device, dtype, atol, rtol, S, causal, p, window, padded, D):
    rng = np.random.default_rng(S + D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, S, 4, D))
                                    .astype(np.float32)).to(cuda_device, dtype)
                   for _ in range(4))
    kvb = None
    if padded:
        b = np.zeros((2, S), np.float32)
        b[0, S - 40:] = -1e9
        kvb = torch.from_numpy(b).to(cuda_device)
    args = (causal, None, p, -99, window)
    out, lse = tfa.flash_attention_fwd(q, k, v, kvb, *args)
    want_out, want_lse = tfa.flash_attention_plain(q, k, v, kvb, *args)
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=1e-5 if dtype == torch.float32
                               else 1.6e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    before = (tfa.DKV_KERNEL.launches, tfa.DQ_KERNEL.launches)
    got = tfa.flash_attention_bwd(q, k, v, kvb, out, lse, do, *args)
    torch.cuda.synchronize()
    assert (tfa.DKV_KERNEL.launches, tfa.DQ_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(q, k, v, kvb, out, lse, do, *args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol, msg=name)
    again = tfa.flash_attention_bwd(q, k, v, kvb, out, lse, do, *args)
    for g, g2 in zip(got, again):  # no atomics: the same bits every run
        assert torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_draw_the_plain_versions_dropout_masks(cuda_device, dtype):
    """f32 reads the CUDA-core kernels' masks, bf16 the tensor-core
    ones'."""
    masks = tfa.probe_dropout_masks(2, 3, 320, 0.1, -2**31, cuda_device,
                                    dtype)
    want = tfa._keep_bhqk(-2**31, 0.1, 2, 3, 320, 320, cuda_device)
    for name, got in masks.items():
        assert torch.equal(got, want), name


GRAD_TOLS = {torch.bfloat16: (1.6e-2, 2.0 ** -7),
             torch.float16: (4e-3, 2.0 ** -10)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", TOLS[1:])
@pytest.mark.parametrize("Sq,Sk,causal,p,biased", [
    (200, 328, False, 0.1, True),   # Sq != Sk, both ragged, key padding
    (130, 70, False, 0.0, False),   # more rows than keys, one ragged tile
    (40, 200, False, 0.1, False),   # Sq < 64: one ragged q tile
    (40, 40, True, 0.1, False)])    # Sq = Sk < 64, causal
@pytest.mark.parametrize("D", [32, 64, 128])
def test_tensor_core_kernels_take_uneven_shapes(cuda_device, dtype, atol, Sq,
                                                Sk, causal, p, biased, D):
    """bf16 / f16 forward and backward kernels where tiles are ragged or
    q and k differ in length, against the plain versions."""
    rng = np.random.default_rng(Sq * Sk + D)
    q, do = (torch.from_numpy(rng.standard_normal((2, Sq, 4, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, Sk, 4, D)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    kvb = None
    if biased:
        b = np.zeros((2, Sk), np.float32)
        b[0, Sk - 50:] = -np.inf
        kvb = torch.from_numpy(b).to(cuda_device)
    args = (causal, None, p, 77, 0)
    kernels = (tfa.KERNEL, tfa.DKV_KERNEL, tfa.DQ_KERNEL)
    before = [x.launches for x in kernels]
    out, lse = tfa.flash_attention_fwd(q, k, v, kvb, *args)
    got = tfa.flash_attention_bwd(q, k, v, kvb, out, lse, do, *args)
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(kernels, before)] == [1, 1, 1]
    want_out, want_lse = tfa.flash_attention_plain(q, k, v, kvb, *args)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    want = tfa.flash_attention_bwd_plain(q, k, v, kvb, out, lse, do, *args)
    g_atol, g_rtol = GRAD_TOLS[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=g_atol,
                                   rtol=g_rtol, msg=name)


@pytest.mark.cuda
def test_autograd_launches_each_kernel_once(cuda_device):
    q, k, v = (torch.randn(2, 256, 4, 64, device=cuda_device,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    kernels = (tfa.KERNEL, tfa.DKV_KERNEL, tfa.DQ_KERNEL)
    before = [x.launches for x in kernels]
    out = tfa.flash_attention(q, k, v, dropout_p=0.1, dropout_seed=5)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(kernels, before)] == [1, 1, 1]
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16
               for t in (q, k, v))
