"""paddle_tpu_torch's quantized serving vs paddle_tpu's, with carried
weights: ``ServingConfig(quantize_weights=True, quantize_kv=True)``.

The setup is tests/test_quantized_serving.py's ``qref``: ``GPTConfig.tiny()``
from ``paddle.seed(0)``, 2 slots, 16-token blocks, 16 blocks, greedy
requests of 8 new tokens. The JAX engine is built ONCE (module fixture)
and serves two interleaved requests; its int8 decode runs the Pallas
kernel in interpret mode. The port's engine serves the same requests on
the CPU through its plain versions. Greedy streams must be
TOKEN-IDENTICAL, and the bytes-saved counters equal.

Weights: the port's int8 payloads and scales are the JAX package's
transposed, bit for bit. Logits: the port's int8-weight model against the
JAX package's
(``dequantize_params`` of ``quantize_params``) on the same ids, f32,
atol = rtol = 1e-4 (two layers of the same f32 arithmetic in another
order, as tests/test_torch_gpt.py holds the fp model). The drift of
quantized against fp logits is recorded through
``ServingEngine.note_logit_drift``; its bound is the JAX package's own
test, not restated here.

Nothing here changes a paddle_tpu module global (the JAX engine takes its
fused int8 kernel by default: ``use_fused_default(quantized=True)``).
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.framework.core import Tensor
from paddle_tpu.quantization import weights as jw
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.convert import quantized_linear_from_jax
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.parallel import comm_compress as tcc
from paddle_tpu_torch.quantization import kv as tkv
from paddle_tpu_torch.quantization import weights as tw
from paddle_tpu_torch.serving import (SamplingParams, ServingConfig,
                                      ServingEngine)

from test_torch_gpt import make_pair

torch.set_num_threads(1)

QCFG = dict(quantize_weights=True, quantize_kv=True)
BASE = dict(num_slots=2, block_size=16, num_blocks=16)
LOGIT_ATOL = LOGIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX GPTConfig.tiny() from paddle.seed(0), port copy), f32."""
    return make_pair("learned", seed=0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in (12, 7)]


def _interleaved(eng, prompts, params):
    """Request 0 alone for one step, then request 1 joins it."""
    r0 = eng.submit(prompts[0], params(max_new_tokens=8))
    eng.step()
    r1 = eng.submit(prompts[1], params(max_new_tokens=8))
    eng.run_until_done()
    return [eng.output(r).tolist() for r in (r0, r1)]


@pytest.fixture(scope="module")
def jax_run(pair, prompts):
    """The JAX quantized engine's streams and bytes-saved counters."""
    jm, _ = pair
    eng = JServingEngine(jm, JServingConfig(metrics_name=None, **BASE,
                                            **QCFG))
    streams = _interleaved(eng, prompts, JSamplingParams)
    m = eng.metrics
    return streams, (m.kv_quant_bytes_saved.value,
                     m.weight_quant_bytes_saved.value)


@pytest.fixture(scope="module")
def jax_quantized(pair):
    """The JAX package's quantized params (``quantize_params``) and
    buffers of the same model."""
    jm, _ = pair
    params, buffers = jm.functional_state()
    return jw.quantize_params(params, jw.linear_weight_names(jm)), buffers


@pytest.fixture(scope="module")
def port_engine(pair):
    _, tm = pair
    return ServingEngine(tm, ServingConfig(**BASE, **QCFG), device="cpu")


def test_quantized_streams_identical_to_jax_engine(pair, prompts, jax_run,
                                                   port_engine):
    _, tm = pair
    streams, saved = jax_run
    eng = port_engine
    before = (tpa.KERNEL.launches, tpa.INT8_KERNEL.launches)
    assert _interleaved(eng, prompts, SamplingParams) == streams
    assert (tpa.KERNEL.launches, tpa.INT8_KERNEL.launches) == before
    m = eng.metrics
    assert (m.kv_quant_bytes_saved.value,
            m.weight_quant_bytes_saved.value) == saved
    assert all(tkv.is_quantized(p) and p.data.dtype == torch.int8
               for p in eng._kpools + eng._vpools)
    assert isinstance(eng.model.gpt.blocks[0].attn.qkv, tw.QuantizedLinear)
    # the engine quantized its own copy: the caller's model stays fp
    assert isinstance(tm.gpt.blocks[0].attn.qkv, torch.nn.Linear)
    eng.blocks.assert_consistent()
    assert eng.blocks.num_allocated == 0


def test_quantized_weights_are_jax_payloads_transposed(pair, jax_quantized,
                                                       port_engine):
    jm, _ = pair
    jq, _ = jax_quantized
    names = jw.linear_weight_names(jm)
    qmodel = port_engine.model
    assert len(names) == 4 * qmodel.gpt.cfg.num_layers
    assert [f"{n}.weight" for n, m in qmodel.named_modules()
            if isinstance(m, tw.QuantizedLinear)] == names
    for name in names:
        mod = qmodel.get_submodule(name[:-len(".weight")])
        data, scale = quantized_linear_from_jax(jq[name].data,
                                                jq[name].scale)
        assert torch.equal(mod.data, data), name
        assert torch.equal(mod.scale, scale), name
        # bf16: dequant_absmax's f32 product, rounded once
        assert torch.equal(mod.dequantize(torch.bfloat16), tcc.dequant_absmax(
            data, scale).to(torch.bfloat16)), name
    assert tw.quantized_bytes_saved(qmodel) == jw.quantized_bytes_saved(jq)
    assert tw.params_bytes(qmodel) == jw.params_bytes(jq)


def test_quantized_logits_match_jax_and_drift_is_recorded(
        pair, jax_quantized, port_engine):
    jm, tm = pair
    jq, buffers = jax_quantized
    ids = np.random.default_rng(3).integers(0, 1024, (4, 24)).astype(
        np.int32)

    @jax.jit
    def jax_logits(p, i):
        out, _ = jm.functional_call(jw.dequantize_params(p), buffers,
                                    Tensor(i), training=False,
                                    forward_fn=lambda t: jm(t))
        return out._value

    want = np.asarray(jax_logits(jq, ids))
    with torch.inference_mode():
        got = port_engine.model(torch.from_numpy(ids)).numpy()
        fp = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    drift = float(np.abs(got - fp).max())
    assert drift > 0  # int8 weights move the logits
    port_engine.note_logit_drift(drift)
    port_engine.note_logit_drift(drift / 2)
    assert port_engine.metrics.quant_logit_drift_max.value == drift
    summary = port_engine.metrics.summary_dict()
    assert summary["quant_logit_drift_max"] == drift
    assert summary["weight_quant_bytes_saved"] > 0
    assert summary["kv_quant_bytes_saved"] > 0
