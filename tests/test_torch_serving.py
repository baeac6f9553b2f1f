"""paddle_tpu_torch ServingEngine vs paddle_tpu's, with carried weights.

A tiny GPT (2 layers, hidden 128, 4 heads) is built in the JAX package and
carried into the port (convert.py). On the CPU both engines run their
plain attention paths in f32, and greedy streams must be TOKEN-IDENTICAL:
for interleaved variable-length requests against the JAX engine, and for a
starved pool that forces preemption (recompute + forced replay) against
an unstarved one. Seeded top-k is held to self-consistency: the same seed
gives the same stream — through preemption too — and the port's own
generate() with that seed.

Also: block-manager invariants (no leak, no double ownership, the same
allocation order as the JAX manager), EOS early stop, stream(), admission
bounds and failure isolation.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.compile import buckets as jbuckets
from paddle_tpu.serving import KVBlockManager as JKVBlockManager
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.compile import buckets as tbuckets
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (BlockError, KVBlockManager, QueueFull,
                                      RequestError, RequestState,
                                      SamplingParams, ServingConfig,
                                      ServingEngine)
from paddle_tpu_torch.serving.kv_block import prefix_hashes
from paddle_tpu.serving.kv_block import prefix_hashes as jprefix_hashes

from test_torch_gpt import make_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair("learned", seed=0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 1024, (n,)).astype(np.int32)
            for n in (5, 11, 3, 8)]


def _port_engine(tm, **kw):
    return ServingEngine(tm, ServingConfig(**kw), device="cpu")


def _interleaved(eng, prompts, max_new, params):
    """4 requests, staggered: two submitted, two steps, one more, one step,
    the last — requests join and leave the batch mid-flight."""
    rids = [eng.submit(prompts[0], params(max_new_tokens=max_new[0])),
            eng.submit(prompts[1], params(max_new_tokens=max_new[1]))]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], params(max_new_tokens=max_new[2])))
    eng.step()
    rids.append(eng.submit(prompts[3], params(max_new_tokens=max_new[3])))
    eng.run_until_done()
    return [eng.output(r) for r in rids]


def test_interleaved_streams_identical_to_jax_engine(pair, prompts):
    jm, tm = pair
    max_new = [6, 9, 12, 7]
    want = _interleaved(
        JServingEngine(jm, JServingConfig(num_slots=3, block_size=4,
                                          num_blocks=64)),
        prompts, max_new, JSamplingParams)
    eng = _port_engine(tm, num_slots=3, block_size=4, num_blocks=64)
    got = _interleaved(eng, prompts, max_new, SamplingParams)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    eng.blocks.assert_consistent()
    assert eng.blocks.num_allocated == 0
    # and each stream is the port's own solo generate
    for p, mn, g in zip(prompts, max_new, got):
        solo = tm.generate(p[None, :], max_new_tokens=mn).numpy()[0, p.size:]
        np.testing.assert_array_equal(g, solo)


def _run(tm, prompts, max_new, num_blocks, **params):
    eng = _port_engine(tm, num_slots=3, block_size=4, num_blocks=num_blocks)
    rids = [eng.submit(p, SamplingParams(max_new_tokens=mn, seed=100 + i,
                                         **params))
            for i, (p, mn) in enumerate(zip(prompts, max_new))]
    eng.run_until_done()
    return eng, [eng.output(r) for r in rids]


@pytest.mark.parametrize("top_k", [0, 5])
def test_starved_pool_preempts_and_streams_match_unstarved(pair, prompts,
                                                           top_k):
    _, tm = pair
    max_new = [6, 9, 12]
    roomy, want = _run(tm, prompts[:3], max_new, 64, top_k=top_k)
    assert roomy.metrics.preemptions.value == 0
    starved, got = _run(tm, prompts[:3], max_new, 9, top_k=top_k)
    assert starved.metrics.preemptions.value > 0, "scenario must preempt"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    starved.blocks.assert_consistent()
    assert starved.blocks.num_allocated == 0
    # the victim choice (newest running) is deterministic
    again, _ = _run(tm, prompts[:3], max_new, 9, top_k=top_k)
    assert again.scheduler.preempted_log == starved.scheduler.preempted_log


def test_seeded_topk_is_reproducible_and_matches_generate(pair, prompts):
    _, tm = pair
    p = prompts[1]
    streams = []
    for _ in range(2):
        eng = _port_engine(tm, num_slots=2, block_size=4, num_blocks=32)
        rid = eng.submit(p, SamplingParams(max_new_tokens=10, top_k=5,
                                           seed=42))
        eng.run_until_done()
        streams.append(eng.output(rid))
    np.testing.assert_array_equal(streams[0], streams[1])
    solo = tm.generate(p[None, :], max_new_tokens=10, top_k=5,
                       seed=42).numpy()[0, p.size:]
    np.testing.assert_array_equal(streams[0], solo)
    eng = _port_engine(tm, num_slots=2, block_size=4, num_blocks=32)
    rid = eng.submit(p, SamplingParams(max_new_tokens=10, top_k=5, seed=43))
    eng.run_until_done()
    assert not np.array_equal(eng.output(rid), streams[0])


def test_eos_early_stop_matches_generate(pair, prompts):
    jm, tm = pair
    p = prompts[0]
    free = tm.generate(p[None, :], max_new_tokens=8).numpy()[0, p.size:]
    eos = int(free[2])
    eng = _port_engine(tm, num_slots=2, block_size=4, num_blocks=32)
    rid = eng.submit(p, SamplingParams(max_new_tokens=8, eos_token_id=eos))
    eng.run_until_done()
    out = eng.output(rid)
    assert out[-1] == eos and out.size <= 3
    gen = tm.generate(p[None, :], max_new_tokens=8,
                      eos_token_id=eos).numpy()[0, p.size:]
    np.testing.assert_array_equal(out, gen[:out.size])
    jeng = JServingEngine(jm, JServingConfig(num_slots=2, block_size=4,
                                             num_blocks=32))
    jrid = jeng.submit(p, JSamplingParams(max_new_tokens=8,
                                          eos_token_id=eos))
    jeng.run_until_done()
    np.testing.assert_array_equal(out, jeng.output(jrid))


def test_stream_full_output_and_exact_length_fallback(pair, prompts):
    _, tm = pair
    # buckets up to 8 tokens: the 11-token prompt takes the exact path
    eng = _port_engine(tm, num_slots=2, block_size=4, num_blocks=32,
                       prefill_buckets=[4, 8])
    r0 = eng.submit(prompts[1], max_new_tokens=5)
    r1 = eng.submit(prompts[0], max_new_tokens=4)
    streamed = list(eng.stream(r0))
    eng.run_until_done()
    np.testing.assert_array_equal(streamed, eng.output(r0))
    np.testing.assert_array_equal(
        eng.full_output(r0), np.concatenate([prompts[1], eng.output(r0)]))
    assert eng.metrics.prefill_fallbacks.value == 1
    for rid, p, mn in ((r0, prompts[1], 5), (r1, prompts[0], 4)):
        solo = tm.generate(p[None, :], max_new_tokens=mn).numpy()[0, p.size:]
        np.testing.assert_array_equal(eng.output(rid), solo)
    summary = eng.metrics.summary_dict()
    assert summary["prefills"] == 2 and summary["tokens_emitted"] == 9
    assert set(summary["prefill_s"]) == {8, 11}


def test_admission_bounds(pair, prompts):
    _, tm = pair
    eng = _port_engine(tm, num_slots=1, block_size=4, num_blocks=8,
                       max_queue=1)
    eng.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(QueueFull):
        eng.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="KV blocks"):
        _port_engine(tm, num_slots=1, block_size=4, num_blocks=4).submit(
            prompts[1], max_new_tokens=8)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _port_engine(tm, num_slots=1, block_size=4, num_blocks=128).submit(
            prompts[1], max_new_tokens=250)


def test_non_finite_logits_fail_only_their_request(pair, prompts):
    _, tm = pair
    eng = _port_engine(tm, num_slots=2, block_size=4, num_blocks=32)
    r0 = eng.submit(prompts[0], max_new_tokens=6)
    r1 = eng.submit(prompts[1], max_new_tokens=6)
    eng.step()  # both prefilled; slot 0 holds r0
    head = tm.forward_head

    def poisoned(h):
        lg = head(h)
        if lg.shape[0] == 2:  # the decode step: poison slot 0
            lg[0] = float("nan")
        return lg

    tm.forward_head = poisoned
    try:
        eng.run_until_done()
    finally:
        del tm.forward_head
    assert eng.request(r0).state is RequestState.FAILED
    with pytest.raises(RequestError):
        list(eng.stream(r0))
    solo = tm.generate(prompts[1][None, :], max_new_tokens=6).numpy()
    np.testing.assert_array_equal(eng.output(r1), solo[0, prompts[1].size:])
    eng.blocks.assert_consistent()
    assert eng.blocks.num_allocated == 0


def test_block_manager_matches_jax_manager():
    """The same seeded op sequence on both managers: identical allocation
    order, refcounts and prefix-index answers, invariants after every op."""
    rng = np.random.default_rng(3)
    t, j = KVBlockManager(24, 4, prefix_cache=True), JKVBlockManager(
        24, 4, prefix_cache=True)
    owned = {}
    for step in range(300):
        op = rng.integers(0, 4)
        if op == 0 or not owned:
            n = int(rng.integers(1, 4))
            if t.can_alloc(n):
                ids = t.alloc(n, owner=step)
                assert ids == j.alloc(n, owner=step)
                owned[step] = ids
        elif op == 1:
            owner = list(owned)[int(rng.integers(0, len(owned)))]
            ids = owned.pop(owner)
            t.free(ids, owner=owner)
            j.free(ids, owner=owner)
        elif op == 2:
            owner = list(owned)[int(rng.integers(0, len(owned)))]
            toks = rng.integers(0, 50, (4 * len(owned[owner]),))
            hs = prefix_hashes(toks, 4)
            assert hs == jprefix_hashes(toks, 4)
            assert (t.register_prefix(hs, owned[owner])
                    == j.register_prefix(hs, owned[owner]))
            assert t.match_prefix(hs) == j.match_prefix(hs)
        else:
            assert t.num_free == j.num_free and t.num_cached == j.num_cached
        t.assert_consistent()
    with pytest.raises(BlockError):
        t.free([0])


def test_buckets_match_jax():
    for multiple, cap in ((4, 64), (16, 2048), (16, 1000)):
        assert (tbuckets.default_ladder(multiple, cap)
                == jbuckets.default_ladder(multiple, cap))
        lengths = [0, 3, 17, 64, 99, 1024, 5000]
        assert (tbuckets.normalize_buckets(lengths, multiple, cap)
                == jbuckets.normalize_buckets(lengths, multiple, cap))
        ladder = tbuckets.default_ladder(multiple, cap)
        for n in (1, 15, 16, 17, 999, 4096):
            assert (tbuckets.bucket_for(n, ladder)
                    == jbuckets.bucket_for(n, ladder))


@pytest.mark.parametrize("quantize", [False, True])
def test_head_dim_outside_the_kernels_serves_through_padded_pools(quantize):
    """hidden 160 over 2 heads gives D = 80, which no kernel is built for:
    the pools are allocated at 128 with the extra columns left zero, the
    130-token prompt's prefill takes the padded flash path, and the fp
    engine's greedy stream equals generate()'s. The int8 engine serves
    through its padded int8 pools the same way."""
    cfg = GPTConfig(vocab_size=64, hidden_size=160, num_layers=1,
                    num_heads=2, max_position_embeddings=256)
    tm = GPTForCausalLM(cfg, device="cpu", seed=3)
    prompt = np.random.default_rng(8).integers(0, 64, (130,)).astype(
        np.int32)
    eng = _port_engine(tm, num_slots=2, block_size=16, num_blocks=16,
                       quantize_weights=quantize, quantize_kv=quantize)
    pool = eng._kpools[0]
    assert pool.shape == (16, 16, 2, 128)
    rid = eng.submit(prompt, max_new_tokens=6)
    eng.run_until_done()
    assert eng.request(rid).finished and eng.output(rid).size == 6
    data = pool.data if quantize else pool
    assert not data[..., 80:].any()
    if not quantize:
        solo = tm.generate(prompt[None, :], max_new_tokens=6).numpy()
        np.testing.assert_array_equal(eng.output(rid), solo[0, 130:])
