"""Seeded sampled ``LLM.generate`` through the port vs ``aphrodite_tpu.LLM``
on the same weights (fp32, CPU).

Both engines draw each request's noise from threefry keyed by its seed and
output position, so sampled tokens are compared token for token. The two
Gumbel draws differ by the logs' last ulp, so a token may part only where
the reference's two best noisy scores lie within that (a near tie). The
cases here show none: each case pins its partings at the count observed,
0 (``PARTINGS``).

Covered: the wave (chunked prefill at a 32-token budget) and the decode
window (64 sub-steps, and single-step decode) under the API, creative-chat
and penalised presets, the advanced stages, a ``sampler_priority`` order
and the constraint stages (min_tokens, logit_bias); the
history-reading stages (DRY, penalties, no-repeat-ngram) riding the
window's sub-steps; the multi-step path (tiny Gemma-2) and the SSM window
(tiny Mamba); ``n = 2``; top-k ``logprobs``; ``prompt_logprobs``; unseeded
requests under the ``base_seed + r * 7919`` rule; and the fields that
still raise. Logprobs agree within 1e-4 (fp32 forwards in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax
from aphrodite_tpu_torch.ops.gumbel_sample import gumbel_sample
from aphrodite_tpu_torch.sampling_params import (
    GuidedDecodingParams as PortGuided)

MAX_TOKENS = 24
LP_TOL = 1e-4
PRESETS = {
    "api": dict(temperature=0.7, top_p=0.9, top_k=40, logprobs=5),
    "creative": dict(temperature=1.0, min_p=0.05, repetition_penalty=1.1,
                     dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
                     dry_sequence_breaker_ids=[3, 7], xtc_threshold=0.1,
                     xtc_probability=0.5),
    "penalised": dict(temperature=0.8, top_p=0.95, presence_penalty=0.5,
                      frequency_penalty=0.3, no_repeat_ngram_size=3,
                      temperature_last=True),
    "advanced": dict(temperature=1.1, top_a=0.05, tfs=0.95, eta_cutoff=2,
                     epsilon_cutoff=1, typical_p=0.95, smoothing_factor=0.2,
                     nsigma=2.0, dynatemp_min=0.6, dynatemp_max=1.4,
                     skew=0.2),
    "priority": dict(temperature=0.9, top_k=50, min_p=0.02,
                     repetition_penalty=1.2, sampler_priority=[
                         "MIN_P", "TOP_K", "TOP_P", "TEMPERATURE", "DRY",
                         "PENALTIES", "NO_REPEAT_NGRAM", "TOP_A", "TFS",
                         "ETA", "EPSILON", "TYPICAL", "QUADRATIC", "XTC",
                         "TOP_NSIGMA"]),
    "constraints": dict(temperature=1.0, min_tokens=20,
                        stop_token_ids=[5, 9], logit_bias={11: 4.0, 12: -3.0}),
}
# Partings (near ties) observed per case; see the module docstring.
PARTINGS = {name: 0 for name in PRESETS}


def _qwen_kwargs(**kw):
    from transformers import Qwen2Config
    hf = Qwen2Config(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=8, num_key_value_heads=2,
                     intermediate_size=256, max_position_embeddings=512,
                     rms_norm_eps=1e-6, tie_word_embeddings=False,
                     architectures=["Qwen2ForCausalLM"])
    return {**dict(hf_config=hf, tokenizer="unused", dtype="float32",
                   load_format="dummy", device="cpu", block_size=16,
                   num_kv_blocks=128, max_num_seqs=4,
                   max_num_batched_tokens=32, max_model_len=256), **kw}


@pytest.fixture(scope="module")
def qwen():
    jax_llm = JaxLLM("dummy", **_qwen_kwargs())
    tree = jax_llm.engine.core.worker.params
    ports = {}
    for window in (64, 1):
        port = LLM("dummy", decode_window=window, **_qwen_kwargs())
        port.engine.core.worker.load_params(params_from_jax(tree))
        ports[window] = port
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (5, 40, 17, 70)]
    return jax_llm, ports, prompts


def _params(preset, seeded=True, **kw):
    base = {**PRESETS.get(preset, {}), "max_tokens": MAX_TOKENS,
            "ignore_eos": True, **kw}
    pick = lambda i: ({"seed": 1000 + 17 * i} if seeded else {})  # noqa
    return ([JaxParams(**base, **pick(i)) for i in range(4)],
            [SamplingParams(**base, **pick(i)) for i in range(4)])


def _partings(want, got):
    return sum(a != b for w, g in zip(want, got) for a, b in zip(w, g))


def _tokens(outs):
    return [c.token_ids for o in outs for c in o.outputs]


@pytest.mark.parametrize("window", [64, 1])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_seeded_tokens_match(qwen, preset, window):
    jax_llm, ports, prompts = qwen
    jp, tp = _params(preset)
    want = jax_llm.generate(prompts, jp)
    gumbel_sample.launches = 0
    got = ports[window].generate(prompts, tp)
    lens = [len(t) for t in _tokens(got)]
    assert lens == [len(t) for t in _tokens(want)]
    if preset != "constraints":  # stop_token_ids may end a request early
        assert lens == [MAX_TOKENS] * 4
    assert _partings(_tokens(want), _tokens(got)) == PARTINGS[preset]
    # Sampled, not greedy: the tokens differ from the argmax run's.
    greedy = ports[window].generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True))
    assert _tokens(greedy) != _tokens(got)
    assert gumbel_sample.launches == 0  # CPU tensors: the plain version
    if preset == "constraints":
        for toks in _tokens(got):  # min_tokens: no stop before 20
            assert len(toks) >= 20 and not {5, 9} & set(toks[:19])


def test_allowed_token_ids(qwen):
    """Port only: the JAX processor's own check of allowed_token_ids reads
    an attribute it lacks (``engine/processor.py:181``), so the reference
    engine takes no such request; the stage itself is held against JAX in
    ``test_torch_sampler.py``."""
    _, ports, prompts = qwen
    allowed = list(range(0, 512, 8))
    outs = ports[64].generate(prompts, SamplingParams(
        temperature=1.0, seed=5, max_tokens=MAX_TOKENS, ignore_eos=True,
        allowed_token_ids=allowed))
    assert all(t % 8 == 0 for toks in _tokens(outs) for t in toks)
    with pytest.raises(ValueError):
        ports[64].generate(prompts[:1], SamplingParams(
            temperature=1.0, allowed_token_ids=list(range(65))))


def test_top_logprobs_match(qwen):
    jax_llm, ports, prompts = qwen
    jp, tp = _params("api")
    want = jax_llm.generate(prompts, jp)
    got = ports[64].generate(prompts, tp)
    for w, g in zip(want, got):
        wl, gl = w.outputs[0].logprobs, g.outputs[0].logprobs
        assert len(wl) == len(gl) == MAX_TOKENS
        for tok, a, b in zip(g.outputs[0].token_ids, wl, gl):
            assert list(a) == list(b) and tok in b and len(b) >= 5
            np.testing.assert_allclose([b[t].logprob for t in b],
                                       [a[t].logprob for t in a], rtol=0,
                                       atol=LP_TOL)
        np.testing.assert_allclose(g.outputs[0].cumulative_logprob,
                                   w.outputs[0].cumulative_logprob,
                                   rtol=0, atol=MAX_TOKENS * LP_TOL)


def test_prompt_logprobs_match(qwen):
    jax_llm, ports, prompts = qwen
    jp, tp = _params("penalised", prompt_logprobs=3)
    # Cold caches: a cached prefix has no prompt logprobs in either engine.
    assert jax_llm.engine.reset_prefix_cache()
    assert ports[64].engine.reset_prefix_cache()
    want = jax_llm.generate(prompts, jp)
    got = ports[64].generate(prompts, tp)
    assert _tokens(want) == _tokens(got)
    for w, g, p in zip(want, got, prompts):
        assert g.prompt_logprobs[0] is None
        assert len(g.prompt_logprobs) == len(w.prompt_logprobs) == len(p)
        for a, b in zip(w.prompt_logprobs[1:], g.prompt_logprobs[1:]):
            assert list(a) == list(b) and 3 <= len(b) <= 4
            np.testing.assert_allclose([b[t].logprob for t in b],
                                       [a[t].logprob for t in a], rtol=0,
                                       atol=LP_TOL)


def test_n2_children_match(qwen):
    jax_llm, ports, prompts = qwen
    kw = {**PRESETS["creative"], "max_tokens": MAX_TOKENS,
          "ignore_eos": True, "n": 2, "seed": 77}
    want = jax_llm.generate(prompts[:2], JaxParams(**kw))
    got = ports[64].generate(prompts[:2], SamplingParams(**kw))
    assert [len(o.outputs) for o in got] == [2, 2]
    assert [c.index for o in got for c in o.outputs] == [0, 1, 0, 1]
    assert _tokens(got) == _tokens(want)
    for o in got:  # seed + i: the two children draw differently
        assert o.outputs[0].token_ids != o.outputs[1].token_ids
        assert o.finished


def test_unseeded_base_seed_rule(qwen):
    """Four short prompts prefill in one wave and decode in one batch, so
    row r draws from base_seed + r * 7919 in both engines."""
    jax_llm, ports, _ = qwen
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 500, size=6).tolist() for _ in range(4)]
    jp, tp = _params("api", seeded=False)
    want = jax_llm.generate(prompts, jp)
    got = ports[64].generate(prompts, tp)
    assert _tokens(got) == _tokens(want)
    assert len({tuple(t) for t in _tokens(got)}) == 4


def test_finished_parent_leaves_no_fanout(qwen):
    """A parent whose children all finish is forgotten: its id no longer
    expands to children on abort, and the engine keeps no entry of it."""
    _, ports, prompts = qwen
    engine = ports[64].engine
    engine.add_request("fin", prompts[0], SamplingParams(
        temperature=1.0, n=2, seed=1, max_tokens=4, ignore_eos=True))
    assert engine._fanout == {"fin": {0, 1}}
    done = []
    while engine.has_unfinished_requests():
        done += [o.outputs[0].index for o in engine.step() if o.finished]
    assert sorted(done) == [0, 1]
    assert engine._fanout == {}


def test_abort_parent_drops_children(qwen):
    _, ports, prompts = qwen
    engine = ports[64].engine
    engine.add_request("par", prompts[0], SamplingParams(
        temperature=1.0, n=3, seed=1, max_tokens=8, ignore_eos=True))
    engine.step()
    engine.abort_request("par")
    assert not engine.has_unfinished_requests()
    assert engine.step() == []


@pytest.mark.parametrize("kw", [
    {"guided_decoding": PortGuided(regex="a+")}, {"stop": ["x"]},
    {"bad_words": ["x"]}, {"logits_processors": [lambda ids, lg: lg]},
    {"best_of": 3, "n": 1}])
def test_unported_fields_raise(qwen, kw):
    _, ports, _ = qwen
    with pytest.raises(NotImplementedError):
        ports[64].generate([[1, 2, 3]], SamplingParams(temperature=0.5, **kw))


def _perturbed(jax_llm, perturb):
    worker = jax_llm.engine.core.worker
    tree = perturb(worker.params, 11)
    worker.params = worker.runner.params = jax.tree.map(jnp.asarray, tree)
    return tree


@pytest.mark.parametrize("family", ["gemma2", "mamba"])
def test_other_decode_paths_match(family):
    """The multi-step path (Gemma-2: no window decode) and the SSM window
    (Mamba) under the creative preset: DRY's and the penalties' history
    rides their sub-steps."""
    if family == "gemma2":
        from tests.test_torch_gemma import gemma_config, perturb
        hf = gemma_config("Gemma2ForCausalLM")
    else:
        from tests.test_torch_mamba import mamba_config, perturb
        hf = mamba_config("MambaForCausalLM")
    kw = dict(hf_config=hf, tokenizer="unused", dtype="float32",
              load_format="dummy", device="cpu", block_size=16,
              num_kv_blocks=128, max_num_seqs=4, max_num_batched_tokens=16,
              max_model_len=256)
    jax_llm = JaxLLM("dummy", **kw)
    tree = _perturbed(jax_llm, perturb)
    port = LLM("dummy", decode_window=16, **kw)
    port.engine.core.worker.load_params(params_from_jax(tree))
    runner = port.engine.core.worker.runner
    path = "_execute_ssm_window" if family == "mamba" else \
        "_execute_multi_step"
    calls = []
    inner = getattr(runner, path)
    setattr(runner, path, lambda *a: calls.append(a[1]) or inner(*a))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in (5, 40, 17)]
    jp, tp = _params("creative", logprobs=2)
    want = jax_llm.generate(prompts, jp[:3])
    got = port.generate(prompts, tp[:3])
    assert max(calls) > 1
    assert _partings(_tokens(want), _tokens(got)) == 0
    for w, g in zip(want, got):
        for a, b in zip(w.outputs[0].logprobs, g.outputs[0].logprobs):
            assert list(a) == list(b)
