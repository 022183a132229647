"""The port's Mamba-family pieces vs the JAX package's on the same numpy
inputs (fp32):

- the selective scan's plain version (``ops/selective_scan.py``, what the
  CUDA wrapper runs on CPU tensors) vs JAX ``selective_scan`` in
  interpret mode and vs the ``associative_scan`` branch of ``ssm_scan``,
  at the shapes of ``tests/ops/test_selective_scan.py`` and with dA = 0
  resets mid-chunk: rtol/atol 1e-5 (the associative scan sums in another
  order; a reset row must restart the recurrence exactly);
- one mixer and the whole model of each of Mamba, FalconMamba and Mamba-2
  on a fresh prefill wave (segments shorter and longer than the conv
  width, random stale state in the slots), a resumed chunk and two decode
  steps with a frozen row: hidden states, logits and both state buffers
  after every step to atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.attention.metadata import AttentionMetadata as JaxMD
from aphrodite_tpu.config import ModelConfig as JaxModelConfig
from aphrodite_tpu.loader.weights import create_model as jax_create_model
from aphrodite_tpu.ops import selective_scan as jax_scan
from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.loader.weights import (create_model, load_params,
                                                params_from_jax)
from aphrodite_tpu_torch.ops.selective_scan import (ref_selective_scan,
                                                    selective_scan)

ARCHS = ["MambaForCausalLM", "FalconMambaForCausalLM", "Mamba2ForCausalLM"]
SLOTS = 8


def mamba_config(arch, vocab=256):
    """A tiny config of each family (hidden 64, 2 layers, state 8)."""
    import transformers as tf
    common = dict(vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
                  state_size=8, conv_kernel=4, tie_word_embeddings=False,
                  architectures=[arch])
    if arch == "MambaForCausalLM":
        return tf.MambaConfig(intermediate_size=128, time_step_rank=8,
                              use_conv_bias=True, use_bias=True, **common)
    if arch == "FalconMambaForCausalLM":
        return tf.FalconMambaConfig(intermediate_size=128, time_step_rank=8,
                                    mixer_rms_eps=1e-6, **common)
    assert arch == "Mamba2ForCausalLM"
    return tf.Mamba2Config(expand=2, head_dim=16, num_heads=8, n_groups=2,
                           chunk_size=16, **common)


def perturb(tree, seed):
    """The JAX dummy tree with weights drawn at fan-in scale from a seeded
    numpy generator (the dummy recipe's 0.02 and zero biases make a
    near-identity model whose greedy tokens hardly depend on the state).
    Leaves stay float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    H = out["embed"].shape[1]
    out["embed"] = rng.randn(*out["embed"].shape).astype(np.float32)
    out["final_norm"] = 1 + 0.1 * rng.randn(H).astype(np.float32)
    if "lm_head" in out:
        out["lm_head"] = (rng.randn(*out["lm_head"].shape)
                          / np.sqrt(H)).astype(np.float32)
    layers = {}
    for name, v in tree["layers"].items():
        shape = np.asarray(v).shape
        if name in ("norm", "gated_norm_w"):
            a = 1 + 0.1 * rng.randn(*shape)
        elif name in ("dt_b", "dt_bias"):
            a = rng.uniform(-3.0, -1.0, size=shape)
        elif name == "D":
            a = 1 + 0.5 * rng.randn(*shape)
        elif name == "A_log":
            a = np.asarray(v) + 0.1 * rng.randn(*shape)
        elif name == "conv_w":
            a = 0.5 * rng.randn(*shape)
        elif name.endswith("_b"):
            a = 0.1 * rng.randn(*shape)
        else:  # [L, fan_in, fan_out] projections
            a = rng.randn(*shape) / np.sqrt(shape[1])
        layers[name] = a.astype(np.float32)
    out["layers"] = layers
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    hf = mamba_config(request.param)
    jmodel = jax_create_model(JaxModelConfig(
        model="dummy", hf_config=hf, tokenizer="unused", dtype="float32"))
    params = perturb(jmodel.init_dummy_params(jax.random.PRNGKey(0)), 5)
    tmodel = create_model(ModelConfig(model="dummy", hf_config=hf,
                                      dtype="float32"), "cpu")
    load_params(tmodel, params_from_jax(params))
    jparams = jax.tree.map(jnp.asarray, params)
    return jmodel, jparams, tmodel


# ------------------------------------------------------------------- scan
SCAN_CASES = [(64, (16, 8)), (100, (24,)), (256, (48, 4)), (32, (130,))]


def _scan_inputs(T, shape, resets=()):
    rng = np.random.default_rng(T)
    dA = rng.uniform(0.8, 1.0, size=(T,) + shape).astype(np.float32)
    dBx = rng.normal(size=(T,) + shape).astype(np.float32)
    for t in resets:
        dA[t] = 0.0
    return dA, dBx


@pytest.mark.parametrize("T,shape", SCAN_CASES)
def test_scan_matches_pallas_interpret(T, shape):
    dA, dBx = _scan_inputs(T, shape)
    want = jax_scan.selective_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                   block_t=16, block_c=128, interpret=True)
    got = ref_selective_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    assert got.dtype == torch.float32 and tuple(got.shape) == dA.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T,shape", SCAN_CASES)
def test_scan_matches_associative_branch(T, shape, monkeypatch):
    monkeypatch.setenv("APHRODITE_PALLAS_INTERPRET", "0")
    dA, dBx = _scan_inputs(T, shape, resets=(0, T // 3, T // 3 + 1))
    # Under jit, as the JAX package runs it (eager, each of the
    # associative scan's many small ops compiles on its own: ~12x slower).
    want = jax.jit(jax_scan.ssm_scan)(jnp.asarray(dA), jnp.asarray(dBx))
    got = selective_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("resets", [(0, 17), (5, 6, 40), (47,)])
def test_scan_reset_rows_restart_exactly(resets):
    """A dA = 0 row (a segment's first token) restarts the recurrence:
    rows after it equal a scan started there, bit for bit; the whole scan
    matches Pallas (interpret, 16-row chunks, so resets fall mid-chunk)."""
    dA, dBx = _scan_inputs(48, (8,), resets=resets)
    got = ref_selective_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    for t in resets:
        alone = ref_selective_scan(torch.from_numpy(dA[t:]),
                                   torch.from_numpy(dBx[t:]))
        assert torch.equal(got[t:], alone)
    want = jax_scan.selective_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                   block_t=16, block_c=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_scan_takes_any_float_input_and_empty_t():
    dA, dBx = _scan_inputs(12, (3, 5))
    got = selective_scan(torch.from_numpy(dA).double(),
                         torch.from_numpy(dBx).bfloat16())
    want = ref_selective_scan(torch.from_numpy(dA),
                              torch.from_numpy(dBx).bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    empty = selective_scan(torch.zeros(0, 4), torch.zeros(0, 4))
    assert tuple(empty.shape) == (0, 4)
    with pytest.raises(ValueError, match="one shape"):
        selective_scan(torch.zeros(3, 4), torch.zeros(3, 5))


# ------------------------------------------------------------------ steps
def _step(chunks, slots, live=None):
    """Metadata of one step: request r feeds tokens at positions
    chunks[r] = (start, n), state slot slots[r]; live[r] False freezes a
    one-token row (JAX: slot_mapping -1 and seq_lens 0)."""
    R = len(chunks)
    live = [True] * R if live is None else live
    token_req, token_pos, valid = [], [], []
    qsl = [0]
    for r, (start, n) in enumerate(chunks):
        token_req += [r] * n
        token_pos += list(range(start, start + n))
        valid += [live[r]] * n
        qsl.append(qsl[-1] + n)
    seq_lens = [s + n if lv else 0 for (s, n), lv in zip(chunks, live)]
    arr = lambda x: np.asarray(x, np.int32)  # noqa: E731
    T = qsl[-1]
    jmd = JaxMD(
        token_req_idx=jnp.asarray(arr(token_req)),
        token_pos=jnp.asarray(arr(token_pos)),
        slot_mapping=jnp.asarray(np.where(valid, 0, -1).astype(np.int32)),
        query_start_loc=jnp.asarray(arr(qsl)),
        seq_lens=jnp.asarray(arr(seq_lens)),
        block_tables=jnp.zeros((R, 1), jnp.int32),
        num_reqs=jnp.asarray(R, jnp.int32),
        num_tokens=jnp.asarray(T, jnp.int32),
        state_slots=jnp.asarray(arr(slots)),
        seg_starts=jnp.asarray(arr(qsl[:-1])))
    t = lambda x: torch.from_numpy(arr(x))  # noqa: E731
    tmd = AttentionMetadata(
        token_req_idx=t(token_req), token_pos=t(token_pos), slot_mapping=None,
        seq_lens=t(seq_lens), block_tables=None, query_start_loc=t(qsl),
        seg_starts=t(qsl[:-1]), state_slots=t(slots),
        token_valid=None if all(valid) else torch.tensor(valid))
    return jmd, tmd, T


# Fresh prefills (one shorter than the conv's K-1 = 3 taps), then resumed
# chunks (one of a single token), then two decode steps, the second with a
# frozen row.
STEPS = [
    ([(0, 5), (0, 2), (0, 9)], [2, 0, 5], None),
    ([(5, 4), (2, 1), (9, 6)], [2, 0, 5], None),
    ([(9, 1), (3, 1), (15, 1)], [2, 0, 5], None),
    ([(10, 1), (4, 1), (16, 1)], [2, 0, 5], [True, False, True]),
]


def _states(jmodel, seed=3):
    rng = np.random.RandomState(seed)
    cache = jmodel.init_cache(SLOTS)
    return {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
            for k, v in cache.items()}


def _assert_states(tstate, jstate):
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_mixer_matches(models):
    jmodel, params, tmodel = models
    init = _states(jmodel)
    jconv, jssm = jnp.asarray(init["conv"][0]), jnp.asarray(init["ssm"][0])
    tconv = torch.from_numpy(init["conv"][0].copy())
    tssm = torch.from_numpy(init["ssm"][0].copy())
    lp = {k: v[0] for k, v in params["layers"].items()}
    mixer = jax.jit(jmodel._mixer)
    rng = np.random.RandomState(4)
    for chunks, slots, live in STEPS:
        jmd, tmd, T = _step(chunks, slots, live)
        x = rng.randn(T, tmodel.hidden_size).astype(np.float32)
        jout, (jconv, jssm) = mixer(jnp.asarray(x), lp, (jconv, jssm), jmd)
        with torch.inference_mode():
            rt = tmodel._routing(tmd, T, SLOTS)
            tout = tmodel._mixer(torch.from_numpy(x), tmodel.layers[0],
                                 tconv, tssm, rt)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-4)
        _assert_states({"conv": tconv, "ssm": tssm},
                       {"conv": jconv, "ssm": jssm})


def test_model_steps_match(models):
    jmodel, params, tmodel = models
    init = _states(jmodel)
    jstate = {k: jnp.asarray(v) for k, v in init.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    rng = np.random.RandomState(6)
    for chunks, slots, live in STEPS:
        jmd, tmd, T = _step(chunks, slots, live)
        ids = rng.randint(1, tmodel.vocab_size, size=T)
        jh, jstate = jmodel.apply(params, jnp.asarray(ids.astype(np.int32)),
                                  jstate, jmd)
        with torch.inference_mode():
            th = tmodel(torch.from_numpy(ids.astype(np.int64)), tstate, tmd)
            tl = tmodel.compute_logits(th)
        jl = jmodel.compute_logits(params, jh)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-4)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        _assert_states(tstate, jstate)


def test_params_from_jax_keeps_leaf_names(models):
    jmodel, params, tmodel = models
    state = params_from_jax(params)
    assert sorted(state) == sorted(tmodel.state_dict())
    for name, v in params["layers"].items():
        np.testing.assert_array_equal(state[f"layers.1.{name}"],
                                      np.asarray(v[1]))
    assert tmodel.layers[0].A_log.dtype == torch.float32
    with pytest.raises(KeyError, match="Mamba"):
        params_from_jax({**params, "layers": {
            k: v for k, v in params["layers"].items() if k != "conv_w"}})


def test_dummy_params_follow_the_jax_recipe(models):
    jmodel, _, _ = models
    hf = mamba_config(type(jmodel).__name__)
    m = create_model(ModelConfig(model="dummy", hf_config=hf,
                                 dtype="bfloat16"), "cpu")
    m.init_dummy_params(torch.Generator().manual_seed(0))
    jp = jmodel.init_dummy_params(jax.random.PRNGKey(0))
    layer = m.layers[0]
    for name, v in jp["layers"].items():
        p = getattr(layer, name)
        assert tuple(p.shape) == tuple(v.shape[1:]), name
        if name in ("norm", "D", "A_log") or name.endswith("_b"):
            np.testing.assert_allclose(p.float().numpy(), np.asarray(v[0]),
                                       rtol=1e-6, err_msg=name)
    assert layer.A_log.dtype == torch.float32
    assert m.layers[1].in_proj.dtype == torch.bfloat16
    cache = m.init_cache(4)
    jcache = jmodel.init_cache(4)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == tuple(jcache[k].shape)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
