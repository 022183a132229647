"""The port's sampler (``aphrodite_tpu_torch/sample/``) vs the JAX package's
(``aphrodite_tpu/sample/``) on the same numpy-seeded inputs.

- ``build_sampling_arrays``: every packed array and the flags equal,
  except ``all_greedy``, which the port sets only where the argmax alone
  gives the sampled branch's result (the JAX flags never set it).
- Each stage on mixed per-row parameters (some rows on, some off):
  the same -inf mask and the finite values within rtol = atol = 2e-5
  (float32 reductions in another order; DRY's power).
- The suffix match lengths: the plain version bit-equal to the JAX one
  (the token-history pass: ``test_torch_history_pass.py``).
- ``sample_tokens`` under each flag group, a ``sampler_priority`` order,
  skew, ``temperature_last`` and top-k logprobs, at step offsets 0-2:
  tokens equal (random float logits, so no near ties: the noise differs
  only by the logs' last ulp), logprobs within atol 1e-5.

Random float logits throughout: ``typical``'s argsort of deviations would
order exact ties otherwise than ``jnp.argsort`` may."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.sample import sampler as J
from aphrodite_tpu.sample.metadata import (SamplingMetadata as JaxMD,
                                           build_sampling_arrays as jax_build)
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch.ops import history_pass as H
from aphrodite_tpu_torch.ops.suffix_match import ref_suffix_match
from aphrodite_tpu_torch.sample import sampler as T
from aphrodite_tpu_torch.sample.metadata import (SamplerFlags,
                                                 SamplingMetadata,
                                                 build_sampling_arrays)
from aphrodite_tpu_torch.sampling_params import SamplingParams

V = 97
TOL = 2e-5

# One row each; the stage tests run every stage over all of them.
ROWS = [
    dict(temperature=0.7, top_p=0.9, top_k=20, seed=3, logprobs=3),
    dict(temperature=1.0, min_p=0.05, repetition_penalty=1.1,
         dry_multiplier=0.8, dry_allowed_length=2,
         dry_sequence_breaker_ids=[1, 2], xtc_threshold=0.1,
         xtc_probability=0.5, seed=4),
    dict(temperature=0.8, top_p=0.95, presence_penalty=0.5,
         frequency_penalty=0.3, no_repeat_ngram_size=3, seed=5),
    dict(temperature=0.0),
    dict(temperature=1.2, top_a=0.1, tfs=0.9, eta_cutoff=3,
         epsilon_cutoff=2, typical_p=0.9, smoothing_factor=0.3,
         smoothing_curve=1.5, nsigma=1.5, dynatemp_min=0.5,
         dynatemp_max=1.5, dynatemp_exponent=1.3, seed=9),
    dict(temperature=0.05, dry_multiplier=1.2, dry_base=2.0,
         dry_allowed_length=1, dry_range=12, no_repeat_ngram_size=2,
         min_tokens=50, stop_token_ids=[4, 5], logit_bias={6: 3.0, 9: -2.0},
         seed=11),
    dict(temperature=1.5, allowed_token_ids=list(range(0, 40)), skew=0.4,
         xtc_probability=1.0, xtc_threshold=0.02, seed=13),
]


def _requests(rows, seed=0, periodic=True):
    """(jax reqs, port reqs): the rows' params over histories drawn from a
    12-token alphabet, every other one periodic so DRY and n-grams bite."""
    rng = np.random.RandomState(seed)
    out_j, out_t = [], []
    for i, kw in enumerate(rows):
        n = int(rng.randint(6, 40))
        if periodic and i % 2:
            unit = rng.randint(0, 12, size=int(rng.randint(2, 6))).tolist()
            toks = (unit * n)[:n]
        else:
            toks = rng.randint(0, 12, size=n).tolist()
        p_len = max(1, n // 2)
        out_j.append((JaxParams(**kw), toks, p_len, n - p_len))
        out_t.append((SamplingParams(**kw), toks, p_len, n - p_len))
    return out_j, out_t


def _metadata(rows, extra_len=3, seed=0):
    rj, rt = _requests(rows, seed)
    aj, fj = jax_build(rj, V, len(rj), base_seed=5, extra_len=extra_len)
    at, ft = build_sampling_arrays(rt, V, len(rt), base_seed=5,
                                   extra_len=extra_len, num_steps=3)
    return (aj, fj), (at, ft)


def _mds(rows, **kw):
    (aj, fj), (at, ft) = _metadata(rows, **kw)
    return (JaxMD(**{k: jnp.asarray(v) for k, v in aj.items()}), fj,
            SamplingMetadata.from_arrays(at, "cpu"), ft)


def _logits(R, seed=1):
    return np.random.RandomState(seed).randn(R, V).astype(np.float32) * 3


def _assert_same(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


def test_packed_arrays_equal():
    """Every array the JAX package packs, and XTC's draws, which the port
    packs for a window's steps at once: the uniform of fold_in(key, 1) at
    each counter, equal to ``jax.random.uniform``'s."""
    (aj, fj), (at, ft) = _metadata(ROWS)
    assert set(at) == set(aj) | {"xtc_uniform"}
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(s.astype(jnp.int32)), c), 1))
    for i in range(3):
        want = jax.vmap(lambda k: jax.random.uniform(k, ()))(
            keys(aj["seeds"], aj["out_len"] + i))
        np.testing.assert_array_equal(at["xtc_uniform"][i], np.asarray(want))
    for k in aj:
        np.testing.assert_array_equal(np.asarray(at[k]),
                                      np.asarray(aj[k]), err_msg=k)
    # need_logprobs gates the JAX sampler's log-softmax; the port always
    # computes the chosen token's logprob, so it has no such flag.
    want = {k: v for k, v in fj._asdict().items() if k != "need_logprobs"}
    assert ft._replace(all_greedy=False, order=()) == \
        SamplerFlags(**{**want, "all_greedy": False, "order": ()})
    assert not ft.all_greedy and ft.track_tokens


@pytest.mark.parametrize("rows,all_greedy", [
    ([dict(temperature=0.0)] * 3, True),
    ([dict(temperature=0.0, logprobs=2)] * 2, True),
    ([dict(temperature=0.0), dict(temperature=0.5)], False),
    ([dict(temperature=0.0, repetition_penalty=1.2)], False),
    ([dict(temperature=0.0, skew=0.5)], False)])
def test_all_greedy_only_without_stages(rows, all_greedy):
    _, (_, ft) = _metadata(rows)
    assert ft.all_greedy == all_greedy


def test_unseeded_seed_rule():
    rows = [dict(temperature=1.0), dict(temperature=1.0, seed=2**33 + 5),
            dict(temperature=1.0)]
    (aj, _), (at, _) = _metadata(rows)
    np.testing.assert_array_equal(
        at["seeds"], [5, (2**33 + 5) & 0x7fffffff, 5 + 2 * 7919])
    np.testing.assert_array_equal(at["seeds"], np.asarray(aj["seeds"]))


STAGES = {
    "dry": (J._apply_dry, lambda lg, md: H._apply_dry(
        lg, md, *H._match_lengths(md, True)[::2])),
    "no_repeat_ngram": (J._apply_no_repeat_ngram,
                        lambda lg, md: H._apply_no_repeat_ngram(
                            lg, md, H._match_lengths(md, False)[1])),
    "penalties": (J._apply_penalties, H._apply_penalties),
    "temperature": (lambda lg, md: J._apply_temperature(lg, md, False),
                    lambda lg, md: T._apply_temperature(lg, md, False)),
    "dynatemp": (lambda lg, md: J._apply_temperature(lg, md, True),
                 lambda lg, md: T._apply_temperature(lg, md, True)),
    "top_k_top_p": (J._apply_top_k_top_p, T._apply_top_k_top_p),
    "min_p": (J._apply_min_p, T._apply_min_p),
    "top_a": (J._apply_top_a, T._apply_top_a),
    "tfs": (J._apply_tfs, T._apply_tfs),
    "eta": (J._apply_eta, T._apply_eta),
    "epsilon": (J._apply_epsilon, T._apply_epsilon),
    "typical": (J._apply_typical, T._apply_typical),
    "quadratic": (J._apply_quadratic, T._apply_quadratic),
    "nsigma": (J._apply_nsigma, T._apply_nsigma),
    "min_tokens": (lambda lg, md: J._apply_min_tokens(lg, md, 2),
                   lambda lg, md: T._apply_min_tokens(lg, md, 2)),
    "allowed_tokens": (J._apply_allowed_tokens, T._apply_allowed_tokens),
    "logit_bias": (J._apply_logit_bias, T._apply_logit_bias),
}


# The JAX stages under jit (eager, each of their jnp ops compiles on its
# own).
JAX_STAGES = {name: jax.jit(fj) for name, (fj, _) in STAGES.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_jax(stage, seed):
    jmd, _, tmd, _ = _mds(ROWS, seed=seed)
    logits = _logits(len(ROWS), seed + 10)
    fj, ft = JAX_STAGES[stage], STAGES[stage][1]
    want = fj(jnp.asarray(logits), jmd)
    got = ft(torch.from_numpy(logits), tmd)
    _assert_same(got, want)
    if stage not in ("temperature", "dynatemp", "quadratic", "penalties"):
        # The stage did something on some row (not a vacuous pass).
        assert not np.array_equal(np.asarray(want), logits), stage


@pytest.mark.parametrize("u", [0.0, 0.6, 1.0])
def test_xtc_matches_jax(u):
    jmd, _, tmd, _ = _mds(ROWS)
    logits = _logits(len(ROWS), 3)
    uu = np.full((len(ROWS),), u, np.float32)
    want = J._apply_xtc(jnp.asarray(logits), jmd, jnp.asarray(uu))
    got = T._apply_xtc(torch.from_numpy(logits), tmd, torch.from_numpy(uu))
    _assert_same(got, want)


def _histories(R, L, seed, periodic):
    rng = np.random.RandomState(seed)
    seq = np.full((R, L), 1000, np.int32)
    lens = rng.randint(0, L + 1, size=R).astype(np.int32)
    lens[:2] = (L, 1)
    for r in range(R):
        if periodic:
            unit = rng.randint(0, 5, size=int(rng.randint(1, 9)))
            row = np.resize(unit, lens[r])
            row[rng.rand(lens[r]) < 0.02] = 7  # a few breaks in the period
        else:
            row = rng.randint(0, 6, size=lens[r])
        seq[r, :lens[r]] = row
    brk = rng.rand(R, L) < 0.05
    return seq, lens, brk


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("L", [1, 33, 256])
def test_suffix_match_bit_equal(L, periodic):
    seq, lens, brk = _histories(6, L, L, periodic)
    want = J._suffix_match_lengths(jnp.asarray(seq), jnp.asarray(lens),
                                   jnp.asarray(brk))
    got = ref_suffix_match(torch.from_numpy(seq), torch.from_numpy(lens),
                           torch.from_numpy(brk))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if periodic and L > 64:
        assert int(got[0].max()) == 64  # the MAX_MATCH cap is reached


PRESETS = {
    "api": [dict(temperature=0.7, top_p=0.9, top_k=40, logprobs=5,
                 seed=s) for s in range(3)],
    "creative": [dict(temperature=1.0, min_p=0.05, repetition_penalty=1.1,
                      dry_multiplier=0.8, dry_base=1.75,
                      dry_allowed_length=2, dry_sequence_breaker_ids=[0],
                      xtc_threshold=0.1, xtc_probability=0.5, seed=s)
                 for s in range(3)],
    "penalised": [dict(temperature=0.8, top_p=0.95, presence_penalty=0.5,
                       frequency_penalty=0.3, no_repeat_ngram_size=3,
                       temperature_last=True, seed=s) for s in range(3)],
    "mixed": ROWS,
    "priority": [dict(temperature=0.9, top_k=30, min_p=0.02, tfs=0.95,
                      xtc_probability=0.7, xtc_threshold=0.05, seed=s,
                      sampler_priority=[
                          "XTC", "MIN_P", "TOP_K", "TOP_P", "TEMPERATURE",
                          "DRY", "PENALTIES", "NO_REPEAT_NGRAM", "TOP_A",
                          "TFS", "ETA", "EPSILON", "TYPICAL", "QUADRATIC",
                          "TOP_NSIGMA"]) for s in range(2)]
    + [dict(temperature=0.0)],
    "skew": [dict(temperature=1.0, skew=s) for s in (-0.5, 0.5)],
    "greedy_topk": [dict(temperature=0.0, logprobs=4)] * 2,
}


@pytest.mark.parametrize("step_offset", [0, 2])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sample_tokens_match_jax(preset, step_offset):
    jmd, fj, tmd, ft = _mds(PRESETS[preset])
    R = len(PRESETS[preset])
    logits = _logits(R, 7 + step_offset)
    want = J.sample_tokens(jnp.asarray(logits), jmd, fj, 8,
                           step_offset=step_offset)
    got = T.sample_tokens(torch.from_numpy(logits), tmd, ft, 8,
                          step_offset=step_offset)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    for k in ("logprob", "topk_values"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["topk_indices"].numpy(),
                                  np.asarray(want["topk_indices"]))


def test_seeds_drive_the_draw():
    """Equal seeds and counters draw equal tokens; another counter draws
    others (on a flat distribution)."""
    rows = [dict(temperature=1.0, seed=7)] * 8
    _, _, tmd, ft = _mds(rows)
    tmd = dataclasses.replace(tmd, out_len=torch.zeros(8, dtype=torch.int32))
    flat = torch.zeros((8, V))
    a = T.sample_tokens(flat, tmd, ft)["tokens"]
    assert len(set(a.tolist())) == 1
    b = T.sample_tokens(flat, tmd, ft, step_offset=1)["tokens"]
    assert b[0] != a[0]


def test_greedy_batch_runs_argmax_alone():
    _, _, _, ft = _mds([dict(temperature=0.0)] * 2)
    logits = torch.from_numpy(_logits(2))
    out = T.sample_tokens(logits, None, ft)
    assert torch.equal(out["tokens"], logits.argmax(-1))
