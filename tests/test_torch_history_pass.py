"""The token-history pass (``aphrodite_tpu_torch/ops/history_pass.py``)
against the JAX package's DRY -> penalties -> no-repeat-ngram
(``aphrodite_tpu/sample/sampler.py:70-167``) on the same numpy-seeded
histories and per-row parameters.

- ``ref_history_pass`` (the plain version, which the CPU runs) vs the
  JAX stages, jitted: the same -inf bans (tolerance 0) and every other
  logit within 2 fp32 ulps of the largest term its chain rounds
  (``_chain_scale``: XLA fuses a multiply into the penalties' subtract
  and raises DRY's base to an integer power its own way, an ulp each).
  Random and periodic histories, a breaker at the tail and one back,
  ``dry_range``, total_len 0, 1 and L, rows with each stage off, and
  batches with only one stage on.
- ``touched_model`` (the kernel's algorithm: the table of touched tokens,
  the matches cut where a row stops reading them) vs the plain version on
  the same cases: within 1 ulp (DRY's power of a 0-d base here, of a
  broadcast one there; equal in practice).
- ``sample_tokens`` with those stages and a ``sampler_priority``: tokens
  equal to the JAX package's; the caller's logits unchanged unless
  handed over (``donate_logits``).
- ``history_plan``: shared memory up to L = 4096, device-memory tables
  beyond, each within an H100's limits; the wrapper's input checks (the
  meta device stands for the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.sample import sampler as J
from aphrodite_tpu.sample.metadata import (SamplingMetadata as JaxMD,
                                           build_sampling_arrays as jax_build)
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch.ops import cuda_build
from aphrodite_tpu_torch.ops import history_pass as H
from aphrodite_tpu_torch.sample import sampler as T
from aphrodite_tpu_torch.sample.metadata import (SamplingMetadata,
                                                 build_sampling_arrays)
from aphrodite_tpu_torch.sampling_params import SamplingParams

V = 61
DRY = dict(dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
           dry_sequence_breaker_ids=[7, 9])
PEN = dict(repetition_penalty=1.3, frequency_penalty=0.4,
           presence_penalty=0.6)
NGRAM = dict(no_repeat_ngram_size=3)
# Each row: its sampling parameters and history kind.
ROWS = {
    "all": dict(**DRY, **PEN, **NGRAM),
    "dry": DRY,
    "pen": PEN,
    "ngram": dict(no_repeat_ngram_size=2),
    "none": {},
    "dry_range": dict(DRY, dry_range=9, dry_allowed_length=1,
                      dry_base=2.0),
    "ngram1": dict(no_repeat_ngram_size=1, repetition_penalty=0.8),
    "ngram5": dict(DRY, no_repeat_ngram_size=5),
}


def _history(rng, kind: str, n: int) -> list[int]:
    if kind == "periodic":
        unit = rng.randint(0, 6, size=int(rng.randint(1, 7)))
        toks = np.resize(unit, n)
        toks[rng.rand(n) < 0.04] = 7  # a few breakers in the period
        return toks.tolist()
    if kind == "tail_breaker":  # a breaker at the tail or one back
        toks = np.resize(rng.randint(0, 5, size=3), n)
        if n:
            toks[-1 - int(rng.randint(0, 2))] = 9
        return toks.tolist()
    return rng.randint(0, 6 if kind == "random" else V, size=n).tolist()


def _case(case: str, seed: int = 0):
    """(jax md, jax flags, port md, port flags, logits) of a batch: every
    row of ROWS (a subset for the one-stage cases) over histories of the
    case's kind, lengths drawn from 8-70 (0, 1 and L for "lengths")."""
    rng = np.random.RandomState(seed)
    names = {"only_dry": ["dry", "none"], "only_pen": ["pen", "none"],
             "only_ngram": ["ngram", "ngram5"]}.get(case, list(ROWS))
    kind = (case if case in ("periodic", "tail_breaker", "random")
            else "vocab" if case in ("vocab", "lengths") else "periodic")
    lens = rng.randint(8, 70, size=len(names)).tolist()
    extra = 5
    if case == "lengths":
        lens[:3] = [0, 1, 64]
        lens[3:] = [min(n, 64) for n in lens[3:]]
        extra = 0  # the 64-token row fills L = 64
    rj, rt = [], []
    for name, n in zip(names, lens):
        toks = _history(rng, kind, n)
        kw = dict(ROWS[name], temperature=1.0, seed=int(rng.randint(99)))
        p_len = int(rng.randint(0, n + 1))
        rj.append((JaxParams(**kw), toks, p_len, n - p_len))
        rt.append((SamplingParams(**kw), toks, p_len, n - p_len))
    aj, fj = jax_build(rj, V, len(rj), extra_len=extra)
    at, ft = build_sampling_arrays(rt, V, len(rt), extra_len=extra)
    jmd = JaxMD(**{k: jnp.asarray(v) for k, v in aj.items()})
    logits = (rng.randn(len(names), V) * 3).astype(np.float32)
    return jmd, fj, SamplingMetadata.from_arrays(at, "cpu"), ft, logits


@jax.jit
def _jax_dry(logits, md):
    return J._apply_dry(logits, md)


@jax.jit
def _jax_penalties(logits, md):
    return J._apply_penalties(logits, md)


@jax.jit
def _jax_ngram(logits, md):
    return J._apply_no_repeat_ngram(logits, md)


def _jax_history(logits, md, flags):
    """The JAX sampler's three stages in its order (sampler.py:395-400)."""
    lg = jnp.asarray(logits)
    if flags.do_dry:
        lg = _jax_dry(lg, md)
    if flags.do_penalties:
        lg = _jax_penalties(lg, md)
    if flags.do_ngram:
        lg = _jax_ngram(lg, md)
    return np.asarray(lg)


def _chain_scale(lg, md, flags) -> np.ndarray:
    """[R, V] the largest magnitude a logit's chain rounds at: the logit,
    DRY's output, and under the penalties that times max(1, repetition),
    frequency x count and presence. XLA contracts the penalties' multiply
    and subtract into one rounding and computes DRY's power of an integer
    exponent its own way; torch rounds each operation and calls powf. Each
    moves a result by up to an ulp of such a term, which the subtractions
    may cancel down to a smaller result."""
    scale = lg.abs()
    if flags.do_dry:
        dry = H._apply_dry(lg, md, *H._match_lengths(md, True)[::2])
        scale = torch.maximum(scale, dry.abs())
    if flags.do_penalties:
        R, V = lg.shape
        pos = torch.arange(md.token_seq.shape[1])[None, :]
        out = (pos >= md.prompt_len[:, None]) & (pos < md.total_len[:, None])
        counts = H.scatter_drop(R, V, torch.where(out, md.token_seq, V), 1,
                                "sum", torch.float32)
        rep = md.repetition_penalty.clamp(min=1)[:, None]
        scale = torch.maximum(scale * rep, torch.maximum(
            md.frequency_penalty.abs()[:, None] * counts,
            md.presence_penalty.abs()[:, None].expand(R, V)))
    return scale.numpy()


def _assert_within_ulp(got, want, scale=None, ulps=1):
    """The same -inf entries; the finite ones within ``ulps`` fp32 ulps of
    ``scale`` (default: of the expected value)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = np.abs(want) if scale is None else scale
    err = np.abs(got[fin] - want[fin])
    assert (err <= ulps * np.spacing(scale[fin].astype(np.float32))).all(), \
        err.max()


CASES = ["random", "periodic", "tail_breaker", "vocab", "lengths",
         "only_dry", "only_pen", "only_ngram"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_plain_pass_matches_jax(case, seed):
    jmd, fj, tmd, ft, logits = _case(case, seed)
    want = _jax_history(logits, jmd, fj)
    lg = torch.from_numpy(logits)
    got = H.history_pass(lg, tmd, ft)
    _assert_within_ulp(got.numpy(), want, _chain_scale(lg, tmd, ft), 2)
    assert not np.array_equal(want, logits)  # some stage did something
    if case == "only_ngram" or (case == "random" and seed == 0):
        assert np.isneginf(want).any()  # bans bite


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_touched_model_equals_plain(case, seed):
    _, _, tmd, ft, logits = _case(case, seed)
    lg = torch.from_numpy(logits)
    want = H.ref_history_pass(lg, tmd, ft)
    got = H.touched_model(lg, tmd, ft)
    _assert_within_ulp(got.numpy(), want.numpy())
    # Outside the tokens of each row's history nothing moves.
    for r in range(lg.shape[0]):
        seen = set(tmd.token_seq[r, :int(tmd.total_len[r])].tolist())
        seen |= set(tmd.token_seq[r, :int(tmd.prompt_len[r])].tolist())
        other = [t for t in range(V) if t not in seen]
        assert torch.equal(want[r, other], lg[r, other])


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("priority", [False, True])
def test_sample_tokens_with_history(priority, donate):
    """Tokens equal to the JAX package's with all three stages on (and a
    ``sampler_priority`` that moves them among the others); the caller's
    logits unchanged unless handed over, and then the pass's output."""
    rows = [dict(ROWS["all"], temperature=0.9, top_k=20, min_p=0.02,
                 seed=s) for s in range(4)]
    if priority:
        for r in rows:
            r["sampler_priority"] = [
                "MIN_P", "NO_REPEAT_NGRAM", "DRY", "TOP_K", "TOP_P",
                "PENALTIES", "TEMPERATURE", "XTC", "TOP_A", "TFS", "ETA",
                "EPSILON", "TYPICAL", "QUADRATIC", "TOP_NSIGMA"]
    rng = np.random.RandomState(3)
    rj, rt = [], []
    for kw in rows:
        toks = _history(rng, "periodic", 40)
        rj.append((JaxParams(**kw), toks, 20, 20))
        rt.append((SamplingParams(**kw), toks, 20, 20))
    aj, fj = jax_build(rj, V, 4, extra_len=2)
    at, ft = build_sampling_arrays(rt, V, 4, extra_len=2)
    assert ft.track_tokens and bool(ft.order) == priority
    logits = (rng.randn(4, V) * 3).astype(np.float32)
    want = J.sample_tokens(jnp.asarray(logits),
                           JaxMD(**{k: jnp.asarray(v) for k, v in aj.items()}),
                           fj)
    tmd = SamplingMetadata.from_arrays(at, "cpu")
    lg = torch.from_numpy(logits.copy())
    got = T.sample_tokens(lg, tmd, ft, donate_logits=donate)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    if donate:
        assert torch.equal(lg, H.ref_history_pass(
            torch.from_numpy(logits), tmd, ft))
    else:
        assert torch.equal(lg, torch.from_numpy(logits))


@pytest.mark.parametrize("stage,seen", [
    (None, (False, True)), ("donate", (True, True)),
    ("allowed_token_ids", (True, True)), ("logit_bias", (False, False))])
def test_sample_tokens_hands_the_pass_its_own_logits(monkeypatch, stage,
                                                      seen):
    """The pass writes in place only into logits that are ``sample_tokens``'
    own (a stage before it made them, or the caller handed them over) and
    contiguous (logit_bias leaves a view of a wider buffer): (inplace,
    contiguous) as the pass sees them."""
    kw = dict(ROWS["all"], temperature=1.0, seed=1)
    if stage in ("allowed_token_ids", "logit_bias"):
        kw[stage] = ([1, 2, 3, 4, 5, 6] if stage == "allowed_token_ids"
                     else {3: 1.5})
    rng = np.random.RandomState(4)
    reqs = [(SamplingParams(**kw), _history(rng, "periodic", 30), 10, 20)
            for _ in range(2)]
    at, ft = build_sampling_arrays(reqs, V, 2, extra_len=2)
    calls = []

    def spy(logits, md, flags, inplace=False):
        calls.append((inplace, logits.is_contiguous()))
        return H.history_pass(logits, md, flags, inplace)
    monkeypatch.setattr(T, "history_pass", spy)
    T.sample_tokens(torch.from_numpy(_case("random")[4][:2].copy()),
                    SamplingMetadata.from_arrays(at, "cpu"), ft,
                    donate_logits=stage == "donate")
    assert calls == [seen]


@pytest.mark.parametrize("L", [1, 64, 1024, 2048, 4096, 8192, 131072])
def test_history_plan_fits_an_h100(L):
    plan = H.history_plan(32, L, 128256)
    assert plan.cap & (plan.cap - 1) == 0
    assert plan.cap >= max(64, 2 * min(L, 128256))  # load factor <= 1/2
    if L <= 4096:  # the table and the history in shared memory
        assert plan.shared_bytes == 4 * (4 * plan.cap + L)
        assert plan.shared_bytes + 328 <= cuda_build.H100_SMEM_OPTIN
        assert (plan.blocks, plan.table_ints) == (32, 0)
    else:  # one device-memory table a block, TABLE_BLOCKS blocks at most
        assert plan.shared_bytes == 0
        assert plan.blocks == min(32, H.TABLE_BLOCKS)
        assert plan.table_ints == plan.blocks * 4 * plan.cap
    assert H.history_plan(3, max(L, 64), 50).cap == 128  # V bounds it


def test_wrapper_checks_inputs_before_the_launch():
    _, _, tmd, ft, logits = _case("random")
    lg = torch.from_numpy(logits)
    with pytest.raises(ValueError, match="float32"):
        H.history_pass(lg.half().to("meta"), tmd, ft)
    with pytest.raises(ValueError, match="logits on meta"):
        H.history_pass(lg.to("meta"), tmd, ft)
    with pytest.raises(ValueError, match="contiguous"):
        H.history_pass(lg.t().contiguous().t().to("meta"), tmd, ft,
                       inplace=True)


def test_cpu_pass_in_place_or_copy():
    _, _, tmd, ft, logits = _case("periodic")
    lg = torch.from_numpy(logits.copy())
    out = H.history_pass(lg, tmd, ft)
    assert torch.equal(lg, torch.from_numpy(logits)) and out is not lg
    same = H.history_pass(lg, tmd, ft, inplace=True)
    assert same is lg and torch.equal(lg, out)
