"""The port's ``LLM.generate`` with images vs ``aphrodite_tpu.LLM`` on the
same weights: Gemma-3 multimodal and PaliGemma on a Gemma and a Gemma-2
base, each built from the same ``hf_config``; the JAX engine's dummy tree,
redrawn at fan-in scale (``test_torch_gemma3_mm.perturb_mm``), is loaded
into both engines, the port's through ``params_from_jax``.

Greedy token ids must be identical (fp32). Gemma-3 runs in fp16 too
(``"gemma3-fp16"``: the fp16 span instances on the card, the plain version
here, against the JAX engine in fp16): tokens identical but where the JAX
engine's top-2 margin is below ``TIE`` (both engines round fp16 at their
own points), a request compared up to its first such tie, at most
``FP16_TIES`` of them (the count observed). The batch holds a prompt with
one image, a prompt with two, and a text-only prompt; a 16-token batch
budget cuts the prompts into chunks, one of them inside an image span (the
span's first rows written by an earlier chunk, as both engines' masks
allow); decode runs 16-step windows on the runner's multi-step path.
Gemma-3 runs the batch twice: the second pass hits the prefix cache and the
encoder cache, and gives the same tokens; a prompt with the same ids and
another image hits no page."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

from tests.test_torch_gemma3_mm import BOI, EOI, IMG, mm_config, perturb_mm

MAX_TOKENS = (10, 6, 12)
# ``test_torch_fp16.py``'s rule for fp16 greedy tokens: a parting only at
# a reference margin below TIE, as many as observed.
TIE, FP16_TIES = 5e-2, 0


def _prompts(arch: str, seed: int = 0) -> list:
    """One image after 12 text tokens (its span crosses the 16-token chunk
    and page edge), two images, and text only."""
    rng = np.random.RandomState(seed)
    text = lambda n: rng.randint(10, 250, size=n).tolist()  # noqa: E731
    img = lambda: ([BOI, IMG, EOI] if arch == "gemma3"  # noqa: E731
                   else [IMG])
    imgs = rng.randint(0, 256, size=(3, 16, 16, 3)).astype(np.uint8)
    return [
        {"prompt_token_ids": [2] + text(12) + img() + text(5),
         "multi_modal_data": {"image": imgs[0]}},
        {"prompt_token_ids": [2] + text(3) + img() + text(2) + img()
         + text(4), "multi_modal_data": {"image": [imgs[1], imgs[2]]}},
        [2] + text(17)]


def _kwargs(arch, dtype="float32", **kw):
    return {**dict(hf_config=mm_config(arch), tokenizer="unused",
                   dtype=dtype, load_format="dummy", device="cpu",
                   block_size=16, num_kv_blocks=128, max_num_seqs=4,
                   max_num_batched_tokens=16, max_model_len=256), **kw}


@pytest.fixture(scope="module", params=["gemma3", "gemma3-fp16",
                                        "paligemma", "paligemma2"])
def engines(request):
    arch, _, f16 = request.param.partition("-")
    dtype = "float16" if f16 else "float32"
    jax_llm = JaxLLM("dummy", **_kwargs(arch, dtype))
    worker = jax_llm.engine.core.worker
    # The redrawn leaves in the engine's dtype (fp16 leaves stay fp16).
    tree = jax.tree.map(
        lambda new, old: np.asarray(new).astype(np.asarray(old).dtype),
        perturb_mm(worker.params, 11), worker.params)
    worker.params = worker.runner.params = jax.tree.map(jnp.asarray, tree)
    prompts = _prompts(arch)
    outs = jax_llm.generate(prompts, [
        JaxParams(temperature=0.0, max_tokens=n, ignore_eos=True,
                  logprobs=2 if f16 else None) for n in MAX_TOKENS])
    jax_tokens = [o.outputs[0].token_ids for o in outs]
    margins = ([[_margin(step) for step in o.outputs[0].logprobs]
                for o in outs] if f16 else None)
    port = LLM("dummy", decode_window=16, **_kwargs(arch, dtype))
    port.engine.core.worker.load_params(params_from_jax(tree))
    return arch, jax_tokens, port, prompts, margins


def _margin(step: dict) -> float:
    """The JAX engine's top-2 logprob margin at one step."""
    vals = sorted((getattr(v, "logprob", v) for v in step.values()),
                  reverse=True)
    return vals[0] - vals[1] if len(vals) > 1 else float("inf")


def _assert_tokens(got, want, margins):
    """fp32 (``margins`` None): identical. fp16: each request identical up
    to its first parting, which must be at a margin below TIE; at most
    FP16_TIES such partings."""
    if margins is None:
        assert got == want
        return
    ties = []
    for r, (a, b) in enumerate(zip(want, got)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            assert margins[r][i] < TIE, (r, i, margins[r][i])
            ties.append((r, i))
    assert len(ties) <= FP16_TIES, ties


def _generate(port, prompts):
    return port.generate(prompts, [
        SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
        for n in MAX_TOKENS])


def test_greedy_tokens_identical(engines):
    arch, jax_tokens, port, prompts, margins = engines
    runner = port.engine.core.worker.runner
    outs = _generate(port, prompts)
    _assert_tokens([o.outputs[0].token_ids for o in outs], jax_tokens,
                   margins)
    assert [len(t) for t in jax_tokens] == list(MAX_TOKENS)
    assert len({t for toks in jax_tokens for t in toks}) > 8
    # Each request's images went through the tower once.
    assert runner.encoder_cache.misses == 2
    assert runner.encoder_cache.num_entries == 2
    if arch != "gemma3":
        return
    hits = runner.encoder_cache.hits
    again = _generate(port, prompts)
    _assert_tokens([o.outputs[0].token_ids for o in again], jax_tokens,
                   margins)
    assert again[0].num_cached_tokens == 16   # the page before the span's end
    assert runner.encoder_cache.hits > hits   # the span's rows past it
    # The same ids with another image: no page hit, other tokens.
    other = dict(prompts[0], multi_modal_data={"image": np.zeros(
        (16, 16, 3), np.uint8)})
    out = port.generate([other], SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS[0], ignore_eos=True))[0]
    assert out.num_cached_tokens == 0
    assert out.outputs[0].token_ids != jax_tokens[0]
