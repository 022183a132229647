"""The port's quantized ``LLM.generate`` vs ``aphrodite_tpu.LLM`` with the
same ``quantization=`` on the same weights: the JAX engine's quantized
tree goes through ``params_from_jax`` into the port's worker.

Greedy token ids must be identical (fp32). Cases: gptq at a tiny geometry
whose W4 leaves stay unpacked, gptq at a packable one (hidden and
intermediate 2048: every projection packs), and w8a16; then gptq and w8a16
at Qwen2.5-7B's head grouping (7 query heads a KV head: 14 heads of 64 on
2, Qwen2.5-0.5B's heads) with widths that stay unpacked under gptq's group
of 128 (hidden 896, intermediate 640), the uint4 and W8 layouts of the
byte-layout slice. A 32-token batch
budget forces chunked prefill; 12 new tokens per request run decode
windows (M <= 256: the kernels' plain versions). A 300-token prompt,
chunked on the JAX side, goes through the port once more in one wave,
which takes the M > 256 dequantize-and-matmul path."""
import numpy as np
import pytest

from aphrodite_tpu.entrypoints.llm import LLM as JaxLLM
from aphrodite_tpu.sampling_params import SamplingParams as JaxParams
from aphrodite_tpu_torch import LLM, SamplingParams
from aphrodite_tpu_torch.loader.weights import params_from_jax

MAX_TOKENS = 12
CASES = {
    # name: (quantization, hidden, intermediate, layers, heads, arch)
    "gptq-unpacked": ("gptq", 128, 256, 2, 8, "Qwen2ForCausalLM"),
    "gptq-packed": ("gptq", 2048, 2048, 1, 16, "LlamaForCausalLM"),
    "w8a16": ("w8a16", 128, 256, 2, 8, "LlamaForCausalLM"),
    "gptq-group7": ("gptq", 896, 640, 2, 14, "Qwen2ForCausalLM"),
    "w8a16-group7": ("w8a16", 896, 640, 2, 14, "Qwen2ForCausalLM"),
}


def _kwargs(quant, H, inter, layers, heads, arch, budget):
    from transformers import LlamaConfig, Qwen2Config
    cls = Qwen2Config if arch == "Qwen2ForCausalLM" else LlamaConfig
    hf = cls(vocab_size=512, hidden_size=H, num_hidden_layers=layers,
             num_attention_heads=heads, num_key_value_heads=2,
             intermediate_size=inter, max_position_embeddings=512,
             rms_norm_eps=1e-5, tie_word_embeddings=False,
             rope_theta=500000.0, architectures=[arch])
    if arch == "LlamaForCausalLM":
        hf.rope_scaling = {"rope_type": "llama3", "factor": 8.0,
                           "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                           "original_max_position_embeddings": 64}
    return dict(hf_config=hf, tokenizer="unused", dtype="float32",
                load_format="dummy", device="cpu", quantization=quant,
                block_size=16, num_kv_blocks=128, max_num_seqs=4,
                max_num_batched_tokens=budget, max_model_len=384)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    quant, *geo = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if request.param.endswith("group7"):
            # The JAX package's Pallas W8/W4 kernels take K that their
            # 512-row block divides; at K = 896 and 640 the reference runs
            # its XLA path, its default off a TPU, whatever an earlier
            # test set APHRODITE_PALLAS_INTERPRET to.
            mp.setenv("APHRODITE_QUANT_PALLAS", "0")
        jax_llm = JaxLLM("dummy", **_kwargs(quant, *geo, budget=32))
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 500, size=n).tolist()
                   for n in (5, 40, 17, 3, 300)]
        params = JaxParams(temperature=0.0, max_tokens=MAX_TOKENS,
                           ignore_eos=True)
        jax_tokens = [o.outputs[0].token_ids
                      for o in jax_llm.generate(prompts, params)]
    tree = jax_llm.engine.core.worker.params
    return request.param, quant, geo, tree, prompts, jax_tokens


def _port(quant, geo, tree, budget):
    port = LLM("dummy", **_kwargs(quant, *geo, budget=budget))
    port.engine.core.worker.load_params(params_from_jax(tree))
    return port


def _generate(llm, prompts):
    outs = llm.generate(prompts, SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True))
    return [o.outputs[0].token_ids for o in outs]


def test_quantized_greedy_tokens_identical(case):
    name, quant, geo, tree, prompts, jax_tokens = case
    port = _port(quant, geo, tree, budget=32)
    leaves = port.engine.core.worker.model.layers[0].w_qkv.leaves()
    assert ("qweight_packed" in leaves) == (name == "gptq-packed")
    assert _generate(port, prompts) == jax_tokens


def test_quantized_prefill_wave_over_256_tokens(case):
    _, quant, geo, tree, prompts, jax_tokens = case
    port = _port(quant, geo, tree, budget=512)
    assert len(prompts[-1]) > 256
    assert _generate(port, prompts[-1:]) == jax_tokens[-1:]
