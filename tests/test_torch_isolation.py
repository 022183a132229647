"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package ``aphrodite_tpu``, and it never falls back to the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# `aphrodite_tpu` followed by a dot, space or line end: the
# `aphrodite_tpu_torch` prefix does not match.
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|aphrodite_tpu)(?=[.\s,]|$)", re.M)

_RUN_TINY = """
import sys
from aphrodite_tpu_torch import LLM, SamplingParams
cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
           num_attention_heads=2, num_key_value_heads=1,
           intermediate_size=64, architectures=["LlamaForCausalLM"])
llm = LLM("tiny", hf_config=cfg, tokenizer="unused", dtype="float32",
          device="cpu", block_size=16, num_kv_blocks=32, max_num_seqs=2,
          max_num_batched_tokens=32, max_model_len=128)
out = llm.generate([[1, 2, 3], [4, 5]],
                   SamplingParams(temperature=0.0, max_tokens=5,
                                  ignore_eos=True))
assert [len(o.outputs[0].token_ids) for o in out] == [5, 5]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "aphrodite_tpu" or m.startswith("aphrodite_tpu."))
print("BAD", bad)
"""


def test_runtime_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _RUN_TINY], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "aphrodite_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path


def test_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.findall("from aphrodite_tpu.config import X\n")
    assert _FORBIDDEN.findall("import jax.numpy as jnp\n")
    assert not _FORBIDDEN.findall("from aphrodite_tpu_torch import LLM\n")
    assert not _FORBIDDEN.findall("import jaxtyping\n")


def test_auto_device_without_cuda_raises():
    import torch
    from aphrodite_tpu_torch.config import DeviceConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'auto' resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceConfig("auto").resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceConfig("cuda").resolve()
    assert DeviceConfig("cpu").resolve() == "cpu"
