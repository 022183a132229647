"""PyTorch/CUDA port of aphrodite-tpu's serving main path.

A package of its own beside the JAX package ``aphrodite_tpu``, which stays
the reference: same scheduler, paged KV cache and Llama/Qwen2 model, with
the TPU's Pallas attention kernels replaced by CUDA kernels written for
Hopper (``csrc/``). It imports nothing of JAX or of ``aphrodite_tpu``.
"""
from aphrodite_tpu_torch.entrypoints.llm import LLM
from aphrodite_tpu_torch.sampling_params import SamplingParams

__all__ = ["LLM", "SamplingParams"]
