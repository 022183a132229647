"""Worker: device choice, model load, KV memory sizing, runner ownership."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from aphrodite_tpu_torch.config import EngineConfig
from aphrodite_tpu_torch.loader.weights import load_model, load_params
from aphrodite_tpu_torch.quantization.base import get_quantization_config
from aphrodite_tpu_torch.utils import logger
from aphrodite_tpu_torch.worker.runner import ModelRunner

# Share of the card's free memory (after the weights) the KV pool may take,
# less a reserve for activations and workspace (bytes).
_KV_MEMORY_SHARE = 0.9
_ACTIVATION_HEADROOM = 1 * 2**30


class Worker:

    def __init__(self, config: EngineConfig) -> None:
        self.config = config
        self.device = torch.device(config.device_config.resolve())
        # The format is fixed before the weights are made: the model builds
        # quantized buffers in place of the projections' fp weights.
        self.quant_config = get_quantization_config(config.model_config)
        if self.quant_config is not None:
            logger.info("quantization: %s (bits=%d group=%d)",
                        self.quant_config.method,
                        self.quant_config.weight_bits,
                        self.quant_config.group_size)
        self.model = load_model(config.model_config, config.load_config,
                                self.device, self.quant_config)
        cc = config.cache_config
        if getattr(self.model, "is_ssm", False):
            # Recurrent-state models have no reusable KV pages: a computed
            # prefix cannot be hit (``aphrodite_tpu/worker/worker.py:190``).
            cc.enable_prefix_caching = False
        if cc.num_blocks is None:
            cc.num_blocks = self._determine_num_blocks()
        logger.info("KV pages: %d x %d tokens", cc.num_blocks, cc.block_size)
        self.runner = ModelRunner(config, self.model, self.device)

    def load_params(self, state: Mapping[str, np.ndarray]) -> None:
        """Replace the model's weights with a full state dict (for example
        ``loader.weights.params_from_jax`` of the JAX engine's tree, or
        another port model's ``state_dict()``: numpy has no fp8)."""
        load_params(self.model, state)

    def _determine_num_blocks(self) -> int:
        """Size the KV pool from the card's free memory after the weights
        are loaded (``aphrodite_tpu/worker/worker.py:279``)."""
        cc = self.config.cache_config
        mc = self.config.model_config
        max_needed = (self.config.max_blocks_per_req *
                      self.config.scheduler_config.max_num_seqs + 1)
        if getattr(self.model, "is_ssm", False):
            # The pages are accounting only: no memory stands behind them.
            return max_needed
        # Bytes of one K/V element in the cache's own dtype (the JAX
        # package's kv_bytes_per_token_per_layer).
        item = cc.torch_dtype(mc.dtype).itemsize
        page_bytes = (mc.num_kv_heads * 2 * mc.head_dim * cc.block_size
                      * mc.num_layers * item)
        if self.device.type != "cuda":
            return 512  # CPU: small default for tests
        torch.cuda.empty_cache()  # transient init buffers count as free
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = int(free * _KV_MEMORY_SHARE) - _ACTIVATION_HEADROOM
        num = max(budget // page_bytes, 16)
        return int(min(num, max_needed))
