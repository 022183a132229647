"""Small shared utilities (shape math, id counter, dtypes, logging)."""
from __future__ import annotations

import logging
import os

logger = logging.getLogger("aphrodite_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(levelname)s %(asctime)s [%(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("APHRODITE_TPU_LOG_LEVEL", "INFO"))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_power_of_2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Counter:
    """Monotonic id generator."""

    def __init__(self) -> None:
        self._v = 0

    def __next__(self) -> int:
        v = self._v
        self._v += 1
        return v


def torch_dtype(name):
    """Map a dtype string to a torch dtype."""
    import torch
    table = {
        "float32": torch.float32, "float": torch.float32,
        "float16": torch.float16, "half": torch.float16,
        "bfloat16": torch.bfloat16, "auto": torch.bfloat16,
    }
    if not isinstance(name, str):
        return name
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}") from None
