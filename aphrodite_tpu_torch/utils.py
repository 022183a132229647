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
    """Map a dtype string to a torch dtype (``aphrodite_tpu/utils.py:111-126``:
    "float8_e4m3" is e4m3fn)."""
    import torch
    table = {
        "float32": torch.float32, "float": torch.float32,
        "float16": torch.float16, "half": torch.float16,
        "bfloat16": torch.bfloat16, "auto": torch.bfloat16,
        "float8_e4m3": torch.float8_e4m3fn,
        "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2,
        "int8": torch.int8, "int32": torch.int32,
    }
    if not isinstance(name, str):
        return name
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}") from None


# The largest magnitude that rounds to e4m3fn's 448 (ties to even); above
# it the reference's cast gives NaN.
E4M3_ROUNDS_TO_MAX = 464.0


def to_fp8(x, dtype):
    """x cast to an fp8 dtype as the JAX package casts it (XLA and ml_dtypes
    agree): round to nearest even, and for e4m3fn NaN (its sign kept) where
    |x| rounds past 448 (above 464, inf included). torch's own cast
    saturates those to +-448 (on the CPU; on the card it is not relied on).
    e5m2 agrees as it is: overflow gives inf in both."""
    import torch
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    b = y.view(torch.uint8)
    b = torch.where(x.abs() > E4M3_ROUNDS_TO_MAX, b | 0x7F, b)
    return b.view(dtype)
