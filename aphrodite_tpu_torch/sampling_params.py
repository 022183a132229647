"""Per-request sampling parameters — the full Aphrodite sampler surface.

Behavioral parity target: aphrodite/common/sampling_params.py:346-416 (the
reference's ~60-field msgspec struct) including the fork's signature samplers:
DRY, XTC, dynamic temperature, top-nsigma, typical, quadratic/smoothing,
tail-free (TFS), eta/epsilon cutoffs, top-a, skew, and `sampler_priority`
re-ordering. Implemented as a plain dataclass. The PyTorch port samples
greedily only; sample/sampler.py rejects every other setting.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Optional, Union


class SamplingType(IntEnum):
    GREEDY = 0
    RANDOM = 1
    RANDOM_SEED = 2


class SamplerID(IntEnum):
    """Stable sampler ids for `sampler_priority` (KoboldCpp-compatible where
    applicable — reference: aphrodite/modeling/layers/sampler.py:165)."""
    # KoboldCpp-compatible ids
    TOP_K = 0
    TOP_A = 1
    TOP_P = 2
    TFS = 3
    TYPICAL = 4
    TEMPERATURE = 5
    XTC = 6
    # Aphrodite-specific ids
    DRY = 7
    PENALTIES = 8
    NO_REPEAT_NGRAM = 9
    EPSILON = 10
    MIN_P = 11
    ETA = 12
    QUADRATIC = 13
    TOP_NSIGMA = 14
    MIN_TOKENS = 15


# Default application order (reference: aphrodite/modeling/layers/sampler.py:331-346).
DEFAULT_SAMPLER_ORDER = [
    SamplerID.DRY,
    SamplerID.PENALTIES,
    SamplerID.NO_REPEAT_NGRAM,
    SamplerID.TEMPERATURE,
    SamplerID.TOP_NSIGMA,
    SamplerID.TOP_P,
    SamplerID.TOP_K,
    SamplerID.TOP_A,
    SamplerID.MIN_P,
    SamplerID.TFS,
    SamplerID.ETA,
    SamplerID.EPSILON,
    SamplerID.TYPICAL,
    SamplerID.QUADRATIC,
    SamplerID.XTC,
]

_SAMPLING_EPS = 1e-5


@dataclass
class GuidedDecodingParams:
    """Structured-output constraints (reference: common/sampling_params.py:35-47)."""
    json: Optional[Union[str, dict]] = None
    regex: Optional[str] = None
    choice: Optional[list[str]] = None
    grammar: Optional[str] = None
    json_object: bool = False
    backend: Optional[str] = None

    def num_constraints(self) -> int:
        return sum(x is not None and x is not False for x in
                   (self.json, self.regex, self.choice, self.grammar,
                    self.json_object or None))


@dataclass
class SamplingParams:
    n: int = 1
    best_of: Optional[int] = None
    # -- penalties -----------------------------------------------------------
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    # -- temperature ---------------------------------------------------------
    temperature: float = 1.0
    dynatemp_min: float = 0.0
    dynatemp_max: float = 0.0
    dynatemp_exponent: float = 1.0
    temperature_last: bool = False
    # -- truncation samplers -------------------------------------------------
    top_p: float = 1.0
    top_k: int = 0  # 0 or -1 => disabled
    top_a: float = 0.0
    min_p: float = 0.0
    tfs: float = 1.0
    eta_cutoff: float = 0.0  # in units of 1e-4, like the reference
    epsilon_cutoff: float = 0.0  # in units of 1e-4
    typical_p: float = 1.0
    # -- smoothing / quadratic ----------------------------------------------
    smoothing_factor: float = 0.0
    smoothing_curve: float = 1.0
    # -- XTC -----------------------------------------------------------------
    xtc_threshold: float = 0.1
    xtc_probability: float = 0.0
    # -- top-nsigma ----------------------------------------------------------
    nsigma: float = 0.0
    # -- DRY -----------------------------------------------------------------
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_sequence_breaker_ids: list[int] = field(default_factory=list)
    dry_range: int = 0  # 0 = whole context
    # -- skew ----------------------------------------------------------------
    skew: float = 0.0
    # -- misc ----------------------------------------------------------------
    seed: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    bad_words: list[str] = field(default_factory=list)
    include_stop_str_in_output: bool = False
    ignore_eos: bool = False
    max_tokens: Optional[int] = 16
    min_tokens: int = 0
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    detokenize: bool = True
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    logit_bias: Optional[dict[int, float]] = None
    allowed_token_ids: Optional[list[int]] = None
    sampler_priority: Optional[list[Union[int, str]]] = None
    guided_decoding: Optional[GuidedDecodingParams] = None
    logits_processors: Optional[list[Callable]] = None
    extra_args: Optional[dict[str, Any]] = None

    def __post_init__(self) -> None:
        self._verify()
        if self.temperature < _SAMPLING_EPS:
            # Greedy: neutralize probabilistic truncation like the reference.
            self.top_p = 1.0
            self.top_k = 0
            self.min_p = 0.0
        if self.sampler_priority is not None:
            self.sampler_priority = [
                SamplerID[p.upper()] if isinstance(p, str) else SamplerID(p)
                for p in self.sampler_priority
            ]
            missing = set(DEFAULT_SAMPLER_ORDER) - set(self.sampler_priority)
            if missing:
                raise ValueError(
                    f"sampler_priority missing samplers: {sorted(missing)}")

    def _verify(self) -> None:
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if self.best_of is not None and self.best_of < self.n:
            raise ValueError("best_of must be >= n")
        if not -2.0 <= self.presence_penalty <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2]")
        if not -2.0 <= self.frequency_penalty <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2]")
        if self.repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < -1:
            raise ValueError("top_k must be -1, 0, or positive")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        if not 0.0 < self.tfs <= 1.0:
            raise ValueError("tfs must be in (0, 1]")
        if not 0.0 < self.typical_p <= 1.0:
            raise ValueError("typical_p must be in (0, 1]")
        if not 0.0 <= self.xtc_threshold <= 0.5:
            raise ValueError("xtc_threshold must be in [0, 0.5]")
        if not 0.0 <= self.xtc_probability <= 1.0:
            raise ValueError("xtc_probability must be in [0, 1]")
        if self.nsigma < 0.0:
            raise ValueError("nsigma must be >= 0")
        if self.dry_multiplier < 0.0:
            raise ValueError("dry_multiplier must be >= 0")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.min_tokens < 0:
            raise ValueError("min_tokens must be >= 0")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError("logprobs must be >= 0")

    @property
    def sampling_type(self) -> SamplingType:
        if self.temperature < _SAMPLING_EPS:
            return SamplingType.GREEDY
        if self.seed is not None:
            return SamplingType.RANDOM_SEED
        return SamplingType.RANDOM

    @property
    def all_stop_token_ids(self) -> set[int]:
        return set(self.stop_token_ids)

    def clone(self) -> "SamplingParams":
        import copy
        return copy.deepcopy(self)
