"""Model and engine configuration for the PyTorch/CUDA serving path.

The dense decoder architectures (Llama 3.x, Qwen2.5 with attention bias,
Qwen3 with per-head q/k norm) and the engine fields the single-device
serving path reads. Mixture-of-experts and encoder models are not served
by this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture description (Llama/Qwen family)."""

    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # Qwen2-style attention projections carry a bias term; Llama's do not.
    attn_bias: bool = False
    # Qwen3-style per-head RMSNorm on q and k after projection (pre-RoPE).
    qk_norm: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (for device-memory budgeting)."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                     + 3 * d * f + 2 * d)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d


# Sizes follow the public architecture descriptions of each family; the
# "test" configs are tiny and used by the unit tests.
MODEL_CONFIGS = {
    "test-tiny": ModelConfig(
        name="test-tiny", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10_000.0, max_seq_len=512,
    ),
    "test-tiny-gqa": ModelConfig(
        name="test-tiny-gqa", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=8, num_kv_heads=4,
        head_dim=16, rope_theta=10_000.0, max_seq_len=512,
    ),
    "test-tiny-qwen": ModelConfig(
        name="test-tiny-qwen", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10_000.0, max_seq_len=512, attn_bias=True,
    ),
    "test-tiny-qwen3": ModelConfig(
        name="test-tiny-qwen3", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, rope_theta=10_000.0, max_seq_len=512, qk_norm=True,
    ),
    "llama3.2:1b": ModelConfig(
        name="llama3.2:1b", vocab_size=128_256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500_000.0, max_seq_len=131_072,
        tie_embeddings=True,
    ),
    "llama3.2:3b": ModelConfig(
        name="llama3.2:3b", vocab_size=128_256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rope_theta=500_000.0, max_seq_len=131_072,
        tie_embeddings=True,
    ),
    "llama3:8b": ModelConfig(
        name="llama3:8b", vocab_size=128_256, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500_000.0, max_seq_len=8192,
    ),
    "qwen2.5:7b": ModelConfig(
        name="qwen2.5:7b", vocab_size=152_064, hidden_size=3584,
        intermediate_size=18_944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1_000_000.0, max_seq_len=32_768,
        attn_bias=True,
    ),
    "qwen2.5-7b-instruct": ModelConfig(
        name="qwen2.5-7b-instruct",
        vocab_size=152_064, hidden_size=3584, intermediate_size=18_944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1_000_000.0, max_seq_len=32_768, attn_bias=True,
    ),
    "qwen3:8b": ModelConfig(
        name="qwen3:8b", vocab_size=151_936, hidden_size=4096,
        intermediate_size=12_288, num_layers=36, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=1_000_000.0,
        max_seq_len=32_768, qk_norm=True,
    ),
}


def smart_match(name: str, candidates) -> Optional[str]:
    """Model-name matching: exact, then lowercase, then tag-stripped
    (`llama3` matches `llama3:8b`). The native scheduler core
    (cpp/mqcore.cpp) applies the same rule in its eligibility gate."""
    candidates = list(candidates)
    if name in candidates:
        return name
    low = name.lower()
    by_lower = {c.lower(): c for c in candidates}
    if low in by_lower:
        return by_lower[low]
    base = low.split(":", 1)[0]
    for c in candidates:
        if c.lower().split(":", 1)[0] == base:
            return c
    return None


def get_model_config(name: str) -> Optional[ModelConfig]:
    """Resolve a requested model name to an architecture via smart_match."""
    key = smart_match(name, MODEL_CONFIGS.keys())
    return MODEL_CONFIGS[key] if key is not None else None


@dataclasses.dataclass
class EngineConfig:
    """Continuous-batching engine configuration (single device)."""

    model: str = "test-tiny"
    # Decode slots = max sequences generating concurrently in one batch.
    max_slots: int = 64
    # Paged KV cache: total pages in the pool (page 0 is the trash page)
    # and tokens per page.
    num_pages: int = 256
    page_size: int = 32
    # Max pages a single sequence may hold (=> max context length).
    max_pages_per_seq: int = 16
    # Token budget of one ragged dispatch: one token per live decode slot
    # plus as many prefill-span tokens as fit. Clamped up to
    # max_slots + token_granule so a full decode batch always fits.
    max_batch_tokens: int = 512
    # The stream's total token count rounds to rungs of a power-of-two
    # ladder over this granule.
    token_granule: int = 16
    # Max new tokens default when the request doesn't specify.
    max_new_tokens: int = 256
    # Decode steps run per dispatch when no admission could land between
    # steps (one Python loop of forward_decode + sampling per step).
    decode_steps_per_iter: int = 8
    # Repeat-penalty window (llama.cpp repeat_last_n).
    repeat_last_n: int = 64
    dtype: str = "bfloat16"
    # "int8": per-channel symmetric int8 weights, quantized when the
    # runtime builds them (f32 scales; norms and biases stay in `dtype`).
    weights_dtype: str = "bfloat16"
    # "int8": int8 KV pages with one f32 scale per (slot, kv head) stored
    # beside the pool; pages shrink by (hd + 4) / (2 * hd).
    kv_dtype: str = "bfloat16"
    seed: int = 0

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size


QUANT_DTYPES = ("bfloat16", "int8")


def validate_quant_config(weights_dtype: str, kv_dtype: str) -> Optional[str]:
    """Check the quantization flags before any device work: an error
    string, or None when valid. ModelRuntime calls it at build (the CLI's
    argparse choices already restrict the flags to QUANT_DTYPES).
    (The JAX package's copy also rejects int8 KV with pp/sp and int8
    weights for MoE models; this package serves neither yet.)"""
    if weights_dtype not in QUANT_DTYPES:
        return (f"--weights-dtype must be one of {QUANT_DTYPES}, "
                f"got {weights_dtype!r}")
    if kv_dtype not in QUANT_DTYPES:
        return f"--kv-dtype must be one of {QUANT_DTYPES}, got {kv_dtype!r}"
    return None
