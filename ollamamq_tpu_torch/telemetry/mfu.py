"""Analytic MFU accounting: FLOPs per generated token over chip peak.

The FLOPs model is the standard decoder estimate (PaLM appendix B /
Chinchilla): matmul work is 2 x (active) parameters per token, plus
attention score+value work 4 x layers x context x q_dim per token. For
MoE models only routed-active experts count (a Mixtral 8x7b token pays
~13B, not 47B).

Peak FLOPs are the published bf16 dense (no sparsity) peaks per card,
keyed on torch.cuda.get_device_name(); a card missing from the table
(and the CPU) yields None and the engine publishes mfu=0 rather than a
made-up number. OLLAMAMQ_PEAK_FLOPS overrides — that is also how CPU
tests get a deterministic nonzero MFU.

Stdlib only: the ModelConfig duck-types (num_layers, hidden_size, ...).
"""

from __future__ import annotations

import os
from typing import Optional

# Published bf16 dense peak FLOP/s per card, matched in order by
# lowercase substring against torch.cuda.get_device_name(): the PCIe
# H100 before the SXM one ("NVIDIA H100 80GB HBM3").
PEAK_FLOPS_BY_KIND = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989e12),
)


def peak_flops_per_chip(device_kind: str) -> Optional[float]:
    """Peak bf16 FLOP/s for one card, or None if unknown (CPU, other
    cards)."""
    env = os.environ.get("OLLAMAMQ_PEAK_FLOPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    for sub, peak in PEAK_FLOPS_BY_KIND:
        if sub in kind:
            return peak
    return None


def active_param_count(cfg) -> int:
    """Params touched per token: for MoE, the top-k routed experts plus
    router, not the full expert bank; dense models = param_count."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    mlp = 3 * d * f
    if getattr(cfg, "num_experts", 0):
        mlp = cfg.num_experts_per_tok * 3 * d * f + d * cfg.num_experts
    per_layer = (
        d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        + mlp
        + 2 * d
    )
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    return cfg.num_layers * per_layer + embed + d


def flops_per_token(cfg, context_len: float = 0.0) -> float:
    """Forward FLOPs to generate one token at the given KV context."""
    dense = 2.0 * active_param_count(cfg)
    # QK^T and attn x V: each 2 x ctx x q_dim MACs = 2 FLOPs, per layer.
    attn = 4.0 * cfg.num_layers * max(0.0, context_len) * cfg.q_dim
    return dense + attn


def mfu(cfg, tokens: float, seconds: float, peak_per_chip: Optional[float],
        n_chips: int = 1, context_len: float = 0.0) -> float:
    """Achieved FLOPs over peak, 0..1; 0.0 when unmeasurable."""
    if not peak_per_chip or seconds <= 0 or tokens <= 0 or n_chips < 1:
        return 0.0
    achieved = tokens * flops_per_token(cfg, context_len) / seconds
    return achieved / (peak_per_chip * n_chips)
