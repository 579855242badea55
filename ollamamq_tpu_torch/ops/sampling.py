"""Token sampling on tensors: penalties, greedy, temperature, top-k, top-p.

The masking arithmetic is the JAX package's (ollamamq_tpu/ops/sampling.py)
operation for operation, so penalties, masks and greedy picks agree
exactly. Random draws come from torch.Generators instead of jax.random
keys: a seeded row draws from a generator seeded by (seed, position)
alone, so its stream is reproducible and independent of its batch-mates;
unseeded rows share the engine's generator. The bits differ from JAX's
threefry streams by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SamplingParams:
    """Host-side per-request sampling options (Ollama/OpenAI option names)."""

    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0
    repeat_penalty: float = 1.0  # 1.0 => off (Ollama's default is 1.1)
    presence_penalty: float = 0.0  # additive, OpenAI semantics (0 => off)
    frequency_penalty: float = 0.0  # additive per occurrence (0 => off)
    # None => unseeded. Any provided integer, INCLUDING 0, maps to a
    # seeded stream.
    seed: "int | None" = None  # stored as int32 > 0 after __post_init__
    max_tokens: int = 256
    stop: tuple = ()
    # Per-request deadline budget in ms from enqueue (0 = none).
    deadline_ms: float = 0.0

    def __post_init__(self):
        try:
            self.deadline_ms = max(0.0, float(self.deadline_ms or 0.0))
        except (TypeError, ValueError):
            self.deadline_ms = 0.0
        # Fold arbitrary client seeds into [1, 2^31-1]; 0 stays a valid
        # seed (folds to 1), distinct from absent (None -> 0 = unseeded).
        self.seed = 0 if self.seed is None else (
            int(self.seed) % 0x7FFFFFFE) + 1

    @classmethod
    def from_ollama_options(cls, options: dict, max_tokens_default: int) -> "SamplingParams":
        options = options or {}
        return cls(
            temperature=float(options.get("temperature", 0.8) or 0.0),
            top_k=int(options.get("top_k", 0) or 0),
            top_p=float(options.get("top_p", 1.0) or 1.0),
            repeat_penalty=float(options.get("repeat_penalty", 1.1) or 1.0),
            presence_penalty=float(options.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(options.get("frequency_penalty", 0.0) or 0.0),
            seed=options.get("seed"),
            max_tokens=int(options.get("num_predict", max_tokens_default) or max_tokens_default),
            stop=tuple(options.get("stop", []) or []),
            deadline_ms=options.get("deadline_ms", 0.0),
        )

    @classmethod
    def from_openai(cls, body: dict, max_tokens_default: int) -> "SamplingParams":
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            temperature=float(body.get("temperature", 1.0) or 0.0),
            top_k=0,
            top_p=float(body.get("top_p", 1.0) or 1.0),
            repeat_penalty=float(body.get("repeat_penalty", 1.0) or 1.0),
            presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
            seed=body.get("seed"),
            max_tokens=int(
                body.get("max_tokens") or body.get("max_completion_tokens") or max_tokens_default
            ),
            stop=tuple(stop),
            deadline_ms=body.get("deadline_ms", 0.0),
        )


def recent_token_counts(recent: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, W] ring of recent token ids (-1 = empty) -> [B, V] int32 counts."""
    B = recent.shape[0]
    valid = (recent >= 0).to(torch.int32)
    counts = torch.zeros((B, vocab), dtype=torch.int32, device=recent.device)
    return counts.scatter_add_(1, recent.clamp_min(0).long(), valid)


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    recent: torch.Tensor,  # [B, W] last-W context token ids (-1 pad)
    repeat: torch.Tensor,  # [B] multiplicative, llama.cpp semantics (1.0 = off)
    presence: torch.Tensor,  # [B] additive once per seen token (0.0 = off)
    frequency: torch.Tensor,  # [B] additive per occurrence (0.0 = off)
) -> torch.Tensor:
    """llama.cpp-style multiplicative repeat penalty plus OpenAI-style
    additive presence / frequency penalties over the recent window."""
    counts = recent_token_counts(recent, logits.shape[1])
    seen = counts > 0
    p = repeat[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    out = torch.where(seen & (p != 1.0), penalized, logits)
    out = out - frequency[:, None] * counts.to(logits.dtype)
    return out - presence[:, None] * seen.to(logits.dtype)


def maybe_apply_penalties(logits, recent, repeat, presence, frequency,
                          need_penalties: bool = True):
    """apply_penalties, skipped when the host knows every row is neutral."""
    if not need_penalties:
        return logits
    return apply_penalties(logits, recent, repeat, presence, frequency)


# Candidate pool for top-k / top-p thresholds: requests asking top_k >
# MAX_TOPK are clamped and a nucleus wider than MAX_TOPK candidates
# degrades to top-MAX_TOPK. Probabilities use the FULL softmax normaliser
# (logsumexp over all logits), so within the pool the cutoff is exact.
MAX_TOPK = 256


def _masked_scaled_logits(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (0 = off)
    top_p: torch.Tensor,  # [B]
    need_mask: bool = True,
):
    """(masked scaled logits, greedy argmax)."""
    V = logits.shape[1]
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    if not need_mask:
        return scaled, greedy

    K = min(MAX_TOPK, V)
    vals = torch.topk(scaled, K, dim=-1).values  # [B, K] descending

    k_idx = (top_k.long() - 1).clamp(0, K - 1)
    kth = torch.gather(vals, 1, k_idx[:, None])
    topk_mask = torch.where((top_k > 0)[:, None], scaled >= kth,
                            torch.ones_like(scaled, dtype=torch.bool))

    log_z = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(vals - log_z)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_count = torch.sum(cum - probs < top_p[:, None], dim=-1)  # >= 1
    cut_idx = (cutoff_count - 1).clamp(0, K - 1)
    p_kth = torch.gather(vals, 1, cut_idx[:, None])
    topp_mask = torch.where((top_p < 1.0)[:, None], scaled >= p_kth,
                            torch.ones_like(scaled, dtype=torch.bool))

    return torch.where(topk_mask & topp_mask, scaled,
                       torch.full_like(scaled, -torch.inf)), greedy


def sampling_flags(temp, top_k, top_p, repeat, presence, frequency):
    """(need_penalties, need_mask, need_sample) from HOST-side parameter
    arrays: an all-greedy batch runs argmax only."""
    return (
        bool(np.any(np.asarray(repeat) != 1.0)
             or np.any(np.asarray(presence) != 0.0)
             or np.any(np.asarray(frequency) != 0.0)),
        bool(np.any(np.asarray(top_k) > 0)
             or np.any(np.asarray(top_p) < 1.0)),
        bool(np.any(np.asarray(temp) > 0)),
    )


def _mix(seed: int, position: int) -> int:
    """64-bit generator seed from (request seed, sampled position):
    splitmix64 finaliser over the pair."""
    z = ((int(seed) << 32) ^ (int(position) & 0xFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def row_uniforms(generator: torch.Generator, seeds, positions, V: int,
                 device) -> torch.Tensor:
    """[B, V] uniforms in (0, 1): seeded rows (seeds[i] > 0) from a
    generator seeded by (seeds[i], positions[i]) alone, unseeded rows
    from the engine's `generator`. `seeds` and `positions` are host
    arrays; `positions` is the absolute position being sampled."""
    seeds = np.asarray(seeds)
    u = torch.rand((len(seeds), V), generator=generator, device=device)
    for i in np.flatnonzero(seeds > 0):
        g = torch.Generator(device=device)
        g.manual_seed(_mix(seeds[i], int(positions[i])))
        u[i] = torch.rand(V, generator=g, device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def sample_tokens_rowwise(
    logits: torch.Tensor,  # [B, V] float32
    uniforms,  # [B, V] row_uniforms(...), or None when need_sample is False
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] (0 = off)
    top_p: torch.Tensor,  # [B]
    need_mask: bool = True,
    need_sample: bool = True,
) -> torch.Tensor:
    """Greedy rows take the argmax; temperature rows draw from the masked
    scaled distribution by Gumbel-max over their own uniforms."""
    masked, greedy = _masked_scaled_logits(logits, temperature, top_k, top_p,
                                           need_mask)
    if not need_sample:
        return greedy.to(torch.int32)
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def accept_prefix(draft: torch.Tensor,  # [B, K] int32 proposed drafts
                  greedy: torch.Tensor,  # [B, K] int32 argmax at each draft's position
                  draft_len: torch.Tensor,  # [B] int32 valid drafts per row
                  ) -> torch.Tensor:
    """[B] number of leading drafts the model verified: draft j counts iff
    every draft before it did and the argmax at its position equals it
    (the running product of the match mask), and only below draft_len.
    Accepting this prefix and then taking the model's own next token
    reproduces the non-speculative greedy stream exactly."""
    K = draft.shape[1]
    if K == 0:
        return torch.zeros(draft.shape[0], dtype=torch.int32, device=draft.device)
    valid = torch.arange(K, device=draft.device)[None, :] < draft_len[:, None]
    match = ((draft == greedy) & valid).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
