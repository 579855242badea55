"""Llama/Qwen-family decoder forwards in PyTorch.

Parameters are a plain dict: "embed" [V, D], "final_norm" [D], optional
"lm_head" [V, D], and "layers", a list with one dict per layer whose
matmul weights keep the JAX package's [in, out] orientation (wq [D,
H*hd], wo [H*hd, D], ...). Activations are flattened to [tokens, D]; the
KV pools [L, S, Hk, hd] are written IN PLACE (the JAX forwards return
fresh pools from donated buffers) and returned for symmetry with them.
Matmuls run in the weights' dtype, norms, RoPE, softmax and logits in
float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.ops.attention import (paged_decode_attention_any,
                                              ragged_attention_any)
from ollamamq_tpu_torch.ops.quant import embed_lookup, kv_write, logits_head, qeinsum
from ollamamq_tpu_torch.ops.rope import apply_rope


def _adtype(params: dict) -> torch.dtype:
    """Activation dtype: norm weights carry it."""
    return params["final_norm"].dtype


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 variance, cast back to x's dtype, then scale by w."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> dict:
    """Random-init parameters: N(0, 1/fan_in) matmul weights drawn in
    float32 from `generator` (on `device`), unit norms, zero biases."""
    d, qd, kvd, f = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (t / math.sqrt(fan_in)).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "attn_norm": ones(d),
            "wq": w((d, qd), d), "wk": w((d, kvd), d), "wv": w((d, kvd), d),
            "wo": w((qd, d), qd),
            "mlp_norm": ones(d),
            "w_gate": w((d, f), d), "w_up": w((d, f), d), "w_down": w((f, d), f),
        }
        if cfg.attn_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                lp[name] = torch.zeros(n, dtype=dtype, device=device)
        if cfg.qk_norm:
            lp["q_norm"] = ones(cfg.head_dim)
            lp["k_norm"] = ones(cfg.head_dim)
        layers.append(lp)
    params = {"embed": w((cfg.vocab_size, d), d), "final_norm": ones(d),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = w((cfg.vocab_size, d), d)
    return params


def _qkv(cfg: ModelConfig, lp: dict, h: torch.Tensor):
    """Project hidden [N, D] -> q [N, H, hd], k, v [N, Hk, hd]."""
    N = h.shape[0]
    q = qeinsum("nd,de->ne", h, lp["wq"])
    k = qeinsum("nd,de->ne", h, lp["wk"])
    v = qeinsum("nd,de->ne", h, lp["wv"])
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(N, cfg.num_heads, cfg.head_dim)
    k = k.reshape(N, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(N, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _mlp(lp: dict, h: torch.Tensor) -> torch.Tensor:
    gate = qeinsum("nd,df->nf", h, lp["w_gate"])
    up = qeinsum("nd,df->nf", h, lp["w_up"])
    return qeinsum("nf,fd->nd", F.silu(gate) * up, lp["w_down"])


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    return logits_head(x, params.get("lm_head", params["embed"]))


def layer_step(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, attend) -> torch.Tensor:
    """One decoder layer: norm, qkv, RoPE, `attend(q, k, v)` -> [N, H,
    hd], output projection and the SwiGLU MLP, with residuals."""
    N = x.shape[0]
    h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = attend(q, k, v)
    x = x + qeinsum("ne,ed->nd", attn.reshape(N, cfg.q_dim), lp["wo"])
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(lp, h2)


def _layers(params, cfg, x, positions, k_cache, v_cache, write_slots, attend):
    """The paged layer stack: each layer writes its K/V BEFORE attention
    (a token sees its own K/V), then attends through `attend(layer, q)`.
    `k_cache[layer]` is that layer's pool, a tensor or a QuantKV."""
    for layer, lp in enumerate(params["layers"]):
        def paged(q, k, v, layer=layer):
            kv_write(k_cache[layer], write_slots, k)
            kv_write(v_cache[layer], write_slots, v)
            return attend(layer, q)

        x = layer_step(cfg, lp, x, positions, paged)
    return x


def forward_ragged(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] flattened mixed-batch token stream
    tok_seq: torch.Tensor,  # [T] sequence (batch row) per token
    tok_pos: torch.Tensor,  # [T] kv position per token (-1 = pad)
    write_slots: torch.Tensor,  # [T] flat cache slot per token
    out_idx: torch.Tensor,  # [B] or [B, O] stream indices to read logits at
    k_cache,  # [L, S, Hk, hd] tensor or QuantKV, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages] int32
    q_start: torch.Tensor,  # [B] int32 span offset per sequence
    q_len: torch.Tensor,  # [B] int32 span length (0 = padding row)
    kv_len: torch.Tensor,  # [B] int32 context length incl. the span
    page_size: int,
    attn_impl: str = "kernel",  # "kernel" (serving) | "plain" (reference)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE forward over a ragged mixed batch of prefill spans and decode
    tokens sharing a flattened [T] stream. Each layer writes the
    stream's K/V into its pages, then every token attends causally over
    its own sequence's paged context. Returns (logits [B, V] or
    [B, O, V] in float32, k_cache, v_cache); padding rows' logits are
    garbage the caller ignores."""
    x = embed_lookup(params["embed"], tokens, _adtype(params))  # [T, D]
    positions = tok_pos.clamp_min(0)

    def attend(layer, q):
        return ragged_attention_any(
            attn_impl, q, k_cache[layer], v_cache[layer], page_table,
            tok_seq, tok_pos, kv_len, q_start, q_len, page_size)

    x = _layers(params, cfg, x, positions, k_cache, v_cache, write_slots,
                attend)
    return _logits(params, cfg, x[out_idx.long()]), k_cache, v_cache


def forward_decode(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] last generated token per slot
    positions: torch.Tensor,  # [B] int32 position of `tokens` in each seq
    k_cache,  # [L, S, Hk, hd] tensor or QuantKV, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    attn_impl: str = "kernel",  # "kernel" (serving) | "plain" (reference)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for the whole batch; returns (logits [B, V] in
    float32, k_cache, v_cache)."""
    B = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens, _adtype(params))  # [B, D]
    pos = positions.long()
    rows = torch.arange(B, device=tokens.device)
    write_slots = (page_table[rows, pos // page_size].long() * page_size
                   + pos % page_size)
    seq_lens = (positions + 1).to(torch.int32)

    def attend(layer, q):
        return paged_decode_attention_any(
            attn_impl, q, k_cache[layer], v_cache[layer], page_table,
            seq_lens, page_size)

    x = _layers(params, cfg, x, positions, k_cache, v_cache, write_slots,
                attend)
    return _logits(params, cfg, x), k_cache, v_cache
