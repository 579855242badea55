"""Llama/Qwen/Mixtral-family decoder forwards in PyTorch.

Parameters are a plain dict: "embed" [V, D], "final_norm" [D], optional
"lm_head" [V, D] (absent for tied embeddings and for encoders), and "layers", a list with one dict per layer whose
matmul weights keep the JAX package's [in, out] orientation (wq [D,
H*hd], wo [H*hd, D], ...). Activations are flattened to [tokens, D]; the
KV pools [L, S, Hk, hd] are written IN PLACE (the JAX forwards return
fresh pools from donated buffers) and returned for symmetry with them.
Matmuls run in the weights' dtype, norms, RoPE, softmax and logits in
float32, as in the JAX package. Under tensor parallelism (`tp`, a
parallel.mesh.TensorGroup) each rank holds its slice of the weights
(parallel/sharding.py): H/tp query heads and its share of the KV heads,
F/tp of the FFN, V/tp vocabulary rows. The layer code reads head counts
from the tensors, not from cfg, and the forwards call the collectives
GSPMD inserts in the JAX package: an all_reduce (sum) after wo and after
the FFN's down projection, the vocab-parallel embedding (ids outside the
rank's rows give zeros, then all_reduce) and the vocab gather of the
logits, so every rank holds the full [N, V] logits and samples the same
ids. A mixture-of-experts layer holds
w_router and the expert stacks we_gate / we_up / we_down
(models/moe.py) in place of w_gate / w_up / w_down. Under expert
parallelism (`ep`, a parallel.mesh.ExpertGroup) a rank holds E / ep of
each MoE layer's experts and everything else as at ep 1: an MoE layer's
partial FFN output is summed over the (expert, tensor) plane in one
all_reduce, while attention, and a dense layer's FFN (replicated over
the expert axis), sum over the tensor axis only.
"""

from __future__ import annotations

import math
import time
from typing import Tuple

import torch
import torch.nn.functional as F

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.models.moe import init_moe_layer_params, moe_mlp
from ollamamq_tpu_torch.ops.attention import (bidirectional_attention,
                                              causal_attention,
                                              flat_slot_indices,
                                              paged_chunk_attention_blockwise,
                                              paged_decode_attention_any,
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
                dtype=torch.bfloat16, device="cpu", prepare_layer=None,
                prepare_top=None) -> dict:
    """Random-init parameters: N(0, 1/fan_in) matmul weights drawn in
    float32 from `generator` (on `device`), unit norms, zero biases; an
    MoE model's layers get routed experts instead of the dense FFN.
    `prepare_layer(layer)` and `prepare_top(name, tensor)` (embed,
    lm_head) transform each piece right after it is drawn, in draw
    order (a tensor-parallel rank keeps its slice and frees the rest); a
    layer for which prepare_layer returns None is dropped (a pipeline
    stage keeps its own layers, drawn in the same order as every other
    stage's, so the random stream is the same on every rank)."""
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
        }
        if cfg.num_experts:
            lp.update(init_moe_layer_params(cfg, generator, dtype, device))
        else:
            lp.update(w_gate=w((d, f), d), w_up=w((d, f), d),
                      w_down=w((f, d), f))
        if cfg.attn_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                lp[name] = torch.zeros(n, dtype=dtype, device=device)
        if cfg.qk_norm:
            lp["q_norm"] = ones(cfg.head_dim)
            lp["k_norm"] = ones(cfg.head_dim)
        lp = prepare_layer(lp) if prepare_layer else lp
        if lp is not None:
            layers.append(lp)

    def top(name, t):
        return prepare_top(name, t) if prepare_top else t

    params = {"embed": top("embed", w((cfg.vocab_size, d), d)),
              "final_norm": ones(d), "layers": layers}
    if not cfg.tie_embeddings and not cfg.is_encoder:
        params["lm_head"] = top("lm_head", w((cfg.vocab_size, d), d))
    return params


def _qkv(cfg: ModelConfig, lp: dict, h: torch.Tensor):
    """Project hidden [N, D] -> q [N, H, hd], k, v [N, Hk, hd] (this
    rank's heads under tensor parallelism)."""
    N = h.shape[0]
    q = qeinsum("nd,de->ne", h, lp["wq"])
    k = qeinsum("nd,de->ne", h, lp["wk"])
    v = qeinsum("nd,de->ne", h, lp["wv"])
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(N, -1, cfg.head_dim)
    k = k.reshape(N, -1, cfg.head_dim)
    v = v.reshape(N, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _mlp(lp: dict, h: torch.Tensor) -> torch.Tensor:
    gate = qeinsum("nd,df->nf", h, lp["w_gate"])
    up = qeinsum("nd,df->nf", h, lp["w_up"])
    return qeinsum("nf,fd->nd", F.silu(gate) * up, lp["w_down"])


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor, valid=None,
         ep=None) -> torch.Tensor:
    """Dense SwiGLU or routed mixture-of-experts, by model family.
    `valid` (bool, one per row of h) marks real tokens; only MoE routing
    reads it (padding and parked rows must not claim expert capacity).
    Under `ep` an MoE layer runs this rank's experts only (a partial
    sum)."""
    if cfg.num_experts:
        experts = None if ep is None else ep.expert_range(cfg.num_experts)
        return moe_mlp(cfg, lp, h, valid=valid, experts=experts)
    return _mlp(lp, h)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    local = logits_head(x, params.get("lm_head", params["embed"]))
    return local if tp is None else tp.gather_vocab(local, cfg.vocab_size)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           tp=None) -> torch.Tensor:
    """Embedding rows [N, D] in the activation dtype; vocab-parallel
    under `tp`: a rank gathers the ids inside its rows, zeros elsewhere,
    and the all_reduce sums the one nonzero row of each id (exact)."""
    dtype = _adtype(params)
    if tp is None:
        return embed_lookup(params["embed"], tokens, dtype)
    lo, hi = tp.vocab_range(cfg.vocab_size)
    local = tokens.long() - lo
    mine = (local >= 0) & (local < hi - lo)
    x = embed_lookup(params["embed"], torch.where(mine, local, 0), dtype)
    return tp.all_reduce(x * mine[:, None].to(dtype))


def _reduce(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else tp.all_reduce(x)


def _ffn_sum(cfg: ModelConfig, y: torch.Tensor, tp, ep) -> torch.Tensor:
    """The FFN's partial outputs summed over the ranks that share them:
    an MoE layer's over the (expert, tensor) plane, a dense layer's
    (replicated over the expert axis) over the tensor axis."""
    if cfg.num_experts and ep is not None:
        return ep.all_reduce(y)
    return _reduce(y, tp)


def layer_step(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, attend, valid=None,
               tp=None, ep=None, ffn=_ffn) -> torch.Tensor:
    """One decoder layer: norm, qkv, RoPE, `attend(q, k, v)` -> [N, H,
    hd], output projection and the FFN (`ffn(cfg, lp, h, valid, ep)`:
    dense SwiGLU or routed experts over the `valid` rows), with
    residuals. Under `tp` the attention output is summed over the
    tensor axis, and the FFN's as _ffn_sum says, before their residual
    adds."""
    N = x.shape[0]
    h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = attend(q, k, v)
    x = x + _reduce(qeinsum("ne,ed->nd", attn.reshape(N, -1), lp["wo"]), tp)
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _ffn_sum(cfg, ffn(cfg, lp, h2, valid, ep), tp, ep)


def _layers(params, cfg, x, positions, k_cache, v_cache, write_slots, attend,
            valid=None, tp=None, ep=None):
    """The paged layer stack: each layer writes its K/V BEFORE attention
    (a token sees its own K/V), then attends through `attend(layer, q)`.
    `k_cache[layer]` is that layer's pool, a tensor or a QuantKV."""
    for layer, lp in enumerate(params["layers"]):
        def paged(q, k, v, layer=layer):
            kv_write(k_cache[layer], write_slots, k)
            kv_write(v_cache[layer], write_slots, v)
            return attend(layer, q)

        x = layer_step(cfg, lp, x, positions, paged, valid, tp, ep)
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
    tp=None,  # TensorGroup: this rank's slice of a tensor-parallel mesh
    ep=None,  # ExpertGroup: this rank's experts of an expert-parallel mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE forward over a ragged mixed batch of prefill spans and decode
    tokens sharing a flattened [T] stream. Each layer writes the
    stream's K/V into its pages, then every token attends causally over
    its own sequence's paged context. Returns (logits [B, V] or
    [B, O, V] in float32, k_cache, v_cache); padding rows' logits are
    garbage the caller ignores."""
    x = _embed(params, cfg, tokens, tp)  # [T, D]
    positions = tok_pos.clamp_min(0)

    def attend(layer, q):
        return ragged_attention_any(
            attn_impl, q, k_cache[layer], v_cache[layer], page_table,
            tok_seq, tok_pos, kv_len, q_start, q_len, page_size)

    x = _layers(params, cfg, x, positions, k_cache, v_cache, write_slots,
                attend, valid=tok_pos >= 0, tp=tp, ep=ep)
    return _logits(params, cfg, x[out_idx.long()], tp), k_cache, v_cache


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
    active=None,  # [B] int32/bool live decode slots (None = all live)
    tp=None,  # TensorGroup: this rank's slice of a tensor-parallel mesh
    ep=None,  # ExpertGroup: this rank's experts of an expert-parallel mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for the whole batch; returns (logits [B, V] in
    float32, k_cache, v_cache). `active` feeds MoE routing only: parked
    slots carry garbage tokens that must not claim expert capacity."""
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, tp)  # [B, D]
    pos = positions.long()
    rows = torch.arange(B, device=tokens.device)
    write_slots = (page_table[rows, pos // page_size].long() * page_size
                   + pos % page_size)
    seq_lens = (positions + 1).to(torch.int32)

    def attend(layer, q):
        return paged_decode_attention_any(
            attn_impl, q, k_cache[layer], v_cache[layer], page_table,
            seq_lens, page_size)

    valid = None if active is None else active > 0
    x = _layers(params, cfg, x, positions, k_cache, v_cache, write_slots,
                attend, valid, tp, ep)
    return _logits(params, cfg, x, tp), k_cache, v_cache


def last_valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> [B, D] at each row's last valid position (row 0's
    position 0 when a row is empty)."""
    T = x.shape[1]
    last = (lens.long() - 1).clamp(0, T - 1)
    return x[torch.arange(x.shape[0], device=x.device), last]


def prefill_layers(cfg: ModelConfig, layers, x, positions, k_cache, v_cache,
                   slots, attend, valid=None, tp=None, ep=None):
    """A stack of layers over a padded [B, T] batch flattened to [B*T, D]:
    each layer writes the batch's K/V at `slots` [B, T] (padding rows
    point at the trash page), then `attend(q, k, v, kcl, vcl)` with q, k,
    v as [B, T, heads, hd] and the layer's pools, returning [B, T, H,
    hd]. `layers` and the pools' layer dim are the same local slice (a
    pipeline stage's own layers). THE layer loop of forward_prefill,
    forward_prefill_chunk and the pipeline stages' prefills."""
    B, T = slots.shape
    flat = slots.reshape(-1)

    for i, lp in enumerate(layers):
        def paged(q, k, v, i=i):
            kv_write(k_cache[i], flat, k)
            kv_write(v_cache[i], flat, v)
            out = attend(q.reshape(B, T, *q.shape[1:]), k.reshape(B, T, *k.shape[1:]),
                         v.reshape(B, T, *v.shape[1:]), k_cache[i], v_cache[i])
            return out.reshape(B * T, *q.shape[1:])

        x = layer_step(cfg, lp, x, positions, paged, valid, tp, ep)
    return x


def forward_prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int32, right-padded
    seq_lens: torch.Tensor,  # [B] valid lengths
    k_cache,  # [L, S, Hk, hd] tensor or QuantKV, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]; padding rows: the trash page
    page_size: int,
    tp=None,  # TensorGroup: this rank's slice of a tensor-parallel mesh
    ep=None,  # ExpertGroup: this rank's experts of an expert-parallel mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fresh prompts padded to one bucket: every position's K/V goes to
    its page (padding positions past a row's pages land in the trash
    page), attention is dense causal over the batch's own K/V. Returns
    (last-valid-position logits [B, V] float32, k_cache, v_cache)."""
    B, T = tokens.shape
    x = _embed(params, cfg, tokens.reshape(-1), tp)  # [B*T, D]
    pos_b = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    slots = flat_slot_indices(page_table, pos_b, page_size)
    valid = (pos_b < seq_lens[:, None]).reshape(-1)

    def attend(q, k, v, kcl, vcl):
        return causal_attention(q, k, v, seq_lens)

    x = prefill_layers(cfg, params["layers"], x, pos_b.reshape(-1), k_cache,
                       v_cache, slots, attend, valid, tp, ep)
    x_last = last_valid(x.reshape(B, T, -1), seq_lens)
    return _logits(params, cfg, x_last, tp), k_cache, v_cache


def forward_prefill_chunk(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, C] one chunk of the prompt, right-padded
    start: torch.Tensor,  # [B] global position of the chunk's first token
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk
    k_cache,  # [L, S, Hk, hd] tensor or QuantKV, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]: covers prefix AND chunk
    page_size: int,
    tp=None,  # TensorGroup: this rank's slice of a tensor-parallel mesh
    ep=None,  # ExpertGroup: this rank's experts of an expert-parallel mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of a long prompt: writes the chunk's K/V into its pages
    and attends over the prefix already written plus the chunk itself
    (paged_chunk_attention_blockwise). Chaining chunks reproduces
    forward_prefill. Returns (last-valid-position logits [B, V] float32,
    k_cache, v_cache)."""
    B, C = tokens.shape
    x = _embed(params, cfg, tokens.reshape(-1), tp)
    pos_b = start[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=tokens.device)[None, :]
    slots = flat_slot_indices(page_table, pos_b, page_size)
    valid = (torch.arange(C, device=tokens.device)[None, :]
             < chunk_lens[:, None]).reshape(-1)

    def attend(q, k, v, kcl, vcl):
        return paged_chunk_attention_blockwise(q, kcl, vcl, page_table, start,
                                               chunk_lens, page_size)

    x = prefill_layers(cfg, params["layers"], x, pos_b.reshape(-1), k_cache,
                       v_cache, slots, attend, valid, tp, ep)
    x_last = last_valid(x.reshape(B, C, -1), chunk_lens)
    return _logits(params, cfg, x_last, tp), k_cache, v_cache


def forward_prefill_sp(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int32, right-padded; T divisible by sp
    seq_lens: torch.Tensor,  # [B] valid lengths
    k_cache,  # [L, S, Hk, hd] tensor, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]; rows cover every real token
    page_size: int,
    seq,  # SeqGroup: this rank's shard of the sequence-parallel ring
    tp=None,  # TensorGroup: this rank's slice of a tensor-parallel mesh
    ep=None,  # ExpertGroup: this rank's experts of an expert-parallel mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel prefill of long prompts: this shard runs the
    layers over its chunk of the sequence (positions seq.index * C ...,
    C = T / sp) with ring attention (parallel/ring_attention.py). Every
    K/V chunk that passes through the shard on the ring is written into
    its own pages, so each shard's pool ends as one whole prefill's
    (the pool is replicated over the seq axis); positions at or past
    seq_lens go to the trash page. The shard holding a row's last valid
    position hands that hidden row to the others (a sum over the seq
    axis with zeros elsewhere, exact), so every shard computes the same
    logits. An MoE layer routes the whole [B, T] stream, as the
    reference's FFN does over the seq-sharded activations: each shard
    hands its hidden rows to the others (a sum over the seq axis with
    zeros elsewhere, exact), every shard routes the same groups of the
    same stream (so capacity and drops do not depend on where the
    chunks are cut), and keeps the FFN output of its own rows. Returns
    (last-valid-position logits [B, V] float32, k_cache, v_cache)."""
    from ollamamq_tpu_torch.engine.kv_cache import TRASH_PAGE
    from ollamamq_tpu_torch.parallel.ring_attention import ring_attention

    t0 = time.perf_counter()
    B, T = tokens.shape
    sp = seq.size
    C = T // sp
    if C * sp != T:
        raise ValueError(f"padded length {T} is not divisible by sp={sp}")
    dev = tokens.device
    lo = seq.index * C
    seq_lens = seq_lens.to(dev)
    x = _embed(params, cfg, tokens[:, lo:lo + C].reshape(-1), tp)  # [B*C, D]
    pos_b = lo + torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
    valid = (pos_b < seq_lens[:, None]).reshape(-1)
    # Every chunk's slots: a position at or past seq_lens lands in the
    # trash page.
    pos_all = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    slots = flat_slot_indices(page_table, pos_all, page_size)
    slots = torch.where(pos_all < seq_lens[:, None], slots,
                        TRASH_PAGE * page_size + pos_all % page_size)
    chunk_slots = [slots[:, j * C:(j + 1) * C].reshape(-1) for j in range(sp)]
    valid_all = (pos_all < seq_lens[:, None]).reshape(-1)

    def stream_ffn(cfg, lp, h, valid, ep):
        if not cfg.num_experts:
            return _ffn(cfg, lp, h, valid, ep)
        full = h.new_zeros(B, T, h.shape[-1])
        full[:, lo:lo + C] = h.reshape(B, C, -1)
        y = _ffn(cfg, lp, seq.all_reduce(full).reshape(B * T, -1), valid_all,
                 ep)
        return y.reshape(B, T, -1)[:, lo:lo + C].reshape(B * C, -1)

    for layer, lp in enumerate(params["layers"]):
        def ring(q, k, v, layer=layer):
            def write(j, kj, vj):
                kv_write(k_cache[layer], chunk_slots[j], kj.flatten(0, 1))
                kv_write(v_cache[layer], chunk_slots[j], vj.flatten(0, 1))

            out = ring_attention(q.reshape(B, C, *q.shape[1:]),
                                 k.reshape(B, C, *k.shape[1:]),
                                 v.reshape(B, C, *v.shape[1:]), seq_lens, seq,
                                 on_chunk=write)
            return out.reshape(B * C, *q.shape[1:])

        x = layer_step(cfg, lp, x, pos_b.reshape(-1), ring, valid, tp, ep,
                       ffn=stream_ffn)
    last = (seq_lens.long() - 1).clamp(0, T - 1)  # [B] global positions
    mine = (last >= lo) & (last < lo + C)
    rows = x.reshape(B, C, -1)[torch.arange(B, device=dev),
                               (last - lo).clamp(0, C - 1)]
    x_last = seq.all_reduce(torch.where(mine[:, None], rows,
                                        torch.zeros_like(rows)))
    logits = _logits(params, cfg, x_last, tp)
    seq.stats["prefills"] += 1
    seq.stats["prefill_s"] += time.perf_counter() - t0
    return logits, k_cache, v_cache


def _pooled_embedding(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      seq_lens: torch.Tensor, attention,
                      tp=None, ep=None) -> torch.Tensor:
    """Stateless [B, T] forward with `attention(q, k, v, seq_lens)` over
    dense [B, T, H, hd] tensors (no KV write), then a masked mean pool of
    the final-norm states in float32 and L2 normalisation. Rows with
    seq_len 0 pool to zeros."""
    B, T = tokens.shape
    x = _embed(params, cfg, tokens.reshape(-1), tp)
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).repeat(B)
    valid = (positions.reshape(B, T)
             < seq_lens.to(tokens.device)[:, None]).reshape(-1)

    def attend(q, k, v):
        out = attention(q.reshape(B, T, *q.shape[1:]),
                        k.reshape(B, T, *k.shape[1:]),
                        v.reshape(B, T, *v.shape[1:]), seq_lens)
        return out.reshape(B * T, *q.shape[1:])

    for lp in params["layers"]:
        x = layer_step(cfg, lp, x, positions, attend, valid, tp, ep)
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps).float()
    x = x.reshape(B, T, -1)
    mask = valid.reshape(B, T).float()[..., None]
    pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


def forward_embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  seq_lens: torch.Tensor, tp=None, ep=None) -> torch.Tensor:
    """Embeddings from a GENERATIVE model: causal forward with no KV
    write, masked mean pool of the final-norm states, L2 norm (llama.cpp's
    default pooling for causal models). tokens [B, T], seq_lens [B] ->
    [B, D] float32."""
    return _pooled_embedding(params, cfg, tokens, seq_lens, causal_attention,
                             tp, ep)


def forward_encoder(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    seq_lens: torch.Tensor, tp=None) -> torch.Tensor:
    """Embedding encoder: bidirectional attention, masked mean pool, L2
    norm. tokens [B, T], seq_lens [B] -> [B, D] float32."""
    return _pooled_embedding(params, cfg, tokens, seq_lens,
                             bidirectional_attention, tp)
