"""Mixture-of-experts FFN (Mixtral family) on one device.

Routing is token-choice top-k (Mixtral semantics: softmax over every
expert in float32, keep the top k, renormalise the kept probabilities).
Dispatch and combine use the GShard dense formulation, as the JAX
package does (ollamamq_tpu/models/moe.py): one-hot (token, k-slot) ->
(expert, capacity-slot) tensors contracted with einsum, tokens routed in
groups of at most 512, and a STATIC capacity per expert and group. A
token routed past its expert's capacity gets no FFN delta from that
expert (its combine weight is zero) and falls through to the residual.

Capacity drops are part of the result, so the forwards route the same
padded stream the JAX forwards route: the [T] ragged stream with its
ladder padding, all max_slots decode rows, the [B*T] embed batch. Only
`valid` rows claim capacity.

One layer's experts are stacked on axis 0: we_gate / we_up [E, D, F],
we_down [E, F, D]; the router w_router is [D, E].

Under tensor parallelism each rank holds every expert's F / tp slice and
the whole router: routing (and so every capacity drop) is identical on
every rank, each rank's combine yields a partial sum over its F slice,
and the caller's all_reduce after the FFN (llama.layer_step) adds them.

Under expert parallelism a rank holds experts [e0, e1) of E (and their
F / tp slice) and still the whole router, and its hidden states are
replicated over the expert axis: it routes every token over all E
experts, so every capacity slot and every drop equals the one-rank
layer's, then only its own experts' columns of dispatch / combine meet
its stacks. Its output is the partial sum over its experts (and F
slice); the caller (llama.layer_step) sums the partials over the
(expert, tensor) plane in one all_reduce. The tokens are on every rank
already, so no all-to-all moves them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ollamamq_tpu_torch.config import ModelConfig


def init_moe_layer_params(cfg: ModelConfig, generator: torch.Generator,
                          dtype=torch.bfloat16, device="cpu") -> dict:
    """Router and stacked expert weights of ONE layer, N(0, 1/fan_in)
    drawn in float32 from `generator` (on `device`): the FFN entries of
    a layer dict when cfg.num_experts > 0."""
    d, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.div_(math.sqrt(fan_in)).to(dtype)

    return {"w_router": w((d, E), d), "we_gate": w((E, d, f), d),
            "we_up": w((E, d, f), d), "we_down": w((E, f, d), f)}


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert token capacity for a group of n_tokens."""
    ideal = n_tokens * cfg.num_experts_per_tok / cfg.num_experts
    return max(1, int(math.ceil(ideal * cfg.moe_capacity_factor)))


def group_size(n_tokens: int, cap: int = 512) -> int:
    """Tokens per routing group: the largest divisor of n_tokens <= cap
    (GShard's group dimension keeps capacity, and with it the dispatch
    one-hots, linear in the token count)."""
    g = min(cap, n_tokens)
    while n_tokens % g:
        g -= 1
    return max(g, 1)


def route(cfg: ModelConfig, lp: dict, x: torch.Tensor, valid=None):
    """Route grouped hiddens x [g, G, D] with capacity C =
    expert_capacity(G). Returns (gate_vals [g, G, K] float32, expert_idx
    [g, G, K], slot [g, G, K, E], C): slot is each (token, k-slot)'s
    position in its expert's per-group queue, token-major ("first C
    win"), or C where the entry was dropped, is not the routed expert,
    or the token is not `valid` (invalid tokens claim no capacity)."""
    n_g, G, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = expert_capacity(G, cfg)
    # The router in float32: the softmax feeds multiplicative gates.
    logits = torch.einsum("gnd,de->gne", x.float(), lp["w_router"].float())
    probs = torch.softmax(logits, dim=-1)
    # Descending, the lower expert index first on a tie (jax.lax.top_k's
    # order; torch.topk promises none).
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = srt[..., :K], idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    sel = F.one_hot(expert_idx, E)  # [g, G, K, E]
    if valid is not None:
        sel = sel * valid.reshape(n_g, G).to(sel.dtype)[..., None, None]
    pos = torch.cumsum(sel.reshape(n_g, G * K, E), dim=1).reshape(sel.shape) - sel
    keep = (pos < C) & (sel > 0)
    return gate_vals, expert_idx, torch.where(keep, pos, C), C


def moe_mlp(cfg: ModelConfig, lp: dict, h: torch.Tensor,
            valid=None, experts=None) -> torch.Tensor:
    """Top-k routed expert FFN over hiddens [..., D]; returns the same
    shape (the residual add is the caller's). All leading dims form one
    stream of N tokens, routed in groups of group_size(N). `valid`
    (bool, h's leading shape) marks real tokens: padding rows and parked
    decode slots must not claim expert capacity, or identical garbage
    rows crowd real tokens out of their experts' queues. `experts`
    (e0, e1): lp's stacks hold only those experts (an expert-parallel
    rank's shard); the result is then their partial sum, which the
    caller adds up over the expert axis."""
    D = h.shape[-1]
    N = h.numel() // D
    G = group_size(N)
    x = h.reshape(N // G, G, D)
    gate_vals, _, slot, C = route(cfg, lp, x, valid)
    if experts is not None:
        slot = slot[..., experts[0]:experts[1]]  # this rank's experts' queues
    # One-hot (token, k-slot) -> (expert, capacity-slot) in h's dtype;
    # slot C (dropped / unrouted) matches no column.
    pos_oh = (slot[..., None] == torch.arange(C, device=h.device)).to(h.dtype)
    dispatch = pos_oh.sum(dim=2)  # [g, G, E, C], 0/1: k-slots are disjoint
    combine = torch.einsum("gnkec,gnk->gnec", pos_oh, gate_vals.to(h.dtype))
    xe = torch.einsum("gnec,gnd->gecd", dispatch, x)
    gate = torch.einsum("gecd,edf->gecf", xe, lp["we_gate"])
    up = torch.einsum("gecd,edf->gecf", xe, lp["we_up"])
    out_e = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, lp["we_down"])
    y = torch.einsum("gnec,gecd->gnd", combine, out_e)  # the gates apply here
    return y.reshape(h.shape)
