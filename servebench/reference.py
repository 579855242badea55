"""The plain reference: the published decoder in float32 PyTorch, with no
kernel, cache or batching of the program's (it imports torch alone).

Llama-family layers as the Mixtral and Qwen3 model cards describe them:
RMSNorm, q/k/v projections (Qwen3: an RMSNorm over each head of q and k
before RoPE), rotate-half RoPE with theta^(-2i/hd) frequencies, causal
softmax attention with grouped KV heads, the output projection, then a
SwiGLU FFN: dense, or (Mixtral) a float32 softmax router whose top-k
experts' outputs are summed with their renormalised probabilities. Every
token is routed to its experts: the published model has no capacity
limit. Final RMSNorm, then logits over the head.

The weights are the served ones (their values in the served type), made
again layer by layer from the seed and widened to float32, so the whole
model never has to sit beside the program's copy. Matmuls run with TF32
off. `quant` ("int8" or "fp8", e4m3) rounds every matmul weight to that
type first, scaled per output channel (the embedding and head per
vocabulary row): the control of an MoE configuration's comparison.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, heads, hd] at positions pos [n]."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int8_round(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel symmetric int8 rounding along `axis` (the reduced one),
    back in float32."""
    scale = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(w / scale).clamp(-127, 127) * scale


def fp8_round(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-channel scaled float8 (e4m3) rounding along `axis`: the
    channel's largest magnitude maps to e4m3's 448, back in float32."""
    scale = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUND = {"int8": int8_round, "fp8": fp8_round}


def attention(a: dict, q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal attention of one sequence: q [n, H, hd], k, v [n, Hk, hd]."""
    n, H, hd = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for s in range(0, n, block):
        e = min(n, s + block)
        scores = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * scale
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v[:e])
    return out


def moe(a: dict, W: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(h @ W["w_router"], dim=-1)
    gate, top = torch.topk(probs, a["K"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(a["E"]):
        tok, slot = torch.nonzero(top == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        out = (torch.nn.functional.silu(x @ W["we_gate"][e]) * (x @ W["we_up"][e])
               ) @ W["we_down"][e]
        y.index_add_(0, tok, out * gate[tok, slot][:, None])
    return y


def layer_forward(a: dict, W: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    hd = a["hd"]
    pos = torch.arange(n, device=x.device)
    h = rmsnorm(x, W["attn_norm"], a["eps"])
    q = (h @ W["wq"]).view(n, -1, hd)
    k = (h @ W["wk"]).view(n, -1, hd)
    v = (h @ W["wv"]).view(n, -1, hd)
    if a["qk_norm"]:
        q = rmsnorm(q, W["q_norm"], a["eps"])
        k = rmsnorm(k, W["k_norm"], a["eps"])
    q, k = rope(q, pos, a["theta"]), rope(k, pos, a["theta"])
    x = x + attention(a, q, k, v).reshape(n, -1) @ W["wo"]
    h = rmsnorm(x, W["mlp_norm"], a["eps"])
    if a["E"]:
        return x + moe(a, W, h)
    return x + (torch.nn.functional.silu(h @ W["w_gate"]) * (h @ W["w_up"])) @ W["w_down"]


def _widen(W: Dict[str, torch.Tensor], quant) -> Dict[str, torch.Tensor]:
    out = {}
    for k, t in W.items():
        t = t.float()
        if quant is not None and t.dim() >= 2:
            t = ROUND[quant](t, axis=t.dim() - 2)  # [.., in, out]: per out column
        out[k] = t
    return out


def logits(a: dict, make_top: Callable[[str], torch.Tensor], layers,
           sequences: Sequence[Sequence[int]], wanted: Sequence[Sequence[int]],
           quant=None) -> List[torch.Tensor]:
    """Float32 logits [len(wanted[i]), V] of each sequence at its wanted
    positions. `make_top(name)` gives embed / final_norm / lm_head as
    served; `layers` yields each layer's dict as served, in order; the
    whole batch of sequences passes one layer before the next is made."""
    with NoTF32():
        embed = make_top("embed")
        xs = []
        for seq in sequences:
            rows = embed[torch.as_tensor(list(seq), device=embed.device)].float()
            xs.append(ROUND[quant](rows, axis=1) if quant else rows)
        del embed
        for W in layers:
            W = _widen(W, quant)
            xs = [layer_forward(a, W, x) for x in xs]
            del W
        norm = make_top("final_norm").float()
        head = make_top("embed" if a["tied"] else "lm_head").float()
        if quant:
            head = ROUND[quant](head, axis=1)
        out = []
        for x, pos in zip(xs, wanted):
            idx = torch.as_tensor(list(pos), device=x.device)
            out.append(rmsnorm(x[idx], norm, a["eps"]) @ head.t())
        return out


class NoTF32:
    """Float32 matmuls in float32 (TF32 off) inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        cuda_tf32, cudnn_tf32, precision = self.saved
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(precision)
