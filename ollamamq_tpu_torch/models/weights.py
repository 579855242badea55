"""Model weights: seeded random initialisation, int8 quantization, the
quantization guardrail, and the bridge from the JAX package's parameter
layout.

The JAX params pytree stacks every layer on axis 0 ([L, D, H*hd] for
wq, ...); this package keeps one dict per layer with the same [in, out]
orientation. Checkpoint loading is not part of this package yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.ops.attention import causal_attention
from ollamamq_tpu_torch.ops.quant import QuantTensor, embed_lookup, quantize_tensor

# Layer matmul weights quantize per output channel (their LAST axis);
# embed / lm_head per vocab ROW (axis 0: the logits' output channel and
# the embedding's gathered row, so a tied embedding needs one vector).
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_ROW_KEYS = ("embed", "lm_head")


def init_random(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Seeded random weights, drawn on `device` from a torch.Generator
    (the numbers differ from jax.random's for the same seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return llama.init_params(cfg, gen, dtype=dtype, device=device)


def quantize_params_int8(params: dict) -> dict:
    """Per-channel symmetric int8 quantization of a params dict (f32
    scales; norms, biases and q/k norms stay as they are). Each quantized
    leaf becomes a QuantTensor with the weight's shape, which qeinsum,
    embed_lookup and logits_head take unchanged. Returns a new dict; the
    input is not modified."""
    out = dict(params)
    out["layers"] = [
        {k: quantize_tensor(v, axis=-1) if k in QUANT_LAYER_KEYS else v
         for k, v in lp.items()}
        for lp in params["layers"]]
    for k in QUANT_ROW_KEYS:
        if k in out:
            out[k] = quantize_tensor(out[k], axis=0)
    return out


def _full_logits(params: dict, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Last-position logits [V] (f32) of a full causal forward with no KV
    pool: the teacher-forced probe the guardrail runs on both trees."""
    device = params["final_norm"].device
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=device)
    T = toks.shape[0]
    positions = torch.arange(T, dtype=torch.int32, device=device)
    seq_lens = torch.tensor([T], dtype=torch.int32, device=device)
    x = embed_lookup(params["embed"], toks, llama._adtype(params))  # [T, D]

    def attend(q, k, v):
        return causal_attention(q[None], k[None], v[None], seq_lens)[0]

    for lp in params["layers"]:
        x = llama.layer_step(cfg, lp, x, positions, attend)
    return llama._logits(params, cfg, x[-1:])[0]


@torch.no_grad()
def quant_guardrail(cfg: ModelConfig, base_params: Optional[dict] = None,
                    q_params: Optional[dict] = None, seed: int = 0,
                    dtype=torch.bfloat16, prompt_len: int = 16,
                    steps: int = 16, device="cpu") -> dict:
    """Greedy token-match rate and max logit error of the int8 tree
    against its source tree, teacher-forced on the source model's own
    greedy rollout (one early mismatch cannot cascade). `rel_logit_err`
    is the max error over the last step's logit spread. Returns the dict
    (this package has no metrics plane to publish it on yet)."""
    if base_params is None:
        base_params = init_random(cfg, seed=seed, dtype=dtype, device=device)
    if q_params is None:
        q_params = quantize_params_int8(base_params)
    rng = np.random.default_rng(seed)
    ctx = rng.integers(3, cfg.vocab_size, size=max(1, prompt_len)).tolist()
    matches, max_err = 0, 0.0
    for _ in range(steps):
        lb = _full_logits(base_params, cfg, ctx).cpu().numpy()
        lq = _full_logits(q_params, cfg, ctx).cpu().numpy()
        max_err = max(max_err, float(np.max(np.abs(lb - lq))))
        tb, tq = int(np.argmax(lb)), int(np.argmax(lq))
        matches += int(tb == tq)
        ctx = ctx + [tb]  # teacher-forced: both follow the source stream
    return {
        "steps": steps,
        "token_match_rate": round(matches / max(1, steps), 4),
        "max_logit_err": round(max_err, 6),
        "rel_logit_err": round(max_err / max(1e-9, float(np.std(lb))), 6),
    }


def _is_quant_leaf(a) -> bool:
    """A quantized leaf of the JAX tree exported to numpy: any object with
    numpy `q` and `s` (the JAX QuantTensor is matched by shape, not by
    type, so this package never imports it)."""
    return (isinstance(getattr(a, "q", None), np.ndarray)
            and isinstance(getattr(a, "s", None), np.ndarray))


def from_jax_numpy(params_np: dict, cfg: ModelConfig, dtype=None,
                   device="cpu") -> dict:
    """JAX params (as numpy arrays: layers stacked on axis 0, wq as
    [D, H*hd], embed / lm_head as [V, D]) -> this package's params.
    `dtype` None keeps each array's own dtype; it never applies to int8
    payloads and f32 scales. Quantized leaves ((q, s) pairs with layer
    scales [L, e]) become per-layer QuantTensors with scales [e]."""

    def tensor(a, cast=True):
        t = torch.from_numpy(np.array(a))  # a private, writable copy
        return t.to(device=device, dtype=(dtype if cast and dtype else t.dtype))

    def conv(a, i=None):
        if _is_quant_leaf(a):
            q, s = (a.q, a.s) if i is None else (a.q[i], a.s[i])
            return QuantTensor(tensor(q, cast=False), tensor(s, cast=False))
        if not isinstance(a, np.ndarray):
            raise TypeError(f"expected a numpy array or a (q, s) leaf, got "
                            f"{type(a).__name__}")
        return tensor(a if i is None else a[i])

    stacked = params_np["layers"]
    n = {name: (a.q if _is_quant_leaf(a) else a).shape[0]
         for name, a in stacked.items()}
    if set(n.values()) != {cfg.num_layers}:
        raise ValueError(f"layer stacks {n} do not match {cfg.num_layers} layers")
    out = {
        "embed": conv(params_np["embed"]),
        "final_norm": conv(params_np["final_norm"]),
        "layers": [{name: conv(a, i) for name, a in stacked.items()}
                   for i in range(cfg.num_layers)],
    }
    if "lm_head" in params_np:
        out["lm_head"] = conv(params_np["lm_head"])
    return out


def to_jax_numpy(params: dict) -> dict:
    """Inverse of from_jax_numpy: float32 numpy arrays (bf16 widens
    exactly), layers stacked on axis 0; a QuantTensor becomes a
    QuantTensor of numpy (q int8, s f32) with layer scales stacked to
    [L, e], the JAX tree's (q, s) pairs."""

    def conv(t):
        if isinstance(t, QuantTensor):
            return QuantTensor(conv(t.q), conv(t.s))
        t = t.detach().to("cpu")
        return t.numpy() if t.dtype == torch.int8 else t.to(torch.float32).numpy()

    def stack(vals):
        if isinstance(vals[0], QuantTensor):
            return QuantTensor(np.stack([v.q for v in vals]),
                               np.stack([v.s for v in vals]))
        return np.stack(vals)

    layers = params["layers"]
    out = {
        "embed": conv(params["embed"]),
        "final_norm": conv(params["final_norm"]),
        "layers": {name: stack([conv(lp[name]) for lp in layers])
                   for name in layers[0]},
    }
    if "lm_head" in params:
        out["lm_head"] = conv(params["lm_head"])
    return out
