"""Model weights: seeded random initialisation and the bridge from the
JAX package's parameter layout.

The JAX params pytree stacks every layer on axis 0 ([L, D, H*hd] for
wq, ...); this package keeps one dict per layer with the same [in, out]
orientation. Checkpoint loading is not part of this package yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.models import llama


def init_random(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Seeded random weights, drawn on `device` from a torch.Generator
    (the numbers differ from jax.random's for the same seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return llama.init_params(cfg, gen, dtype=dtype, device=device)


def from_jax_numpy(params_np: dict, cfg: ModelConfig, dtype=None,
                   device="cpu") -> dict:
    """JAX params (as numpy arrays: layers stacked on axis 0, wq as
    [D, H*hd], embed / lm_head as [V, D]) -> this package's params.
    `dtype` None keeps each array's own dtype."""

    def conv(a):
        if not isinstance(a, np.ndarray):
            raise TypeError(f"expected a numpy array, got {type(a).__name__}"
                            " (int8 weights are not supported yet)")
        t = torch.from_numpy(np.array(a))  # a private, writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    stacked = params_np["layers"]
    n = {name: a.shape[0] for name, a in stacked.items()}
    if set(n.values()) != {cfg.num_layers}:
        raise ValueError(f"layer stacks {n} do not match {cfg.num_layers} layers")
    out = {
        "embed": conv(params_np["embed"]),
        "final_norm": conv(params_np["final_norm"]),
        "layers": [{name: conv(a[i]) for name, a in stacked.items()}
                   for i in range(cfg.num_layers)],
    }
    if "lm_head" in params_np:
        out["lm_head"] = conv(params_np["lm_head"])
    return out


def to_jax_numpy(params: dict) -> dict:
    """Inverse of from_jax_numpy: float32 numpy arrays, layers stacked on
    axis 0 (bf16 widens exactly to float32)."""

    def conv(t):
        return t.detach().to("cpu", torch.float32).numpy()

    layers = params["layers"]
    out = {
        "embed": conv(params["embed"]),
        "final_norm": conv(params["final_norm"]),
        "layers": {name: np.stack([conv(lp[name]) for lp in layers])
                   for name in layers[0]},
    }
    if "lm_head" in params:
        out["lm_head"] = conv(params["lm_head"])
    return out
