"""Seeded weights, made on the device: every tensor alone from (seed,
name), so the reference can make any one of them again without the rest.

Each tensor draws from a torch.Generator on its device, seeded from a
digest of (seed, name), in one normal_() call straight into the type it
is served in: matmul weights N(0, 1/fan_in), norm weights N(1, 0.1^2)
(not all ones, so a norm whose weight went missing shows in the logits).
The layout is the port's: matmul weights [in, out], expert stacks
[E, in, out], embedding and head [vocab, d]. The same call on the same
device and torch gives the same numbers again.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch


def tensor_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"servebench/{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def layer_shapes(a: dict) -> Dict[str, Tuple[tuple, float, float]]:
    """One layer's tensors: name -> (shape, mean, std)."""
    D, F, hd = a["D"], a["F"], a["hd"]
    q, kv = a["H"] * hd, a["Hk"] * hd
    s = {"attn_norm": ((D,), 1.0, 0.1), "mlp_norm": ((D,), 1.0, 0.1),
         "wq": ((D, q), 0.0, D ** -0.5), "wk": ((D, kv), 0.0, D ** -0.5),
         "wv": ((D, kv), 0.0, D ** -0.5), "wo": ((q, D), 0.0, q ** -0.5)}
    if a["E"]:
        E = a["E"]
        s.update(w_router=((D, E), 0.0, D ** -0.5),
                 we_gate=((E, D, F), 0.0, D ** -0.5),
                 we_up=((E, D, F), 0.0, D ** -0.5),
                 we_down=((E, F, D), 0.0, F ** -0.5))
    else:
        s.update(w_gate=((D, F), 0.0, D ** -0.5), w_up=((D, F), 0.0, D ** -0.5),
                 w_down=((F, D), 0.0, F ** -0.5))
    if a["qk_norm"]:
        s.update(q_norm=((hd,), 1.0, 0.1), k_norm=((hd,), 1.0, 0.1))
    return s


def top_shapes(a: dict) -> Dict[str, Tuple[tuple, float, float]]:
    s = {"embed": ((a["V"], a["D"]), 0.0, a["D"] ** -0.5),
         "final_norm": ((a["D"],), 1.0, 0.1)}
    if not a["tied"]:
        s["lm_head"] = ((a["V"], a["D"]), 0.0, a["D"] ** -0.5)
    return s


def make(seed: int, name: str, spec: Tuple[tuple, float, float], dtype,
         device) -> torch.Tensor:
    shape, mean, std = spec
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        mean, std, generator=gen)


def layer(a: dict, seed: int, i: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {k: make(seed, f"layers.{i}.{k}", spec, dtype, device)
            for k, spec in layer_shapes(a).items()}


def params(a: dict, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """The whole tree in the port's params layout."""
    out = {k: make(seed, k, spec, dtype, device) for k, spec in top_shapes(a).items()}
    out["layers"] = [layer(a, seed, i, dtype, device) for i in range(a["L"])]
    return out


def nbytes(a: dict, elem_bytes: int = 2) -> int:
    """Bytes of the whole tree at `elem_bytes` per element."""
    n = sum(math.prod(s[0]) for s in top_shapes(a).values())
    n += a["L"] * sum(math.prod(s[0]) for s in layer_shapes(a).values())
    return n * elem_bytes


def served_layers(a: dict, seed: int, dtype, device) -> Iterator[Dict[str, torch.Tensor]]:
    """The layers one at a time, as served (dtype), for the reference."""
    for i in range(a["L"]):
        yield layer(a, seed, i, dtype, device)
