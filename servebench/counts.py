"""The yardstick's arithmetic: the chip's peaks, the model FLOPs of a
served token, and the operations and bytes of one attention call,
counted from the work the call's inputs describe (not from how a kernel
does it), so a later kernel that replaces one is held to the same count.

Model FLOPs follow the standard decoder estimate that
ollamamq_tpu_torch/telemetry/mfu.py uses (PaLM appendix B): 2 x the
active parameters of a layer per token (a Mixtral token pays its k
routed experts and the router, not all of them), plus 4 x layers x
context x q_dim for the scores and the weighted values. Two departures
from that file, both about what the model needs rather than what it
holds: the embedding is a row lookup (no FLOPs), and the head's
2 x vocab x d is paid only by the tokens whose logits are read (the last
prompt position and every decoded token).

Stdlib only.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

# (lowercase substring of torch.cuda.get_device_name(), dense bf16
# FLOP/s, HBM bytes/s): NVIDIA's data sheet of the card the cells run on,
# the H100 SXM, dense rates without sparsity.
PEAKS = (
    ("h100 80gb hbm3", 989e12, 3.35e12),
)


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of one card of this name, or None when the
    table does not know it (a reader then reports nothing)."""
    name = (device_name or "").lower()
    for sub, flops, bw in PEAKS:
        if sub in name:
            return flops, bw
    return None


def layer_active_params(a: dict) -> int:
    """Parameters one token meets in one decoder layer: attention
    projections, its k experts and the router (MoE) or the dense FFN,
    and the two norms."""
    d, f = a["D"], a["F"]
    q_dim, kv_dim = a["H"] * a["hd"], a["Hk"] * a["hd"]
    mlp = 3 * d * f
    if a["E"]:
        mlp = a["K"] * 3 * d * f + d * a["E"]
    return d * q_dim + 2 * d * kv_dim + q_dim * d + mlp + 2 * d


def token_flops(a: dict, context: int, logits: bool) -> float:
    """FLOPs of one token through the model at a KV context of `context`
    positions (itself included), with the head when its logits are read."""
    f = 2.0 * a["L"] * layer_active_params(a)
    f += 4.0 * a["L"] * context * a["H"] * a["hd"]
    if logits:
        f += 2.0 * a["V"] * a["D"]
    return f


def prefill_flops(a: dict, prompt: int) -> float:
    """A prompt of `prompt` tokens, each attending to itself and what
    precedes it, with the last position's logits."""
    layers = 2.0 * a["L"] * layer_active_params(a) * prompt
    attn = 4.0 * a["L"] * a["H"] * a["hd"] * prompt * (prompt + 1) / 2.0
    return layers + attn + 2.0 * a["V"] * a["D"]


def ragged_call(a: dict, spans: Iterable[Tuple[int, int]], page_size: int,
                elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's ragged paged-attention call over
    `spans`, (q_len, kv_len) per sequence with q_len > 0: a span's rows
    are the last q_len positions of a kv_len context, each attending
    causally. Every input byte is read once and every output written
    once: q and the output rows, each sequence's K and V up to kv_len,
    its page-table entries and its three int32 span fields."""
    H, Hk, hd = a["H"], a["Hk"], a["hd"]
    flops = 0.0
    nbytes = 0.0
    for n, k in spans:
        if n <= 0:
            continue
        ctx = n * k - n * (n - 1) / 2.0  # sum of the rows' contexts
        flops += 4.0 * H * hd * ctx
        nbytes += 2.0 * n * H * hd * elem_bytes  # q in, out
        nbytes += 2.0 * k * Hk * hd * elem_bytes  # K, V
        nbytes += 4.0 * (-(-k // page_size)) + 12.0
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bw: float) -> float:
    """The least time the chip needs: the larger of the compute and the
    memory bound."""
    return max(flops / peak_flops, nbytes / peak_bw)
