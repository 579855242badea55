"""Partition rules for model params and the KV pool: rank r's slice.

The JAX package's Megatron-style layout (its PartitionSpecs) as plain
functions. A spec is the dim cut over the tensor axis, or None for a
replicated leaf; shard_params cuts rank r's slice out of a host (or
device) tree. This package's layer dicts carry no stacked layer axis, so
dims are named from the right:

  - wq/wk/wv, bq/bk/bv  [D, heads*hd]  -> column-parallel: output (head)
                                          dim
  - wo                  [heads*hd, D]  -> row-parallel: input (head) dim;
                                          the forward sums the partial
                                          outputs (all_reduce)
  - w_gate/w_up [D, F], w_down [F, D]  -> F
  - we_gate/we_up [E, D, F], we_down [E, F, D] -> each expert's F
  - embed, lm_head      [V, D]         -> vocab rows
  - norms, q/k norms, the MoE router   -> replicated
  - KV pool [L, S, kv_heads, hd] and its int8 scale rows [L, S, kv_heads]
                                       -> kv_heads

Under expert parallelism the expert stacks are also cut on E over the
expert axis (EXPERT, expert_spec): expert index i of ep holds experts
[i E/ep, (i + 1) E/ep), each with its tensor rank's F slice, as the JAX
package's PS(None, "expert", None, "tensor") / PS(None, "expert",
"tensor", None) lay them out. Every other leaf, the router and the KV
pool included, is replicated over the expert axis.

Under pipeline parallelism the list of layers, and the KV pool's layer
dim, are cut over the pipe axis as well: stage s of P holds layers
[s L/P, (s + 1) L/P) (stage_layers). As in the JAX package, the
embedding, the final norm and the head are not cut over pipe: every
stage holds them (stage 0 embeds, every stage computes the logits from
the last stage's hidden states).

A QuantTensor's scales follow the channel they scale: cut with
column-parallel payloads and with vocab rows, replicated for the
row-parallel wo / w_down (their output channel is not cut). Weights are
quantized BEFORE they are cut, so every rank holds the scales of the
whole tensor's channels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ollamamq_tpu_torch.ops.quant import QuantTensor
from ollamamq_tpu_torch.parallel.mesh import shard_range

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv",
          "we_gate", "we_up")
ROW = ("wo", "w_down", "we_down")
VOCAB = ("embed", "lm_head")
# Cut on their expert dim (axis 0 of one layer's [E, ...] stack) over the
# expert axis.
EXPERT = ("we_gate", "we_up", "we_down")


def spec_for(name: str, leaf):
    """The dim of `leaf` cut over the tensor axis (None = replicated); a
    QuantTensor gets a QuantTensor of its payload's and scales' specs."""
    if isinstance(leaf, QuantTensor):
        q = spec_for(name, leaf.q)
        if name in COLUMN:
            return QuantTensor(q, -1)
        if name in VOCAB:
            return QuantTensor(q, 0)  # per-row scales follow the rows
        return QuantTensor(q, None)
    if name in COLUMN:
        return -1
    if name in ROW:
        return -2
    if name in VOCAB:
        return 0
    return None  # norms, the router: replicated


def expert_spec(name: str):
    """The dim of a layer leaf cut over the expert axis (None =
    replicated over it)."""
    return 0 if name in EXPERT else None


def param_partition_specs(params: dict) -> dict:
    """The spec of every leaf of a params dict, in its structure."""
    out = {k: spec_for(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: spec_for(k, v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def shard_tensor(t: torch.Tensor, dim: Optional[int], tp: int,
                 rank: int) -> torch.Tensor:
    """Rank `rank`'s slice of t along `dim` (a private copy, so the whole
    tensor can be freed), or t itself when replicated."""
    if dim is None or tp == 1:
        return t
    lo, hi = shard_range(t.shape[dim], tp, rank)
    return t.narrow(dim, lo, hi - lo).clone()


def shard_leaf(name: str, leaf, tp: int, rank: int, ep: int = 1,
               expert_index: int = 0):
    """Rank (expert_index, rank)'s slice of one leaf: its experts, then
    its tensor slice of them."""
    if ep > 1 and expert_spec(name) is not None:
        lo, hi = shard_range(leaf.shape[0], ep, expert_index)
        leaf = leaf[lo:hi]
        if tp == 1:
            return leaf.clone()
    spec = spec_for(name, leaf)
    if isinstance(leaf, QuantTensor):
        return QuantTensor(shard_tensor(leaf.q, spec.q, tp, rank),
                           shard_tensor(leaf.s, spec.s, tp, rank))
    return shard_tensor(leaf, spec, tp, rank)


def shard_layer(lp: dict, tp: int, rank: int, ep: int = 1,
                expert_index: int = 0) -> dict:
    return {k: shard_leaf(k, v, tp, rank, ep, expert_index)
            for k, v in lp.items()}


def shard_params(params: dict, tp: int, rank: int, ep: int = 1,
                 expert_index: int = 0) -> dict:
    """Rank (expert_index, rank)'s params of an ep x tp mesh. Head and
    FFN dims must divide by tp (validate_tp_for_model) and expert counts
    by ep; the vocabulary is cut in ceil(V / tp) rows per rank."""
    if tp == 1 and ep == 1:
        return params
    out = {k: shard_leaf(k, v, tp, rank) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [shard_layer(lp, tp, rank, ep, expert_index)
                     for lp in params["layers"]]
    return out


def kv_cache_spec() -> int:
    """KV slot pool [L, S, kv_heads, hd]: kv_heads on the tensor axis."""
    return 2


def kv_scale_spec() -> int:
    """Quantized-pool scale rows [L, S, kv_heads]: the payload's layout
    minus head_dim, so each rank owns its own heads' scales."""
    return 2


# Params keys whose leaves are cut over the pipe axis (the per-layer
# dicts); every other leaf is held whole by every stage.
PIPE_CUT = ("layers",)


def stage_layers(num_layers: int, pp: int, stage: int) -> Tuple[int, int]:
    """[lo, hi) of the layers pipeline stage `stage` of `pp` holds (pp
    must divide num_layers, as the runtime checks)."""
    per = num_layers // pp
    return stage * per, (stage + 1) * per


def pipeline_param_specs(params: dict) -> dict:
    """The PP(xTP) layout of a params dict: each leaf's tensor-axis spec
    (param_partition_specs) and, under "pipe", the keys whose leaves are
    cut over the pipe axis on their layer index."""
    specs = param_partition_specs(params)
    specs["pipe"] = PIPE_CUT
    return specs


def kv_pipe_spec() -> int:
    """KV slot pool [L, S, kv_heads, hd] under pipeline parallelism: the
    layer dim on the pipe axis (kv_heads stays on tensor)."""
    return 0
