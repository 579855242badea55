"""Model weights: seeded random initialisation, HF-layout safetensors
checkpoints, int8 quantization, the quantization guardrail, and the
bridge from the JAX package's parameter layout.

The JAX params pytree stacks every layer on axis 0 ([L, D, H*hd] for
wq, ...); this package keeps one dict per layer with the same [in, out]
orientation.

Checkpoints are HF-layout safetensors directories (Llama/Qwen2/Qwen3
tensor names, and Mixtral's block_sparse_moe router and experts), read
and written with the standard library and numpy:
the format is an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} and the raw bytes. An orbax
checkpoint (the JAX package's own format) needs JAX to read it:
scripts/orbax_to_safetensors.py converts one into such a directory.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.ops.attention import causal_attention
from ollamamq_tpu_torch.ops.quant import QuantTensor, embed_lookup, quantize_tensor
from ollamamq_tpu_torch.telemetry import schema as tm

# Layer matmul weights quantize per output channel (their LAST axis);
# embed / lm_head per vocab ROW (axis 0: the logits' output channel and
# the embedding's gathered row, so a tied embedding needs one vector).
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_ROW_KEYS = ("embed", "lm_head")


# HF tensor name -> (our layer key, transpose?) for one layer.
_HF_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "block_sparse_moe.gate.weight": ("w_router", True),
}
# Mixtral's per-expert HF names (experts.{e}.w1 / w3 / w2: gate / up /
# down, each [out, in]) -> our stacked [E, in, out] layer keys.
_HF_EXPERT_MAP = {"w1": "we_gate", "w3": "we_up", "w2": "we_down"}

# safetensors dtype -> (numpy storage dtype, torch dtype). bf16 is read as
# its uint16 bit pattern and viewed as bf16 in torch.
_ST_DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "I64": (np.int64, torch.int64),
}
_ST_NAMES = {t: name for name, (_, t) in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file as a CPU tensor in its stored
    dtype, backed by a copy-on-write memory map of the file (nothing is
    read until used)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}; "
                             f"supported: {sorted(_ST_DTYPES)}")
        np_dtype, t_dtype = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        arr = data[lo:hi].view(np_dtype).reshape(meta["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(t_dtype) if t_dtype == torch.bfloat16 else t
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as one .safetensors file (names sorted, header
    padded with spaces to 8 bytes, as the safetensors package writes)."""
    header, offset, order = {}, 0, sorted(tensors)
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no "
                             "safetensors encoding here")
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nb]}
        offset += nb
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.numpy()).cast("B"))


def leaves(params: dict):
    """Every weight of a params dict (QuantTensors whole)."""
    yield from (v for k, v in params.items() if k != "layers")
    for lp in params["layers"]:
        yield from lp.values()


def _safetensors_files(path: str):
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(".safetensors"))


def load_safetensors(cfg: ModelConfig, path: str, dtype=torch.bfloat16,
                     device="cpu", layers: Optional[tuple] = None,
                     experts: Optional[tuple] = None) -> dict:
    """Load an HF-layout safetensors checkpoint (every *.safetensors file
    of the directory, in sorted order) into this package's params dict,
    cast to `dtype` on `device`. HF projections are [out, in]; ours are
    [in, out]. Tied-embedding configs get no lm_head. A Mixtral-layout
    checkpoint loads into an MoE config: each layer's experts stack to
    [E, in, out] in `dtype` as they are read, and their raw tensors are
    dropped at once (the expert stacks are ~90% of an 8x7b). `layers`
    (lo, hi) reads only those layers (a pipeline stage's), and `experts`
    (e0, e1) only those experts of each MoE layer (an expert-parallel
    rank's): the memory map leaves the others unread."""
    files = _safetensors_files(path)
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    raw: Dict[str, torch.Tensor] = {}
    for f in files:
        raw.update(read_safetensors(f))
    if not cfg.num_experts and any(".block_sparse_moe." in k for k in raw):
        raise ValueError(f"{path} is a mixture-of-experts (Mixtral layout) "
                         f"checkpoint; model {cfg.name} is dense")

    def grab(name: str, transpose: bool = False) -> torch.Tensor:
        t = raw[name].to(device=device).to(dtype)
        return t.t().contiguous() if transpose else t

    layer_names = [k for k in raw if re.match(r"model\.layers\.\d+\.", k)]
    n_layers = 1 + max((int(k.split(".")[2]) for k in layer_names), default=-1)
    if n_layers != cfg.num_layers:
        raise ValueError(f"checkpoint has {n_layers} layers, config {cfg.num_layers}")
    present = [(hf, ours, tr) for hf, (ours, tr) in _HF_LAYER_MAP.items()
               if f"model.layers.0.{hf}" in raw]
    lo, hi = layers if layers is not None else (0, cfg.num_layers)
    layers = [{ours: grab(f"model.layers.{i}.{hf}", tr)
               for hf, ours, tr in present} for i in range(lo, hi)]
    if cfg.num_experts:
        e0, e1 = experts if experts is not None else (0, cfg.num_experts)
        for i, lp in enumerate(layers, start=lo):
            p = f"model.layers.{i}.block_sparse_moe."
            for hf, ours in _HF_EXPERT_MAP.items():
                names = [f"{p}experts.{e}.{hf}.weight" for e in range(e0, e1)]
                out_dim, in_dim = raw[names[0]].shape
                stack = torch.empty((e1 - e0, in_dim, out_dim),
                                    dtype=dtype, device=device)
                for e, n in enumerate(names):
                    stack[e] = raw.pop(n).to(device=device).to(dtype).t()
                lp[ours] = stack
    params = {
        "embed": grab("model.embed_tokens.weight"),
        "final_norm": grab("model.norm.weight"),
        "layers": layers,
    }
    if "lm_head.weight" in raw and not cfg.tie_embeddings:
        params["lm_head"] = grab("lm_head.weight")
    return params


def save_safetensors(params: dict, cfg: ModelConfig, path: str) -> str:
    """Write a params dict as an HF-layout checkpoint directory (one
    model.safetensors, tensors in their own dtype) that load_safetensors,
    the safetensors package and the JAX package's loader all read. Returns
    the file's path. int8 trees are refused: save the source weights."""
    if any(isinstance(t, QuantTensor) for t in leaves(params)):
        raise ValueError("save_safetensors writes unquantized weights; "
                         "save the tree before quantize_params_int8")
    inverse = {ours: (hf, tr) for hf, (ours, tr) in _HF_LAYER_MAP.items()}
    experts = {ours: hf for hf, ours in _HF_EXPERT_MAP.items()}
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"]
    for i, lp in enumerate(params["layers"]):
        for ours, t in lp.items():
            if ours in experts:
                for e in range(t.shape[0]):
                    out[f"model.layers.{i}.block_sparse_moe.experts.{e}."
                        f"{experts[ours]}.weight"] = t[e].t()
                continue
            hf, tr = inverse[ours]
            out[f"model.layers.{i}.{hf}"] = t.t() if tr else t
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"params hold {len(params['layers'])} layers, "
                         f"config {cfg.num_layers}")
    os.makedirs(path, exist_ok=True)
    f = os.path.join(path, "model.safetensors")
    write_safetensors(out, f)
    return f


def load_params(cfg: ModelConfig, checkpoint_path: Optional[str] = None,
                seed: int = 0, dtype=torch.bfloat16,
                weights_dtype: str = "bfloat16", device="cpu",
                tp: int = 1, rank: int = 0, pp: int = 1,
                stage: int = 0, ep: int = 1, expert_index: int = 0) -> dict:
    """Resolve weights: an HF safetensors directory or seeded random init,
    then int8 quantization when `weights_dtype` is "int8". A directory
    with no .safetensors file (an orbax checkpoint) is refused.

    With tp > 1 the result is rank `rank`'s slice of a tp-way tensor-
    parallel mesh (parallel/sharding.py), taken after the KV heads are
    replicated (tp > kv heads) and after int8 quantization of the whole
    tensors, so every rank's slice equals the same slice of the one-rank
    tree. The seeded tree is drawn, prepared and cut one layer at a time
    on `device` (the whole tree never sits on it); a checkpoint is read
    whole on the host, cut there, and only the slice moves.

    With pp > 1 the result holds only pipeline stage `stage`'s layers
    (parallel/sharding.py stage_layers) beside the whole embedding,
    final norm and head: the seed draws every layer in order on every
    stage and keeps its own (so they are bit-identical to the same
    layers of a one-stage tree), a checkpoint is read for those layers
    only.

    With ep > 1 each MoE layer holds only expert index `expert_index`'s
    experts (parallel/sharding.py), then its tensor slice of them; every
    other leaf is as at ep 1. The seed draws each layer whole, in the
    one-rank order (one randn per expert stack), and the rank keeps its
    experts and frees the rest before the next layer is drawn; a
    checkpoint is read for the rank's experts only."""
    int8 = weights_dtype == "int8"
    if int8 and cfg.num_experts:
        raise ValueError("int8 weight quantization does not cover MoE expert "
                         "stacks; load the model with --weights-dtype=bfloat16")
    ep = ep if cfg.num_experts else 1  # a dense model: replicated over it
    experts = None
    if ep > 1:
        from ollamamq_tpu_torch.parallel.mesh import shard_range

        experts = shard_range(cfg.num_experts, ep, expert_index)
    cut = tp > 1 or ep > 1
    span = None
    if pp > 1:
        from ollamamq_tpu_torch.parallel.sharding import stage_layers

        span = stage_layers(cfg.num_layers, pp, stage)
        if not cut:
            layer = quantize_layer_int8 if int8 else (lambda lp: lp)
            top = ((lambda name, t: quantize_tensor(t, axis=0)
                    if name in QUANT_ROW_KEYS else t) if int8 else None)
    if cut:
        from ollamamq_tpu_torch.parallel.sharding import shard_layer, shard_leaf

        r = tp // cfg.num_kv_heads if tp > cfg.num_kv_heads else 1

        def layer(lp: dict, ep: int = ep) -> dict:
            if r > 1:
                lp = replicate_kv_layer(lp, cfg, r)
            if int8:
                lp = quantize_layer_int8(lp)
            return shard_layer(lp, tp, rank, ep, expert_index)

        def top(name: str, t):
            if int8 and name in QUANT_ROW_KEYS:
                t = quantize_tensor(t, axis=0)
            return shard_leaf(name, t, tp, rank)
    elif pp == 1:
        layer = top = None
    if checkpoint_path:
        if not _safetensors_files(checkpoint_path):
            raise ValueError(
                f"{checkpoint_path} holds no .safetensors file; an orbax "
                "checkpoint needs the JAX package (ollamamq_tpu) to read it: "
                "convert it to HF safetensors first with "
                f"`python scripts/orbax_to_safetensors.py --model {cfg.name} "
                f"{checkpoint_path} DST` (where both packages are installed) "
                "and serve DST")
        if not cut:
            params = load_safetensors(cfg, checkpoint_path, dtype=dtype,
                                      device=device, layers=span)
            return quantize_params_int8(params) if int8 else params
        params = load_safetensors(cfg, checkpoint_path, dtype=dtype,
                                  layers=span, experts=experts)
        # The rank's experts only were read: cut the rest as at ep 1.
        params["layers"] = [layer(lp, 1) for lp in params["layers"]]
        params.update({k: top(k, v) for k, v in params.items()
                       if k != "layers"})
        return _to_device(params, device)
    if not cut and pp == 1:
        params = init_random(cfg, seed=seed, dtype=dtype, device=device)
        return quantize_params_int8(params) if int8 else params
    drawn = iter(range(cfg.num_layers))

    def stage_layer(lp):  # this stage's layers, prepared; the rest dropped
        return layer(lp) if span[0] <= next(drawn) < span[1] else None

    return init_random(cfg, seed=seed, dtype=dtype, device=device,
                       prepare_layer=layer if span is None else stage_layer,
                       prepare_top=top)


def _to_device(params: dict, device) -> dict:
    def move(t):
        if isinstance(t, QuantTensor):
            return QuantTensor(t.q.to(device), t.s.to(device))
        return t.to(device)

    out = {k: move(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: move(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def clone_to(params: dict, device) -> dict:
    """A copy of a params tree on `device` in storage of its own (a
    tensor already there is copied too): one data-parallel replica's
    weights from the tree loaded once."""
    def copy(t):
        if isinstance(t, QuantTensor):
            return QuantTensor(copy(t.q), copy(t.s))
        return t.to(device, copy=True)

    out = {k: copy(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: copy(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def replicate_kv_layer(lp: dict, cfg: ModelConfig, r: int) -> dict:
    """One layer of replicate_kv_heads."""
    Hk, hd = cfg.num_kv_heads, cfg.head_dim

    def rep_w(w):  # [d, Hk*hd] -> [d, r*Hk*hd]
        if isinstance(w, QuantTensor):
            # Per-channel scales live on the duplicated axis: replicate
            # payload and scales in lockstep, numerics exactly preserved.
            return QuantTensor(rep_w(w.q), rep_b(w.s))
        d = w.shape[0]
        return w.reshape(d, Hk, hd).repeat_interleave(r, dim=1).reshape(
            d, r * Hk * hd)

    def rep_b(b):  # [Hk*hd] -> [r*Hk*hd]
        return b.reshape(Hk, hd).repeat_interleave(r, dim=0).reshape(-1)

    out = dict(lp)
    out["wk"], out["wv"] = rep_w(lp["wk"]), rep_w(lp["wv"])
    if "bk" in lp:
        out["bk"], out["bv"] = rep_b(lp["bk"]), rep_b(lp["bv"])
    return out


def replicate_kv_heads(params: dict, cfg: ModelConfig, r: int) -> dict:
    """Duplicate each KV head r times (consecutively) so num_kv_heads grows
    to r * cfg.num_kv_heads — the replicated-group sharding for
    tp > num_kv_heads: every tensor-parallel shard then owns exactly one
    (duplicated) KV head. Numerics are exactly preserved: q head i maps to
    kv' head i // (H/Hk') and kv'[j] == kv[j // r], which composes to the
    original i // (H/Hk) assignment. Costs r x KV-cache memory."""
    out = dict(params)
    out["layers"] = [replicate_kv_layer(lp, cfg, r) for lp in params["layers"]]
    return out


def stage_slice(params: dict, cfg: ModelConfig, pp: int, stage: int) -> dict:
    """Pipeline stage `stage`'s part of a whole params tree: its layers
    and the embedding, final norm and head (held by every stage)."""
    if pp == 1:
        return params
    from ollamamq_tpu_torch.parallel.sharding import stage_layers

    lo, hi = stage_layers(cfg.num_layers, pp, stage)
    return dict(params, layers=params["layers"][lo:hi])


def tp_slice(params: dict, cfg: ModelConfig, tp: int, rank: int,
             ep: int = 1, expert_index: int = 0) -> dict:
    """Rank (expert_index, rank)'s slice of a whole params tree
    (quantized or not, as given): KV heads replicated when tp > kv
    heads, then cut (a dense model is replicated over the expert
    axis)."""
    ep = ep if cfg.num_experts else 1
    if tp == 1 and ep == 1:
        return params
    from ollamamq_tpu_torch.parallel.sharding import shard_params

    if tp > cfg.num_kv_heads:
        params = replicate_kv_heads(params, cfg, tp // cfg.num_kv_heads)
    return shard_params(params, tp, rank, ep, expert_index)


def init_random(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu", prepare_layer=None, prepare_top=None) -> dict:
    """Seeded random weights, drawn on `device` from a torch.Generator
    (the numbers differ from jax.random's for the same seed).
    `prepare_layer(layer)` / `prepare_top(name, tensor)` transform each
    layer dict and the embed / lm_head as they are drawn. On the meta
    device nothing is drawn: the tree's shapes and dtypes only."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return llama.init_params(cfg, gen, dtype=dtype, device=device,
                             prepare_layer=prepare_layer,
                             prepare_top=prepare_top)


def quantize_layer_int8(lp: dict) -> dict:
    """One layer of quantize_params_int8."""
    return {k: quantize_tensor(v, axis=-1) if k in QUANT_LAYER_KEYS else v
            for k, v in lp.items()}


def quantize_params_int8(params: dict) -> dict:
    """Per-channel symmetric int8 quantization of a params dict (f32
    scales; norms, biases and q/k norms stay as they are). Each quantized
    leaf becomes a QuantTensor with the weight's shape, which qeinsum,
    embed_lookup and logits_head take unchanged. Returns a new dict; the
    input is not modified. MoE expert stacks are refused."""
    if any("we_gate" in lp for lp in params["layers"]):
        raise ValueError("int8 weight quantization does not cover MoE expert "
                         "stacks; load the model with --weights-dtype=bfloat16")
    out = dict(params)
    out["layers"] = [quantize_layer_int8(lp) for lp in params["layers"]]
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
    is the max error over the last step's logit spread. Publishes
    `ollamamq_quant_logit_err{model}` and returns the dict."""
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
    out = {
        "steps": steps,
        "token_match_rate": round(matches / max(1, steps), 4),
        "max_logit_err": round(max_err, 6),
        "rel_logit_err": round(max_err / max(1e-9, float(np.std(lb))), 6),
    }
    tm.QUANT_LOGIT_ERR.labels(model=cfg.name).set(out["max_logit_err"])
    return out


def _is_quant_leaf(a) -> bool:
    """A quantized leaf of the JAX tree exported to numpy: any object with
    numpy `q` and `s` (the JAX QuantTensor is matched by shape, not by
    type, so this package never imports it)."""
    return (isinstance(getattr(a, "q", None), np.ndarray)
            and isinstance(getattr(a, "s", None), np.ndarray))


def from_jax_numpy(params_np: dict, cfg: ModelConfig, dtype=None,
                   device="cpu", layers: Optional[tuple] = None) -> dict:
    """JAX params (as numpy arrays: layers stacked on axis 0, wq as
    [D, H*hd], embed / lm_head as [V, D]) -> this package's params.
    `dtype` None keeps each array's own dtype (bfloat16 arrays, numpy's
    ml_dtypes kind, cross bit for bit); it never applies to int8
    payloads and f32 scales. Quantized leaves ((q, s) pairs with layer
    scales [L, e]) become per-layer QuantTensors with scales [e].
    `layers` (lo, hi) converts only those layers (a pipeline stage's
    slice of the stack)."""

    def tensor(a, cast=True):
        a = np.array(a)  # a private, writable copy
        if a.dtype.name == "bfloat16":  # torch takes no numpy bf16: its bits
            t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
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
                   for i in range(*(layers or (0, cfg.num_layers)))],
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
