"""Model weights: seeded random initialisation, HF-layout safetensors
checkpoints, int8 quantization, the quantization guardrail, and the
bridge from the JAX package's parameter layout.

The JAX params pytree stacks every layer on axis 0 ([L, D, H*hd] for
wq, ...); this package keeps one dict per layer with the same [in, out]
orientation.

Checkpoints are HF-layout safetensors directories (Llama/Qwen2/Qwen3
tensor names), read and written with the standard library and numpy:
the format is an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} and the raw bytes. An orbax
checkpoint (the JAX package's own format) needs JAX to read it.
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
}

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
                     device="cpu") -> dict:
    """Load an HF-layout safetensors checkpoint (every *.safetensors file
    of the directory, in sorted order) into this package's params dict,
    cast to `dtype` on `device`. HF projections are [out, in]; ours are
    [in, out]. Tied-embedding configs get no lm_head."""
    files = _safetensors_files(path)
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    raw: Dict[str, torch.Tensor] = {}
    for f in files:
        raw.update(read_safetensors(f))
    if any(".block_sparse_moe." in k for k in raw):
        raise ValueError(f"{path} is a mixture-of-experts (Mixtral layout) "
                         "checkpoint; this package serves dense models only")

    def grab(name: str, transpose: bool = False) -> torch.Tensor:
        t = raw[name].to(device=device).to(dtype)
        return t.t().contiguous() if transpose else t

    layer_names = [k for k in raw if re.match(r"model\.layers\.\d+\.", k)]
    n_layers = 1 + max((int(k.split(".")[2]) for k in layer_names), default=-1)
    if n_layers != cfg.num_layers:
        raise ValueError(f"checkpoint has {n_layers} layers, config {cfg.num_layers}")
    present = [(hf, ours, tr) for hf, (ours, tr) in _HF_LAYER_MAP.items()
               if f"model.layers.0.{hf}" in raw]
    params = {
        "embed": grab("model.embed_tokens.weight"),
        "final_norm": grab("model.norm.weight"),
        "layers": [{ours: grab(f"model.layers.{i}.{hf}", tr)
                    for hf, ours, tr in present}
                   for i in range(cfg.num_layers)],
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
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"]
    for i, lp in enumerate(params["layers"]):
        for ours, t in lp.items():
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
                weights_dtype: str = "bfloat16", device="cpu") -> dict:
    """Resolve weights: an HF safetensors directory or seeded random init,
    then int8 quantization when `weights_dtype` is "int8". A directory
    with no .safetensors file (an orbax checkpoint) is refused."""
    if checkpoint_path:
        if not _safetensors_files(checkpoint_path):
            raise ValueError(
                f"{checkpoint_path} holds no .safetensors file; an orbax "
                "checkpoint needs the JAX package (ollamamq_tpu) to read it: "
                "convert it to HF safetensors first")
        params = load_safetensors(cfg, checkpoint_path, dtype=dtype, device=device)
    else:
        params = init_random(cfg, seed=seed, dtype=dtype, device=device)
    if weights_dtype == "int8":
        params = quantize_params_int8(params)
    return params


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
