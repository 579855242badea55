#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package (ollamamq_tpu) into an
HF-layout safetensors directory that the PyTorch port (ollamamq_tpu_torch)
serves:

    python scripts/orbax_to_safetensors.py --model llama3.2:1b SRC DST
    python -m ollamamq_tpu_torch.cli --model llama3.2:1b \\
        --checkpoints llama3.2:1b=DST

SRC is a directory written by `ollamamq_tpu.models.weights.save_orbax`. It
is read with that package's `load_orbax`, on the host's CPU (no
accelerator is needed), and checked against the model's tree as the JAX
package draws it (`llama.init_params`, shapes only). The tree then goes
through the port's `from_jax_numpy` and `save_safetensors`, so the HF
tensor names are the ones the port loads with. Every tensor keeps its
dtype: bfloat16 crosses bit for bit, never through float32. A
tokenizer.json in SRC is copied beside the weights.

Refused, each with what to do instead: a SRC that is no orbax directory
(or already a safetensors one), a tree with int8 (q, s) leaves, a tree
whose layer count or leaves are not the model's, a model name neither
package knows, and a DST that already holds a checkpoint.

This is the one file outside tests/ that imports both packages. It prints
one JSON line: the model, the directories, the tensor count, the bytes
and the dtypes written.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)  # both packages, from this checkout
# Files save_orbax writes at the top of a checkpoint directory.
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA")


class Refused(Exception):
    """A conversion this script will not make; the message says why and
    what to do."""


def _check_dirs(src: str, dst: str) -> None:
    if not os.path.isdir(src):
        raise Refused(f"{src} is not a directory: pass the orbax checkpoint "
                      "directory save_orbax wrote")
    entries = os.listdir(src)
    if any(e.endswith(".safetensors") for e in entries):
        raise Refused(f"{src} is already an HF safetensors checkpoint: serve it "
                      "as it is (--checkpoints NAME=SRC)")
    if not any(m in entries for m in ORBAX_MARKERS):
        raise Refused(f"{src} is not an orbax checkpoint (no "
                      f"{' or '.join(ORBAX_MARKERS)}): pass the directory "
                      "save_orbax wrote")
    if os.path.abspath(src) == os.path.abspath(dst):
        raise Refused("DST must be another directory than SRC")
    if os.path.isdir(dst) and any(e.endswith(".safetensors")
                                  for e in os.listdir(dst)):
        raise Refused(f"{dst} already holds a .safetensors checkpoint: pick an "
                      "empty or new directory")


def _check_tree(tree: dict, jcfg, name: str) -> None:
    """Refuse what the port's checkpoint cannot carry or what is not the
    model's tree, before anything is written."""
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.models import llama as jllama

    if not (isinstance(tree, dict) and {"embed", "final_norm", "layers"} <= set(tree)
            and isinstance(tree["layers"], dict)):
        raise Refused("the checkpoint is not a model params tree (embed, "
                      "final_norm, layers): pass a tree save_orbax wrote from "
                      "load_params or init_params")
    leaves = {**{k: v for k, v in tree.items() if k != "layers"},
              **{f"layers.{k}": v for k, v in tree["layers"].items()}}
    quantized = sorted(k for k, v in leaves.items()
                       if isinstance(v, dict) or getattr(v, "dtype", None) == "int8")
    if quantized:
        raise Refused(f"the tree holds int8 (q, s) leaves ({', '.join(quantized)}): "
                      "convert the checkpoint saved before quantize_params_int8, "
                      "then serve it with --weights-dtype int8")
    layers = sorted({v.shape[0] for v in tree["layers"].values()})
    if layers != [jcfg.num_layers]:
        raise Refused(f"the checkpoint holds {'/'.join(map(str, layers))} layers, "
                      f"model {name} has {jcfg.num_layers}: pass the --model the "
                      "checkpoint was saved for")
    want = jax.eval_shape(lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                                     dtype=jnp.float32))
    want = {**{k: v.shape for k, v in want.items() if k != "layers"},
            **{f"layers.{k}": v.shape for k, v in want["layers"].items()}}
    got = {k: tuple(v.shape) for k, v in leaves.items()}
    diff = sorted(f"{k}: {got.get(k)} (model {want.get(k)})"
                  for k in set(want) | set(got) if got.get(k) != want.get(k))
    if diff:
        raise Refused(f"the checkpoint is not a {name} tree ({'; '.join(diff[:6])}): "
                      "pass the --model the checkpoint was saved for")


def convert(name: str, src: str, dst: str) -> dict:
    """SRC (orbax) -> DST (HF safetensors) for model `name`; returns the
    summary printed."""
    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.models.weights import (from_jax_numpy, leaves,
                                                   save_safetensors)

    cfg = get_model_config(name)
    if cfg is None:
        raise Refused(f"unknown model {name!r}: pass a name of the port's "
                      "MODEL_CONFIGS")
    _check_dirs(src, dst)
    import jax

    jax.config.update("jax_platforms", "cpu")  # reading needs no accelerator
    import numpy as np

    from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
    from ollamamq_tpu.models.weights import load_orbax

    if cfg.name not in JAX_CONFIGS:
        raise Refused(f"model {cfg.name} is not one of the JAX package's: its "
                      "orbax checkpoints hold other trees")
    try:
        tree = load_orbax(src)
    except Exception as e:  # noqa: BLE001 — reported with the path
        raise Refused(f"{src} could not be read as an orbax checkpoint "
                      f"({type(e).__name__}: {e})") from None
    _check_tree(tree, JAX_CONFIGS[cfg.name], cfg.name)
    params = from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg)
    del tree
    path = save_safetensors(params, cfg, dst)
    tok = os.path.join(src, "tokenizer.json")
    if os.path.isfile(tok):
        shutil.copyfile(tok, os.path.join(dst, "tokenizer.json"))
    written = list(leaves(params))
    return {"model": cfg.name, "src": os.path.abspath(src), "dst": os.path.abspath(dst),
            "file": os.path.basename(path), "tensors": len(written),
            "bytes": sum(t.numel() * t.element_size() for t in written),
            "dtypes": sorted({str(t.dtype).replace("torch.", "") for t in written}),
            "tokenizer": os.path.isfile(tok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True,
                    help="the model the checkpoint was saved for (e.g. llama3.2:1b)")
    ap.add_argument("src", help="orbax checkpoint directory (save_orbax)")
    ap.add_argument("dst", help="HF safetensors directory to write")
    args = ap.parse_args(argv)
    try:
        summary = convert(args.model, args.src, args.dst)
    except Refused as e:
        print(f"orbax_to_safetensors: {e}", file=sys.stderr)
        return 2
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
