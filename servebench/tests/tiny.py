"""Tiny cells for the CPU tests: the harness's real code over a
two-layer model, a four-slot engine and a few seconds of traffic."""

from __future__ import annotations

import types

from servebench import spec

SAMPLING = {"temperature": 0, "repeat_penalty": 1.0}


def conf(moe: bool) -> dict:
    c = {"name": "mixtral-tiny" if moe else "qwen3-tiny",
         "model_type": "mixtral" if moe else "qwen3",
         "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
         "max_position_embeddings": 2048, "tie_word_embeddings": False,
         "program": {"moe_capacity_factor": 2.0},
         "engine": {"max_slots": 4, "num_pages": 64, "page_size": 16,
                    "max_pages_per_seq": 16, "max_batch_tokens": 64,
                    "token_granule": 16, "decode_steps_per_iter": 4,
                    "max_new_tokens": 64, "prefix_cache": False, "spec": False},
         "chat": ({"bos": True, "prefix": "[INST] ", "suffix": " [/INST]"} if moe
                  else {"bos": False, "prefix": "<|im_start|>user\n",
                        "suffix": "<|im_end|>\n<|im_start|>assistant\n"})}
    if moe:
        c.update(num_local_experts=4, num_experts_per_tok=2)
    return c


def traffic(rate: float = 2.0) -> dict:
    return {"sampling": SAMPLING,
            "streams": [{"class": "light", "users": 3, "user_prefix": "u",
                         "rate_rps": rate, "arrival": "poisson",
                         "prompt_tokens": {"median": 90, "sigma": 0.3, "min": 60,
                                           "max": 120},
                         "output_tokens": {"median": 8, "sigma": 0.5, "min": 4,
                                           "max": 16}}]}


LIMITS = {"sample": {"served_tokens": 40, "max_total": 2000},
          "compare": {"gap_msq": 0.05}}


def cell(moe: bool, rate: float = 2.0) -> types.SimpleNamespace:
    """A cell that reports every metric of BENCHMARK.json."""
    c = conf(moe)
    bench = spec.benchmark()
    return types.SimpleNamespace(
        name="tiny", config_name=c["name"], conf=c, arch=spec.arch(c),
        traffic=traffic(rate), chips=1, end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"], here=spec.HERE, limits=LIMITS)
