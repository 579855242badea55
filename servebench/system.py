"""The system under test, ollamamq_tpu_torch, as one process serves it:
the HTTP server over TorchEngine with its paged KV pool, the fair-share
core and the scheduler, the model and the CUDA kernels.

The configuration file's model is registered with the port under the
configuration's name (as a model the port does not list itself), its
weights are made on the device from the seed (servebench/weights.py) and
handed to TorchEngine, and the runtime gets the harness's tokenizer
(servebench/tokenizer.py). The port is imported here, inside functions,
and nowhere else in the harness.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from servebench import loadgen, weights
from servebench.tokenizer import ServeTokenizer


def model_config(name: str, conf: dict, a: dict):
    from ollamamq_tpu_torch.config import ModelConfig

    extra = {}
    if a["E"]:
        extra = dict(num_experts=a["E"], num_experts_per_tok=a["K"],
                     moe_capacity_factor=float(conf["program"]["moe_capacity_factor"]))
    return ModelConfig(
        name=name, vocab_size=a["V"], hidden_size=a["D"],
        intermediate_size=a["F"], num_layers=a["L"], num_heads=a["H"],
        num_kv_heads=a["Hk"], head_dim=a["hd"], rope_theta=a["theta"],
        rms_norm_eps=a["eps"], max_seq_len=a["max_pos"],
        tie_embeddings=a["tied"], qk_norm=a["qk_norm"], **extra)


class System:
    """One served model behind the port's HTTP server on port 0.

    `precision` "int8" serves the port's own int8 path: the seeded bf16
    weights quantized by the port (--weights-dtype int8) over an int8 KV
    pool (--kv-dtype int8); "int8w" the same weights over the bf16 pool.
    Both are controls of a dense configuration's comparison; the
    benchmark's runs never set them."""

    def __init__(self, name: str, conf: dict, a: dict, seed: int, device,
                 precision: str = "bfloat16"):
        from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
        from ollamamq_tpu_torch.engine.engine import TorchEngine
        from ollamamq_tpu_torch.server.app import serve_in_thread

        self.name, self.conf, self.arch = name, conf, a
        self._registry = MODEL_CONFIGS
        self._had = MODEL_CONFIGS.get(name)
        MODEL_CONFIGS[name] = model_config(name, conf, a)
        params = weights.params(a, seed, torch.bfloat16, device)
        wdt = "int8" if precision in ("int8", "int8w") else precision
        kvdt = "int8" if precision == "int8" else "bfloat16"
        if wdt == "int8":
            from ollamamq_tpu_torch.models.weights import quantize_params_int8

            params = quantize_params_int8(params)
        ecfg = EngineConfig(model=name, dtype="bfloat16",
                            weights_dtype=wdt, kv_dtype=kvdt,
                            seed=seed % (2 ** 31), **conf["engine"])
        self.engine = TorchEngine(ecfg, device=device, params=params)
        del params
        self.rt = self.engine.runtimes[name]
        self.rt.tokenizer = ServeTokenizer(a["V"])
        self.server = serve_in_thread(self.engine, port=0, timeout_s=600)
        self.port = self.server.server_address[1]
        self.ecfg = ecfg

    def send(self, requests, sampling: dict, t0: float, t_close: float) -> dict:
        """Requests through the load generator's code, in this process
        (set-up and warm-up only; the window's load runs in a child)."""
        return loadgen.run({"port": self.port, "model": self.name,
                            "t0": t0, "t_close": t_close, "sampling": sampling,
                            "requests": requests, "timeout_s": 600})

    def warm_up(self, streams, sampling: dict, budget_s: float = 300.0) -> dict:
        """Every shape the cell's traffic makes: one short request alone
        per rung of the ragged token ladder up to the token budget, then a
        full batch of slots whose prompts span the traffic's lengths,
        decoding two full decode dispatches."""
        ecfg = self.ecfg
        lo = min(s["prompt_tokens"]["min"] for s in streams)
        hi = max(s["prompt_tokens"]["max"] for s in streams)
        rungs, n = [], ecfg.token_granule
        while n <= ecfg.max_batch_tokens:
            rungs.append(n)
            n *= 2
        t = time.monotonic()
        ladder = [{"i": i, "due": 0.0, "user": "warm", "text": "w" * max(1, r - 40),
                   "max_tokens": 2} for i, r in enumerate(rungs)]
        done = []
        for r in ladder:
            done.append(self.send([r], sampling, time.monotonic(),
                                  time.monotonic() + budget_s))
        slots = ecfg.max_slots
        full = [{"i": i, "due": 0.0, "user": f"warm{i % 8}",
                 "text": "w" * max(1, lo + (hi - lo) * i // max(1, slots - 1) - 40),
                 "max_tokens": 2 * ecfg.decode_steps_per_iter}
                for i in range(slots)]
        done.append(self.send(full, sampling, time.monotonic(),
                              time.monotonic() + budget_s))
        errors = [r["error"] for d in done for r in d["results"] if r["error"]]
        unfinished = sum(not r["done"] for d in done for r in d["results"])
        if errors or unfinished:
            raise RuntimeError(f"warm-up failed: {unfinished} unfinished, "
                               f"errors {errors[:3]}")
        return {"requests": len(ladder) + len(full),
                "seconds": time.monotonic() - t}

    def close(self) -> None:
        """Stop the server and the engine and give the device memory back.

        Every request still queued or running is cancelled first: a
        handler thread whose request never started waits on its stream
        (up to the server's timeout) and keeps the engine alive through
        the server it references. The runtime's tensors are dropped
        after the stop, so nothing that outlives the engine holds them."""
        from ollamamq_tpu_torch.server.app import stop_server

        eng = self.engine
        with eng._pending_lock:
            queued = list(eng.pending)
        for rid in queued + [q.req_id for q in self.rt.held_requests()]:
            eng.cancel(rid)
        deadline = time.monotonic() + 10.0
        while self.rt.active_count() and time.monotonic() < deadline:
            time.sleep(0.05)
        stop_server(self.server)
        eng._model_params.clear()  # kept by the engine to rebuild a runtime
        for attr in ("params", "kc", "vc", "recent"):
            setattr(self.rt, attr, None)
        self.server = self.engine = self.rt = None
        if self._had is None:
            self._registry.pop(self.name, None)
        else:
            self._registry[self.name] = self._had
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def device_name(device) -> Optional[str]:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
