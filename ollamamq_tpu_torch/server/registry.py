"""Model registry: the models an engine can serve, in process.

"Available" = a registered architecture (with an optional checkpoint
directory on disk), "loaded" = weights resident on the device inside an
engine runtime. /api/pull loads a model onto the device, /api/delete
evicts it. The payloads are the JAX package's (server/registry.py), so
Ollama and OpenAI clients read the same shapes from both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional

from ollamamq_tpu_torch.config import ModelConfig, get_model_config, smart_match


@dataclasses.dataclass
class RegistryEntry:
    name: str
    config: ModelConfig
    checkpoint_path: Optional[str] = None
    registered_at: float = dataclasses.field(default_factory=time.time)
    loaded_at: Optional[float] = None


class ModelRegistry:
    """Thread-safe registry shared by the server, engine, and TUI."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._entries: Dict[str, RegistryEntry] = {}
        for name in engine.loaded_models():
            cfg = get_model_config(name)
            if cfg:
                self._entries[name] = RegistryEntry(name, cfg, loaded_at=time.time())

    # -- queries ------------------------------------------------------------
    def available(self) -> List[RegistryEntry]:
        with self._lock:
            return list(self._entries.values())

    def loaded(self) -> List[RegistryEntry]:
        live = set(self.engine.loaded_models())
        with self._lock:
            return [e for e in self._entries.values() if e.name in live]

    def resolve(self, name: str) -> Optional[RegistryEntry]:
        with self._lock:
            key = smart_match(name, self._entries.keys())
            return self._entries.get(key) if key else None

    def is_loaded(self, name: str) -> bool:
        key = smart_match(name, self.engine.loaded_models())
        return key is not None

    # -- mutations ------------------------------------------------------------
    def register(self, name: str, checkpoint_path: Optional[str] = None) -> RegistryEntry:
        cfg = get_model_config(name)
        if cfg is None:
            raise KeyError(f"unknown model architecture: {name}")
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                entry = RegistryEntry(name, cfg, checkpoint_path)
                self._entries[name] = entry
            elif checkpoint_path:
                entry.checkpoint_path = checkpoint_path
        return entry

    def pull(self, name: str) -> RegistryEntry:
        """Load a model's weights onto the device (the /api/pull analogue)."""
        entry = self.resolve(name) or self.register(name)
        self.engine.load_model(entry.name, entry.checkpoint_path)
        entry.loaded_at = time.time()
        return entry

    def delete(self, name: str) -> bool:
        """Evict from the device and deregister (the /api/delete analogue).
        RuntimeError (the model has work in flight) propagates."""
        entry = self.resolve(name)
        if entry is None:
            return False
        try:
            self.engine.evict_model(entry.name)
        except KeyError:
            pass
        with self._lock:
            self._entries.pop(entry.name, None)
        return True

    def copy(self, source: str, destination: str) -> bool:
        """Alias a registered model under a new name (/api/copy analogue)."""
        entry = self.resolve(source)
        if entry is None:
            return False
        with self._lock:
            self._entries[destination] = RegistryEntry(
                destination, entry.config, entry.checkpoint_path
            )
        return True

    # -- wire formats ---------------------------------------------------------
    def tags_payload(self) -> dict:
        """Ollama GET /api/tags shape."""
        models = []
        for e in self.available():
            models.append({
                "name": e.name,
                "model": e.name,
                "modified_at": _iso(e.registered_at),
                "size": e.config.param_count() * 2,  # bf16 bytes
                "digest": _digest(e.name),
                "details": self._details(e.config),
            })
        return {"models": models}

    def ps_payload(self) -> dict:
        """Ollama GET /api/ps shape: models resident on the device."""
        models = []
        for e in self.loaded():
            size = e.config.param_count() * 2
            models.append({
                "name": e.name,
                "model": e.name,
                "size": size,
                "size_vram": size,  # device-resident
                "digest": _digest(e.name),
                "expires_at": _iso(time.time() + 3600),
                "details": self._details(e.config),
            })
        return {"models": models}

    def show_payload(self, name: str) -> Optional[dict]:
        e = self.resolve(name)
        if e is None:
            return None
        c = e.config
        return {
            "modelfile": f"# tpu-native model {e.name}",
            "parameters": "",
            "template": "{{ .Prompt }}",
            "details": self._details(c),
            "model_info": {
                "general.architecture": "qwen2" if c.attn_bias else "llama",
                "general.parameter_count": c.param_count(),
                f"{'qwen2' if c.attn_bias else 'llama'}.context_length": c.max_seq_len,
                f"{'qwen2' if c.attn_bias else 'llama'}.embedding_length": c.hidden_size,
                f"{'qwen2' if c.attn_bias else 'llama'}.block_count": c.num_layers,
                f"{'qwen2' if c.attn_bias else 'llama'}.attention.head_count": c.num_heads,
                f"{'qwen2' if c.attn_bias else 'llama'}.attention.head_count_kv": c.num_kv_heads,
            },
        }

    def openai_models_payload(self) -> dict:
        return {
            "object": "list",
            "data": [
                {
                    "id": e.name,
                    "object": "model",
                    "created": int(e.registered_at),
                    "owned_by": "ollamamq-tpu",
                }
                for e in self.available()
            ],
        }

    @staticmethod
    def _details(c: ModelConfig) -> dict:
        p = c.param_count()
        size_label = f"{p / 1e9:.1f}B" if p >= 1e9 else f"{p / 1e6:.0f}M"
        return {
            "format": "safetensors",
            "family": "qwen2" if c.attn_bias else ("bert" if c.is_encoder else "llama"),
            "parameter_size": size_label,
            "quantization_level": "BF16",
        }


def _digest(name: str) -> str:
    return "sha256:" + hashlib.sha256(name.encode()).hexdigest()[:24]


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + "Z"
