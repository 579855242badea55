"""Chat templating: messages -> prompt string (Llama 3, ChatML for the
Qwen families, Mistral [INST], and a plain fallback for the byte-tokenizer
test models)."""

from __future__ import annotations

from typing import List, Optional

from ollamamq_tpu_torch.config import ModelConfig


def chat_family(cfg: Optional[ModelConfig]) -> str:
    """'chatml' | 'llama3' | 'mistral' | 'plain' — the one place the
    template-family heuristics live (render_chat and template_owns_bos
    both read it). Name prefix decides first; architecture markers cover
    unregistered names."""
    if cfg is None:
        return "plain"
    name = cfg.name.lower()
    if name.startswith(("qwen",)):
        return "chatml"
    if name.startswith(("mixtral", "mistral")):
        return "mistral"
    if name.startswith(("llama3", "llama-3")):
        return "llama3"
    if cfg.attn_bias:  # Qwen2 family marker
        return "chatml"
    if not cfg.is_encoder and cfg.num_experts == 0 and cfg.vocab_size > 100_000:
        return "llama3"
    return "plain"


def template_owns_bos(cfg: Optional[ModelConfig]) -> bool:
    """True when the template emits its own begin-of-sequence text
    (Llama 3) or the format defines none (ChatML); callers pass
    add_bos=not template_owns_bos(cfg) to the tokenizer."""
    return chat_family(cfg) in ("chatml", "llama3")


def render_chat(messages: List[dict], cfg: Optional[ModelConfig]) -> str:
    """Render an Ollama/OpenAI-style messages list into a prompt."""
    msgs = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if isinstance(content, list):  # OpenAI content-part arrays
            content = "".join(
                p.get("text", "") for p in content if isinstance(p, dict))
        msgs.append((role, content))

    family = chat_family(cfg)
    if family == "chatml":
        out = [f"<|im_start|>{role}\n{content}<|im_end|>\n"
               for role, content in msgs]
        out.append("<|im_start|>assistant\n")
        return "".join(out)

    if family == "mistral":
        # System text folds into the first user turn; assistant turns
        # close with </s>.
        out = []
        pending_sys = ""
        for role, content in msgs:
            if role == "system":
                pending_sys += content + "\n\n"
            elif role == "assistant":
                out.append(f"{content}</s>")
            else:
                out.append(f"[INST] {pending_sys}{content} [/INST]")
                pending_sys = ""
        if pending_sys:
            out.append(f"[INST] {pending_sys.strip()} [/INST]")
        return "".join(out)

    if family == "llama3":
        out = ["<|begin_of_text|>"]
        for role, content in msgs:
            out.append(
                f"<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>")
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)

    out = [f"{role}: {content}\n" for role, content in msgs]
    out.append("assistant: ")
    return "".join(out)
