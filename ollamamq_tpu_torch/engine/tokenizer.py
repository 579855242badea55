"""Tokenizers: a deterministic byte-level tokenizer (random-weight models
and tests) and a wrapper of an HF tokenizer.json for checkpoints that
ship one. The `tokenizers` package is imported only when such a file is
loaded."""

from __future__ import annotations

import codecs
import os
from typing import List, Optional, Sequence


class ByteTokenizer:
    """Reversible byte-level tokenizer: id = byte + 3; 0=pad, 1=bos, 2=eos.

    Incremental decode holds back incomplete UTF-8 tails so streamed
    chunks never contain mojibake.
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 3 for i in ids if i >= 3)
        return data.decode("utf-8", errors="replace")

    def make_incremental_decoder(self):
        # Incomplete multibyte tails are held back; invalid bytes become
        # U+FFFD immediately rather than wedging the buffer.
        dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

        def step(token_id: int) -> str:
            # Ids outside the byte range (random-weight models with a
            # larger vocab) decode to nothing.
            if token_id < 3 or token_id >= 259:
                return ""
            return dec.decode(bytes([token_id - 3]))

        return step


class HFTokenizer:
    """tokenizer.json (an HF model directory's) through the `tokenizers`
    package, imported here and nowhere at module level."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        f = path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
        self._tok = Tokenizer.from_file(f)
        self.vocab_size = self._tok.get_vocab_size()
        # <|im_start|> is not a BOS candidate: ChatML (Qwen) has no BOS,
        # and the turn delimiter as one would prefix every prompt.
        self.bos_id = self._first_special(["<|begin_of_text|>", "<s>"])
        self.eos_id = self._first_special(
            ["<|eot_id|>", "<|end_of_text|>", "</s>", "<|im_end|>"])
        self.pad_id = 0

    def _first_special(self, names) -> int:
        for n in names:
            i = self._tok.token_to_id(n)
            if i is not None:
                return i
        return 0

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return [self.bos_id] + ids if add_bos and self.bos_id else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def make_incremental_decoder(self):
        prev_ids: List[int] = []
        prev_text = ""

        def step(token_id: int) -> str:
            nonlocal prev_text
            prev_ids.append(token_id)
            text = self._tok.decode(prev_ids, skip_special_tokens=True)
            # A trailing U+FFFD is an incomplete multibyte piece: hold it
            # back until the next token completes it.
            if text.endswith("\ufffd"):
                return ""
            new = text[len(prev_text):]
            prev_text = text
            return new

        return step


def load_tokenizer(model_dir: Optional[str]):
    """The checkpoint directory's tokenizer.json when it ships one, else
    the byte-level tokenizer."""
    if model_dir:
        f = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(f):
            return HFTokenizer(f)
    return ByteTokenizer()
