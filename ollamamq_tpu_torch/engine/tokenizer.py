"""Deterministic byte-level tokenizer (used with random-weight models;
loading a checkpoint's tokenizer is not part of this package yet)."""

from __future__ import annotations

import codecs
from typing import List, Sequence


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
