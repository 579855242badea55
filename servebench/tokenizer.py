"""The served model's tokenizer, in place of the tokenizer.json a real
checkpoint ships (stdlib only).

A seeded model has no vocabulary file, and the port's byte tokenizer
decodes the ids past 258 to no text at all: the server then streams no
frame for nearly every token a random-weight model picks, so a client
could time neither its first token nor the gaps between tokens. This
tokenizer encodes text as the byte tokenizer does (id = byte + 3, BOS 1),
so prompt lengths are counted in bytes, and decodes every id to one
ASCII letter, so every token reaches the client in a frame of its own,
as a real vocabulary's tokens nearly all do.

No id ends a reply (eos_id -1): the traffic fixes each reply's length
(num_predict), as serving benchmarks do by ignoring EOS; with random
weights an end-of-sequence id would otherwise cut replies at random.
"""

from __future__ import annotations

from typing import List, Sequence


def _piece(token_id: int) -> str:
    return chr(97 + token_id % 26)


class ServeTokenizer:
    pad_id = 0
    bos_id = 1
    eos_id = -1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(_piece(i) for i in ids)

    def make_incremental_decoder(self):
        def step(token_id: int) -> str:
            return _piece(token_id)

        step.pending_ids = lambda: []
        return step
