"""Whether the served tokens are right: a sample of the finished requests
against the plain reference.

The sample is drawn from the seed among the requests that finished
inside the window and always holds the one with the most served tokens.
The reference runs once over each sampled prompt followed by its served
tokens; at every served position it reads how far the served token's
logit lies below the reference's best one (0 where the served token is
the reference's own greedy pick). The numbers compared are taken over
all sampled positions; a cell's limits file names them and their limits.
With random weights the top two logits often lie within rounding of
each other, so a sound bf16 run serves some tokens that are not the
float32 pick, at small gaps; a lower precision serves more of them, at
wider gaps. The mean of the squared gaps weighs the wide ones.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from servebench import reference, traffic, weights


def draw(finished: List[dict], seed: int, served_tokens: int,
         max_total: int) -> List[dict]:
    """The longest finished request, then others in a seeded order until
    the sample holds `served_tokens` served tokens or the next would pass
    `max_total` tokens of prompt and reply together."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r["ids"]), r["i"]))
    pick = [by_len[0]]
    rest = by_len[1:]
    random.Random(f"servebench-sample:{seed}").shuffle(rest)
    served = len(pick[0]["ids"])
    total = pick[0]["prompt_tokens"] + served
    for r in rest:
        if served >= served_tokens:
            break
        n = r["prompt_tokens"] + len(r["ids"])
        if total + n > max_total:
            continue
        pick.append(r)
        served += len(r["ids"])
        total += n
    return pick


def gap_numbers(gaps: torch.Tensor) -> Dict[str, float]:
    """The readings over every compared position: the mean squared gap
    (the number the cells compare: PERF.md gives why), the widest gap,
    the mean gap, and the share of positions whose served token is not
    the reference's own pick (gap > 0)."""
    g = gaps.double()
    return {"gap_msq": float((g * g).mean()), "gap_max": float(g.max()),
            "gap_mean": float(g.mean()), "off_share": float((g > 0).double().mean())}


def served_gaps(ref_logits: List[torch.Tensor], served: List[List[int]],
                picks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Per position: reference best logit minus the reference logit of the
    served token (or of `picks`' token, a control's own greedy choice)."""
    out = []
    for i, lg in enumerate(ref_logits):
        tok = (torch.as_tensor(served[i], device=lg.device) if picks is None
               else picks[i])
        out.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None].long())[:, 0])
    return torch.cat(out)


def reference_logits(a: dict, seed: int, sample: List[dict], chat: dict,
                     device, quant=None) -> List[torch.Tensor]:
    seqs, wanted = [], []
    for r in sample:
        ids = traffic.prompt_ids(chat, r["text"])
        seqs.append(ids + r["ids"][:-1])
        wanted.append(range(len(ids) - 1, len(ids) - 1 + len(r["ids"])))
    tops = weights.top_shapes(a)
    return reference.logits(
        a, lambda name: weights.make(seed, name, tops[name], torch.bfloat16, device),
        weights.served_layers(a, seed, torch.bfloat16, device), seqs, wanted,
        quant=quant)


def inputs_agree(sample: List[dict], chat: dict) -> List[str]:
    """Faults that make the comparison meaningless: the server counted
    other prompt tokens than the harness made, or a reply that ended by
    length holds another number of tokens than it asked for."""
    bad = []
    for r in sample:
        n = len(traffic.prompt_ids(chat, r["text"]))
        if r.get("prompt_eval_count") != n:
            bad.append(f"request {r['i']}: server counted "
                       f"{r.get('prompt_eval_count')} prompt tokens, harness made {n}")
        if r.get("reason") == "length" and len(r["ids"]) != r["max_tokens"]:
            bad.append(f"request {r['i']}: {len(r['ids'])} tokens for "
                       f"num_predict {r['max_tokens']}")
    return bad


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit (a number passes at or under
    its limit)."""
    return {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}


def passed(compared: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in compared.values())
