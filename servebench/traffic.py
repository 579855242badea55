"""The one traffic generator: a traffic file's parameters and a seed
become a fixed open-loop schedule of chat requests (stdlib only).

Every seed gets the same schedule: each stream's N = round(rate x
seconds) prompt lengths, output lengths and inter-arrival gaps are the N
mid-quantiles of their distributions, shuffled (and the users dealt) in
an order fixed by the traffic file's name. The seed draws the prompts'
text (and, elsewhere, the weights). Where a long reply falls in the
window decides how many of its tokens stream inside it, so an order
drawn from the seed changed the work from seed to seed (qwen3-rag's
output_tps read 170-205 tokens/s over six seeds, and within 3% for two
runs of one seed).

A stream of a traffic file:
  class       label readers filter by ("light", "heavy", ...)
  users       number of users, named <user_prefix><index>
  rate_rps    requests a second the stream offers
  arrival     "poisson" (exponential gaps) or "constant"
  prompt_tokens, output_tokens
              {"median", "sigma", "min", "max"}: log-normal, clipped
Prompt lengths count the whole prompt as the model sees it (template
and BOS included): one token per byte of the rendered text.
"""

from __future__ import annotations

import math
import random
import statistics
from typing import Dict, List

ALPHABET = "abcdefghijklmnopqrstuvwxyz "


def mid_quantiles(n: int) -> List[float]:
    return [(i + 0.5) / n for i in range(n)]


def lognormal_sizes(dist: dict, n: int) -> List[int]:
    """n sizes at the mid-quantiles of a log-normal with this median and
    sigma, clipped to [min, max]."""
    nd = statistics.NormalDist()
    out = []
    for u in mid_quantiles(n):
        x = dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(u))
        out.append(int(min(dist["max"], max(dist["min"], round(x)))))
    return out


def arrival_times(stream: dict, n: int, seconds: float,
                  rng: random.Random) -> List[float]:
    """n arrivals in [0, seconds). Poisson: the n mid-quantile
    exponential gaps in the seed's order, from a seeded part of one gap,
    scaled so that they span the window whatever their order (their
    mean stays 1/rate to within the rounding of n)."""
    rate = stream["rate_rps"]
    if stream["arrival"] == "constant":
        return [(j + 0.5) / rate for j in range(n)]
    if stream["arrival"] != "poisson":
        raise ValueError(f"unknown arrival {stream['arrival']!r}")
    gaps = [-math.log(1.0 - u) / rate for u in mid_quantiles(n)]
    rng.shuffle(gaps)
    scale = seconds / sum(gaps)
    t = gaps[-1] * rng.random()
    times = []
    for g in gaps:
        times.append(t * scale)
        t += g
    return times


def template_tokens(chat: dict) -> int:
    """Tokens the chat template adds around the user's text."""
    return (int(chat["bos"]) + len(chat["prefix"].encode())
            + len(chat["suffix"].encode()))


def prompt_ids(chat: dict, text: str) -> List[int]:
    """The ids the model sees for `text` (servebench/tokenizer.py's
    encoding of the rendered template)."""
    ids = [b + 3 for b in (chat["prefix"] + text + chat["suffix"]).encode()]
    return ([1] if chat["bos"] else []) + ids


def schedule(traffic: dict, chat: dict, seed: int, seconds: float) -> List[Dict]:
    """Requests due in [0, seconds), sorted by due time: i, due, user,
    cls, prompt_tokens, max_tokens, text."""
    overhead = template_tokens(chat)
    reqs = []
    for s_idx, st in enumerate(traffic["streams"]):
        rng = random.Random(f"servebench-order:{traffic.get('name', '')}:{s_idx}:"
                            f"{st['class']}")
        text_rng = random.Random(f"servebench:{seed}:{s_idx}:{st['class']}")
        n = max(1, round(st["rate_rps"] * seconds))
        prompts = lognormal_sizes(st["prompt_tokens"], n)
        outputs = lognormal_sizes(st["output_tokens"], n)
        if min(prompts) <= overhead:
            raise ValueError(f"prompts of {min(prompts)} tokens leave no room "
                             f"for text beside a {overhead}-token template")
        rng.shuffle(prompts)
        rng.shuffle(outputs)
        users = [j % st["users"] for j in range(n)]
        rng.shuffle(users)
        times = arrival_times(st, n, seconds, rng)
        for j in range(n):
            text = "".join(text_rng.choices(ALPHABET, k=prompts[j] - overhead))
            reqs.append({"due": times[j],
                         "user": f"{st['user_prefix']}{users[j]:02d}",
                         "cls": st["class"], "prompt_tokens": prompts[j],
                         "max_tokens": outputs[j], "text": text})
    reqs.sort(key=lambda r: r["due"])
    for i, r in enumerate(reqs):
        r["i"] = i
    return reqs
