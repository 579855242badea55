"""The traffic generator: a seed's schedule repeats exactly, and its
lengths, users and rates are what the traffic file says."""

from __future__ import annotations

import collections
import math
import os
import statistics

import pytest

from servebench import spec, traffic

FILES = sorted(f[:-5] for f in os.listdir(os.path.join(spec.HERE, "traffic")))
CHAT = {"bos": True, "prefix": "[INST] ", "suffix": " [/INST]"}


def _load(name):
    return spec.load_json(os.path.join(spec.HERE, "traffic", name + ".json"))


@pytest.mark.parametrize("name", FILES)
def test_same_seed_same_schedule(name):
    tr = _load(name)
    a = traffic.schedule(tr, CHAT, 2 ** 33 + 5, 20.0)
    b = traffic.schedule(tr, CHAT, 2 ** 33 + 5, 20.0)
    assert a == b
    c = traffic.schedule(tr, CHAT, 2 ** 33 + 6, 20.0)
    assert [r["text"] for r in a] != [r["text"] for r in c]


@pytest.mark.parametrize("name", FILES)
def test_seeds_share_the_schedule(name):
    """Another seed sends the same requests at the same times, with other
    prompt text of the same lengths."""
    tr = _load(name)
    a = traffic.schedule(tr, CHAT, 11, 30.0)
    b = traffic.schedule(tr, CHAT, 2 ** 31 + 12, 30.0)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "text"} for r in rs]
    assert strip(a) == strip(b)
    assert all(len(x["text"]) == len(y["text"]) and x["text"] != y["text"]
               for x, y in zip(a, b))


@pytest.mark.parametrize("name", FILES)
def test_lengths_users_and_rates_match_the_file(name):
    tr = _load(name)
    seconds = 200.0
    reqs = traffic.schedule(tr, CHAT, 99, seconds)
    assert all(0.0 <= r["due"] < seconds for r in reqs)
    assert [r["due"] for r in reqs] == sorted(r["due"] for r in reqs)
    for st in tr["streams"]:
        mine = [r for r in reqs if r["cls"] == st["class"]]
        assert len(mine) == round(st["rate_rps"] * seconds)
        for key, dist in (("prompt_tokens", st["prompt_tokens"]),
                          ("max_tokens", st["output_tokens"])):
            xs = [r[key] for r in mine]
            assert min(xs) >= dist["min"] and max(xs) <= dist["max"]
            assert statistics.median(xs) == pytest.approx(dist["median"], rel=0.02)
        # Prompt text fills the prompt to its length with the template.
        for r in mine[:20]:
            assert len(traffic.prompt_ids(CHAT, r["text"])) == r["prompt_tokens"]
        users = collections.Counter(r["user"] for r in mine)
        assert len(users) == st["users"]
        assert max(users.values()) - min(users.values()) <= 1  # even shares
        span = mine[-1]["due"] - mine[0]["due"]
        assert span == pytest.approx(seconds, rel=0.1)
        gaps = [b["due"] - a["due"] for a, b in zip(mine, mine[1:])]
        if st["arrival"] == "constant":
            assert max(gaps) - min(gaps) < 1e-9
        else:  # exponential gaps: their spread is about their mean
            assert statistics.pstdev(gaps) == pytest.approx(1 / st["rate_rps"], rel=0.2)


def test_mid_quantile_sizes():
    sizes = traffic.lognormal_sizes({"median": 100, "sigma": 1.0, "min": 10,
                                     "max": 1000}, 3)
    nd = statistics.NormalDist()
    want = [round(100 * math.exp(nd.inv_cdf(u))) for u in (1 / 6, 0.5, 5 / 6)]
    assert sizes == want
    assert traffic.lognormal_sizes({"median": 100, "sigma": 5.0, "min": 50,
                                    "max": 60}, 2) == [50, 60]
