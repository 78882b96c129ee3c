"""The one traffic generator: a traffic file's parameters + ``--seed`` -> requests.

Every seed gets the same work: the sizes and the prompt lengths are fixed
multisets (exact shares, quantiles of the stated distribution), put in an
order drawn from ``--seed``, which also draws the prompts' words and the
requests' seeds. (Every prompt pads to the encoder's 512 tokens, so its
length does not change the work.)

A serving traffic file (``benchmark/traffic/<name>.json``) has:

- ``kind``: ``"closed"``: ``clients`` clients, each sending its next request
  when its image arrives;
- ``clients``;
- ``sizes``: ``[{"px": side, "share": s}, ...]``, square images;
- ``steps``; ``prompt_words``: ``{"median", "sigma", "min", "max"}`` of a
  log-normal word count;
- ``check``: ``{"requests": n, "among": m}``: the output check compares
  ``n`` requests at stream positions drawn from the seed among the ``m``
  that follow the clients' first ones, one of them of the largest size
  there (``check.positions``).

A train traffic file (``kind`` ``"train"``) is read by ``benchmark/training.py``.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist
from typing import Iterator, List

WORDS = (
    "a an the of in on under over beside behind near far bright dark misty golden silver crimson azure emerald "
    "ancient modern quiet busy tiny huge lonely crowded wooden stone glass metal paper velvet frozen burning "
    "floating sunken hidden painted woven carved glowing faded cat dog fox owl whale horse dragon robot child "
    "sailor farmer dancer knight wizard city village forest desert ocean river mountain island garden library "
    "market harbor castle bridge tower street kitchen studio train bicycle lantern umbrella clock mirror book "
    "teapot violin map telescope flower tree cloud storm sunset dawn moon star snow rain fog wind light shadow "
    "portrait landscape closeup photograph painting sketch watercolor illustration render poster cinematic "
    "soft sharp warm cold vivid muted dramatic gentle detailed minimal symmetrical wide angle macro lens "
    "morning evening night autumn winter spring summer reflection texture pattern colorful monochrome"
).split()


def _counts(shares: List[dict], key: str, n: int) -> List:
    """``n`` values of ``key`` in exact shares (largest remainders)."""
    raw = [e["share"] * n for e in shares]
    counts = [int(r) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: raw[i] - counts[i], reverse=True)[: n - sum(counts)]:
        counts[i] += 1
    return [e[key] for e, c in zip(shares, counts) for _ in range(c)]


def _word_counts(p: dict, n: int) -> List[int]:
    """``n`` log-normal quantiles of the word count, clipped to [min, max]."""
    nd = NormalDist(math.log(p["median"]), p["sigma"])
    return [min(p["max"], max(p["min"], round(math.exp(nd.inv_cdf((i + 0.5) / n))))) for i in range(n)]


def closed_requests(traffic: dict, seed: int, block: int = 256) -> Iterator[dict]:
    """An endless sequence of requests, made ``block`` at a time, each with
    a prompt and a seed of its own, so the prompt cache never hits."""
    order, rng = random.Random(f"order:{seed}"), random.Random(f"traffic:{seed}")
    used_prompts, used_seeds = set(), set()
    while True:
        sizes = _counts(traffic["sizes"], "px", block)
        words = _word_counts(traffic["prompt_words"], block)
        order.shuffle(sizes), order.shuffle(words)
        for px, nw in zip(sizes, words):
            prompt = " ".join(rng.choice(WORDS) for _ in range(nw))
            while prompt in used_prompts:
                prompt += " " + rng.choice(WORDS)
            used_prompts.add(prompt)
            s = rng.randrange(1, 2**31 - 1)
            while s in used_seeds:
                s = rng.randrange(1, 2**31 - 1)
            used_seeds.add(s)
            yield {"prompt": prompt, "height": px, "width": px, "steps": traffic["steps"], "seed": s}
