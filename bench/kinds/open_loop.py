"""Requests that arrive on a schedule whatever the system does: Poisson
gaps at ``rate`` a second.  A share (``shared_share``) of the prompts
start with one of ``heads`` shared heads of ``head_len`` tokens, the head
drawn Zipf(``zipf_s``), then a tail of their own (``shared_tail``); the
rest are unshared (``unshared``).  Each request asks for its drawn output
length (``output``).

The arrival times and the set of sizes are drawn from the mix's
``base_seed``, so every seed offers the same work.  With
``order_by_seed`` the run's seed deals those sizes to the arrival times
in an order of its own; the seed always draws the token ids."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from bench.generator import MASK64, draw, requests, seed_rng, zipf_weights

#: Each request due in the window is judged by its time to first token.
OPEN_LOOP = True


def generate(mix: Dict, seed: int, seconds: float, config: Dict
             ) -> List[Dict]:
    """The requests due in a window of ``seconds``, in due order."""
    base = np.random.default_rng(mix["base_seed"])
    rate = float(mix["rate"])
    gaps = base.exponential(1.0 / rate, int(math.ceil(rate * seconds * 2)) + 64)
    while gaps.sum() < seconds:
        gaps = np.concatenate([gaps, base.exponential(1.0 / rate, len(gaps))])
    n = int((np.cumsum(gaps) < seconds).sum())
    gaps = gaps[:n]
    shared = base.random(n) < mix["shared_share"]
    head = base.choice(mix["heads"], n, p=zipf_weights(mix["heads"],
                                                       mix["zipf_s"]))
    tail = draw(base, mix["shared_tail"], n)
    alone = draw(base, mix["unshared"], n)
    new = draw(base, mix["output"], n)
    sizes = [(int(h) if s else -1, int(t) if s else int(a), int(k))
             for s, h, t, a, k in zip(shared, head, tail, alone, new)]
    if mix.get("order_by_seed"):
        order = np.random.default_rng([int(seed) & MASK64, 2]).permutation(n)
        sizes = [sizes[i] for i in order]
    rng = seed_rng(seed)
    vocab = config["run"]["vocab"]
    heads = rng.integers(0, vocab, (mix["heads"], mix["head_len"]),
                         dtype=np.int64)
    return requests(rng, heads, sizes, np.cumsum(gaps), vocab)
