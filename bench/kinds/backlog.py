"""A backlog: ``requests`` unshared requests (sizes ``prompt`` and
``output``), all due when the window opens, in one order for every seed
(drawn from the mix's ``base_seed``); the seed draws the token ids."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench.generator import draw, requests, seed_rng

#: The backlog keeps the system full; a request is judged by being
#: admitted, not by its time to first token.
OPEN_LOOP = False


def generate(mix: Dict, seed: int, seconds: float, config: Dict
             ) -> List[Dict]:
    base = np.random.default_rng(mix["base_seed"])
    n = int(mix["requests"])
    sizes = list(zip([-1] * n, draw(base, mix["prompt"], n).tolist(),
                     draw(base, mix["output"], n).tolist()))
    return requests(seed_rng(seed), None, sizes, [0.0] * n,
                    config["run"]["vocab"])
