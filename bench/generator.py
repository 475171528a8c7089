"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and ``--seed`` give the work a run offers.  The mix's ``kind`` names its
arrival process, a module ``kinds/<kind>.py`` found by that name, with
one signature for every kind::

    generate(mix, seed, seconds, config) -> list

(requests for a served model, input batches for a compiled graph).  A
new arrival process is a new file there.  The helpers below are what
the kinds share: seeding, the size distributions, the Zipf weights and
the request records.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np

from bench import load_module

HERE = Path(__file__).resolve().parent
MASK64 = (1 << 64) - 1


def kind(mix: Dict, here: Path = HERE) -> ModuleType:
    """The mix's arrival process, ``kinds/<kind>.py`` under ``here``."""
    return load_module(here / "kinds" / f"{mix['kind']}.py",
                       f"bench_kind_{mix['kind']}")


def generate(mix: Dict, seed: int, seconds: float, config: Dict,
             here: Path = HERE) -> List:
    """What the mix offers a window of ``seconds`` (see the kind)."""
    return kind(mix, here).generate(mix, seed, seconds, config)


def seed_rng(seed: int) -> np.random.Generator:
    """The run's own generator (any whole number is a seed)."""
    return np.random.default_rng(int(seed) & MASK64)


def draw(rng: np.random.Generator, dist: Dict, n: int) -> np.ndarray:
    """``n`` whole sizes from ``dist``: ``lognormal`` (``median``,
    ``sigma``) or ``uniform`` (inclusive), clipped to ``[min, max]``."""
    name = dist["dist"]
    if name == "lognormal":
        x = dist["median"] * np.exp(dist["sigma"] * rng.standard_normal(n))
    elif name == "uniform":
        x = rng.integers(dist["min"], dist["max"] + 1, n)
    else:
        raise ValueError(f"unknown size distribution {name!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def requests(rng, heads, sizes, dues, vocab) -> List[Dict]:
    """Requests in due order: ``sizes`` rows of (head or -1, own tokens,
    output tokens), the tokens drawn from ``rng``."""
    out = []
    for uid, ((head, own, new), due) in enumerate(zip(sizes, dues)):
        toks = rng.integers(0, vocab, int(own), dtype=np.int64)
        if head >= 0:
            toks = np.concatenate([heads[head], toks])
        out.append({"uid": uid, "due": float(due),
                    "prompt": toks.astype(np.int32), "max_new": int(new),
                    "head": int(head)})
    return out
