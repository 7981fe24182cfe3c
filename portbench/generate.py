"""The one traffic generator: plots and request sizes from a traffic file and a seed.

Everything a run feeds the program is made here from ``--seed`` and the
traffic file's parameters, so the same seed gives the same inputs:

* ``corpus``: synthetic plots (``synthetic.py``) of ``points`` points each,
  with the reference's normalised-intensity feature and four biomass targets;
* ``request_sizes``: the plots per request of a closed-loop client, by a law:
  ``fixed`` (every request ``plots`` plots) or ``lognormal`` (``median``,
  ``sigma``, clipped to ``min``-``max``). The sizes are the same multiset for
  every seed (each cycle holds the law's quantiles at ``(i + 0.5) / cycle``);
  the seed only shuffles each cycle, so two seeds give the same work in
  another order.
"""

from __future__ import annotations

import hashlib
import math
import statistics
from typing import List, Sequence, Tuple

import numpy as np

from portbench.synthetic import synthetic_dataset


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and tags, the same on every machine."""
    text = ",".join([str(int(seed)), *map(str, tags)]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") & ((1 << 63) - 1)


def corpus(n_plots: int, points: int, seed: int, tag: str = "corpus"
           ) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray, List[str]]:
    """(positions, features, targets, plot ids) of ``n_plots`` plots of ``points``."""
    return synthetic_dataset(n_plots, points, seed=sub_seed(seed, tag))


def size_quantiles(law: dict, count: int) -> List[int]:
    """The ``count`` quantiles of the request-size law, rounded and clipped."""
    if law["dist"] == "fixed":
        return [int(law["plots"])] * count
    if law["dist"] != "lognormal":
        raise ValueError(f"unknown request-size law {law['dist']!r}")
    z = statistics.NormalDist()
    out = []
    for i in range(count):
        v = law["median"] * math.exp(law["sigma"] * z.inv_cdf((i + 0.5) / count))
        out.append(int(min(max(round(v), law["min"]), law["max"])))
    return out


def request_sizes(law: dict, cycle: int, cycles: int, seed: int) -> List[int]:
    """``cycles`` shuffled copies of the law's ``cycle`` quantiles, in a row."""
    base = np.asarray(size_quantiles(law, cycle))
    rng = np.random.default_rng(sub_seed(seed, "sizes"))
    return [int(s) for _ in range(cycles) for s in rng.permutation(base)]


def request_plots(sizes: Sequence[int], pool: int, seed: int) -> List[np.ndarray]:
    """For each request, the pool plots it carries (distinct within a request)."""
    rng = np.random.default_rng(sub_seed(seed, "plots"))
    return [rng.choice(pool, size=s, replace=False) for s in sizes]
