"""The traffic is made from the seed alone, and the request sizes follow the
stated law: the same multiset of quantiles for every seed, in another order."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generate

TRAFFIC = Path(generate.__file__).resolve().parent / "traffic"
LAW = {"dist": "lognormal", "median": 48, "sigma": 1.0, "min": 1, "max": 512}


def test_corpus_is_deterministic_per_seed():
    a = generate.corpus(3, 256, 2**31 + 11)
    b = generate.corpus(3, 256, 2**31 + 11)
    c = generate.corpus(3, 256, 2**31 + 12)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[2], b[2])
    assert not np.array_equal(a[0][0], c[0][0])
    assert a[0][0].shape == (256, 3) and a[1][0].shape == (256, 1)


def test_size_quantiles_follow_the_lognormal_law():
    q = generate.size_quantiles(LAW, 64)
    assert q == sorted(q) and min(q) >= 1 and max(q) == 512
    assert q[31] <= 48 <= q[32]  # the median between the middle quantiles
    # the mean of the unclipped law is 48 e^(1/2) = 79.1; clipped and rounded
    assert 75 < np.mean(q) < 80
    padded = [-(-s // 64) * 64 for s in q]
    assert 105 < np.mean(padded) < 115


def test_a_fixed_law_gives_every_request_its_size():
    law = {"dist": "fixed", "plots": 288}
    assert generate.size_quantiles(law, 5) == [288] * 5
    assert generate.request_sizes(law, 1, 7, 2**31 + 3) == [288] * 7
    with pytest.raises(ValueError, match="unknown request-size law"):
        generate.size_quantiles({"dist": "poisson"}, 4)


def test_the_serving_traffic_sends_the_documented_poll():
    t = json.loads((TRAFFIC / "serve_watch.json").read_text())
    sizes = generate.request_sizes(t["size_law"], t["sizes_per_cycle"], t["cycles"], 5)
    assert set(sizes) == {288} and len(sizes) == t["sizes_per_cycle"] * t["cycles"]
    assert -(-288 // t["plot_bucket"]) * t["plot_bucket"] == 320


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**31])
def test_request_sizes_same_multiset_for_every_seed(seed):
    base = collections.Counter(generate.size_quantiles(LAW, 64))
    sizes = generate.request_sizes(LAW, 64, 3, seed)
    assert len(sizes) == 192
    for c in range(3):
        assert collections.Counter(sizes[c * 64:(c + 1) * 64]) == base
    assert sizes == generate.request_sizes(LAW, 64, 3, seed)
    assert sizes != generate.request_sizes(LAW, 64, 3, seed + 1)


def test_request_plots_distinct_and_in_the_pool():
    sizes = generate.request_sizes(LAW, 64, 2, 9)
    picks = generate.request_plots(sizes, 512, 9)
    for s, p in zip(sizes, picks):
        assert len(p) == s == len(set(p.tolist())) and p.max() < 512


def test_sub_seed_is_stable_and_large_seeds_work():
    assert generate.sub_seed(2**33 + 1, "corpus") == generate.sub_seed(2**33 + 1, "corpus")
    assert 0 <= generate.sub_seed(2**33 + 1, "x") < 2**63
    assert generate.sub_seed(1, "a") != generate.sub_seed(1, "b")


@pytest.mark.parametrize("path", sorted(TRAFFIC.glob("*.json")), ids=lambda p: p.stem)
def test_traffic_files_name_a_kind_and_a_why(path):
    t = json.loads(path.read_text())
    assert (Path(generate.__file__).parent / "kinds" / f"{t['kind']}.py").exists()
    assert t["why"] and t["points"] > 0
