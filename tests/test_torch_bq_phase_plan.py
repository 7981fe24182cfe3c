"""Kernel 9's launch, ``tools/bq_phase_bench.plan``: every centroid taken
once by the kernel's dispatch (whole clouds: warps taking the tile's
centroids from a shared counter; chunked: one a warp), a block's shared
memory within an H100's, the switch from two blocks an SM to one and from
whole to chunked at the clouds that no longer fit, and a plan for every input
the parent kernel took (0 to 2**24 - 1 points, k 1-127, cm 1-32, which the
launch no longer reads)."""

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.tools import bq_phase_bench as k9

SMEM = 232448  # a block's shared memory on an H100


def taken(p: k9.Plan, m: int, take: int, seed: int) -> list:
    """The centroids each warp of each block scans, as the kernel hands them
    out (``take`` at a time from the shared counter in a whole cloud: 2 for
    ``dist``), the warps' turns at the counter in a random order."""
    rng = np.random.default_rng(seed)
    out = []
    if not p.whole:  # one centroid a warp
        for x in range(-(-m // p.warps)):
            out += [c for c in range(x * p.warps, (x + 1) * p.warps) if c < m]
        return out
    for x in range(-(-m // p.centroids)):
        c0, c1 = x * p.centroids, min(m, (x + 1) * p.centroids)
        held = [c0 + take * w for w in range(p.warps)]  # each warp's first
        nxt = c0 + take * p.warps
        while any(c < c1 for c in held):
            w = int(rng.choice([i for i, c in enumerate(held) if c < c1]))
            out += [c for c in range(held[w], held[w] + take) if c < c1]  # the rest not in
            held[w], nxt = nxt, nxt + take  # atomicAdd on the counter
    return out


@pytest.mark.parametrize("take", [1, 2])
@pytest.mark.parametrize("n,m,k", [(2048, 512, 64), (2048, 37, 64), (1200, 100, 1),
                                   (13824, 300, 64), (20608, 70, 127), (0, 5, 64),
                                   (300, 33, 127), (300, 17, 64)])
def test_every_centroid_is_taken_once(n, m, k, take):
    p = k9.plan(n, m, k)
    for seed in range(3):
        assert sorted(taken(p, m, take, seed)) == list(range(m))


@pytest.mark.parametrize("k", [1, 8, 64, 127])
def test_shared_memory_fits_a_block(k):
    for n in list(range(0, 40000, 97)) + [k9.MAX_POINTS]:
        p = k9.plan(n, 512, k)
        assert k9.smem_bytes(p, k) <= SMEM
        assert p.points % k9.GROUP == 0
        assert (p.points >= n) == p.whole  # whole: the padded cloud; else a chunk of it
        assert 32 * p.warps <= 1024 and p.centroids >= p.warps


def test_the_plan_switches_where_the_cloud_stops_fitting():
    # two blocks an SM up to 6912 points at k=64 (2 x ((6912 + 32) x 16 + 8 x 64 x 4 + 16)
    # bytes), one block of 32 warps up to 13,824 ((13,824 + 128) x 16 + 32 x 64 x 4 + 16),
    # then chunks, as kernel 3's
    shared, alone = k9.plan(6912, 512, 64), k9.plan(6913, 512, 64)
    assert (shared.warps, shared.centroids, shared.whole) == (8, 32, True)
    assert (alone.warps, alone.centroids, alone.whole) == (32, 128, True)
    assert 2 * k9.smem_bytes(shared, 64) <= SMEM < 2 * k9.smem_bytes(alone, 64)
    whole, chunked = k9.plan(13824, 512, 64), k9.plan(13825, 512, 64)
    assert whole.whole and whole.points == 13824 and k9.smem_bytes(whole, 64) <= SMEM
    assert chunked == k9.Plan(32, 32, 8192, False)
    # at k=127 the slots leave less room for the cloud
    assert k9.plan(13824, 512, 127).whole is False


@pytest.mark.parametrize("n,k", [(0, 64), (1, 1), (2048, 127), (k9.MAX_POINTS, 64),
                                 (k9.MAX_POINTS, 1), (k9.MAX_POINTS, 127)])
def test_a_plan_for_every_input_the_parent_took(n, k):
    p = k9.launch_plan(n, 1, k)
    assert k9.smem_bytes(p, k) <= SMEM
    if n >= 1 << 20:  # chunks of 8192, one centroid a warp
        assert not p.whole and p.points == 8192
    else:
        assert p.whole and p.points == -(-n // 256) * 256


@pytest.mark.parametrize("n,m,k", [(1 << 24, 4, 64), (100, 0, 64), (100, 4, 0),
                                   (100, 4, 128), (-1, 4, 64)])
def test_no_plan_beyond_the_packed_key(n, m, k):
    assert k9.plan(n, m, k) is None
    with pytest.raises(ValueError, match="takes no clouds"):
        k9.launch_plan(n, m, k)


@pytest.mark.parametrize("phase", ["full", "dist", "rank", "when0"])
def test_cm_changes_no_result(phase):
    rng = np.random.default_rng(3)
    pos = torch.from_numpy((rng.normal(size=(2, 300, 3)) * 5).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 300)) > 0.1)
    outs = [k9.bq(pos[:, :40], mask[:, :40], pos, mask, radius=8.0, cm=cm, phase=phase)
            for cm in (1, 7, 32)]
    assert all(torch.equal(o, outs[0]) for o in outs)
