"""Kernel 3's launch plan (``ball_query_kernel.plan``) and the cases its
exact first-K selection must get right.

``plan(n, m, k)`` mirrors the CUDA kernel's dispatch (``csrc/ball_query.cu``):
these tests hold it to the instantiations, threads and shared memory the
kernel has, and to staging the cloud whole where it fits a block. The plain
version runs here on the cases of ``tests/query_cases.py`` against the JAX
package's exact path, its numpy reference and the Pallas kernel in interpret
mode; ``tests/test_torch_cuda.py`` holds the kernel against the plain version
on the same cases on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.ballquery import ball_query as jax_ball_query
from dl_biomass_tpu.ops.pallas_ballquery import ball_query_pallas
from dl_biomass_tpu.ops.reference import ball_query_numpy
from dl_biomass_tpu_torch.ops import ball_query_kernel as k3
from query_cases import (BOUNDARY_POINTS, CASES, OVERFLOW_BUCKET, PALLAS_BUCKET_CAP,
                         PALLAS_DIVERGES, RADIUS, fma_d2, first_k_reference, query_case, r2,
                         separate_d2)

torch.set_num_threads(1)

# the shapes kernel 3 runs at on the paths (chip_smoke.QUERY_SHAPES): SA2 of
# 10240, 7168 and 20608 points, the parity preset's SA1 of 10240, and SA1 of
# 20608 under that preset, beyond what one block's shared memory holds
PATH_SHAPES = [(2048, 512), (1434, 359), (4122, 1031), (10240, 2048), (20608, 4122)]
EDGE_NS = (1, 31, 32, 33, 127, 128, 129, 300)
EDGE_KS = (1, 16, 64)
# the largest cloud a block stages whole at k=64, one block an SM
SLOTS_ALONE = k3.ALONE_WARPS * 64 * k3.SLOT_BYTES
WHOLE_MAX = (k3.SMEM_PER_BLOCK - k3.STATIC_SMEM - SLOTS_ALONE) // k3.POINT_BYTES // (
    32 * k3.AHEAD) * (32 * k3.AHEAD)


def _shapes():
    out = [(n, m, 64) for n, m in PATH_SHAPES]
    out += [(n, 9, k) for n in EDGE_NS for k in EDGE_KS]
    return out + [(33, 5, 100), (WHOLE_MAX, 7, 64), (WHOLE_MAX + 1, 7, 64)]  # k > N; the edge


def _check_plan(p, n, m, k):
    assert p is not None
    assert p.ahead in k3.AHEADS
    assert 1 <= p.warps and 32 * p.warps <= k3.MAX_THREADS
    assert p.points % (32 * p.ahead) == 0
    assert k3.smem_bytes(p, k) <= k3.SMEM_PER_BLOCK
    if p.whole:  # the padded cloud; the tile's centroids taken one a warp at a time
        assert n <= p.points < n + 32 * p.ahead
        assert p.centroids >= 1
    else:  # one centroid a warp, the cloud a chunk of `points` at a time
        assert p.centroids == p.warps and p.points < n


@pytest.mark.parametrize("n,m,k", _shapes())
def test_plan_gives_an_instantiation_the_kernel_has(n, m, k):
    _check_plan(k3.plan(n, m, k), n, m, k)


def test_path_shapes_take_the_plans_measured():
    """Whole clouds at every path shape but SA1 of 20608 points: the SHARED
    plan where two blocks fit an SM's shared memory, the ALONE plan where one
    block fills it."""
    plans = {(n, m): k3.plan(n, m, 64) for n, m in PATH_SHAPES}
    assert all(p.whole for (n, _), p in plans.items() if n < 20608)
    assert not plans[(20608, 4122)].whole
    assert plans[(20608, 4122)][:3] == (k3.CHUNK_WARPS, k3.CHUNK_WARPS, k3.CHUNK_POINTS)
    assert plans[(10240, 2048)][:2] == (k3.ALONE_CENTROIDS, k3.ALONE_WARPS)
    for n, m in PATH_SHAPES[:3]:
        assert plans[(n, m)][:2] == (k3.SHARED_CENTROIDS, k3.SHARED_WARPS)


def test_chunked_staging_where_the_cloud_does_not_fit():
    assert k3.plan(WHOLE_MAX, 64, 64).whole
    for n in (WHOLE_MAX + 1, 20608, 10**6):
        p = k3.plan(n, 64, 64)
        assert not p.whole and p.points == k3.CHUNK_POINTS
        assert k3.smem_bytes(p, 64) <= k3.SMEM_PER_BLOCK
    # the slots take shared memory too: more of them leave less for the cloud
    assert not k3.plan(WHOLE_MAX, 64, 128).whole


def test_blocks_share_an_sm_where_two_fit():
    for n in (1, 2048, 4122):
        p = k3.plan(n, 512, 64)
        assert 2 * k3.smem_bytes(p, 64) <= k3.SMEM_PER_BLOCK
    p = k3.plan(10240, 2048, 64)
    assert 2 * k3.smem_bytes(p, 64) > k3.SMEM_PER_BLOCK >= k3.smem_bytes(p, 64)


@pytest.mark.parametrize("n,m,k", [(0, 8, 64), (8, 0, 64), (8, 8, 0),
                                   (k3.MAX_POINTS + 1, 8, 64), (20608, 8, 10**4)])
def test_wrapper_raises_where_no_plan_takes_the_clouds(n, m, k):
    assert k3.plan(n, m, k) is None
    with pytest.raises(ValueError, match="takes no clouds"):
        k3.launch_plan(n, m, k)
    if n and m and k:  # a tensor off the CPU (shapes only) reaches the plan before any launch
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="takes no clouds"):
            k3.ball_query_first_k(torch.empty((1, m, 3), **meta),
                                  torch.empty((1, m), dtype=torch.bool, **meta),
                                  torch.empty((1, n, 3), **meta),
                                  torch.empty((1, n), dtype=torch.bool, **meta),
                                  radius=RADIUS, k=k)


def _plain(centers, cmask, pos, mask, k):
    t = torch.from_numpy
    idx, ok = k3.ball_query_first_k(t(centers), t(cmask), t(pos), t(mask), radius=RADIUS, k=k)
    return idx.numpy(), ok.numpy()


def _pallas_overflows(idx, ok) -> bool:
    """Whether some residue bucket holds more than the Pallas kernel's cap of
    one centroid's first hits."""
    for row, valid in zip(idx.reshape(-1, idx.shape[-1]), ok.reshape(-1, ok.shape[-1])):
        if np.bincount(row[valid] % 128, minlength=128).max() > PALLAS_BUCKET_CAP:
            return True
    return False


@pytest.mark.parametrize("case", [c for c in CASES if c != "on_radius"])
def test_plain_cases_match_exact_jax_and_numpy(case):
    """Index-exact against ball_query(method="exact"), the numpy reference
    and the selection rounded per operation."""
    centers, cmask, pos, mask, k = query_case(case)
    idx, ok = _plain(centers, cmask, pos, mask, k)
    b, m = cmask.shape
    assert idx.shape == (b, m, k) and idx.dtype == np.int32 and ok.dtype == bool
    jidx, jok = jax_ball_query(jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos),
                               jnp.asarray(mask), radius=RADIUS, k=k, method="exact")
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    for bi in range(b):
        ref_idx, ref_ok = ball_query_numpy(centers[bi], cmask[bi], pos[bi], mask[bi], RADIUS, k)
        np.testing.assert_array_equal(idx[bi], ref_idx)
        np.testing.assert_array_equal(ok[bi], ref_ok)
    ref_idx, ref_ok = first_k_reference(centers, cmask, pos, mask, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(ok, ref_ok)
    assert not idx[~ok].any()  # empty slots hold 0
    assert (ok[..., 1:] <= ok[..., :-1]).all()  # the valid slots first, ascending
    assert (np.diff(idx, axis=-1)[ok[..., 1:]] > 0).all()
    n = pos.shape[1]
    if k > n:
        assert not ok[..., n:].any()
    if case == "few_in_radius":
        assert (ok.sum(-1) < k).mean() > 0.5 and ok.any()
    if case == "empty_ball":
        assert not ok[:, ::2].any() and ok[:, 1::2].all(-1).any()
    if case == "full_ball":  # every slot taken, the first k valid indices
        assert ok[0].all() and (idx[0] == np.arange(k, dtype=np.int32)).all()
    if case == "coincident":  # a centroid sits on the four copies of its point
        assert (ok[..., :4].all(-1) | ~cmask).all()
    if case == "masked_points":
        assert (idx[ok] % 2 == 1).all()
    if case == "masked_cloud":
        assert not ok[1].any() and ok[0].any()
    if case == "masked_centroids":
        assert not ok[:, ::3].any()
    if case == "bucket_overflow":  # centroid 0's hits: the bucket's points, all of them
        sel = np.arange(OVERFLOW_BUCKET, n, 128)
        assert ok[0, 0].sum() == len(sel) > PALLAS_BUCKET_CAP
        np.testing.assert_array_equal(idx[0, 0, :len(sel)], sel)


def test_on_radius_rounds_every_operation_on_its_own():
    """Points on the radius, where a fused multiply-add flips the test: the
    plain version takes exactly those that the separately rounded sum puts
    inside (the rule the CUDA kernel follows); the JAX exact path and the
    Pallas kernel, whose sums XLA's CPU backend may contract, are held to it
    with those points masked."""
    centers, cmask, pos, mask, k = query_case("on_radius")
    on = np.zeros(pos.shape[1], bool)
    on[::5][:BOUNDARY_POINTS] = True
    d = pos[0, on] - centers[0, 0]
    inside = separate_d2(d) <= r2()
    assert (inside != (fma_d2(d) <= r2())).all()  # the case bites
    assert 0 < inside.sum() < BOUNDARY_POINTS
    idx, ok = _plain(centers, cmask, pos, mask, k)
    ref_idx, ref_ok = first_k_reference(centers, cmask, pos, mask, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(ok, ref_ok)
    picked = set(idx[0, 0][ok[0, 0]].tolist())
    assert picked & set(np.flatnonzero(on)[inside].tolist())
    assert not picked & set(np.flatnonzero(on)[~inside].tolist())
    mask_off = mask & ~on[None]
    idx, ok = _plain(centers, cmask, pos, mask_off, k)
    args = [jnp.asarray(a) for a in (centers, cmask, pos, mask_off)]
    for jidx, jok in (jax_ball_query(*args, radius=RADIUS, k=k, method="exact"),
                      ball_query_pallas(*args, radius=RADIUS, k=k, interpret=True)):
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_array_equal(ok, np.asarray(jok))


# the interpret-mode sweep (about a second a case) runs three cases in tier 1,
# the rest behind the slow marker
PALLAS_TIER1 = ("n129", "coincident", "masked_points")
PALLAS_CASES = [c if c in PALLAS_TIER1 else pytest.param(c, marks=pytest.mark.slow)
                for c in CASES if c not in PALLAS_DIVERGES and c != "on_radius"]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_cases_match_pallas(case):
    """Index-exact against ball_query_pallas in interpret mode, on the cases
    where no residue bucket holds more than its cap of a centroid's first K."""
    centers, cmask, pos, mask, k = query_case(case)
    idx, ok = _plain(centers, cmask, pos, mask, k)
    assert not _pallas_overflows(idx, ok)
    jidx, jok = ball_query_pallas(jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos),
                                  jnp.asarray(mask), radius=RADIUS, k=k, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(ok, np.asarray(jok))


def test_pallas_drops_where_a_bucket_overflows():
    """The divergence by design (ROADMAP C): where one residue bucket holds
    more than 8 of a centroid's first 64, the Pallas kernel keeps 8 of them
    and the port keeps all; elsewhere the two agree."""
    centers, cmask, pos, mask, k = query_case("bucket_overflow")
    idx, ok = _plain(centers, cmask, pos, mask, k)
    assert _pallas_overflows(idx, ok)
    jidx, jok = (np.asarray(a) for a in ball_query_pallas(
        jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos), jnp.asarray(mask),
        radius=RADIUS, k=k, interpret=True))
    assert jok[0, 0].sum() == PALLAS_BUCKET_CAP < ok[0, 0].sum()
    kept = jidx[0, 0][jok[0, 0]]
    assert set(kept.tolist()) <= set(idx[0, 0][ok[0, 0]].tolist())
    np.testing.assert_array_equal(idx[:, 1:], jidx[:, 1:])
    np.testing.assert_array_equal(ok[:, 1:], jok[:, 1:])
