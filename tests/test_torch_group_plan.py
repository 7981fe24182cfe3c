"""Kernel 2's launch plan (``ball_group_kernel.plan``) and the cases its
selection and capture must get exactly right.

``plan(n, m)`` mirrors the CUDA kernel's template dispatch
(``csrc/ball_group.cu``): these tests hold it to the instantiations,
threads, shared memory and register budget the kernel has. The plain
version runs here on the edge cases of ``tests/group_cases.py`` against the
Pallas kernel in interpret mode; ``tests/test_torch_cuda.py`` holds the
kernel against the plain version on the same cases on a card.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.pallas_group import ball_group_pallas
from dl_biomass_tpu_torch.ops import ball_group_kernel as k2
from group_cases import (BOUNDARY_POINTS, CASES, RADIUS, fma_d2, group_case, select_reference,
                         separate_d2)

torch.set_num_threads(1)

# the clouds kernel 2 runs on: SA1 of 10240 and 7168 points (2048 and 1434
# centroids) and 20608 points, beyond what shared memory would hold; and the
# small edges
PATH_SHAPES = list(itertools.product((10240, 7168, 20608), (2048, 1434)))
EDGE_SHAPES = [(1, 1), (127, 9), (128, 9), (129, 9), (300, 13)]


@pytest.mark.parametrize("n,m", PATH_SHAPES + EDGE_SHAPES)
def test_plan_gives_an_instantiation_the_kernel_has(n, m):
    p = k2.plan(n, m)
    assert p is not None
    assert p.centroids in k2.CENTROIDS and p.points in k2.CHUNK_POINTS
    assert p.centroids % 2 == 0  # the capture takes two centroids a thread a round


def test_path_shapes_take_the_measured_plan():
    for n, m in PATH_SHAPES:
        assert k2.plan(n, m) == (16, 8)


def test_threads_and_shared_memory_fit():
    for p in itertools.starmap(k2.Plan, itertools.product(k2.CENTROIDS, k2.CHUNK_POINTS)):
        assert k2.THREADS <= 1024 and k2.THREADS == k2.G
        assert k2.smem_bytes(p) <= k2.SMEM_PER_BLOCK <= 232448


def test_every_plan_fits_its_register_budget():
    """Five registers a centroid, four for the point under test and the
    loop's own fit the 128 a thread of a block compiled for four blocks an
    SM has, on every cloud the plan takes."""
    assert k2.REGISTERS_PER_THREAD * k2.THREADS * 4 <= 65536
    plans = {k2.plan(n, m) for n in range(1, 4 * 128 * 16 + 2) for m in (1, 13, 2048)}
    assert plans == {k2.Plan(k2.PLAN_CENTROIDS, k2.PLAN_POINTS)}
    for p in plans:
        assert k2.registers(p) <= k2.REGISTERS_PER_THREAD, p


@pytest.mark.parametrize("n,m", [(0, 8), (8, 0), (k2.MAX_POINTS + 1, 8)])
def test_wrapper_raises_where_no_plan_takes_the_clouds(n, m):
    assert k2.plan(n, m) is None
    with pytest.raises(ValueError, match="takes no clouds"):
        k2.launch_plan(n, m)
    if n and m:  # a tensor off the CPU (shapes only) reaches the plan before any launch
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="takes no clouds"):
            k2.ball_group(torch.empty((1, m, 3), **meta),
                          torch.empty((1, m), dtype=torch.bool, **meta),
                          torch.empty((1, n, 3), **meta),
                          torch.empty((1, n), dtype=torch.bool, **meta), radius=RADIUS)


def _both(case, centers, cmask, pos, mask, feat):
    """The Pallas kernel (interpret mode) and the plain version on one case."""
    _, _, _, _, dtype, need_idx = CASES[case]
    jidx, jok, jrel, jfeat = ball_group_pallas(
        jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos), jnp.asarray(mask),
        None if feat is None else jnp.asarray(feat), radius=RADIUS, interpret=True,
        compute_dtype=getattr(jnp, dtype), need_idx=need_idx)
    t = torch.from_numpy
    got = k2.ball_group(t(centers), t(cmask), t(pos), t(mask), None if feat is None else t(feat),
                        radius=RADIUS, out_dtype=getattr(torch, dtype), need_idx=need_idx)
    return (jidx, jok, jrel, jfeat), got


@pytest.mark.parametrize("case", [c for c in CASES if c != "on_radius"])
def test_plain_edge_cases_match_pallas(case):
    """Index-exact selection and equal captured values, the plain version
    against the Pallas kernel in interpret mode."""
    centers, cmask, pos, mask, feat = group_case(case)
    (jidx, jok, jrel, jfeat), (idx, ok, edges) = _both(case, centers, cmask, pos, mask, feat)
    b, m = cmask.shape
    f = 0 if feat is None else feat.shape[-1]
    assert edges.shape == (b, m, 64, f + 3) and edges.dtype == getattr(torch, CASES[case][4])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if CASES[case][5]:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    else:
        assert idx is None and jidx is None
    np.testing.assert_array_equal(edges[..., :f].float().numpy(),
                                  np.asarray(jfeat.astype(jnp.float32)))
    np.testing.assert_array_equal(edges[..., f:].float().numpy(),
                                  np.asarray(jrel.astype(jnp.float32)))
    assert not edges[~ok].any()  # invalid slots are zero rows
    _, ref_ok = select_reference(centers, cmask, pos, mask)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    if case == "empty_ball":
        assert not ok[:, ::2].any() and ok[:, 1::2].any()
    if case == "full_ball":  # every slot: the least index of its bucket pair
        assert ok.all() and (idx == torch.arange(64, dtype=torch.int32)).all()
    if case == "masked_points":
        assert (idx[ok] % 2 == 1).all()
    if case == "masked_centroids":
        assert not ok[:, ::3].any()


def test_on_radius_rounds_every_operation_on_its_own():
    """Points on the radius, where a fused multiply-add flips the test: the
    plain version takes exactly those that the separately rounded sum puts
    inside (the rule the CUDA kernel follows). XLA's CPU backend contracts
    the Pallas kernel's sum in interpret mode (ROADMAP C), so the Pallas
    kernel is held to the plain version with those points masked."""
    centers, cmask, pos, mask, feat = group_case("on_radius")
    on = np.zeros(pos.shape[1], bool)
    on[::5][:BOUNDARY_POINTS] = True
    d = pos[0, on] - centers[0, 0]
    inside = separate_d2(d) <= np.float32(RADIUS**2)
    assert (inside != (fma_d2(d) <= np.float32(RADIUS**2))).all()  # the case bites
    assert 0 < inside.sum() < BOUNDARY_POINTS
    t = torch.from_numpy
    idx, ok, edges = k2.ball_group(t(centers), t(cmask), t(pos), t(mask), None, radius=RADIUS)
    ref_idx, ref_ok = select_reference(centers, cmask, pos, mask)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    picked = set(idx[0, 0][ok[0, 0]].tolist())
    assert picked & set(np.flatnonzero(on)[inside].tolist())
    assert not picked & set(np.flatnonzero(on)[~inside].tolist())
    mask_off = mask & ~on[None]
    (jidx, jok, jrel, _), (idx, ok, edges) = _both("on_radius", centers, cmask, pos, mask_off,
                                                   None)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jrel))
