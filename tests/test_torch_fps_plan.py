"""Kernel 1's launch plan (``fps_kernel.plan``) and the cases its argmax must
get exactly right.

``plan(n)`` mirrors the CUDA kernel's template dispatch (``csrc/fps.cu``):
these tests hold it to the paths and register budget the kernel has. The
plain version runs here on the edge cases, against the Pallas kernel in
interpret mode; ``tests/test_torch_cuda.py`` holds the kernel against the
plain version on the same cases on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.pallas_fps import fps_pallas
from dl_biomass_tpu_torch.ops import fps_kernel
from fps_cases import EDGE_CASES, edge_case

torch.set_num_threads(1)

# the rows kernel 1 runs on: SA1 and SA2 of 16 and 36 x 10240 and 36 x 7168,
# exact FPS on 10240, phase 9's 16384; and the small edges
TABLE_POINTS = (1280, 256, 3584, 1434, 10240, 16384)
EDGE_POINTS = (1, 32, 33)
REGISTER_PATHS = ("warp", "block")


def _threads(p: fps_kernel.Plan) -> int:
    return 32 * p.warps_per_row * p.rows_per_block


@pytest.mark.parametrize("n", TABLE_POINTS + EDGE_POINTS)
def test_plan_gives_a_path_the_kernel_has(n):
    p = fps_kernel.plan(n)
    assert p is not None and p.path in ("warp", "block", "planes")
    assert _threads(p) <= 1024 and p.warps_per_row <= fps_kernel.MAX_WARPS
    if p.path in REGISTER_PATHS:
        assert p.points_per_thread in fps_kernel.POINTS_PER_THREAD[
            fps_kernel.block_limit(_threads(p))]
        assert 32 * p.warps_per_row * p.points_per_thread >= n
        assert p.rows_per_block == 1 or p.warps_per_row == 1
    else:
        assert (p.warps_per_row, p.rows_per_block) == (fps_kernel.PLANES_WARPS, 1)
        assert n > 32 * fps_kernel.MAX_WARPS * fps_kernel.WIDE_P_MAX


def test_table_shapes_take_the_planned_paths():
    got = {n: fps_kernel.plan(n) for n in TABLE_POINTS}
    assert got[256] == (1, 8, fps_kernel.ROWS_PER_WARP_BLOCK, "warp")
    assert got[1280] == (4, 10, 1, "block")
    assert got[3584] == (12, 10, 1, "block")
    assert got[1434] == (4, 12, 1, "block")
    assert got[10240] == (32, 10, 1, "block")
    assert got[16384].path == "planes"


def test_every_register_plan_fits_its_budget():
    """Five registers a point (x, y, z, |p|^2, running min) and the loop's
    own fit what a thread of the block may hold, on every row length the
    registers take."""
    plans = {fps_kernel.plan(n)
             for n in range(1, 32 * fps_kernel.MAX_WARPS * fps_kernel.WIDE_P_MAX + 1)}
    assert {p.path for p in plans} == set(REGISTER_PATHS)
    for p in plans:
        budget = fps_kernel.REGISTERS_PER_THREAD[fps_kernel.block_limit(_threads(p))]
        assert budget <= min(255, 65536 // fps_kernel.block_limit(_threads(p)))
        assert (p.points_per_thread * fps_kernel.REGISTERS_PER_POINT
                + fps_kernel.LOOP_REGISTERS <= budget), p


def test_one_warp_per_row_where_a_row_fits_a_warp():
    limit = 32 * fps_kernel.P_MAX
    for n in (1, 32, 33, 256, limit):
        assert fps_kernel.plan(n).path == "warp" and fps_kernel.plan(n).warps_per_row == 1
    assert fps_kernel.plan(limit + 1).path == "block"


@pytest.mark.parametrize("n", [0, fps_kernel.MAX_POINTS + 1])
def test_wrapper_raises_where_no_path_takes_the_rows(n):
    assert fps_kernel.plan(n) is None
    with pytest.raises(ValueError, match="no kernel path"):
        fps_kernel.launch_plan(n)
    if n:  # a tensor off the CPU (shapes only) reaches the plan before any launch
        pos = torch.empty((1, n, 3), device="meta")
        mask = torch.empty((1, n), dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="no kernel path"):
            fps_kernel.fps_rows(pos, mask, torch.zeros(1, dtype=torch.int32, device="meta"), 1)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_fps_plain_edge_cases_match_pallas(case):
    """Ties to the first index, exhausted rows picking 0, masked starts: the
    plain version against the Pallas kernel in interpret mode, index-exact."""
    n = 64
    pos, mask, starts, k = edge_case(case, n)
    want = np.asarray(fps_pallas(jnp.asarray(pos), jnp.asarray(mask), k, jnp.asarray(starts),
                                 interpret=True))
    got = fps_kernel.fps_rows(torch.from_numpy(pos), torch.from_numpy(mask),
                              torch.from_numpy(starts), k).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "all_masked":
        assert got[1, 0] == starts[1] and (got[1, 1:] == 0).all()
    if case == "beyond_valid":
        assert (got[2, 3:] == 0).all() and sorted(got[2, :3]) == [0, 1, 2]
    if case == "duplicates":  # every point once: ties never repeat a pick
        assert all(len(set(row)) == n for row in got.tolist())
    if case == "masked_start":
        np.testing.assert_array_equal(got[:, 0], starts)
        assert (got[:, 1:] % 2 == 1).all()
