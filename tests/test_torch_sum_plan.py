"""The slice sum's launch and order, ``ops/sum_slices_kernel.plan``: each
slice in exactly one run, the runs consecutive and in order; the threads, tile
and grid within the kernel's limits; a numpy emulation of the planned float64
order within 1e-6 of ``sum_slices_plain`` on slices that cancel; zero slices
give zeros. ``planned_sum`` is also the card tests' bit-for-bit reference."""

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.ops import sum_slices_kernel as ss

# the shapes the paths give it (7-B's at tail_bench's SA1 and SA2, kernel 8's
# at its two widths), the card test's, and edges
SHAPES = [(396, 8192), (132, 32768), (660, 128), (660, 256), (133, 5000), (0, 7), (1, 5),
          (5, 3), (7, 1), (300, 4), (1000, 9), (2, 100003)]


def planned_sum(slices: np.ndarray) -> np.ndarray:
    """The kernel's order in numpy: each run's slices added in slice order in
    float64 from 0.0, the runs' sums SPAN at a time in run order, then the
    spans' sums in span order, each from 0.0, rounded once to float32.
    Elementwise float64 adds round as the card's do."""
    blocks, n = slices.shape
    p = ss.plan(blocks, n)
    sums = []
    for lo, hi in ss.runs(blocks, p.groups):
        part = np.zeros(n, np.float64)
        for j in range(lo, hi):
            part = part + slices[j].astype(np.float64)
        sums.append(part)
    total = np.zeros(n, np.float64)
    for q in range(0, len(sums), ss.SPAN):
        span = np.zeros(n, np.float64)
        for part in sums[q:q + ss.SPAN]:
            span = span + part
        total = total + span
    return total.astype(np.float32)


@pytest.mark.parametrize("blocks,n", SHAPES)
def test_each_slice_in_exactly_one_run_in_order(blocks, n):
    p = ss.plan(blocks, n)
    spans = ss.runs(blocks, p.groups)
    assert len(spans) == p.groups >= 1
    assert [j for lo, hi in spans for j in range(lo, hi)] == list(range(blocks))
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    assert p.groups <= max(blocks, 1)


@pytest.mark.parametrize("blocks,n", SHAPES)
def test_launch_within_the_kernels_limits(blocks, n):
    p = ss.plan(blocks, n)
    assert p.vec == (4 if n % 4 == 0 else 1)
    assert ss.MIN_COLS <= p.cols <= ss.MAX_COLS and p.cols % p.vec == 0
    assert p.threads == p.groups * p.cols // p.vec <= ss.MAX_THREADS
    assert p.grid == -(-n // p.cols) and p.smem_bytes == 8 * p.groups * p.cols <= 48 * 1024


def test_narrow_slices_spread_and_wide_ones_keep_rows():
    assert ss.plan(660, 128)[:3] == (4, 8, 128)  # 16 blocks of 128 runs
    assert ss.plan(396, 8192)[:3] == (4, 64, 16)  # 128 blocks
    assert ss.plan(132, 32768)[:3] == (4, 256, 4)  # 128 blocks of 256-value rows
    assert ss.plan(10, 1 << 20).cols == ss.MAX_COLS
    assert ss.plan(-1, 5) is None and ss.plan(5, -1) is None


@pytest.mark.parametrize("blocks,n", [(396, 8192), (660, 128), (133, 5000), (1000, 9)])
def test_planned_order_within_1e6_of_plain_on_cancelling_slices(blocks, n):
    rng = np.random.default_rng(blocks)
    half = blocks // 2
    big = (rng.normal(size=(half, n)) * 1e4).astype(np.float32)
    small = rng.normal(size=(blocks - half, n)).astype(np.float32)
    small[:half] -= big[::-1]  # each large slice cancels against one late in the order
    slices = np.concatenate([big, small])
    want = ss.sum_slices_plain(torch.from_numpy(slices)).numpy()
    got = planned_sum(slices)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(want).max() < 1e-2 * np.abs(slices).max()  # the slices did cancel


def test_zero_slices_give_zeros():
    for n in (0, 1, 128, 5000):
        slices = np.zeros((0, n), np.float32)
        assert ss.plan(0, n).groups == 1
        np.testing.assert_array_equal(planned_sum(slices), np.zeros(n, np.float32))
        assert torch.equal(ss.sum_slices(torch.from_numpy(slices)), torch.zeros(n))
