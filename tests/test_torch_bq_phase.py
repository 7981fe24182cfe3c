"""Kernel 9's plain version (``dl_biomass_tpu_torch.tools.bq_phase_bench``)
on CPU tensors: every variant against the JAX tool's ``bq`` (its Pallas
bodies in interpret mode, the tool loaded by path), ``dyn`` against the exact
ball query's plain version, the tool's ``main`` at cut sizes, and its
guards."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.ops import ball_query_kernel
from dl_biomass_tpu_torch.ops.grouping import in_radius
from dl_biomass_tpu_torch.tools import bq_phase_bench
from torch_port_helpers import interpreted, jax_tool

torch.set_num_threads(1)
RADIUS = 0.7  # f32(0.7 ** 2) = 0.49000001 is one ulp above f32(0.7) * f32(0.7)
# (x, y, 0) from a centroid at the origin: d2 rounds to f32(0.49) in any order
# of the two products and their sum, FMA-contracted or not
BOUNDARY = (np.float32(0.63241994), np.float32(0.30007502))
FAR = np.float32(3.0)  # a centroid far from the cloud, with one bucket clustered at it


def _case(b=3, m=40, n=1200, seed=0):
    """Batch 0: centroid 0 far from the cloud with bucket 5's ten points and
    points 1100 and 1190 (after bucket 5's ninth) around it, so that a cap of
    8 leaves a hole at slot 8; centroid 1 at the origin with one point exactly
    on the radius. Batch 1: masked points and centroids. Batch 2: plain.
    M=40 is no multiple of cm=16, N=1200 none of 128."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 0.5).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1] = rng.random(n) > 0.2
    centers = pos[:, :m].copy()
    cmask = np.ones((b, m), bool)
    cmask[1] = rng.random(m) > 0.3
    centers[0, 0] = FAR
    for j in list(range(5, n, 128)) + [1100, 1190]:
        pos[0, j] = FAR + (rng.normal(size=3) * 0.05).astype(np.float32)
    centers[0, 1] = 0.0
    pos[0, 1] = (BOUNDARY[0], BOUNDARY[1], 0.0)
    return centers, cmask, pos, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_the_case_drops_points_and_has_a_point_on_the_radius():
    centers, cmask, pos, mask = _torch(*_case())
    tool = in_radius(centers, cmask, pos, mask, bq_phase_bench.radius2(RADIUS))
    k3 = in_radius(centers, cmask, pos, mask, ball_query_kernel._radius2(RADIUS))
    assert torch.equal(tool ^ k3, torch.zeros_like(tool).index_put_(
        (torch.tensor([0]), torch.tensor([1]), torch.tensor([1])), torch.tensor(True)))
    got = bq_phase_bench.bq(centers, cmask, pos, mask, radius=RADIUS, cm=16, phase="full")
    assert got[0, 0, :12].tolist() == [5, 133, 261, 389, 517, 645, 773, 901, 1200, 1100,
                                       1200, 1190]


@pytest.fixture(scope="module")
def jax_outputs():
    jt = jax_tool("bq_phase_bench")
    args = [jnp.asarray(a) for a in _case()]
    cache = {}

    def run(phase):
        if phase not in cache:
            with interpreted():
                cache[phase] = np.asarray(jt.bq(*args, radius=RADIUS, cm=16, phase=phase))
        return cache[phase]
    return run


@pytest.mark.parametrize("phase", bq_phase_bench.PHASES)
def test_bq_plain_matches_the_jax_tool(jax_outputs, phase):
    want = jax_outputs(phase)
    got = bq_phase_bench.bq(*_torch(*_case()), radius=RADIUS, cm=16, phase=phase)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (3, 40, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dyn_is_the_exact_first_k():
    centers, cmask, pos, mask = _torch(*_case())
    radius = 0.75  # squares exactly in f32: both radius roundings agree
    got = bq_phase_bench.bq(centers, cmask, pos, mask, radius=radius, phase="dyn")
    idx, nbr = ball_query_kernel.ball_query_plain(centers, cmask, pos, mask, radius=radius, k=64)
    assert torch.equal(got, torch.where(nbr, idx, pos.shape[1]))
    capped = bq_phase_bench.bq(centers, cmask, pos, mask, radius=radius, phase="full")
    kept = capped != pos.shape[1]
    assert torch.equal(capped[kept], got[kept]) and not torch.equal(capped, got)


def test_main_runs_on_the_cpu_when_asked(capsys):
    with mock.patch.multiple(bq_phase_bench, LOOPS=2, WINDOWS=1):
        rows = bq_phase_bench.main(b=2, m=24, n=200, device="cpu")
    out = capsys.readouterr().out
    for phase in bq_phase_bench.TIMED_PHASES:
        assert f"phase={phase:8s} cm= 32: " in out, out
    assert [r["phase"] for r in rows] == list(bq_phase_bench.TIMED_PHASES)


def test_main_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bq_phase_bench.main()


@pytest.mark.parametrize("n,k,cm,phase,match", [
    (1 << 24, 64, 32, "full", "2\\*\\*24"),  # the index would spill into the rank
    (100, 0, 32, "full", "k=0"),
    (100, 128, 32, "full", "k=128"),  # (128 << 24) is negative
    (100, 64, 0, "full", "cm=0"),
    (100, 64, 33, "full", "cm=33"),
    (100, 64, 32, "whenx", "unknown phase"),
])
def test_bq_refuses_what_the_packed_key_cannot_hold(n, k, cm, phase, match):
    pos = torch.zeros((1, 1, 3)).expand(1, n, 3)  # no memory behind the large n
    mask = torch.ones((1, 1), dtype=torch.bool).expand(1, n)
    with pytest.raises(ValueError, match=match):
        bq_phase_bench.bq(pos[:, :1], mask[:, :1], pos, mask, radius=1.0, k=k, cm=cm,
                          phase=phase)
