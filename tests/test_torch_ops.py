"""The port's ops (dl_biomass_tpu_torch.ops) against the JAX package's.

The same numpy inputs go through both. Pallas kernels run in interpret mode,
as the JAX package's own tests run them on the CPU; the port runs the plain
PyTorch versions of its CUDA kernels, which a CPU tensor selects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.ballquery import ball_query as jax_ball_query
from dl_biomass_tpu.ops.fps import farthest_point_sample as jax_fps
from dl_biomass_tpu.ops.fps import fps_sectored as jax_fps_sectored
from dl_biomass_tpu.ops.pallas_fps import fps_pallas
from dl_biomass_tpu.ops.pallas_group import ball_group_pallas
from dl_biomass_tpu.ops.pallas_mxu_gather import mxu_gather
from dl_biomass_tpu.ops.pooling import masked_max as jax_masked_max
from dl_biomass_tpu.ops.pooling import masked_mean as jax_masked_mean
from dl_biomass_tpu.ops.reference import ball_query_numpy
from dl_biomass_tpu_torch import ops
from dl_biomass_tpu_torch.ops import _build, fps_kernel, gather_kernel

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def cloud(seed, b, n, valid, scale=3.0):
    """Gaussian clouds; cloud i keeps its first valid[i] points."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * scale).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(valid)[:, None]
    return pos, mask


# ---- kernel 1: FPS -----------------------------------------------------------

FPS_CASES = [  # (seed, B, N, valid counts, k)
    (0, 2, 256, [256, 200], 32),
    (1, 3, 300, [300, 123, 290], 50),  # N not a multiple of 128
    (2, 2, 96, [96, 10], 24),  # a cloud with fewer valid points than k
    (3, 1, 1000, [1000], 100),
]


@pytest.mark.parametrize("seed,b,n,valid,k", FPS_CASES)
def test_fps_matches_pallas_index_exact(seed, b, n, valid, k):
    pos, mask = cloud(seed, b, n, valid)
    starts = np.asarray([0, 5, 7][:b], np.int32)
    want = np.asarray(fps_pallas(jnp.asarray(pos), jnp.asarray(mask), k, jnp.asarray(starts),
                                 interpret=True))
    got = ops.farthest_point_sample(t(pos), t(mask), k, starts=t(starts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(640, 128), (376, 76)])
def test_fps_sectored_matches_pallas(n, k):
    """Sector counts 8 and 4 (76 % 8 != 0)."""
    pos, mask = cloud(4, 2, n, [n, n - 37])
    want = np.asarray(jax_fps_sectored(jnp.asarray(pos), jnp.asarray(mask), k, use_pallas=True))
    got = ops.fps_sectored(t(pos), t(mask), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [1, 2])
def test_fps_sectored_hands_kernel_1_contiguous_rows(b, monkeypatch):
    """The sector-major rows are a copy at every batch size: at B = 1 the
    reshape after the transpose is a strided view, which kernel 1's launch
    refuses on the card (a serving request of one cloud raised there)."""
    pos, mask = cloud(4, b, 640, [640, 603][:b])
    real, seen = fps_kernel.fps_rows, []

    def rows(p, m, starts, k):
        seen.append(p.is_contiguous() and m.is_contiguous())
        return real(p, m, starts, k)

    monkeypatch.setattr(fps_kernel, "fps_rows", rows)
    want = np.asarray(jax_fps_sectored(jnp.asarray(pos), jnp.asarray(mask), 128,
                                       use_pallas=True))
    np.testing.assert_array_equal(ops.fps_sectored(t(pos), t(mask), 128).numpy(), want)
    assert seen == [True]


def test_fps_sectored_halves_to_two_sectors_at_7168():
    """At N=7168 the SA1 count ceil(0.2 N) = 1434 is not a multiple of 4, so
    both packages run 2 sectors of 3584 points, 717 picks each.

    Against the interpret-mode Pallas kernel the picks are the same points in
    the same order except for one pair of consecutive picks of cloud 0, which
    trade places. Their running-min distances differ by 16 ulps (2.1547966 vs
    2.1547928): within the cancellation error of the |p|^2 - 2 p.l + |l|^2
    form at |p|^2 ~ 100, and XLA's CPU backend, which runs the interpret mode,
    contracts two of the form's multiply-adds into FMAs where the port rounds
    each operation (replaying the row in numpy with those two FMAs reproduces
    XLA's order). The test pins exactly that: same sectors, same point set,
    order equal up to that one swap."""
    n, k = 7168, 1434
    pos, mask = cloud(4, 2, n, [n, n - 37])
    want = np.asarray(jax_fps_sectored(jnp.asarray(pos), jnp.asarray(mask), k, use_pallas=True))
    got = ops.fps_sectored(t(pos), t(mask), k).numpy()
    assert (got[:, :717] % 2 == 0).all() and (got[:, 717:] % 2 == 1).all()
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))
    diff = np.argwhere(got != want)
    np.testing.assert_array_equal(diff, [[0, 1155], [0, 1156]])
    np.testing.assert_array_equal(got[0, 1155:1157], want[0, 1156:1154:-1])


@pytest.mark.parametrize("seed", [5, 6])
def test_fps_matches_jnp_difference_form(seed):
    """The jnp path measures (p - l)^2, the kernels |p|^2 - 2 p.l + |l|^2: the
    two forms round differently and could split a near-tie between two
    candidates. On these clouds they pick the same points; a split would show
    here as a mismatch, not be hidden by a looser comparison."""
    pos, mask = cloud(seed, 2, 512, [512, 400])
    want = np.asarray(jax_fps(jnp.asarray(pos), jnp.asarray(mask), 64, use_pallas=False))
    got = ops.farthest_point_sample(t(pos), t(mask), 64).numpy()
    np.testing.assert_array_equal(got, want)


def test_fps_first_valid_start_and_unique():
    pos, _ = cloud(7, 2, 128, [128, 128])
    mask = np.ones((2, 128), bool)
    mask[1, :9] = False
    got = ops.farthest_point_sample(t(pos), t(mask), 40).numpy()
    assert got[0, 0] == 0 and got[1, 0] == 9
    for row, m in zip(got, mask):
        assert len(set(row.tolist())) == 40 and m[row].all()


# ---- kernel 3: exact ball query ----------------------------------------------

BQ_CASES = [  # (seed, N, M, radius, k)
    (0, 256, 40, 3.0, 64),
    (1, 300, 33, 8.0, 64),  # most balls overflow K
    (2, 48, 20, 2.0, 64),  # N < K
    (3, 200, 16, 1.0, 16),
]


@pytest.mark.parametrize("seed,n,m,radius,k", BQ_CASES)
def test_ball_query_matches_exact_jnp_and_numpy(seed, n, m, radius, k):
    pos, mask = cloud(seed, 2, n, [n, n * 3 // 4])
    rng = np.random.default_rng(seed + 10)
    centers = pos[:, rng.permutation(n)[:m]] + rng.normal(size=(2, m, 3)).astype(np.float32) * .1
    cmask = np.ones((2, m), bool)
    cmask[1, -3:] = False
    want_idx, want_ok = jax_ball_query(jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos),
                                       jnp.asarray(mask), radius=radius, k=k, method="exact")
    idx, ok = ops.ball_query(t(centers), t(cmask), t(pos), t(mask), radius=radius, k=k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    for bi in range(2):
        ref_idx, ref_ok = ball_query_numpy(centers[bi], cmask[bi], pos[bi], mask[bi], radius, k)
        np.testing.assert_array_equal(idx[bi].numpy(), ref_idx)
        np.testing.assert_array_equal(ok[bi].numpy(), ref_ok)


# ---- kernel 2: stratified ball group -----------------------------------------


def _group_inputs(seed, with_feat=True):
    b, n, m = 2, 384, 48
    pos, mask = cloud(seed, b, n, [384, 300], scale=4.0)
    centers = np.ascontiguousarray(pos[:, :m])
    cmask = np.arange(m)[None] < np.asarray([48, 40])[:, None]
    feat = np.random.default_rng(seed).normal(size=(b, n, 1)).astype(np.float32)
    return centers, cmask, pos, mask, (feat if with_feat else None)


@pytest.mark.parametrize("need_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ball_group_matches_pallas(need_idx, dtype):
    centers, cmask, pos, mask, feat = _group_inputs(11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jidx, jok, jrel, jfeat = ball_group_pallas(
        jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos), jnp.asarray(mask),
        jnp.asarray(feat), radius=3.0, interpret=True, compute_dtype=jdt, need_idx=need_idx)
    idx, ok, edges = ops.ball_group(t(centers), t(cmask), t(pos), t(mask), t(feat), radius=3.0,
                                    out_dtype=tdt, need_idx=need_idx)
    assert edges.dtype == tdt and edges.shape == (2, 48, 64, 4)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if need_idx:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    else:
        assert idx is None and jidx is None
    # channel order [feat_j, pos_j - center_i]; captured values compare equal
    np.testing.assert_array_equal(edges[..., :1].float().numpy(),
                                  np.asarray(jfeat.astype(jnp.float32)))
    np.testing.assert_array_equal(edges[..., 1:].float().numpy(),
                                  np.asarray(jrel.astype(jnp.float32)))


def test_ball_group_without_features():
    centers, cmask, pos, mask, _ = _group_inputs(12, with_feat=False)
    jidx, jok, jrel, _ = ball_group_pallas(
        jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos), jnp.asarray(mask), None,
        radius=2.5, interpret=True)
    idx, ok, edges = ops.ball_group(t(centers), t(cmask), t(pos), t(mask), None, radius=2.5)
    assert edges.shape == (2, 48, 64, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jrel))


# ---- kernel 4: row gather ----------------------------------------------------


@pytest.mark.parametrize("dtype,m,c", [("float32", 20, 96), ("bfloat16", 37, 128),
                                       ("bfloat16", 64, 40)])
def test_gather_bit_exact_vs_mxu_gather(dtype, m, c):
    """M=20 and 37 are not multiples of the Pallas kernel's 32-centroid tile."""
    rng = np.random.default_rng(m)
    b, n, k = 2, 200, 64
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m, k)).astype(np.int32)
    jv = jnp.asarray(vals).astype(getattr(jnp, dtype))
    want = np.asarray(mxu_gather(jv, jnp.asarray(idx), interpret=True).astype(jnp.float32))
    got = ops.gather_rows(t(vals).to(getattr(torch, dtype)), t(idx))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, m, k, c)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_out_of_range_rows_are_zero():
    """An index outside [0, N) matches no one-hot column in mxu_gather: a zero row."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(1, 50, 128)).astype(np.float32)
    idx = rng.integers(0, 50, size=(1, 4, 64)).astype(np.int32)
    idx[0, 1, 5], idx[0, 2, 7] = 50, -1
    want = np.asarray(mxu_gather(jnp.asarray(vals), jnp.asarray(idx), interpret=True))
    got = ops.gather_rows(t(vals), t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 1, 5].any() and not got[0, 2, 7].any()


# ---- pooling -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_max_and_mean_with_empty_rows(dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 7, 6)).astype(np.float32) * 4
    mask = rng.random((3, 5, 7)) < 0.5
    mask[0, 1] = False  # an empty row: 0, not -inf
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = t(x).to(getattr(torch, dtype))
    got = ops.masked_max(tx, t(mask), dim=2)
    want = np.asarray(jax_masked_max(jx, jnp.asarray(mask), 2).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (got[0, 1] == 0).all()
    got_mean = ops.masked_mean(t(x), t(mask), dim=2).numpy()
    want_mean = np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask), 2))
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-6, atol=1e-6)


# ---- routing -----------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version for a CPU tensor only: a tensor on any
    other device launches the kernel (cuda) or raises."""
    pos = torch.zeros((1, 8, 3), device="meta")
    mask = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        fps_kernel.fps_rows(pos, mask, torch.zeros(1, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        gather_kernel.gather_rows(torch.zeros((1, 8, 4), device="meta"),
                                  torch.zeros((1, 2, 64), dtype=torch.int32, device="meta"))


def test_cpu_calls_do_not_count_as_launches():
    before = dict(_build.launch_counts)
    pos, mask = cloud(9, 1, 64, [64])
    ops.farthest_point_sample(t(pos), t(mask), 8)
    assert dict(_build.launch_counts) == before
