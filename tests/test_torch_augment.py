"""The port's augmentation (``dl_biomass_tpu_torch/transforms/augment.py``):
``apply_augment`` against the JAX package's ``augment_cloud`` and
``augment_batch`` on the draws JAX makes from the same key splits, and the
distributions of ``tests/test_augment.py`` through the port's own draws from a
``torch.Generator``, with the port's copy of ``numpy_augment`` as the host
oracle."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.transforms.augment import augment_batch as jax_augment_batch
from dl_biomass_tpu.transforms.augment import augment_cloud as jax_augment_cloud
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.transforms import augment, numpy_augment
from dl_biomass_tpu_torch.transforms.augment import (AugmentDraws, apply_augment, aug_capacity,
                                                     augment_batch, augment_cloud, draw_augment)

torch.set_num_threads(1)


def jax_draws(key, c, f) -> AugmentDraws:
    """The draws ``augment_cloud(key, ...)`` of the JAX package makes, from its
    own key splits (``augment.py:139-140``, ``:106-107``), as an AugmentDraws
    of one cloud."""
    k_rm, k_noise, k_rot, k_sc, k_perm = jax.random.split(key, 5)
    _, k_cnt = jax.random.split(k_rm)
    k_sd, k_sign, k_np, k_nf, _, k_extra = jax.random.split(k_noise, 6)
    u = jax.random.uniform
    vals = dict(
        theta=u(k_rot, (), minval=-jnp.pi, maxval=jnp.pi), keep_u=u(k_cnt, ()),
        sd=u(k_sd, (), minval=0.01, maxval=0.025),
        sign=jnp.where(u(k_sign, ()) >= 0.5, 1.0, -1.0),
        noise_pos=jax.random.normal(k_np, (c, 3)), noise_feat=jax.random.normal(k_nf, (c, f)),
        extra_u=u(k_extra, ()), scores=u(k_perm, (c,)), scale=u(k_sc, (), minval=0.9, maxval=1.1))
    return AugmentDraws(**{k: torch.from_numpy(np.array(v, np.float32))[None]
                           for k, v in vals.items()})


def jax_batch_draws(key, b, c, f) -> AugmentDraws:
    """The draws of ``augment_batch(key, ...)``: one key a cloud."""
    per = [jax_draws(k, c, f) for k in jax.random.split(key, b)]
    return AugmentDraws(*(torch.cat(parts) for parts in zip(*per)))


def clouds(b, n, f=1, seed=0, sizes=None):
    """b clouds of up to n points (``sizes``) in a capacity aug_capacity(n)."""
    cap = aug_capacity(n)
    rng = np.random.default_rng(seed)
    pos = np.zeros((b, cap, 3), np.float32)
    feat = np.zeros((b, cap, f), np.float32)
    mask = np.zeros((b, cap), bool)
    for i, k in enumerate(sizes or [n] * b):
        pos[i, :k] = rng.normal(size=(k, 3)) * 5
        feat[i, :k] = rng.normal(size=(k, f))
        mask[i, :k] = True
    return pos, feat, mask


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _same(got, want_pos, want_feat, want_mask):
    pos, feat, mask = (t.numpy() for t in got)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    np.testing.assert_allclose(pos, np.asarray(want_pos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(feat, np.asarray(want_feat), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,f,sizes", [(200, 1, [200, 150, 77]), (640, 4, [640, 639])])
def test_apply_augment_matches_jax_augment_batch(n, f, sizes):
    """The mask (kept points, appended slots) exactly, positions and features
    to 1e-6 (the rotation's sin and cos)."""
    pos, feat, mask = clouds(len(sizes), n, f, seed=n, sizes=sizes)
    key = jax.random.key(n + f)
    want = jax_augment_batch(key, JaxBatch(pos=jnp.asarray(pos), feat=jnp.asarray(feat),
                                           mask=jnp.asarray(mask), y=jnp.zeros((len(sizes), 4))),
                             n)
    draws = jax_batch_draws(key, len(sizes), pos.shape[1], f)
    got = apply_augment(draws, torch.from_numpy(pos), torch.from_numpy(feat),
                        torch.from_numpy(mask), n)
    _same(got, want.pos, want.feat, want.mask)
    assert (np.asarray(want.mask)[:, n:].sum(1) > 0).any()  # something was appended


@pytest.mark.parametrize("with_scale", [False, True])
def test_apply_augment_matches_jax_augment_cloud(with_scale):
    pos, feat, mask = clouds(1, 300, seed=3)
    key = jax.random.key(7)
    want = jax_augment_cloud(key, *(jnp.asarray(a[0]) for a in (pos, feat, mask)), 300,
                             with_scale=with_scale)
    got = apply_augment(jax_draws(key, pos.shape[1], 1), torch.from_numpy(pos),
                        torch.from_numpy(feat), torch.from_numpy(mask), 300, with_scale)
    _same([t[0] for t in got], *want)


def test_ranks_over_valid_is_a_permutation_of_the_valid_slots():
    mask = torch.tensor([[True, False, True, True, False, True]])
    scores = torch.tensor([[0.5, 0.1, 0.2, 0.9, 0.0, 0.3]])
    ranks, order = augment._ranks_over_valid(mask, scores)
    assert order[0, :4].tolist() == [2, 5, 0, 3]
    assert ranks[0, [2, 5, 0, 3]].tolist() == [0, 1, 2, 3] and (ranks[0, [1, 4]] >= 4).all()


# ---- distributions through the port's own draws ------------------------------------


def test_draws_land_on_the_generators_device_and_repeat():
    a, b = draw_augment(gen(3), 2, 256, 1), draw_augment(gen(3), 2, 256, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.noise_feat.shape == (2, 256, 1) and set(a.sign.tolist()) <= {-1.0, 1.0}
    assert (a.sd >= 0.01).all() and (a.sd <= 0.025).all()
    assert (a.theta.abs() <= math.pi).all() and (a.scale >= 0.9).all() and (a.scale <= 1.1).all()


def test_rotation_preserves_z_and_norms():
    pos, _, _ = clouds(1, 100)
    p = torch.from_numpy(pos[0])
    out = augment.rotate_points(gen(0), p)
    torch.testing.assert_close(out[:, 2], p[:, 2], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[:, :2].norm(dim=1), p[:, :2].norm(dim=1), rtol=1e-4,
                               atol=1e-4)


def test_rotation_angle_distribution_uniform():
    pos = torch.tensor([[1.0, 0.0, 0.0]])
    angs = np.asarray([float(torch.atan2(o[0, 1], o[0, 0])) for o in
                       (augment.rotate_points(gen(i), pos) for i in range(200))])
    assert angs.min() < -2.5 and angs.max() > 2.5 and abs(np.mean(angs)) < 0.3


@pytest.mark.parametrize("n", [50, 100])
def test_point_removal_keep_count_in_reference_envelope(n):
    """Kept ~ U[round(0.9 n), n] (reference randint, inclusive), and only
    valid slots are removed."""
    _, _, mask = clouds(1, n)
    m = torch.from_numpy(mask[0])
    kept = [augment.point_removal(gen(i), m) for i in range(100)]
    counts = np.asarray([int(k.sum()) for k in kept])
    assert counts.min() >= round(0.9 * n) and counts.max() <= n and len(np.unique(counts)) > 3
    assert not any(k[n:].any() for k in kept)


def test_random_noise_appends_noisy_copies_to_a_clean_base():
    """0..10% appended in slots [n, C), base points and mask untouched, every
    appended point close to an original (sigma <= 0.025) but not equal to it."""
    n = 100
    pos, feat, mask = (torch.from_numpy(a[0]) for a in clouds(1, n))
    found = 0
    for i in range(20):
        p2, f2, m2 = augment.random_noise(gen(i), pos, feat, mask, n)
        assert 0 <= int(m2[n:].sum()) <= 10 and torch.equal(m2[:n], mask[:n])
        assert torch.equal(p2[:n], pos[:n]) and torch.equal(f2[:n], feat[:n])
        app = p2[n:][m2[n:]]
        if len(app):
            d = torch.cdist(app, pos[:n]).min(1).values
            assert d.max() < 0.5 and d.min() > 0.0
            found += len(app)
    assert found > 0


def test_random_scale_envelope_and_isotropy():
    pos = torch.tensor([[2.0, 0.0, 1.0], [0.0, 4.0, -1.0]])
    for i in range(20):
        out = augment.random_scale(gen(i), pos)
        s = float(out[0, 0]) / 2.0
        assert 0.9 <= s <= 1.1
        torch.testing.assert_close(out, pos * s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("with_scale", [False, True])
def test_appended_sources_survive_removal(with_scale):
    """One permutation serves removal and append: every appended point is a
    copy of a point that survived the removal (features are not rotated)."""
    n, checked = 100, 0
    pos, feat, mask = (torch.from_numpy(a[0]) for a in clouds(1, n))
    for i in range(30):
        p2, f2, m2 = augment_cloud(gen(i), pos, feat, mask, n, with_scale=with_scale)
        assert bool(torch.isfinite(p2).all())
        app, kept = f2[n:][m2[n:]], f2[:n][m2[:n]]
        if len(app):
            assert (app[:, None, 0] - kept[None, :, 0]).abs().min(1).values.max() < 0.2
            checked += len(app)
    assert checked > 0


def test_augment_batch_shapes_y_and_independent_clouds():
    n = 200
    pos, feat, mask = clouds(8, n)
    batch = CloudBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                       mask=torch.from_numpy(mask), y=torch.ones(8, 4))
    out = augment_batch(gen(5), batch, n)
    assert out.pos.shape == batch.pos.shape and torch.equal(out.y, batch.y)
    assert not torch.allclose(out.pos[0], out.pos[1])
    counts = out.mask.sum(1)
    assert int(counts.min()) >= int(0.9 * n) and int(counts.max()) <= int(1.1 * n) + 1


def test_device_and_numpy_distributions_agree():
    """The masked transforms and the port's copy of the host numpy transforms
    (the reference's semantics) keep as many points on average."""
    rng = np.random.default_rng(0)
    coords, x = rng.normal(size=(200, 3)) * 5, rng.normal(size=(200, 1))
    pos, feat, mask = clouds(1, 200)
    pos[0, :200], feat[0, :200] = coords, x
    p, f, m = (torch.from_numpy(a[0]) for a in (pos, feat, mask))
    dev = [int(augment_cloud(gen(i), p, f, m, 200)[2].sum()) for i in range(25)]
    host = [len(numpy_augment.augment(rng, coords, x)[0]) for _ in range(25)]
    assert 180 <= min(dev) and max(dev) <= 220 and 180 <= min(host) and max(host) <= 220
    assert abs(np.mean(dev) - np.mean(host)) < 8
