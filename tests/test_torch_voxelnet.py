"""The port's voxel family against the JAX package: ``ops/voxelize.py``
(``voxelize`` against the numpy oracle and JAX's: counts exact, sums within
1e-6 of the oracle's; ``voxel_select_first`` index-equal to JAX's and to the
host ``io/resample.voxel_downsample``, also past the JAX package's int32 key
envelope) and ``VoxelNet`` against ``model.apply`` on an even and an odd
grid, on the same weights through the bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.models.voxelnet import VoxelNet as JaxVoxelNet
from dl_biomass_tpu.ops import voxelize as jax_voxelize
from dl_biomass_tpu_torch.bridge import from_flax_variables, to_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.resample import voxel_downsample
from dl_biomass_tpu_torch.models.pointnet2 import build_model
from dl_biomass_tpu_torch.models.voxelnet import VoxelNet, same_padding
from dl_biomass_tpu_torch.ops.voxelize import voxel_select_first, voxelize, voxelize_reference
from dl_biomass_tpu_torch.train.trainer import Trainer
from torch_port_helpers import BF16_RTOL, F32_RTOL, rel_err

torch.set_num_threads(1)


def clouds(seed, b, n, f=1, scale=4.0, keep=0.8):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * scale).astype(np.float32)
    feat = rng.normal(size=(b, n, f)).astype(np.float32)
    mask = rng.random((b, n)) < keep
    return pos, feat, mask


# ---- voxelize ------------------------------------------------------------------------------


@pytest.mark.parametrize("extent", [None, 12.0])
def test_voxelize_matches_jax_and_the_oracle(extent):
    pos, feat, mask = clouds(0, 2, 300, f=2)
    got = voxelize(torch.from_numpy(pos), torch.from_numpy(feat), torch.from_numpy(mask),
                   grid=8, extent=extent)
    want = jax_voxelize.voxelize(jnp.asarray(pos), jnp.asarray(feat), jnp.asarray(mask),
                                 grid=8, extent=extent)
    oracle = voxelize_reference(pos, feat, mask, grid=8, extent=extent)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # counts exact
    np.testing.assert_array_equal(got[0].numpy(), oracle[0])
    for g, w, o in zip(got[1:], want[1:], oracle[1:]):
        np.testing.assert_allclose(g.numpy(), o, rtol=0, atol=1e-6)
        # XLA folds the fixed extent's division into a multiply, which moves
        # JAX's offsets off the oracle's by up to 2.4e-6 (its own test holds
        # it to 1e-5); the port divides as the oracle does
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_voxelize_without_features():
    pos, _, _ = clouds(1, 1, 64, keep=1.1)
    mask = torch.ones(1, 64, dtype=torch.bool)
    counts, fs, os_ = voxelize(torch.from_numpy(pos), None, mask, grid=4)
    want = jax_voxelize.voxelize(jnp.asarray(pos), None, jnp.ones((1, 64), bool), grid=4)
    assert tuple(fs.shape) == (1, 4, 4, 4, 0) and float(counts.sum()) == 64
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(os_.numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)


def test_voxelize_feature_gradient_is_jaxs():
    """The scatter-add's gradient is a gather: every valid point's feature
    gets its voxel's cotangent, every pad point's gets 0."""
    pos, feat, mask = clouds(2, 1, 32, f=2)
    jg = jax.grad(lambda f: jnp.sum(jax_voxelize.voxelize(
        jnp.asarray(pos), f, jnp.asarray(mask), grid=4)[1] ** 2))(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    (voxelize(torch.from_numpy(pos), tf, torch.from_numpy(mask), grid=4)[1] ** 2).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert (tf.grad.numpy()[0][~mask[0]] == 0).all()


# ---- voxel_select_first --------------------------------------------------------------------


@pytest.mark.parametrize("n_keep", [40, 400])
def test_voxel_select_first_is_jaxs_and_the_hosts(n_keep):
    pos, _, mask = clouds(3, 3, 300, scale=3.0, keep=0.9)
    idx, out_mask = voxel_select_first(torch.from_numpy(pos), torch.from_numpy(mask),
                                       voxel_size=0.5, n_keep=n_keep)
    jidx, jmask = jax_voxelize.voxel_select_first(jnp.asarray(pos), jnp.asarray(mask),
                                                  voxel_size=0.5, n_keep=n_keep)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(jmask))
    for b in range(3):  # the host path over the valid points, in original indices
        valid = np.flatnonzero(mask[b])
        host = valid[voxel_downsample(pos[b][valid], 0.5)][:n_keep]
        np.testing.assert_array_equal(idx[b][out_mask[b]].numpy(), host)


def test_voxel_select_first_past_the_int32_envelope_is_the_hosts():
    """A plot spanning 700 m on every axis at 0.35 m voxels (2000 voxels an
    axis, 8e9 in all): the JAX package's int32 key wraps (ROADMAP C.1), and
    voxels (0, 0, 0) and (1073, 1483, 1296), whose keys differ by exactly
    2^32, become one; the port's int64 key keeps both, as the host path does."""
    rng = np.random.default_rng(4)
    vox = np.concatenate([[[0, 0, 0], [1073, 1483, 1296], [1999, 1999, 1999]],
                          rng.integers(0, 2000, size=(997, 3))])
    vox = np.concatenate([vox, vox[rng.permutation(1000)[:500]]])  # repeated voxels
    pos = ((vox + rng.uniform(0.2, 0.8, vox.shape)) * 0.35).astype(np.float32)[None]
    mask = np.ones(pos.shape[:2], bool)
    n = pos.shape[1]
    idx, out_mask = voxel_select_first(torch.from_numpy(pos), torch.from_numpy(mask),
                                       voxel_size=0.35, n_keep=n)
    host = voxel_downsample(pos[0], 0.35)
    assert {0, 1} <= set(host.tolist()) and len(host) < n
    np.testing.assert_array_equal(idx[0][out_mask[0]].numpy(), host)
    jidx, jmask = jax_voxelize.voxel_select_first(jnp.asarray(pos), jnp.asarray(mask),
                                                  voxel_size=0.35, n_keep=n)
    wrapped = np.asarray(jidx)[0][np.asarray(jmask)[0]]
    assert 1 not in wrapped and len(wrapped) == len(host) - 1


# ---- VoxelNet ------------------------------------------------------------------------------


def pair(grid, dtype="float32", b=3, n=256, channels=(64, 128), seed=0):
    pos, feat, mask = clouds(seed, b, n, scale=5.0)
    y = np.random.default_rng(seed + 1).normal(size=(b, 4)).astype(np.float32)
    jb = JaxBatch(pos=jnp.asarray(pos), feat=jnp.asarray(feat), mask=jnp.asarray(mask),
                  y=jnp.asarray(y))
    tb = CloudBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), y=torch.from_numpy(y))
    jm = JaxVoxelNet(num_features=1, grid=grid, channels=channels,
                     compute_dtype=getattr(jnp, dtype))
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), jb, train=True))
    rng = np.random.default_rng(seed + 2)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(size=x.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, size=x.shape)).astype(np.float32),
        v["batch_stats"])
    tm = VoxelNet(num_features=1, grid=grid, channels=channels,
                  compute_dtype=getattr(torch, dtype))
    tm.load_state_dict(from_flax_variables(v))
    return jm, v, tm, jb, tb


def test_same_padding_is_flaxs():
    assert same_padding(8, 3, 2) == (0, 1) and same_padding(9, 3, 2) == (1, 1)
    assert same_padding(9, 2, 2) == (0, 1) and same_padding(8, 2, 2) == (0, 0)


@pytest.mark.parametrize("grid,dtype,rtol", [(8, "float32", F32_RTOL), (9, "float32", F32_RTOL),
                                             (8, "bfloat16", BF16_RTOL),
                                             (9, "bfloat16", BF16_RTOL)])
def test_eval_forward_matches_apply(grid, dtype, rtol):
    jm, v, tm, jb, tb = pair(grid, dtype)
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 4)
    assert rel_err(got.numpy(), want) <= rtol


@pytest.mark.parametrize("grid", [8, 9])
def test_train_step_matches_jax(grid):
    """Train mode in float32: output, gradients (of a squared sum) and the new
    running statistics, on the bridge's conv kernels."""
    jm, v, tm, jb, tb = pair(grid, b=4)

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jnp.sum((out - jb.y) ** 2), (out, upd)

    (jl, (jout, upd)), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    out = tm(tb, train=True)
    ((out - tb.y) ** 2).sum().backward()
    assert rel_err(out.detach().numpy(), np.asarray(jout)) <= F32_RTOL
    grads = to_flax_variables(_grads_as_module(tm))["params"]
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(jg))
    for mod, leaves in jg.items():
        for key, want in leaves.items():
            if mod.startswith("conv") and key == "bias":  # a BatchNorm follows: gradient 0
                assert max(np.abs(grads[mod][key]).max(), np.abs(want).max()) <= 1e-5 * top
                continue
            assert rel_err(grads[mod][key], np.asarray(want)) <= F32_RTOL, (mod, key)
    stats = to_flax_variables(tm)["batch_stats"]
    for mod, leaves in upd["batch_stats"].items():
        for key, want in leaves.items():
            assert rel_err(stats[mod][key], np.asarray(want)) <= F32_RTOL, (mod, key)


def _grads_as_module(model):
    """A copy of ``model`` whose parameters are its gradients (to map them with
    the bridge's names and layouts)."""
    import copy

    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return g


def test_the_bridge_maps_conv_kernels_and_the_dense_head():
    jm, v, tm, _, _ = pair(8)
    sd = from_flax_variables(v)
    assert set(sd) == set(tm.state_dict())
    k1 = v["params"]["conv1"]["kernel"]  # (3, 3, 3, Cin, Cout)
    assert tuple(sd["conv1.weight"].shape) == (64, tm.voxel_channels, 3, 3, 3)
    assert float(sd["conv1.weight"][5, 2, 0, 1, 2]) == float(k1[0, 1, 2, 2, 5])
    back = to_flax_variables(tm)
    for mod in ("conv1", "conv2", "head", "bn1"):
        for key, want in v["params"][mod].items():
            np.testing.assert_array_equal(back["params"][mod][key], want)
    assert "bias" not in back["params"]["conv1"]


def test_param_count_is_the_probes():
    jm, v, tm, _, _ = pair(8)
    got = sum(p.numel() for p in tm.parameters())
    assert got == tm.param_count() == jm.param_count()
    assert tm.conv1.bias is None and tuple(tm.conv2.weight.shape) == (128, 64, 3, 3, 3)
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v["params"])) == got


def test_pad_invariance():
    _, _, tm, _, tb = pair(8)
    garbage = CloudBatch(pos=torch.where(tb.mask[..., None], tb.pos, 1e6),
                         feat=torch.where(tb.mask[..., None], tb.feat, -333.0), mask=tb.mask)
    with torch.no_grad():
        torch.testing.assert_close(tm(tb), tm(garbage), rtol=0, atol=1e-5)


def test_trainer_loss_falls():
    """The family drops into the unchanged Trainer (family='voxelnet')."""
    cfg = TrainConfig()
    cfg.hp = dataclasses.replace(cfg.hp, batch_size=4, lr=3e-3)
    cfg.model = dataclasses.replace(cfg.model, family="voxelnet", voxel_grid=8,
                                    compute_dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, num_features=1)
    assert isinstance(model, VoxelNet)
    _, _, _, _, tb = pair(8, b=4)
    trainer = Trainer(model, cfg, device="cpu")
    losses = [float(trainer.step(tb, torch.Generator().manual_seed(i))) for i in range(30)]
    assert losses[-1] < 0.7 * losses[0], losses
