"""The port's feature-propagation decoder against the JAX package's
(``models/decoder.py``): ``knn_interpolate``, ``FPModule`` and the per-point
``PointNet2Segmentor`` on the same weights through the bridge, in float32;
and ``dump_predicted_las`` read back. The JAX segmentor's SA layers run its
plain selection on the CPU (exact FPS, exact first-K ball query, the unsplit
SA2), the port's its kernels' plain versions (SA2 split, kernel 4a's); the
segmentor runs ELU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.models import decoder as jax_decoder
from dl_biomass_tpu_torch.bridge import from_flax_variables, to_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.io.reader import read_las
from dl_biomass_tpu_torch.models.decoder import (FPModule, PointNet2Segmentor,
                                                 dump_predicted_las, knn_interpolate)
from torch_port_helpers import F32_RTOL, batches, rel_err

torch.set_num_threads(1)

B, N, VALID = 2, 640, [640, 517]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("m_valid", [[40, 25], [40, 2]])
def test_knn_interpolate_matches_jax(m_valid):
    """Inverse-distance weights over the 3 nearest valid sources; a cloud with
    2 valid sources weighs its third neighbour 0; invalid targets get 0."""
    rng = np.random.default_rng(0)
    fs = rng.normal(size=(2, 40, 5)).astype(np.float32)
    ps = (rng.normal(size=(2, 40, 3)) * 2).astype(np.float32)
    pd = (rng.normal(size=(2, 100, 3)) * 2).astype(np.float32)
    sm = np.arange(40)[None] < np.asarray(m_valid)[:, None]
    dm = rng.random((2, 100)) < 0.9
    pd[0, 3] = ps[0, 7]  # a target on a source: that source takes (almost) all
    want = jax_decoder.knn_interpolate(*(jnp.asarray(a) for a in (fs, ps, sm, pd, dm)))
    got = knn_interpolate(*_t(fs, ps, sm, pd, dm))
    assert rel_err(got.numpy(), np.asarray(want)) <= F32_RTOL
    assert (got.numpy()[~dm] == 0).all()
    np.testing.assert_allclose(got[0, 3].numpy(), fs[0, 7], rtol=1e-6, atol=1e-6)


def test_knn_interpolate_gradient_flows_to_the_features_only():
    rng = np.random.default_rng(1)
    fs, ps, pd = (rng.normal(size=s).astype(np.float32) for s in ((1, 12, 4), (1, 12, 3),
                                                                 (1, 30, 3)))
    sm, dm = np.ones((1, 12), bool), np.ones((1, 30), bool)
    jg = jax.grad(lambda f: jnp.sum(jax_decoder.knn_interpolate(
        f, *(jnp.asarray(a) for a in (ps, sm, pd, dm))) ** 2))(jnp.asarray(fs))
    tf = torch.from_numpy(fs).requires_grad_(True)
    (knn_interpolate(tf, *_t(ps, sm, pd, dm)) ** 2).sum().backward()
    assert rel_err(tf.grad.numpy(), np.asarray(jg)) <= F32_RTOL


def test_fp_module_matches_jax_in_train_and_eval():
    rng = np.random.default_rng(2)
    args = [rng.normal(size=(2, 30, 16)), rng.normal(size=(2, 30, 3)),
            rng.random((2, 30)) < 0.9, rng.normal(size=(2, 90, 8)),
            rng.normal(size=(2, 90, 3)), rng.random((2, 90)) < 0.9]
    args = [a.astype(np.float32) if a.dtype != bool else a for a in args]
    jm = jax_decoder.FPModule([16 + 8, 32, 32])
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), *map(jnp.asarray, args), train=True))
    tm = FPModule([16 + 8, 32, 32])
    tm.load_state_dict(from_flax_variables(v))
    dm = args[-1][..., None]
    for train in (False, True):
        out = jm.apply(v, *map(jnp.asarray, args), train=train,
                       mutable=["batch_stats"] if train else False)
        want = np.asarray(out[0] if train else out)
        got = tm(*_t(*args), train=train).detach().numpy()
        assert rel_err(np.where(dm, got, 0), np.where(dm, want, 0)) <= F32_RTOL, train


@pytest.fixture(scope="module")
def segmentor_pair():
    jb, tb = batches(5, B, N, VALID)
    # ELU, a smooth activation: under ReLU an input within rounding of 0 takes
    # the other branch in one package and moves one element's gradient whole
    jm = jax_decoder.PointNet2Segmentor(num_features=1, activation_function="ELU")
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jb, train=True))
    rng = np.random.default_rng(6)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(size=x.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, size=x.shape)).astype(np.float32),
        v["batch_stats"])
    tm = PointNet2Segmentor(num_features=1, activation_function="ELU")
    tm.load_state_dict(from_flax_variables(v))
    return jm, v, tm, jb, tb


def test_segmentor_eval_matches_apply(segmentor_pair):
    jm, v, tm, jb, tb = segmentor_pair
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb)
    assert tuple(got.shape) == (B, N, 1) and got.dtype == torch.float32
    assert (got.numpy()[~tb.mask.numpy()] == 0).all()
    assert rel_err(got.numpy(), want) <= F32_RTOL


def test_segmentor_train_step_matches_jax(segmentor_pair):
    """Train mode: the per-point output, the gradients of its squared sum and
    the new running statistics (SA2's gather backward is kernel 4b's plain
    version)."""
    jm, v, tm, jb, tb = segmentor_pair

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, upd)

    (_, (jout, upd)), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    state = {k: x.clone() for k, x in tm.state_dict().items()}
    tm.zero_grad()
    out = tm(tb, train=True)
    (out ** 2).sum().backward()
    assert rel_err(out.detach().numpy(), np.asarray(jout)) <= F32_RTOL
    stats = dict(_flat(to_flax_variables(tm)["batch_stats"]))
    for path, want in _flat(upd["batch_stats"]):
        assert rel_err(stats[path], want) <= F32_RTOL, path
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(jg))
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    for path, want in _flat(jg):
        mods, leaf = path.split(".")[:-1], path.split(".")[-1]
        name = ".".join(mods) + "." + {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        g = grads[name].T if leaf == "kernel" else grads[name]
        # every Linear's bias but the head's last has a true gradient of 0: a
        # BatchNorm follows it, or follows the max, interpolation or concat
        # that passes its shift on
        if leaf == "bias" and mods[-1].startswith("lin") and name != "head.lin1.bias":
            assert max(np.abs(g).max(), np.abs(want).max()) <= 1e-5 * top, name
            continue
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max(), name
    tm.load_state_dict(state)


def _flat(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _flat(x, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(x, np.float64)


def test_dump_predicted_las_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 20, size=(50, 3))
    mask = rng.random(50) < 0.8
    ref, pred = rng.normal(size=50), torch.from_numpy(rng.normal(size=(50, 1)))
    path = tmp_path / "ep1_0.las"
    dump_predicted_las(path, torch.from_numpy(pos), torch.from_numpy(mask), ref, pred)
    xyz, attrs = read_las(str(path), get_attributes=True, filter_height=0)
    np.testing.assert_allclose(xyz, pos[mask], atol=2.5e-4)
    np.testing.assert_allclose(attrs["ref"], ref[mask])
    np.testing.assert_allclose(attrs["pred"], pred.numpy()[:, 0][mask])
