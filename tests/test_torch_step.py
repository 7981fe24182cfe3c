"""One training step of the port (``Trainer.step``) against the body of the JAX
package's ``Trainer._step_core`` on the same weights through the bridge.

JAX side: ``jax.value_and_grad`` over ``model.apply(train=True,
mutable=["batch_stats"])`` with no ``fps`` stream (FPS starts at the first
valid point) and ``dropout_probability=0``, then ``make_optimizer(hp)``.
Port side: ``Trainer.step`` without a generator, which starts FPS at the
first valid point too. Compared: the loss, every gradient, the new BatchNorm
running statistics and the Adam-updated parameters (``to_flax_variables``).

Batch: 8 clouds of 640 points. At 2 clouds the head's train-mode BatchNorm
(statistics over the batch's rows) outputs ±1 whatever its input, so every
gradient upstream of it is float noise; at 4 its backward still amplifies
rounding ~3000-fold. At 8, float32 gradients agree to ~3e-5.

Some biases have a true gradient of 0: each hidden layer's (a BatchNorm
follows), each SA MLP's last layer's (the max passes a constant shift on to
the next layer's BatchNorm) and the head's first BatchNorm's (the head has no
activation). Adam's first step moves such a bias by ~±lr whatever the noise
is, so they are held by the size of their gradient, not by their step.
"""

import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.train.loss import weighted_component_mse as jax_loss
from dl_biomass_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dl_biomass_tpu_torch.bridge import to_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.ops import pooling, sa_train_kernel
from dl_biomass_tpu_torch.train.trainer import Trainer
from torch_port_helpers import batches, models

torch.set_num_threads(1)

B, N, VALID = 8, 640, [640, 517, 600, 300, 640, 420, 333, 640]
LR = TrainConfig().hp.lr
_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def zero_gradient(name: str) -> bool:
    m = re.match(r"(.*)\.lin(\d)\.bias$", name)
    return bool(m and (int(m.group(2)) < 2 or m.group(1) != "head")) or name == "head.bn0.bias"


def flat(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from flat(x, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(x, np.float64)


def torch_name(path):
    return ".".join(path[:-1]) + "." + _NAMES[path[-1]]


def step_pair(preset, dtype, act, seed, **model_kwargs):
    """Both steps on the same clouds and weights; returns a dict of results."""
    jb, tb = batches(seed, B, N, VALID)
    y = (np.random.default_rng(9).normal(size=(B, 4)) * 3).astype(np.float32)
    jb = JaxBatch(pos=jb.pos, feat=jb.feat, mask=jb.mask, y=jnp.asarray(y))
    tb = CloudBatch(pos=tb.pos, feat=tb.feat, mask=tb.mask, y=torch.from_numpy(y))
    jm, v, tm = models(preset, dtype, jb, dropout_probability=0.0, activation_function=act,
                       **model_kwargs)
    cfg = TrainConfig()

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jax_loss(out, jb.y, jnp.any(jb.mask, axis=1)), upd

    (jloss, upd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    tx = jax_make_optimizer(cfg.hp)
    u, _ = tx.update(jgrads, tx.init(v["params"]), v["params"])
    jnew = optax.apply_updates(v["params"], u)

    gaps = []
    real = pooling.first_argmax

    def record_gap(filled, raw, dim):  # how far each max is from a tie
        top2 = filled.float().topk(2, dim=dim).values
        a, b = top2.select(dim, 0), top2.select(dim, 1)
        ok = torch.isfinite(b) & (a != 0)
        gaps.append(float(((a - b).abs() / a.abs())[ok].min()))
        return real(filled, raw, dim)

    # kernel 6's plain passes bind first_argmax by name
    with mock.patch.object(pooling, "first_argmax", record_gap), \
            mock.patch.object(sa_train_kernel, "first_argmax", record_gap):
        tloss = Trainer(tm, cfg, device="cpu").step(tb)
    tgrads = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
    tv = to_flax_variables(tm)
    return dict(jloss=float(jloss), tloss=float(tloss), jgrads=dict(flat(jgrads)),
                tgrads=tgrads, jstats=dict(flat(upd["batch_stats"])),
                tstats=dict(flat(tv["batch_stats"])), old=dict(flat(v["params"])),
                jnew=dict(flat(jnew)), tnew=dict(flat(tv["params"])), gaps=gaps)


def port_grad(r, path):
    g = r["tgrads"][torch_name(path)]
    return g.T if path[-1] == "kernel" else g


@pytest.mark.parametrize("preset,seed,model_kwargs", [
    pytest.param("production", 0, {}, id="production-0"),
    pytest.param("parity", 1, {}, id="parity-1"),
    # SA2 gathers features and positions by one index (kernel 4c); its
    # features' gradient is the scatter-add backward (4b)
    pytest.param("production", 1, dict(split_first_layer=False), id="production-1-unsplit"),
    # SA1 and SA2 on kernel 6's plain passes, forward (F1-F3) and backward
    # (B1-B3); measured: gradients 2.1e-5, loss 6.5e-7
    pytest.param("production", 1, dict(fused_sa=True), id="production-1-fused_sa"),
])
def test_float32_step_matches_jax(preset, seed, model_kwargs):
    """float32 with ELU, a smooth activation: a ReLU input within rounding of
    0 would take the other branch in one package and move one element's
    gradient whole. The inputs keep every max at least 1e-6 (relative) from a
    tie, well clear of the ~1e-6 float32 agreement of the forward, so no
    argmax flips either (asserted). Then loss, gradients, statistics and
    updates agree at 1e-4 (measured: ~3e-5 gradients, 2e-6 loss)."""
    r = step_pair(preset, "float32", "ELU", seed, **model_kwargs)
    assert min(r["gaps"]) >= 1e-6
    assert abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"])
    top = max(np.abs(g).max() for g in r["jgrads"].values())
    for path, jg in r["jgrads"].items():
        tg = port_grad(r, path)
        if zero_gradient(torch_name(path)):
            assert np.abs(tg).max() <= 1e-5 * top and np.abs(jg).max() <= 1e-5 * top
            continue
        assert np.abs(tg - jg).max() <= 1e-4 * np.abs(jg).max(), torch_name(path)
        # Adam's first step: equal where the gradient's sign is well defined
        sure = np.abs(jg) > 1e-3 * np.abs(jg).max()
        dj, dt = r["jnew"][path] - r["old"][path], r["tnew"][path] - r["old"][path]
        assert np.abs(dt - dj)[sure].max() <= 1e-3 * LR, torch_name(path)
    for path, js in r["jstats"].items():
        assert np.abs(r["tstats"][path] - js).max() <= 1e-4 * np.abs(js).max()
    for path in r["old"]:
        if zero_gradient(torch_name(path)):
            for new in (r["jnew"], r["tnew"]):
                assert np.abs(new[path] - r["old"][path]).max() <= LR * 1.001


@pytest.mark.parametrize("preset", ["production", "parity"])
def test_bfloat16_step_agrees_with_jax(preset):
    """bf16 with ReLU, the production numerics. Activations keep 8 significant
    bits, so the two packages' forwards differ by ~1e-3 (another summation
    order rounds a value one step the other way), and each such step that
    changes a max's argmax or a ReLU's branch moves a gradient element whole;
    the head's BatchNorm over 8 rows amplifies the rest. Measured at these
    inputs: loss 4.7e-3 apart, statistics 1.6e-3, gradients 0.26 apart in
    relative L2 norm, Adam steps of the same sign on >= 89% of each tensor.
    The bounds: 1e-2, 1e-2, 0.35 and 85%."""
    r = step_pair(preset, "bfloat16", "ReLU", 0)
    assert abs(r["tloss"] - r["jloss"]) <= 1e-2 * abs(r["jloss"])
    top = max(np.abs(g).max() for g in r["jgrads"].values())
    for path, jg in r["jgrads"].items():
        tg = port_grad(r, path)
        if zero_gradient(torch_name(path)):
            assert np.abs(tg).max() <= 2e-2 * top and np.abs(jg).max() <= 2e-2 * top
            continue
        assert np.linalg.norm(tg - jg) <= 0.35 * np.linalg.norm(jg), torch_name(path)
        dj, dt = r["jnew"][path] - r["old"][path], r["tnew"][path] - r["old"][path]
        assert np.mean(np.sign(dj) == np.sign(dt)) >= 0.85, torch_name(path)
        assert np.abs(dt).max() <= LR * 1.001
    for path, js in r["jstats"].items():
        assert np.abs(r["tstats"][path] - js).max() <= 1e-2 * np.abs(js).max()
