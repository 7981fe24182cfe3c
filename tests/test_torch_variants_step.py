"""One float32 training step of the port's model variants (``msg``,
``analytic_bn``, ``pointnet2_v2``) against the JAX package on the same
weights through the bridge: ``Trainer.step`` (ELU, no head dropout, FPS from
the first valid point) against ``jax.value_and_grad`` of
``model.apply(train=True)`` — the loss, every gradient and the new running
statistics, in ``tests/test_torch_step.py``'s bounds."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.train.loss import weighted_component_mse as jax_loss
from dl_biomass_tpu_torch.bridge import to_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.train.trainer import Trainer
from test_torch_variants import VARIANTS
from torch_port_helpers import batches, models

torch.set_num_threads(1)

STEP_B, STEP_N = 8, 256
STEP_VALID = [256, 200, 240, 130, 256, 170, 150, 256]


def zero_gradient(name: str) -> bool:
    """Biases whose true gradient is 0 (tests/test_torch_step.py): each hidden
    layer's, each SA MLP's last layer's, and the head's first BatchNorm's."""
    m = re.match(r"(.*)\.lin(\d)\.bias$", name)
    return bool(m and (int(m.group(2)) < 2 or m.group(1) != "head")) or name == "head.bn0.bias"


def flat(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from flat(x, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(x, np.float64)


def step_pair(kwargs):
    jb, tb = batches(3, STEP_B, STEP_N, STEP_VALID)
    y = (np.random.default_rng(9).normal(size=(STEP_B, 4)) * 3).astype(np.float32)
    jb = JaxBatch(pos=jb.pos, feat=jb.feat, mask=jb.mask, y=jnp.asarray(y))
    tb = CloudBatch(pos=tb.pos, feat=tb.feat, mask=tb.mask, y=torch.from_numpy(y))
    jm, v, tm = models("production", "float32", jb, dropout_probability=0.0,
                       activation_function="ELU", **kwargs)

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jax_loss(out, jb.y, jnp.any(jb.mask, axis=1)), upd

    (jloss, upd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    trainer = Trainer(tm, TrainConfig(), device="cpu")
    tloss = trainer.step(tb)
    tgrads = {}
    for n, p in tm.named_parameters():
        g = p.grad.double().numpy()
        tgrads[n] = g.T if g.ndim == 2 else g  # kernels are (in, out) in flax
    return (float(jloss), float(tloss), dict(flat(jgrads)), tgrads,
            dict(flat(upd["batch_stats"])), dict(flat(to_flax_variables(tm)["batch_stats"])))


def _torch_name(path: str) -> str:
    parts = path.split(".")
    return ".".join(parts[:-1]) + "." + {"kernel": "weight", "scale": "weight"}.get(
        parts[-1], parts[-1])


@pytest.mark.parametrize("variant", ["msg", "analytic_bn", "v2"])
def test_float32_step_matches_jax(variant):
    """Loss within 1e-5, each gradient within 1e-4 of its largest, the new
    running statistics within 1e-4 (tests/test_torch_step.py's bounds)."""
    jloss, tloss, jgrads, tgrads, jstats, tstats = step_pair(VARIANTS[variant])
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    top = max(np.abs(g).max() for g in jgrads.values())
    assert len(jgrads) == len(tgrads)
    for path, jg in jgrads.items():
        name = _torch_name(path)
        tg = tgrads[name]
        if zero_gradient(name):
            assert np.abs(tg).max() <= 1e-5 * top and np.abs(jg).max() <= 1e-5 * top, name
            continue
        assert np.abs(tg - jg).max() <= 1e-4 * np.abs(jg).max(), name
    for path, js in jstats.items():
        assert np.abs(tstats[path] - js).max() <= 1e-4 * np.abs(js).max(), path
