"""Shared set-up for the tests that hold the PyTorch port against the JAX package:
one JAX model, its variables as numpy arrays (BatchNorm running statistics
moved away from identity, so that folding does real work), and the ported
model with the same weights through the bridge; and the JAX package's tools,
loaded by path, with their Pallas bodies run in interpret mode."""

import importlib.util
from functools import partial
from pathlib import Path
from unittest import mock

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.models import PointNet2Regressor as JaxModel
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor

# flags of the production model (core/config.py defaults) and of the parity preset
PRESETS = {
    "production": dict(fast_group=True, fast_fps=True),
    "parity": dict(exact_selection=True),
}
# the bf16 bound for comparisons across the two packages: max |diff| / max |y|.
# bf16 keeps 8 significant bits (a rounding step is 2^-8 = 3.9e-3 of a value);
# the two packages accumulate matmuls in another order, so an f32 sum that
# lands near a bf16 rounding boundary rounds the other way in one of them, and
# that step travels through the remaining layers and max pools. 1e-2 allows
# such steps in the output; measured differences are around 1e-3 or 0.
BF16_RTOL = 1e-2
F32_RTOL = 1e-4


def batches(seed, b, n, valid):
    """The same random clouds as a JAX batch and a port batch (CPU)."""
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 3).astype(np.float32)
    feat = rng.normal(size=(b, n, 1)).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(valid)[:, None]
    jb = JaxBatch(pos=jnp.asarray(pos), feat=jnp.asarray(feat), mask=jnp.asarray(mask))
    tb = CloudBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask))
    return jb, tb


def models(preset, dtype, jax_batch, num_features=1, seed=0, **kwargs):
    """(JAX model, numpy variables, bridged port model) with the JAX package's
    kernels on (use_pallas=True: interpret mode on the CPU); ``kwargs`` go to
    both constructors."""
    flags = dict(PRESETS[preset], **kwargs)
    jm = JaxModel(num_features=num_features, use_pallas=True,
                  compute_dtype=getattr(jnp, dtype), **flags)
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(seed)}, jax_batch,
                                         train=False))
    rng = np.random.default_rng(seed + 100)

    def stat(path, x):
        if path[-1].key == "mean":
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)

    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}
    tm = PointNet2Regressor(num_features=num_features, compute_dtype=getattr(torch, dtype),
                            **flags)
    tm.load_state_dict(from_flax_variables(v))
    return jm, v, tm


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


ROOT = Path(__file__).resolve().parent.parent


def jax_tool(name: str):
    """The JAX package's tools/<name>.py, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpreted():
    """pallas_call in interpret mode: the TPU bodies run on the CPU."""
    return mock.patch.object(jpl, "pallas_call", partial(jpl.pallas_call, interpret=True))
