"""The ported PointNet2Regressor against model.apply(train=False) of the JAX
package, on the same weights through the bridge."""

import dataclasses

import numpy as np
import pytest
import torch

from dl_biomass_tpu.core import config as jax_config
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.core import config
from dl_biomass_tpu_torch.models.pointnet2 import build_model
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

# B=2, N=640: SA1 picks 128 centroids and SA2 32, and both take 8 sectors
B, N, VALID = 2, 640, [640, 517]


@pytest.fixture(scope="module")
def batch_pair():
    return batches(0, B, N, VALID)


@pytest.mark.parametrize("preset,dtype,rtol", [
    ("production", "float32", F32_RTOL),
    ("production", "bfloat16", BF16_RTOL),
    ("parity", "float32", F32_RTOL),
    ("parity", "bfloat16", BF16_RTOL),
])
def test_eval_forward_matches_apply(batch_pair, preset, dtype, rtol):
    jb, tb = batch_pair
    jm, v, tm = models(preset, dtype, jb)
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 4)
    assert rel_err(got.numpy(), want) <= rtol


def test_coordinates_as_features_matches_apply(batch_pair):
    """num_features=0: the coordinates stand in (three captured feature planes)."""
    jb, tb = batch_pair
    jm, v, tm = models("production", "float32", jb, num_features=0)
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb).numpy()
    assert rel_err(got, want) <= F32_RTOL


def test_bridged_model_counts_reference_parameters(batch_pair):
    jb, _ = batch_pair
    _, v, tm = models("production", "bfloat16", jb)
    assert sum(p.numel() for p in tm.parameters()) == 953_732
    n_flax = sum(int(np.prod(x.shape)) for x in _leaves(v["params"]))
    assert n_flax == 953_732


def _leaves(tree):
    for x in tree.values():
        yield from (_leaves(x) if isinstance(x, dict) else [x])


def test_bridge_transposes_kernels_and_renames_batch_norm(batch_pair):
    jb, _ = batch_pair
    _, v, tm = models("production", "float32", jb)
    sd = from_flax_variables(v)
    assert set(sd) == set(tm.state_dict())
    kernel = v["params"]["sa2"]["mlp"]["lin0"]["kernel"]  # (131, 128)
    np.testing.assert_array_equal(sd["sa2.mlp.lin0.weight"].numpy(), kernel.T)
    np.testing.assert_array_equal(sd["head.bn1.weight"].numpy(),
                                  v["params"]["head"]["bn1"]["scale"])
    np.testing.assert_array_equal(sd["sa1.mlp.bn0.running_var"].numpy(),
                                  v["batch_stats"]["sa1"]["mlp"]["bn0"]["var"])


def test_build_model_follows_config():
    prod = build_model(config.TrainConfig(), num_features=1)
    assert prod.compute_dtype == torch.bfloat16
    assert prod.fast_group and prod.fast_fps and prod.split_first_layer
    assert not prod.exact_selection
    par = build_model(config.TrainConfig().apply_parity(), num_features=1)
    assert par.compute_dtype == torch.float32 and par.exact_selection
    assert not (par.fast_group or par.fast_fps)
    cfg = config.TrainConfig()
    cfg.model.msg = True
    with pytest.raises(NotImplementedError, match="msg"):
        build_model(cfg, num_features=1)


def test_config_copy_matches_reference():
    """The port's copy of the config dataclasses keeps every field and default."""
    for name in ("HyperParams", "ModelConfig", "DataConfig", "MeshConfig", "TrainConfig"):
        ours, ref = getattr(config, name), getattr(jax_config, name)
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert config.TrainConfig().to_dict() == jax_config.TrainConfig().to_dict()
    assert (config.TrainConfig().apply_parity().to_dict()
            == jax_config.TrainConfig().apply_parity().to_dict())
    over = ["--hp.lr", "0.01", "model.voxel_channels=64,128,256"]
    assert (config.TrainConfig().with_overrides(over).to_dict()
            == jax_config.TrainConfig().with_overrides(over).to_dict())
