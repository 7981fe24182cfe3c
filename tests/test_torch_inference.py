"""The port's serving engine against compile_inference of the JAX package, on
the same weights through the bridge; its invariants; its device rule."""

from unittest import mock

import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.models.inference import compile_inference as jax_compile_inference
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.models.inference import compile_inference, fold_bn
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

B, N, VALID = 2, 640, [640, 517]


@pytest.fixture(scope="module")
def batch_pair():
    return batches(1, B, N, VALID)


@pytest.mark.parametrize("preset,dtype,rtol", [
    ("production", "float32", F32_RTOL),
    ("production", "bfloat16", BF16_RTOL),
    ("parity", "float32", F32_RTOL),
    ("parity", "bfloat16", BF16_RTOL),
])
def test_serving_matches_jax_engine(batch_pair, preset, dtype, rtol):
    jb, tb = batch_pair
    jm, v, tm = models(preset, dtype, jb)
    want = np.asarray(jax_compile_inference(jm, v)(jb))
    got = compile_inference(tm, device="cpu")(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 4)
    assert rel_err(got.numpy(), want) <= rtol


def test_ragged_mask_matches_jax_engine():
    """Clouds of 640, 300 and 129 valid points in one padded batch."""
    jb, tb = batches(2, 3, N, [640, 300, 129])
    jm, v, tm = models("production", "float32", jb)
    want = np.asarray(jax_compile_inference(jm, v)(jb))
    got = compile_inference(tm, device="cpu")(tb).numpy()
    assert rel_err(got, want) <= F32_RTOL


def test_pad_garbage_and_repeat_leave_predictions_identical(batch_pair):
    jb, tb = batch_pair
    _, _, tm = models("production", "bfloat16", jb)
    serve = compile_inference(tm, device="cpu")
    want = serve(tb)
    pad = ~tb.mask
    rng = np.random.default_rng(5)
    garbage = CloudBatch(pos=tb.pos.clone(), feat=tb.feat.clone(), mask=tb.mask)
    garbage.pos[pad] = torch.from_numpy(rng.uniform(-1e4, 1e4, (int(pad.sum()), 3))).float()
    garbage.feat[pad] = torch.from_numpy(rng.uniform(-1e4, 1e4, (int(pad.sum()), 1))).float()
    assert torch.equal(serve(garbage), want)
    assert torch.equal(serve(tb), want)


def test_from_numpy_pads_like_the_jax_package():
    rng = np.random.default_rng(3)
    pos = [rng.normal(size=(n, 3)).astype(np.float32) for n in (100, 300)]
    feat = [rng.normal(size=(n, 1)).astype(np.float32) for n in (100, 300)]
    y = rng.normal(size=(2, 4)).astype(np.float32)
    ours = CloudBatch.from_numpy(pos, feat, y, device="cpu")
    ref = JaxBatch.from_numpy(pos, feat, y)
    assert ours.num_points == 384 and ours.num_features == 1
    for a in ("pos", "feat", "mask", "y"):
        np.testing.assert_array_equal(getattr(ours, a).numpy(), np.asarray(getattr(ref, a)))
    np.testing.assert_array_equal(ours.valid_counts().numpy(), [100, 300])


def test_default_device_raises_without_a_card():
    """device=None means the card; without one the entry points raise rather
    than run on the CPU unasked."""
    model = PointNet2Regressor(num_features=1)
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_inference(model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CloudBatch.from_numpy([np.zeros((4, 3), np.float32)], [np.zeros((4, 1), np.float32)])


@pytest.mark.parametrize("kwargs,model_kwargs,match", [
    # fused_eval needs the stratified SA1 path, as in the JAX package
    (dict(fused_eval=True), dict(exact_selection=True), "fused_eval"),
    (dict(mesh=object()), {}, "ROADMAP A.8"),
    (dict(fused_eval=True), dict(fast_group=False), "fused_eval"),
    ({}, dict(activation_function="ELU"), "ReLU"),
])
def test_unported_options_raise(kwargs, model_kwargs, match):
    model = PointNet2Regressor(num_features=1, **model_kwargs)
    with pytest.raises(NotImplementedError, match=match):
        compile_inference(model, device="cpu", **kwargs)


def test_fold_bn_is_the_eval_affine():
    rng = np.random.default_rng(4)
    w, b, scale, bias, mean = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                               for s in ((8, 16), (16,), (16,), (16,), (16,)))
    var = torch.from_numpy(rng.uniform(0.5, 2, 16).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    want = ((x @ w + b) - mean) / torch.sqrt(var + 1e-5) * scale + bias
    wf, bf = fold_bn(w, b, scale, bias, mean, var)
    torch.testing.assert_close(x @ wf + bf, want, rtol=2e-5, atol=1e-5)
