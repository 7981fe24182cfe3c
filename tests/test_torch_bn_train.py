"""Kernel 11's arithmetic on the CPU (``ops/bn_train_kernel``): the rule by
which the models take it, its plain passes in float64 against autograd
through ``MaskedBatchNorm.batch_stats`` (the hand-written backward), the
whole step in the working dtypes against the PyTorch chain (the forward bit
for bit), the models' wiring with the rule forced to take the CPU (remat
bit for bit against the plain fused step), and the ``bn.values`` /
``bn.fused`` counters. The kernels themselves run in ``tests/test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models import layers
from dl_biomass_tpu_torch.models.layers import MLP, Dense, MaskedBatchNorm, resolve_activation
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.models.voxelnet import VoxelNet
from dl_biomass_tpu_torch.ops import bn_train_kernel as bk
from dl_biomass_tpu_torch.ops import sum_slices_kernel
from dl_biomass_tpu_torch.train.trainer import Trainer
from dl_biomass_tpu_torch.utils import profiling

torch.set_num_threads(1)

ACTS = [None, "ReLU", "LeakyReLU", "ELU"]
SA1 = (36, 1588, 64, 64)  # the SSG cell's SA1 hidden output, and its mask below
BASE = dict(train=True, act="ReLU", dropout=0.0, mesh=None)


# ---- the rule ------------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mask_shape,dtype,device,kw,want", [
    (SA1, SA1[:3], torch.bfloat16, "cuda", {}, True),  # SA1
    ((36, 397, 64, 128), (36, 397, 64), torch.float32, "cuda", {}, True),  # SA2, float32
    ((4, 16, 16, 16, 64), (4, 16, 16, 16), torch.bfloat16, "cuda", {}, True),  # VoxelNet conv1
    ((4, 7936, 128), (4, 7936), torch.bfloat16, "cuda", {}, True),  # the segmentor's fp1
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(act=None), True),
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(act="None"), True),
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(act="LeakyReLU"), True),
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(act="ELU"), True),
    (SA1, SA1[:3], torch.bfloat16, "cpu", {}, False),  # the CPU: the plain chain
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(train=False), False),  # eval
    (SA1, None, torch.bfloat16, "cuda", {}, False),  # no mask (the head)
    (SA1, SA1[:2], torch.bfloat16, "cuda", {}, False),  # mask of another rank
    (SA1, (36, 1588, 32), torch.bfloat16, "cuda", {}, False),  # of another shape
    ((36, 397, 256), (36, 397), torch.bfloat16, "cuda", {}, False),  # SA3: 397 rows a cloud
    ((36, 1588, 32, 64), (36, 1588, 32), torch.bfloat16, "cuda", {}, True),  # 1588 x 32 rows
    ((36, 33, 64), (36, 33), torch.bfloat16, "cuda", {}, False),  # gcd(33, 64) = 1
    (SA1, SA1[:3], torch.float16, "cuda", {}, False),
    (SA1, SA1[:3], torch.float64, "cuda", {}, False),
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(mesh=object()), False),  # a mesh
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(dropout=0.5), False),
    (SA1, SA1[:3], torch.bfloat16, "cuda", dict(act="GELU"), False),
    ((36, 1588, 64, 96), SA1[:3], torch.bfloat16, "cuda", {}, False),  # 96 channels
    ((36, 1588, 64, 1024), SA1[:3], torch.bfloat16, "cuda", {}, False),
    ((0, 1588, 64, 64), (0, 1588, 64), torch.bfloat16, "cuda", {}, False),  # no cloud
])
def test_takes(shape, mask_shape, dtype, device, kw, want):
    assert bk.takes(shape, mask_shape, dtype, device, **dict(BASE, **kw)) is want


# ---- the plain passes in float64 against autograd -------------------------------------------

def _mask(b, m, seed):
    """(b, m, 64) slots, the last cloud empty, centroid 1 of cloud 0 with one
    valid slot."""
    rng = np.random.default_rng(seed)
    mask = rng.random((b, m, 64)) < 0.7
    mask[-1] = False
    mask[0, 1] = False
    mask[0, 1, 17] = True
    return torch.from_numpy(mask)


def _bn(c, seed):
    bn = MaskedBatchNorm(c)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
    return bn


def _plain64(y, mask, bn, act):
    """The PyTorch chain with ``y`` in float64: batch_stats, fold, normalize,
    act (``MaskedBatchNorm.forward`` casts to float32; here autograd runs in
    float64 where the chain's rows do)."""
    mean, var, cnt = MaskedBatchNorm.batch_stats(y, mask)
    scale, shift = bn.fold(mean, var)
    o = y * scale + shift
    fn = resolve_activation(act)
    return (o if fn is None else fn(o)), mean, var, cnt


def _grads(out, g, *ts):
    return torch.autograd.grad(out, ts, g)


@pytest.mark.parametrize("act", ACTS)
def test_plain_passes_match_autograd_in_float64(act):
    b, m, c = 3, 4, 16
    mask = _mask(b, m, 1)
    gen = torch.Generator().manual_seed(2)
    y = (torch.randn((b, m, 64, c), generator=gen, dtype=torch.float64) * 1.5 + 0.5)
    y[..., 0] = 0.75  # a constant channel: the variance is 0, at the clamp
    y.requires_grad_(True)
    g = torch.randn((b, m, 64, c), generator=gen, dtype=torch.float64)
    bn = _bn(c, 3)
    want, wmean, wvar, wcnt = _plain64(y, mask, bn, act)
    gy, gg, gb = _grads(want, g, y, bn.weight, bn.bias)
    got, mean, var, cnt = bk.bn_train(y, mask, bn.weight, bn.bias, eps=bn.eps, act=act)
    hy, hg, hb = _grads(got, g, y, bn.weight, bn.bias)
    assert torch.equal(mean, wmean) and torch.equal(var, wvar) and var[0] == 0.0
    assert cnt == wcnt == mask.sum()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for h, w in ((hy, gy), (hg, gg), (hb, gb)):
        torch.testing.assert_close(h, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("act", ["ReLU", "ELU"])
def test_plain_passes_with_the_dense_match_autograd_in_float64(act):
    b, m, cin, c = 2, 3, 8, 32
    mask = _mask(b, m, 4)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((b, m, 64, cin), generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((cin, c), generator=gen, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(c, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn((b, m, 64, c), generator=gen, dtype=torch.float64)
    bn = _bn(c, 6)
    y = x @ w + bias
    want, *_ = _plain64(y, mask, bn, act)
    *wants, dy = _grads(want, g, x, w, bias, bn.weight, bn.bias, y)
    got, *_ = bk.bn_train(x, mask, bn.weight, bn.bias, eps=bn.eps, act=act, w=w, bias=bias)
    gots = _grads(got, g, x, w, bias, bn.weight, bn.bias)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # the bias's gradient is 0 but for rounding (the normalize does not see a
    # shift of y): its scale is that of the rows' gradients it sums
    scales = [1.0, 1.0, float(dy.abs().sum((0, 1, 2)).max()), 1.0, 1.0]
    for h, wt, sc in zip(gots, wants, scales):
        atol = 1e-5 * max(float(wt.abs().max()), sc if sc != 1.0 else 0.0)
        torch.testing.assert_close(h, wt, rtol=1e-5, atol=atol)


def test_f1_partials_are_chunk_sums_and_the_count_is_the_valid_slots():
    """F1's partials summed in float64 are ``chunk_sums``' sums, bit for bit,
    and B2's bias partials sum to the rows' sum of dy."""
    mask = _mask(2, 5, 7)
    gen = torch.Generator().manual_seed(8)
    z = torch.randn((2 * 5 * 64, 64), generator=gen) * 3
    bias = torch.randn(64, generator=gen)
    y, part = bk.f1(z, bias, mask.reshape(-1), torch.bfloat16)
    assert torch.equal(y, (z + bias).to(torch.bfloat16)) and part.shape == (10, 128)
    xf = y.float().view(2, 5, 64, 64)
    xm = xf * mask.unsqueeze(-1).float()
    want = torch.cat([layers.chunk_sums(xm), layers.chunk_sums(xm * xf)])
    assert torch.equal(sum_slices_kernel.sum_slices(part, torch.float64), want)
    assert sum_slices_kernel.sum_slices(part).dtype == torch.float32
    scale, shift = torch.rand(64) + 0.5, torch.randn(64)
    d1, d2 = torch.randn(64), torch.randn(64) * 1e-3
    g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
    dy, dpart = bk.b2(g, y, mask.reshape(-1), scale, shift, d1, d2, "ReLU", bias_sums=True)
    torch.testing.assert_close(dpart.sum(0), dy.float().sum(0), rtol=1e-5, atol=1e-4)


# ---- the whole step in the working dtypes --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ACTS)
def test_fused_step_matches_the_pytorch_chain(dtype, act):
    """``MaskedBatchNorm.fused`` (the plain passes on the CPU) against
    ``plain`` then the activation: the output and the running statistics bit
    for bit, every gradient to the rounding of the sums."""
    b, m, cin, c = 2, 3, 16, 64
    mask = _mask(b, m, 9)
    x = (torch.randn((b, m, 64, cin), generator=torch.Generator().manual_seed(10)) * 2
         ).to(dtype)
    g = torch.randn((b, m, 64, c), generator=torch.Generator().manual_seed(11)).to(dtype)
    outs, grads, stats = [], [], []
    for fused in (False, True):
        torch.manual_seed(12)
        lin, bn = Dense(cin, c, dtype), _bn(c, 13)
        xi = x.clone().requires_grad_(True)
        if fused:
            out = bn.fused(xi, mask, act, lin)
        else:
            fn = resolve_activation(act)
            out = bn.plain(lin(xi), mask, True)
            out = out if fn is None else fn(out)
        outs.append(out)
        grads.append(_grads(out, g, xi, lin.weight, lin.bias, bn.weight, bn.bias))
        stats.append((bn.running_mean.clone(), bn.running_var.clone()))
    assert outs[1].dtype == dtype and torch.equal(outs[1], outs[0])
    assert all(torch.equal(a, b) for a, b in zip(*stats))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    names = ("x", "weight", "bias", "gamma", "beta")
    got, want = ({n: t.double() for n, t in zip(names, gs)} for gs in grads[::-1])
    for n in names:
        assert got[n].dtype == want[n].dtype
        # the bias before the normalize has a gradient of 0 but for rounding:
        # held to its weight's gradient's scale
        scale = want["weight" if n == "bias" else n].norm()
        assert float((got[n] - want[n]).norm() / scale) < tol, n


# ---- the models, with the rule taking the CPU ----------------------------------------------

@pytest.fixture
def cpu_takes(monkeypatch):
    """``bn_train_kernel.takes`` as on the card, here: the models call
    ``bn_train``, whose passes run their plain versions."""
    rule = bk.takes
    monkeypatch.setattr(bk, "takes", lambda shape, mask_shape, dtype, _, **kw:
                        rule(shape, mask_shape, dtype, "cuda", **kw))


def _step(model, batch, dtype=None):
    trainer = Trainer(model, TrainConfig(), device="cpu")
    with profiling.recording():
        profiling.clear()
        loss = trainer.step(batch, torch.Generator().manual_seed(5))
        counters = profiling.collect()["counters"]
    profiling.clear()
    return (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()}, counters)


def _batch(b=4, n=512, seed=4):
    rng = np.random.default_rng(seed)
    valid = np.array([n, 400, 300, n])[:b]
    return CloudBatch(
        pos=torch.from_numpy((rng.normal(size=(b, n, 3)) * 3).astype(np.float32)),
        feat=torch.from_numpy(rng.normal(size=(b, n, 1)).astype(np.float32)),
        mask=torch.from_numpy(np.arange(n)[None] < valid[:, None]),
        y=torch.from_numpy(rng.normal(size=(b, 4)).astype(np.float32)))


def _regressor(dtype, **kw):
    torch.manual_seed(0)
    return PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                              compute_dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regressor_step_on_the_passes_matches_the_chain(cpu_takes, monkeypatch, dtype):
    """A production training step with the SA layers' BatchNorms on the
    passes: the loss and the running statistics of the chain's step bit for
    bit, the gradients to rounding; the counters: the SA layers' hidden
    values fused, SA3's and the head's not."""
    batch = _batch()
    fused = _step(_regressor(dtype), batch)
    monkeypatch.setattr(bk, "takes", lambda *a, **kw: False)
    plain = _step(_regressor(dtype), batch)
    assert torch.equal(fused[0], plain[0])
    assert all(torch.equal(fused[2][k], plain[2][k]) for k in plain[2] if "running" in k)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for k, w in plain[1].items():
        # a Dense bias whose shift a BatchNorm further on takes out again (the
        # SA layers') has a gradient of 0 but for rounding: every Dense bias
        # is held to its weight's gradient's scale
        lin_bias = k.endswith(".bias") and ".lin" in k
        scale = plain[1][k[:-len("bias")] + "weight"] if lin_bias else w
        assert float((fused[1][k] - w).norm() / max(float(scale.norm()), 1e-30)) < tol, k
    m1, m2 = math.ceil(0.2 * 512), math.ceil(0.25 * math.ceil(0.2 * 512))
    sa = 4 * 64 * (m1 * (64 + 64) + m2 * (128 + 128))
    rest = 4 * (m2 * (256 + 512) + 128 + 128)
    assert fused[3]["bn.values"] == plain[3]["bn.values"] == sa + rest
    assert fused[3]["bn.fused"] == sa and plain[3]["bn.fused"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_step_on_the_passes_is_the_plain_fused_step_bit_for_bit(cpu_takes, dtype):
    """Under remat the recompute runs F1 and F2 again and skips the running
    update: the loss, gradients and statistics of the step without remat."""
    batch = _batch()
    plain = _regressor(dtype)
    remat = _regressor(dtype, remat=True)
    remat.load_state_dict(plain.state_dict())
    (lp, gp, sp, cp), (lr, gr, sr, cr) = _step(plain, batch), _step(remat, batch)
    assert torch.equal(lp, lr)
    assert all(torch.equal(gp[k], gr[k]) for k in gp)
    assert all(torch.equal(sp[k], sr[k]) for k in sp)
    assert cp["bn.fused"] > 0 and cr["bn.fused"] >= cp["bn.fused"]


def test_voxelnet_step_on_the_passes_matches_the_chain(cpu_takes, monkeypatch):
    """VoxelNet's conv1 BatchNorm (4^3 = 64 sites a cloud at grid 8) takes the
    passes with no activation of its own; conv2's (8 sites) the chain."""
    batch = _batch(n=256)
    results = []
    for rule in (None, lambda *a, **kw: False):
        if rule is not None:
            monkeypatch.setattr(bk, "takes", rule)
        torch.manual_seed(1)
        results.append(_step(VoxelNet(num_features=1, grid=8), batch))
    (lf, gf, sf, cf), (lp, gpl, spl, cpl) = results
    assert torch.equal(lf, lp)
    assert all(torch.equal(sf[k], spl[k]) for k in spl if "running" in k)
    for k, w in gpl.items():
        assert float((gf[k] - w).norm() / max(float(w.norm()), 1e-30)) < 1e-4, k
    assert cf["bn.fused"] == 4 * 64 * 64 and cpl["bn.fused"] == 0
    assert cf["bn.values"] == cpl["bn.values"] == 4 * (64 * 64 + 8 * 128)


def test_counters_on_the_cpu_count_every_train_mode_batchnorm_as_plain():
    """Without the forced rule the CPU takes the chain: ``bn.values`` counts
    each train-mode call's values, ``bn.fused`` reads 0; eval counts
    nothing."""
    mlp = MLP([4, 64, 64, 128])
    mask = _mask(2, 3, 14)
    x = torch.randn(2, 3, 64, 4)
    with profiling.recording():
        profiling.clear()
        mlp(x, mask, train=True)
        mlp(x, mask, train=False)
        counters = profiling.collect()["counters"]
    profiling.clear()
    assert counters == {"bn.values": 2 * 2 * 3 * 64 * 64, "bn.fused": 0}
    mlp(x, mask, train=True)  # off: nothing recorded
    assert profiling.collect()["counters"] == {}
