"""Gradients of the port's ops and layers against ``jax.grad`` of the JAX
package's, and the small pieces of its training loop (loss, early stopping,
optimizer, random FPS starts, dropout).

The same numpy inputs go through both packages; Pallas kernels run in
interpret mode. The port runs the plain versions of its CUDA kernels, which a
CPU tensor selects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl_biomass_tpu.models.layers import Dense as JaxDense
from dl_biomass_tpu.models.layers import MaskedBatchNorm as JaxBN
from dl_biomass_tpu.ops.fps import _random_start
from dl_biomass_tpu.ops.fps import farthest_point_sample as jax_fps
from dl_biomass_tpu.ops.pallas_mxu_gather import mxu_gather
from dl_biomass_tpu.ops.pooling import masked_max as jax_masked_max
from dl_biomass_tpu.train.loss import weighted_component_mse as jax_loss
from dl_biomass_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
from dl_biomass_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dl_biomass_tpu_torch.core.config import HyperParams
from dl_biomass_tpu_torch.models.layers import Dense, MaskedBatchNorm, dropout
from dl_biomass_tpu_torch.ops import fps as fps_ops
from dl_biomass_tpu_torch.ops import gather_kernel
from dl_biomass_tpu_torch.ops.pooling import masked_max
from dl_biomass_tpu_torch.train.loss import weighted_component_mse
from dl_biomass_tpu_torch.train.trainer import EarlyStopping, make_optimizer

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


def bf16_exact(rng, shape, scale=1.0):
    """float32 values that bf16 holds exactly, so that a cotangent handed to
    both packages is the same in either dtype."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def assert_within_one_bf16_step(got, want, max_share):
    """Equal bf16 values, except at most ``max_share`` of them one bf16 step
    (8 significant bits) apart."""
    diff = got != want
    assert diff.mean() <= max_share, f"{int(diff.sum())} of {diff.size} differ"
    step = 2.0 ** (np.floor(np.log2(np.abs(want[diff]))) - 7)
    assert (np.abs(got[diff] - want[diff]) <= step).all()


# ---- kernel 4b: the gather's scatter-add backward ----------------------------


def _gather_case(seed, b, n, m, c):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m, 64)).astype(np.int32)
    idx[0, 3, 5], idx[b - 1, 2, 0], idx[b - 1, 4, 9] = n, -1, n + 7  # out of range
    ct = bf16_exact(rng, (b, m, 64, c))
    return vals, idx, ct


@pytest.mark.parametrize("dtype,m,c", [("float32", 37, 128), ("bfloat16", 37, 128),
                                       ("bfloat16", 70, 40), ("float32", 32, 24)])
def test_gather_backward_matches_jax_grad_of_mxu_gather(dtype, m, c):
    """M=37 and 70 are not multiples of the Pallas kernel's 32-centroid tile.
    The Pallas backward adds one-hot products in XLA's CPU dot order and the
    port in ascending row order: at bf16 the sums round to the same bits
    (measured: 0 of 76,800 differ), at f32 they agree to 2e-7 of the
    largest."""
    b, n = 2, 200
    vals, idx, ct = _gather_case(m, b, n, m, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ctj = jnp.asarray(ct).astype(jdt)

    def loss(v):
        return jnp.sum((mxu_gather(v, jnp.asarray(idx), interpret=True) * ctj).astype(jnp.float32))

    want = np.asarray(jax.grad(loss)(jnp.asarray(vals).astype(jdt)).astype(jnp.float32))
    v = t(vals).to(tdt).requires_grad_()
    gather_kernel.gather_rows(v, t(idx)).backward(t(ct).to(tdt))
    assert v.grad.dtype == tdt and v.grad.shape == (b, n, c)
    got = v.grad.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # and the float64 scatter-add of numpy, out-of-range indices dropped
    ref = np.zeros((b, n, c))
    for i in range(b):
        ok = (idx[i] >= 0) & (idx[i] < n)
        np.add.at(ref[i], idx[i][ok], ct[i][ok].astype(np.float64))
    step = 2.0**-8 if dtype == "bfloat16" else 1e-6  # one rounding of the f32 sum
    assert np.abs(got - ref).max() <= step * np.abs(ref).max()


def test_scatter_plain_sums_in_ascending_row_order():
    """Each output row is the float32 sum of its contributions in ascending
    flat-row order, rounded once: a sequential numpy float32 loop in that order
    gives the same bits, also for a long segment (every pad slot at index 0)."""
    rng = np.random.default_rng(4)
    b, n, m, c = 2, 16, 9, 8
    ct = (rng.normal(size=(b, m, 64, c)) * np.exp(rng.normal(size=(b, m, 64, 1)) * 3)
          ).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m, 64)).astype(np.int32)
    idx[1, 5:] = 0
    got = gather_kernel.scatter_rows_plain(t(ct), t(idx), n).numpy()
    want = np.zeros((b, n, c), np.float32)
    for i in range(b):
        for r, row in zip(idx[i].reshape(-1), ct[i].reshape(-1, c)):
            want[i, r] = want[i, r] + row
    np.testing.assert_array_equal(got, want)
    got16 = gather_kernel.scatter_rows_plain(t(ct).to(torch.bfloat16), t(idx), n)
    want16 = np.zeros((b, n, c), np.float32)
    ct16 = t(ct).to(torch.bfloat16).float().numpy()
    for i in range(b):
        for r, row in zip(idx[i].reshape(-1), ct16[i].reshape(-1, c)):
            want16[i, r] = want16[i, r] + row
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, t(want16).to(torch.bfloat16))


def test_gather_without_grad_is_the_forward_alone():
    vals, idx, _ = _gather_case(1, 1, 50, 6, 16)
    out = gather_kernel.gather_rows(t(vals), t(idx))
    assert out.grad_fn is None
    assert torch.equal(out, gather_kernel.gather_rows_plain(t(vals), t(idx)))


# ---- masked max ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_max_gradient_goes_to_the_first_argmax(dtype):
    """Duplicated points make ties (the gradient goes to the first index, not
    split), and an empty row gets no gradient."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 7, 6)).astype(np.float32) * 4
    x[:, :, 4] = x[:, :, 1]  # slot 4 duplicates slot 1
    x[:, :, 6] = x[:, :, 1]
    mask = rng.random((3, 5, 7)) < 0.7
    mask[:, :, 1] = mask[:, :, 4] = True
    mask[0, 1] = False  # an empty row
    g = bf16_exact(rng, (3, 5, 6))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(v):
        return jnp.sum(jax_masked_max(v, jnp.asarray(mask), 2).astype(jnp.float32) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tx = t(x).to(tdt).requires_grad_()
    out = masked_max(tx, t(mask), dim=2)
    out.backward(t(g).to(tdt))
    np.testing.assert_array_equal(tx.grad.float().numpy(), want)
    assert tx.grad.dtype == tdt
    assert not tx.grad[:, :, 4].any() and not tx.grad[0, 1].any()
    assert (out[0, 1] == 0).all()


def test_masked_max_global_pool_gradient():
    """The SA3 form: (B, M, C) pooled over dim 1."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    x[1, 7] = x[1, 2]
    mask = np.ones((2, 9), bool)
    mask[0, 5:] = False
    g = rng.normal(size=(2, 5)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_masked_max(v, jnp.asarray(mask), 1) * g))(
        jnp.asarray(x)))
    tx = t(x).requires_grad_()
    masked_max(tx, t(mask), dim=1).backward(t(g))
    np.testing.assert_array_equal(tx.grad.numpy(), want)


# ---- Dense and BatchNorm --------------------------------------------------------


@pytest.mark.parametrize("dtype,x_dtype", [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                                           ("float32", "float32")])
def test_dense_gradients_match_flax(dtype, x_dtype):
    """jax.grad of flax ``Dense`` at the same weights: both round dx and dW to
    the compute dtype after a float32 product of exact bf16 products. The two
    packages add the float32 sums in another order, so at bf16 an element
    whose sum lands near a rounding boundary may round one bf16 step apart
    (measured: 1 element of dx in 14,400, none of dW or the bias); at f32 they
    agree to float32 rounding."""
    rng = np.random.default_rng(0)
    cin, cout = 96, 64
    x = rng.normal(size=(3, 50, cin)).astype(np.float32)
    ct = bf16_exact(rng, (3, 50, cout))
    jdt = getattr(jnp, dtype)
    jd = JaxDense(features=cout, in_features=cin, compute_dtype=jdt)
    params = jd.init(jax.random.key(0), jnp.zeros((1, cin)))["params"]
    xj = jnp.asarray(x).astype(getattr(jnp, x_dtype))

    def loss(p, xx):
        return jnp.sum(jd.apply({"params": p}, xx).astype(jnp.float32) * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, xj)
    td = Dense(cin, cout, compute_dtype=getattr(torch, dtype))
    with torch.no_grad():
        td.weight.copy_(t(np.asarray(params["kernel"]).T))
        td.bias.copy_(t(np.asarray(params["bias"])))
    tx = t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, x_dtype)).requires_grad_()
    y = td(tx)
    assert y.dtype == getattr(torch, dtype)
    y.backward(t(ct).to(y.dtype))
    pairs = [(tx.grad, gx), (td.weight.grad.t(), gp["kernel"]), (td.bias.grad, gp["bias"])]
    for got, want in pairs:
        got, want = got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "bfloat16":
            assert_within_one_bf16_step(got, want, max_share=1e-3)
        else:
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("masked", [True, False])
def test_train_batch_norm_matches_flax(masked):
    """Output, gradients (x, scale, bias) and the running update of train-mode
    BatchNorm with batch statistics over the valid slots (a ragged mask), and
    without a mask (the head: the row count)."""
    rng = np.random.default_rng(3 + masked)
    c = 16
    shape = (2, 9, 12, c) if masked else (7, c)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    mask = (rng.random(shape[:-1]) < 0.6) if masked else None
    ct = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    rmean = rng.normal(size=c).astype(np.float32) * 0.1
    rvar = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jbn = JaxBN(num_features=c)
    stats = {"mean": jnp.asarray(rmean), "var": jnp.asarray(rvar)}
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p, xx):
        out, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, jmask,
                             use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, upd)

    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (gp, gx), (out, upd) = jax.grad(loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(t(scale))
        bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(rmean))
        bn.running_var.copy_(t(rvar))
    tx = t(x).requires_grad_()
    y = bn(tx, None if mask is None else t(mask), train=True)
    y.backward(t(ct))
    for got, want in [(y, out), (tx.grad, gx), (bn.weight.grad, gp["scale"]),
                      (bn.bias.grad, gp["bias"]),
                      (bn.running_mean, upd["batch_stats"]["mean"]),
                      (bn.running_var, upd["batch_stats"]["var"])]:
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_eval_batch_norm_leaves_running_statistics():
    bn = MaskedBatchNorm(4)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    bn(x, train=True)
    assert not torch.equal(bn.running_mean, torch.zeros(4))


# ---- dropout, loss, early stopping, optimizer --------------------------------------


def test_dropout_follows_flax_rule_and_repeats_under_a_seed():
    x = torch.randn(4000, generator=torch.Generator().manual_seed(1)).abs() + 0.5
    a = dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], x[kept] / 0.5)
    assert 0.45 < kept.float().mean() < 0.55
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, None)


def test_weighted_loss_matches_jax_with_a_pad_cloud():
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(4, 4)).astype(np.float32) * 3
    y = rng.normal(size=(4, 4)).astype(np.float32) * 3
    w = np.array([True, True, False, True])  # cloud 2 is all padding
    want = float(jax_loss(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(w)))
    got = float(weighted_component_mse(t(pred), t(y), t(w)))
    assert abs(got - want) <= 1e-6 * abs(want)
    pred[2] += 100.0  # a pad cloud's prediction does not count
    assert float(weighted_component_mse(t(pred), t(y), t(w))) == got
    want_all = float(jax_loss(jnp.asarray(pred), jnp.asarray(y)))
    assert abs(float(weighted_component_mse(t(pred), t(y))) - want_all) <= 1e-6 * want_all


def test_early_stopping_matches_the_jax_class():
    vals = [5.0, 4.0, 4.5, 4.2, 3.9, 4.0, 4.1, 4.3, 3.0, 3.5, 3.6, 3.7]
    ours, ref = EarlyStopping(3), JaxEarlyStopping(3)
    for v in vals:
        assert ours.update(v) == ref.update(v)
        assert (ours.trigger_times, ours.last_val) == (ref.trigger_times, ref.last_val)
    assert not EarlyStopping(1, enabled=False).update(1e9)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_optimizer_matches_optax_on_the_same_gradients(name):
    """Three steps of the port's optimizer and of the JAX package's optax
    chain, each fed the same gradients: L2 decay inside the gradient (Adam)
    or decoupled (AdamW), the same moments and bias correction."""
    hp = HyperParams(optimizer=name)
    rng = np.random.default_rng(11)
    p0 = rng.normal(size=(5, 7)).astype(np.float32) * 0.3
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s for s in (1.0, 0.1, 3.0)]
    tx = jax_make_optimizer(hp)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(t(p0.copy()))
    opt = make_optimizer([tp], hp)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer([tp], HyperParams(optimizer="SGD"))


# ---- random FPS starts ------------------------------------------------------------


def test_random_start_fps_picks_valid_points_and_repeats():
    rng = np.random.default_rng(2)
    b, n = 3, 640
    pos = t((rng.normal(size=(b, n, 3)) * 3).astype(np.float32))
    mask = t(np.arange(n)[None] < np.array([[640], [333], [129]]))

    def draw(seed, sectored):
        g = torch.Generator().manual_seed(seed)
        f = fps_ops.fps_sectored if sectored else fps_ops.farthest_point_sample
        return f(pos, mask, 128, generator=g)

    for sectored in (False, True):
        a, b2 = draw(3, sectored), draw(3, sectored)
        assert torch.equal(a, b2)
        assert not torch.equal(a, draw(4, sectored))
        assert bool(mask.gather(1, a[:, :100].long())[2, :100].sum() == 100)  # first picks valid
        assert bool(mask.gather(1, a.long())[:2].all())
    starts = fps_ops.random_starts(mask, torch.Generator().manual_seed(0))
    assert bool(mask.gather(1, starts[:, None]).all())
    first = fps_ops.farthest_point_sample(pos, mask, 16)
    assert torch.equal(first[:, 0], torch.zeros(3, dtype=torch.int32))


def test_injected_starts_reproduce_jax_random_start_fps():
    """The JAX package draws its start with a Gumbel argmax from a key; handed
    the same starts, the port picks the same points (exact FPS, use_pallas)."""
    rng = np.random.default_rng(6)
    b, n = 2, 300
    pos = (rng.normal(size=(b, n, 3)) * 3).astype(np.float32)
    mask = np.arange(n)[None] < np.array([[300], [211]])
    key = jax.random.key(5)
    want = np.asarray(jax_fps(jnp.asarray(pos), jnp.asarray(mask), 40, key=key, use_pallas=True))
    starts = np.asarray(jax.vmap(_random_start)(jax.random.split(key, b), jnp.asarray(mask)))
    got = fps_ops.farthest_point_sample(t(pos), t(mask), 40, starts=t(starts)).numpy()
    np.testing.assert_array_equal(got, want)

