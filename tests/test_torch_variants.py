"""The port's model variants against the JAX package, on the same weights
through the bridge: multi-scale grouping (``msg``), the folded BatchNorm
(``analytic_bn``), recomputation in the backward (``remat``) and
``pointnet2_v2`` (one output, SA3 and the head twice as wide).

Eval forwards against ``model.apply(train=False)`` in float32 (``F32_RTOL``)
and bf16 (``BF16_RTOL``; a training step against JAX's is in
``tests/test_torch_variants_step.py``); ``MLP(analytic_bn=True)`` against
JAX's; the analytic head's dropout (which the JAX package cannot build); and
a remat step bit for bit against the plain step."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models import layers as jax_layers
from dl_biomass_tpu.models import pointnet2 as jax_pointnet2
from dl_biomass_tpu_torch.bridge import from_flax_variables, to_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models.layers import MLP
from dl_biomass_tpu_torch.models.pointnet2 import (PointNet2Regressor, model_to_dict,
                                                   pointnet2_v2)
from dl_biomass_tpu_torch.train.trainer import Trainer
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

B, N, VALID = 2, 640, [640, 517]
VARIANTS = {
    "msg": dict(msg=True),
    "msg_doubled": dict(msg=True, doubled_radius=True),
    "analytic_bn": dict(analytic_bn=True),
    "remat": dict(remat=True),
    "v2": dict(num_outputs=1, global_width_mult=2),
}


@pytest.fixture(scope="module")
def batch_pair():
    return batches(0, B, N, VALID)


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL), ("bfloat16", BF16_RTOL)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_apply(batch_pair, variant, dtype, rtol):
    """The production preset: SA1 on kernel 2 at every scale, SA2 on kernel 3
    and, split, kernel 4a (analytic_bn: unsplit, kernel 4c)."""
    jb, tb = batch_pair
    jm, v, tm = models("production", dtype, jb, dropout_probability=0.0, **VARIANTS[variant])
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) <= rtol


def test_msg_builds_a_second_mlp_per_layer_with_the_flax_names(batch_pair):
    jb, _ = batch_pair
    _, v, tm = models("parity", "float32", jb, msg=True)
    sd = from_flax_variables(v)
    assert set(sd) == set(tm.state_dict())
    assert tm.sa1.radii == (2.0, 4.0) and tm.sa2.radii == (8.0, 16.0)
    assert tm.sa2.mlp1.lin0.in_features == 2 * 128 + 3  # the two scales concatenated
    assert tm.sa3.mlp.lin0.in_features == 2 * 256 + 3
    back = to_flax_variables(tm)
    np.testing.assert_array_equal(back["params"]["sa2"]["mlp1"]["lin0"]["kernel"],
                                  v["params"]["sa2"]["mlp1"]["lin0"]["kernel"])


def test_v2_is_the_jax_packages_v2():
    ours, ref = model_to_dict(pointnet2_v2(1)), jax_pointnet2.model_to_dict(
        jax_pointnet2.pointnet2_v2(1))
    ref.pop("use_pallas")
    assert ours == ref
    m = pointnet2_v2(1)
    assert m.head.lin2.out_features == 1 and m.sa3.mlp.lin2.out_features == 2048


# ---- remat ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_is_the_plain_step_bit_for_bit(dtype):
    """A remat step (SA MLPs recomputed in the backward) gives the plain
    step's loss, gradients and running statistics bit for bit: the recompute
    runs the same operations and does not apply the running-statistics
    update again. Production preset, head dropout 0.5 from one generator."""
    _, tb = batches(4, 4, 512, [512, 400, 300, 512])
    tb = CloudBatch(pos=tb.pos, feat=tb.feat, mask=tb.mask,
                    y=torch.from_numpy(np.random.default_rng(1).normal(size=(4, 4))
                                       .astype(np.float32)))
    kw = dict(num_features=1, fast_group=True, fast_fps=True,
              compute_dtype=getattr(torch, dtype))
    torch.manual_seed(0)
    plain = PointNet2Regressor(**kw)
    remat = PointNet2Regressor(remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    assert remat.sa1.mlp.remat and not remat.sa3.mlp.remat and not remat.head.remat
    results = []
    for model in (plain, remat):
        trainer = Trainer(model, TrainConfig(), device="cpu")
        loss = trainer.step(tb, torch.Generator().manual_seed(5))
        results.append((loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items()}))
    (lp, gp, sp), (lr, gr, sr) = results
    assert torch.equal(lp, lr)
    assert all(torch.equal(gp[k], gr[k]) for k in gp)
    assert all(torch.equal(sp[k], sr[k]) for k in sp)  # statistics and the updated weights


def test_remat_keeps_no_edge_activation_for_the_backward():
    """The point of remat: the SA MLPs' (B, M, K, C) activations are not
    saved for the backward (saved-tensor hooks count the bytes)."""
    _, tb = batches(4, 2, 512, [512, 400])
    saved = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                                   remat=remat, dropout_probability=0.0)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(tb, train=True).sum()
        saved[remat] = total[0]
    assert saved[True] < 0.5 * saved[False], saved


def flat(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from flat(x, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(x, np.float64)


# ---- MLP(analytic_bn=True) -----------------------------------------------------------------


def _mlp_pair(channels, dropout=0.0):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 4, channels[0])).astype(np.float32) * 2 + 0.5
    mask = rng.random((2, 6, 4)) < 0.8
    jm = jax_layers.MLP(channels, analytic_bn=True, dropout=dropout)
    v = jax.tree.map(np.asarray, jax_layers.MLP(channels).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(mask), True))
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda s: (s + rng.uniform(0.1, 0.5, s.shape)).astype(np.float32), v["batch_stats"])}
    tm = MLP(channels, analytic_bn=True, dropout=dropout)
    tm.load_state_dict(from_flax_variables(v))
    return jm, v, tm, x, mask


def test_analytic_mlp_matches_jax_outputs_statistics_and_gradients():
    jm, v, tm, x, mask = _mlp_pair((5, 8, 8, 6))

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(jnp.where(jnp.asarray(mask)[..., None], out, 0.0) ** 2), (out, upd)

    (jl, (jout, upd)), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    m = mask[..., None]
    # eval: the running statistics folded the same way
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(mask), False))
    with torch.no_grad():
        assert rel_err(np.where(m, tm(tx, tmask).numpy(), 0), np.where(m, want, 0)) <= F32_RTOL
    out = tm(tx, tmask, train=True)
    tl = (torch.where(tmask[..., None], out, 0.0) ** 2).sum()
    tl.backward()
    assert rel_err(np.where(m, out.detach().numpy(), 0), np.where(m, jout, 0)) <= F32_RTOL
    assert abs(float(tl.detach()) - float(jl)) <= F32_RTOL * abs(float(jl))
    got = to_flax_variables(tm)
    for path, want in flat(upd["batch_stats"]):
        assert rel_err(dict(flat(got["batch_stats"]))[path], want) <= F32_RTOL, path
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(jg))
    for n, p in tm.named_parameters():
        *mods, leaf = n.split(".")
        key = {"weight": "kernel" if mods[-1].startswith("lin") else "scale"}.get(leaf, leaf)
        want = np.asarray(jg[mods[-1]][key])
        g = p.grad.numpy()
        if n in ("lin0.bias", "lin1.bias"):  # a BatchNorm follows: true gradient 0
            assert max(np.abs(g).max(), np.abs(want).max()) <= 1e-5 * top, n
            continue
        assert rel_err(g.T if key == "kernel" else g, want) <= F32_RTOL, n


def test_analytic_from_z0_raises_as_jax_does():
    with pytest.raises(ValueError, match="analytic_bn"):
        MLP((5, 8, 8, 6), analytic_bn=True).from_z0(torch.zeros(2, 8))


def test_analytic_model_is_the_standard_model_to_2e_4(batch_pair):
    """JAX's model-level case (tests/test_analytic_bn.py): float32 analytic and
    standard predictions on the same weights agree to 2e-4, in both packages."""
    jb, tb = batch_pair
    jm, v, tm = models("production", "float32", jb, dropout_probability=0.0,
                       analytic_bn=True)
    std = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                             dropout_probability=0.0)
    std.load_state_dict(tm.state_dict())
    with torch.no_grad():
        o_ana, o_std = tm(tb).numpy(), std(tb).numpy()
    np.testing.assert_allclose(o_ana, o_std, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(o_ana, np.asarray(jm.apply(v, jb, train=False)),
                               rtol=2e-4, atol=2e-4)


# ---- the analytic head's dropout: a divergence by design -----------------------------------


def test_jax_analytic_mlp_with_dropout_raises():
    """The JAX package builds the folded form's dropout inline in a method
    that is not compact (layers.py:316): flax refuses, in train and eval."""
    x = jnp.ones((3, 5))
    for train in (True, False):
        with pytest.raises(flax.errors.AssignSubModuleError):
            jax_layers.MLP((5, 8, 8, 4), dropout=0.5, analytic_bn=True).init(
                {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x, None, train)


def test_analytic_eval_with_head_dropout_is_jax_standard_model(batch_pair):
    """The port's analytic model with the head's default dropout 0.5, in eval,
    is the JAX package's standard model on the same weights."""
    jb, tb = batch_pair
    jm, v, _ = models("production", "float32", jb)  # standard, dropout 0.5
    tm = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, analytic_bn=True)
    tm.load_state_dict(from_flax_variables(v))
    with torch.no_grad():
        got = tm(tb).numpy()
    assert rel_err(got, np.asarray(jm.apply(v, jb, train=False))) <= F32_RTOL


def test_analytic_train_draws_the_standard_dropout_mask(batch_pair):
    """In training the analytic head applies dropout after the activation,
    where the standard form does: from one generator state both draw the same
    mask, give the same output to float32 rounding and leave the generator in
    the same state; another state's mask moves the output by far more."""
    _, tb = batch_pair
    torch.manual_seed(0)
    std = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True)
    ana = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, analytic_bn=True)
    ana.load_state_dict(std.state_dict())
    outs, states = [], []
    for model in (std, ana):
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            outs.append(model(tb, train=True, generator=g))
        states.append(g.get_state())
    assert torch.equal(states[0], states[1])
    # the two forms' float32 statistics differ in rounding, which the head's
    # train-mode BatchNorm over the batch's 2 rows amplifies (3.3e-4 here)
    assert rel_err(outs[1].numpy(), outs[0].numpy()) <= 1e-3
    g = torch.Generator().manual_seed(12)  # another mask gives another output
    with torch.no_grad():
        other = ana(tb, train=True, generator=g)
    assert rel_err(other.numpy(), outs[0].numpy()) > 1e-2
