"""Kernel 6, the fused SA-layer MLP: the forward of its plain version
(``ops/sa_train_kernel.fused_sa_mlp_plain``; the wrapper runs it on a CPU
tensor) against the JAX package's ``fused_sa_mlp`` in interpret mode, the
``FusedSAMLP`` layer and the ``fused_sa`` model against their JAX
counterparts on the same weights through the bridge, and the port's entry
points on such a model: ``build_model``, ``Trainer`` (evaluation and the
training step) and the serving engine. The backward's parity with JAX is in
``test_torch_sa_train_bwd.py``.

Tolerances, as max|diff| / max|y|: the plain version and JAX's interpret
mode take the same float32 (or exact bf16 x bf16) products and sum them in
another order, so float32 agrees to 1e-5 (measured ~3e-7). In bf16 the
statistics differ at that level too, but a hidden activation that lands at a
bf16 rounding boundary then rounds one step (2^-8 of itself) the other way,
and that step reaches the output: 2e-3 (measured up to 2.2e-4). The argmax
is compared where the winning value leads the runner-up by more than the
bound. The whole model
uses the helpers' cross-package bounds (``F32_RTOL``, ``BF16_RTOL``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.layers import FusedSAMLP as JaxFusedSAMLP
from dl_biomass_tpu.models.pointnet2 import PointNet2Regressor as JaxModel
from dl_biomass_tpu.models.pointnet2 import model_to_dict as jax_model_to_dict
from dl_biomass_tpu.ops.pallas_sa_train import fused_sa_mlp as jax_fused_sa_mlp
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.layers import FusedSAMLP
from dl_biomass_tpu_torch.models.pointnet2 import (PointNet2Regressor, build_model,
                                                   model_to_dict)
from dl_biomass_tpu_torch.ops import sa_train_kernel
from dl_biomass_tpu_torch.train.trainer import Trainer
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

TOL = {False: 1e-5, True: 2e-3}  # by bf16
B, M = 2, 12
K = sa_train_kernel.K
# (CD, CP) of each input form: planes only (SA1 under fast_group), dense only
# (group_neighborhoods), dense and planes (SA2 on kernel 4c)
FORMS = {"planes": (0, 4), "dense": (7, 0), "both": (4, 3)}


def _case(seed, cd, cp, widths=(8, 8, 16)):
    """numpy dense (invalid rows zero), planes, mask (centroid 3 of cloud 0
    has no valid slot), params and running statistics."""
    rng = np.random.default_rng(seed)
    mask = rng.random((B, M, K)) > 0.3
    mask[0, 3] = False
    dense = (np.where(mask[..., None], rng.normal(size=(B, M, K, cd)), 0).astype(np.float32)
             if cd else None)
    planes = rng.normal(size=(B, M, K, cp)).astype(np.float32) if cp else None
    ch = (cd + cp,) + tuple(widths)
    p = {}
    for i in range(3):
        p[f"w{i + 1}"] = (rng.normal(size=(ch[i], ch[i + 1])) * 0.4).astype(np.float32)
        p[f"b{i + 1}"] = (rng.normal(size=ch[i + 1]) * 0.1).astype(np.float32)
    for i in (1, 2):
        p[f"gamma{i}"] = rng.uniform(0.5, 1.5, ch[i]).astype(np.float32)
        p[f"beta{i}"] = (rng.normal(size=ch[i]) * 0.1).astype(np.float32)
    running = tuple(f(size=ch[i]).astype(np.float32) for i in (1, 2)
                    for f in (lambda size: rng.normal(size=size) * 0.2,
                              lambda size: rng.uniform(0.5, 2.0, size)))
    return dense, planes, mask, p, running


def _ahead_of_runner_up(out_h3, tol):
    """Where the max leads the second-largest valid value by more than tol."""
    srt = np.sort(out_h3, axis=2)
    with np.errstate(invalid="ignore"):  # -inf - -inf where no slot is valid
        return (srt[:, :, -1] - srt[:, :, -2]) > tol


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("form,act", [("planes", "ReLU"), ("dense", "LeakyReLU"),
                                      ("both", "ELU"), ("both", None)])
def test_plain_version_matches_jax_interpret(form, act, train, bf16):
    cd, cp = FORMS[form]
    dense, planes, mask, p, running = _case(cd * 10 + cp, cd, cp)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    tt = torch.bfloat16 if bf16 else torch.float32
    jd = None if dense is None else jnp.asarray(dense, jt)
    jpl = [] if planes is None else [jnp.asarray(planes[..., c]) for c in range(cp)]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    td = None if dense is None else torch.from_numpy(dense).to(tt)
    tpl = None if planes is None else torch.from_numpy(planes)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if train:
        want_out, want_stats, want_am = jax_fused_sa_mlp(
            jd, jpl, jnp.asarray(mask), jp, act=act, bf16=bf16, interpret=True,
            return_argmax=True)
    else:
        want_out = jax_fused_sa_mlp(jd, jpl, jnp.asarray(mask), jp,
                                    tuple(jnp.asarray(r) for r in running), act=act,
                                    bf16=bf16, interpret=True, train=False)
        want_stats = running
    t_running = None if train else tuple(torch.from_numpy(r) for r in running)
    got = sa_train_kernel.fused_sa_mlp(td, tpl, torch.from_numpy(mask), tp, t_running, act=act,
                                       bf16=bf16, train=train, return_argmax=train)
    plain = sa_train_kernel.fused_sa_mlp_plain(td, tpl, torch.from_numpy(mask), tp, t_running,
                                               act=act, bf16=bf16, train=train)
    got_out, got_stats, got_am = got if train else (got, plain[1], plain[2])
    assert torch.equal(got_out, plain[0])  # on a CPU tensor the wrapper runs the plain passes
    want_out = np.asarray(want_out)
    assert got_out.dtype == torch.float32 and tuple(got_out.shape) == (B, M, 16)
    assert got_am.dtype == torch.int32
    assert rel_err(got_out.numpy(), want_out) <= TOL[bf16]
    for g, w in zip(got_stats, want_stats):
        assert rel_err(g.numpy(), np.asarray(w)) <= TOL[bf16]
    # the centroid with no valid slot: 0 and -1
    assert (got_out[0, 3] == 0).all() and (got_am[0, 3] == -1).all()
    assert (want_out[0, 3] == 0).all()
    if train:
        want_am = np.asarray(want_am)
        assert (want_am[0, 3] == -1).all()
        # the argmax wherever the winner leads the runner-up in the plain h3
        folds = [sa_train_kernel._fold(tp[f"gamma{i}"], tp[f"beta{i}"], *got_stats[2 * i - 2:2 * i])
                 for i in (1, 2)]
        h3 = sa_train_kernel.hidden_plain(3, td, tpl, torch.from_numpy(mask), tp, folds, act=act,
                                          bf16=bf16).view(B, M, K, -1).numpy()
        lead = _ahead_of_runner_up(np.where(mask[..., None], h3, -np.inf),
                                   TOL[bf16] * np.abs(want_out).max())
        lead[0, 3] = True
        assert np.array_equal(got_am.numpy()[lead], want_am[lead])


def test_wrapper_raises_where_autograd_needs_the_backward():
    """Where autograd needs the backward, the wrapper gives it: the gradient of
    every parameter and of dense on a CPU tensor, equal to that of the plain
    chain; the planes get none. What the kernels cannot take still raises:
    an unsupported activation, return_argmax in eval mode, mismatched
    channels, and float64 on any device but the CPU (``meta`` stands in for a
    card here: the refusal comes before any launch)."""
    dense, planes, mask, p, _ = _case(5, 4, 3)
    grads = []
    for fn in (sa_train_kernel.fused_sa_mlp, sa_train_kernel.fused_sa_mlp_plain):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        td = torch.from_numpy(dense).requires_grad_()
        tpl = torch.from_numpy(planes).requires_grad_()
        out = fn(td, tpl, torch.from_numpy(mask), tp)[0]
        out.square().sum().backward()
        assert tpl.grad is None and td.grad.dtype == torch.float32
        grads.append([td.grad] + [tp[k].grad for k in sa_train_kernel.PARAMS])
    assert all(g is not None and bool(g.abs().max() > 0) for g in grads[0])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    args = (torch.from_numpy(dense), torch.from_numpy(planes), torch.from_numpy(mask),
            {k: torch.from_numpy(v) for k, v in p.items()})
    out, stats = sa_train_kernel.fused_sa_mlp(*args)
    assert out.shape == (B, M, 16) and len(stats) == 4
    with pytest.raises(ValueError, match="unsupported activation"):
        sa_train_kernel.fused_sa_mlp(*args, act="GELU")
    with pytest.raises(ValueError, match="return_argmax"):
        sa_train_kernel.fused_sa_mlp(*args, stats, train=False, return_argmax=True)
    with pytest.raises(ValueError, match="input channels"):
        sa_train_kernel.fused_sa_mlp(args[0], None, *args[2:])
    meta = [x.double().to("meta") for x in args[:2]] + [args[2].to("meta")]
    with pytest.raises(ValueError, match="float64"):
        sa_train_kernel.fused_sa_stage(1, *meta, args[3])
    with pytest.raises(ValueError, match="float64"):
        sa_train_kernel.fused_sa_bwd_stage(1, *meta, args[3], [], [], [], None, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_sa_mlp_layer_matches_jax(dtype, train):
    """FusedSAMLP against the JAX layer on bridged weights: the pooled output
    and, in train mode, the running statistics after the update."""
    dense, planes, mask, _, _ = _case(11, 4, 3)
    chans = [7, 8, 8, 16]
    jl = JaxFusedSAMLP(chans, act="ReLU", compute_dtype=getattr(jnp, dtype))
    jpl = [jnp.asarray(planes[..., c]) for c in range(3)]
    v = jl.init(jax.random.key(3), jnp.asarray(dense), jpl, jnp.asarray(mask), False)
    rng = np.random.default_rng(4)
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), v["batch_stats"])}
    tl = FusedSAMLP(chans, act="ReLU", compute_dtype=getattr(torch, dtype))
    tl.load_state_dict(from_flax_variables(v))
    args = (torch.from_numpy(dense), torch.from_numpy(planes), torch.from_numpy(mask))
    if train:
        want, upd = jl.apply(v, jnp.asarray(dense), jpl, jnp.asarray(mask), True,
                             mutable=["batch_stats"])
        with torch.no_grad():
            got = tl(*args, train=True)
        moved = from_flax_variables({"params": v["params"], **upd})
        for name, t in tl.state_dict().items():
            if "running" in name:
                assert rel_err(t.numpy(), moved[name].numpy()) <= TOL[dtype == "bfloat16"], name
    else:
        want = jl.apply(v, jnp.asarray(dense), jpl, jnp.asarray(mask), False)
        with torch.no_grad():
            got = tl(*args)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) <= TOL[dtype == "bfloat16"]


@pytest.mark.parametrize("preset,dtype", [("production", "float32"), ("production", "bfloat16"),
                                          ("parity", "float32")])
def test_fused_sa_model_matches_jax(preset, dtype):
    """PointNet2Regressor(fused_sa=True) against the JAX model (use_pallas,
    interpret mode) at N=128: the eval forward, and the train-mode forward
    (FPS from the first valid point on both sides, dropout 0) with its
    running-statistic update.

    In train mode the head's BatchNorm normalises over the batch's 2 rows,
    which amplifies rounding: the unfused model is 1e-3 (float32) and 8e-2
    (bf16) from JAX at its output and 4.5e-3 at the head's last statistic. So
    the fused layers' statistics (SA1, SA2; measured 7e-8 and 1.4e-5) are held
    at this file's bounds and SA3's at the helpers'; the head's statistics and
    the output are held in float32 only (output: 1e-2, measured 1.7e-3)."""
    jb, tb = batches(21, 2, 128, [128, 101])
    jm, v, tm = models(preset, dtype, jb, fused_sa=True, dropout_probability=0.0)
    assert tm.sa1.fused_sa and tm.sa2.fused_sa
    assert isinstance(tm.sa1.mlp, FusedSAMLP) and isinstance(tm.sa2.mlp, FusedSAMLP)
    bf16 = dtype == "bfloat16"
    rtol = BF16_RTOL if bf16 else F32_RTOL
    with torch.inference_mode():
        got = tm(tb)
    assert rel_err(got.numpy(), np.asarray(jm.apply(v, jb, train=False))) <= rtol
    want_t, upd = jm.apply(v, jb, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = tm(tb, train=True)
    assert bool(torch.isfinite(got_t).all())
    if not bf16:
        assert rel_err(got_t.numpy(), np.asarray(want_t)) <= 1e-2
    moved = from_flax_variables({"params": v["params"], **upd})
    bounds = {"sa1": TOL[bf16], "sa2": TOL[bf16], "sa3": rtol, "head": None if bf16 else rtol}
    for name, t in tm.state_dict().items():
        bnd = bounds[name.split(".")[0]]
        if "running" in name and bnd is not None:
            assert rel_err(t.numpy(), moved[name].numpy()) <= bnd, name


def test_build_model_takes_fused_sa_and_writes_it_back():
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fused_sa=True))
    model = build_model(cfg, num_features=1)
    assert model.fused_sa and isinstance(model.sa2.mlp, FusedSAMLP)
    ours = model_to_dict(model)
    ref = jax_model_to_dict(JaxModel(num_features=1, fast_group=True, fast_fps=True,
                                     fused_sa=True, compute_dtype=jnp.bfloat16))
    ref.pop("use_pallas")
    assert ours == ref
    assert PointNet2Regressor(**{k: v for k, v in ours.items() if k in (
        "num_features", "fast_group", "fast_fps", "fused_sa")}).fused_sa
    for option in ("analytic_bn", "remat"):
        # kernel 6 takes the SA layers under either; analytic_bn folds SA3
        # and the head, as in the JAX package
        both = build_model(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **{option: True})), num_features=1)
        assert isinstance(both.sa1.mlp, FusedSAMLP) and isinstance(both.sa2.mlp, FusedSAMLP)
        assert both.sa3.mlp.analytic_bn == both.head.analytic_bn == (option == "analytic_bn")
        ref = jax_model_to_dict(JaxModel(num_features=1, fast_group=True, fast_fps=True,
                                         fused_sa=True, compute_dtype=jnp.bfloat16,
                                         **{option: True}))
        ref.pop("use_pallas")
        assert model_to_dict(both) == ref


def _fused_trainer():
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fused_sa=True))
    torch.manual_seed(0)
    return Trainer(build_model(cfg, num_features=1), cfg, device="cpu")


def _synthetic(b, n=256, seed=0):
    pos, feat, y, _ = synthetic_dataset(b, n, seed=seed)
    return CloudBatch.from_numpy(pos, feat, y, capacity=n, device="cpu")


def test_trainer_evaluates_and_predicts_a_fused_sa_model_but_refuses_its_step():
    """Evaluation and prediction of a fused_sa model, and its training step
    (once refused): a finite loss, every parameter with a gradient, every
    parameter and running statistic moved."""
    trainer = _fused_trainer()
    batch = _synthetic(3)
    pred = trainer.predict([batch])
    assert pred.shape == (3, 4) and np.isfinite(pred).all()
    assert np.array_equal(pred, trainer.predict([batch]))
    assert np.isfinite(trainer.evaluate([batch]))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss = trainer.step(batch, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(loss))
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    for k, v in trainer.model.state_dict().items():
        assert not torch.equal(v, before[k]), k


def test_serving_engine_serves_a_fused_sa_model_as_the_unfused_one():
    """The engine folds the BatchNorms and ignores the flag, as the JAX
    engine does: the same weights serve the same predictions either way."""
    fused = _fused_trainer().model
    unfused = build_model(TrainConfig(), num_features=1)
    unfused.load_state_dict(fused.state_dict())
    batch = _synthetic(2, seed=1)
    got = compile_inference(fused, "cpu")(batch)
    assert torch.equal(got, compile_inference(unfused, "cpu")(batch))
    with torch.inference_mode():
        module = fused(batch)
    assert rel_err(got.numpy(), module.numpy()) <= 5e-2  # folded bf16 serving vs the module
