"""Kernel 6's backward, B1-B3 of the fused SA-layer MLP: the gradient of
``ops/sa_train_kernel.fused_sa_mlp`` (its ``torch.autograd.Function``, which
runs the plain passes on a CPU tensor) and of ``fused_sa_mlp_plain`` against
``jax.grad`` of the JAX package's ``fused_sa_mlp`` in interpret mode; a
float64 ``gradcheck``; the float64 forward against the JAX function under
x64; and the ``FusedSAMLP`` layer's parameter gradients against the JAX
layer's on bridged weights.

Tolerances. float32: max|diff| <= 1e-4 of the largest gradient of the call
(measured <= 5e-7): both sides take the same float32 products and sum them
in another order. bf16: the same bf16 x bf16 products, exact in float32, so
also 1e-4 of the largest gradient (measured <= 7e-6), and each gradient
within 1e-2 in relative L2 norm (measured <= 4e-5) unless its true value is
0 (the hidden layers' biases in train mode: a BatchNorm follows), which is
held by the first bound alone. float64: see its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.layers import FusedSAMLP as JaxFusedSAMLP
from dl_biomass_tpu.ops.pallas_sa_train import fused_sa_mlp as jax_fused_sa_mlp
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.models.layers import FusedSAMLP
from dl_biomass_tpu_torch.ops import sa_train_kernel
from test_torch_sa_train import B, FORMS, M, _case

torch.set_num_threads(1)

PARAMS = sa_train_kernel.PARAMS
F32_TOL = 1e-4  # of the call's largest gradient
BF16_L2 = 1e-2  # relative L2 norm per gradient


def _cotangent(seed, c3):
    return np.random.default_rng(seed).normal(size=(B, M, c3)).astype(np.float32)


def _jax_grads(dense, planes, mask, p, running, r, act, bf16, train, x64=False):
    """jax.grad of sum(out * r) in dense and every parameter."""
    jt = jnp.bfloat16 if bf16 else (jnp.float64 if x64 else jnp.float32)
    jpl = [] if planes is None else [jnp.asarray(planes[..., c]) for c in range(planes.shape[-1])]
    jrun = None if train else tuple(jnp.asarray(x) for x in running)

    def loss(d, pp):
        out = jax_fused_sa_mlp(d, jpl, jnp.asarray(mask), pp, jrun, act=act, bf16=bf16,
                               interpret=True, train=train)
        return jnp.sum((out[0] if train else out) * jnp.asarray(r))

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if dense is None:
        return None, jax.grad(loss, argnums=1)(None, jp)
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(dense, jt), jp)


def _torch_grads(fn, dense, planes, mask, p, running, r, act, bf16, train):
    tt = torch.bfloat16 if bf16 else torch.float32
    td = None if dense is None else torch.from_numpy(dense).to(tt).requires_grad_()
    tpl = None if planes is None else torch.from_numpy(planes).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    trun = None if train else tuple(torch.from_numpy(x) for x in running)
    out = fn(td, tpl, torch.from_numpy(mask), tp, trun, act=act, bf16=bf16, train=train)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.from_numpy(r)).sum().backward()
    assert tpl is None or tpl.grad is None  # the planes get no gradient
    return td, {k: tp[k].grad for k in PARAMS}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("form,act", [("planes", "ReLU"), ("dense", "LeakyReLU"),
                                      ("both", "ELU")])
def test_backward_matches_jax_grad(form, act, train, bf16):
    """The Function's and the plain chain's gradients (identical on the CPU)
    against jax.grad under a random cotangent, the fully invalid centroid
    included; dense gets its gradient in its own dtype."""
    cd, cp = FORMS[form]
    dense, planes, mask, p, running = _case(cd * 10 + cp + 1, cd, cp)
    r = _cotangent(5, 16)
    jd, jg = _jax_grads(dense, planes, mask, p, running, r, act, bf16, train)
    args = (dense, planes, mask, p, running, r, act, bf16, train)
    td, tg = _torch_grads(sa_train_kernel.fused_sa_mlp, *args)
    pd, pg = _torch_grads(sa_train_kernel.fused_sa_mlp_plain, *args)
    assert all(torch.equal(tg[k], pg[k]) for k in PARAMS)
    assert td is None or torch.equal(td.grad, pd.grad)
    want = {k: np.asarray(jg[k], np.float64) for k in PARAMS}
    got = {k: tg[k].double().numpy() for k in PARAMS}
    if td is not None:
        assert td.grad.dtype == td.dtype
        want["dense"] = np.asarray(jd.astype(jnp.float32), np.float64)
        got["dense"] = td.grad.double().numpy()
        assert not got["dense"][0, 3].any()  # no valid slot: no gradient
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= F32_TOL * top, k
        if bf16 and not (train and k in ("b1", "b2")):
            assert np.linalg.norm(got[k] - w) <= BF16_L2 * np.linalg.norm(w), k


def _f64_case(seed, cd=2, cp=3, b=1, m=3, widths=(4, 4, 8)):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, m, 64)) > 0.3
    mask[0, 1] = False
    dense = torch.from_numpy(np.where(mask[..., None], rng.normal(size=(b, m, 64, cd)), 0.0))
    planes = torch.from_numpy(rng.normal(size=(b, m, 64, cp)))
    ch = (cd + cp,) + widths
    p = {}
    for i in range(3):
        p[f"w{i + 1}"] = torch.from_numpy(rng.normal(size=(ch[i], ch[i + 1])) * 0.5)
        p[f"b{i + 1}"] = torch.from_numpy(rng.normal(size=ch[i + 1]) * 0.1)
    for i in (1, 2):
        p[f"gamma{i}"] = torch.from_numpy(rng.uniform(0.5, 1.5, ch[i]))
        p[f"beta{i}"] = torch.from_numpy(rng.normal(size=ch[i]) * 0.1)
    running = tuple(torch.from_numpy(f(ch[i])) for i in (1, 2)
                    for f in (lambda n: rng.normal(size=n) * 0.2,
                              lambda n: rng.uniform(0.5, 2.0, n)))
    return dense, planes, torch.from_numpy(mask), p, running


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_gradcheck_float64(train):
    """torch.autograd.gradcheck of the Function in float64 (ELU: smooth; the
    maxes lead their runners-up by far more than the finite step)."""
    dense, planes, mask, p, running = _f64_case(3)

    def fn(d, *values):
        out = sa_train_kernel.fused_sa_mlp(d, planes, mask, dict(zip(PARAMS, values)),
                                           None if train else running, act="ELU",
                                           train=train)
        return out[0] if train else out

    inputs = [dense.requires_grad_()] + [p[k].requires_grad_() for k in PARAMS]
    assert fn(*inputs).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_float64_forward_matches_jax_x64():
    """float64 inputs compute in float64 with the parameters promoted, as the
    JAX function does under x64: the statistics agree to float64 rounding, the
    output to float32 rounding (the JAX function casts it to float32; the
    port keeps float64) and the gradients to 1e-6."""
    dense, planes, mask, p, running = _f64_case(4, b=B, m=M)
    p32 = {k: v.float() for k, v in p.items()}  # promoted inside, as in JAX
    out, stats = sa_train_kernel.fused_sa_mlp_plain(dense, planes, mask, p32, act="ELU")[:2]
    assert out.dtype == torch.float64 and all(s.dtype == torch.float64 for s in stats)
    r = np.random.default_rng(6).normal(size=tuple(out.shape))
    jax.config.update("jax_enable_x64", True)
    try:
        jpl = [jnp.asarray(planes[..., c].numpy()) for c in range(planes.shape[-1])]
        jp = {k: jnp.asarray(v.numpy()) for k, v in p32.items()}
        want_out, want_stats = jax_fused_sa_mlp(jnp.asarray(dense.numpy()), jpl,
                                                jnp.asarray(mask.numpy()), jp, act="ELU",
                                                interpret=True)
        _, jg = _jax_grads(dense.numpy(), planes.numpy(), mask.numpy(),
                           {k: v.numpy() for k, v in p32.items()}, None, r, "ELU", False,
                           True, x64=True)
        jg = jax.tree.map(lambda x: np.asarray(x, np.float64), jg)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out, np.float64), rtol=2 ** -23)
    for got, want in zip(stats, want_stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), rtol=1e-10,
                                   atol=1e-12)
    tp = {k: v.clone().requires_grad_() for k, v in p32.items()}
    o = sa_train_kernel.fused_sa_mlp(dense, planes, mask, tp, act="ELU")[0]
    (o * torch.from_numpy(r)).sum().backward()
    for k in PARAMS:
        assert tp[k].grad.dtype == torch.float32  # each parameter's own dtype
        np.testing.assert_allclose(tp[k].grad.double().numpy(), jg[k], rtol=1e-6,
                                   atol=1e-6 * max(np.abs(x).max() for x in jg.values()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_sa_layer_gradients_match_jax(dtype, train):
    """FusedSAMLP's parameter gradients, gammas and betas included, against
    the JAX layer's on bridged weights under one cotangent; the dense block's
    gradient arrives in its own dtype (float32 here)."""
    dense, planes, mask, _, _ = _case(12, 4, 3)
    chans = [7, 8, 8, 16]
    jl = JaxFusedSAMLP(chans, act="ReLU", compute_dtype=getattr(jnp, dtype))
    jpl = [jnp.asarray(planes[..., c]) for c in range(3)]
    v = jl.init(jax.random.key(5), jnp.asarray(dense), jpl, jnp.asarray(mask), False)
    rng = np.random.default_rng(6)
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), v["batch_stats"])}
    r = _cotangent(7, 16)

    def loss(params):
        out = jl.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(dense),
                       jpl, jnp.asarray(mask), train, mutable=["batch_stats"])[0]
        return jnp.sum(out * jnp.asarray(r))

    jg = from_flax_variables({"params": jax.grad(loss)(v["params"]),
                              "batch_stats": v["batch_stats"]})
    tl = FusedSAMLP(chans, act="ReLU", compute_dtype=getattr(torch, dtype))
    tl.load_state_dict(from_flax_variables(v))
    td = torch.from_numpy(dense).requires_grad_()
    out = tl(td, torch.from_numpy(planes), torch.from_numpy(mask), train=train)
    (out * torch.from_numpy(r)).sum().backward()
    assert td.grad.dtype == torch.float32 and bool(torch.isfinite(td.grad).all())
    grads = dict(tl.named_parameters())
    top = max(float(jg[n].abs().max()) for n in grads)
    for name, prm in grads.items():
        got, want = prm.grad.double().numpy(), jg[name].double().numpy()
        assert np.abs(got - want).max() <= F32_TOL * top, name
        if dtype == "bfloat16" and not (train and name in ("lin0.bias", "lin1.bias")):
            assert np.linalg.norm(got - want) <= BF16_L2 * np.linalg.norm(want), name


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> the bf16 value nearest (ties to even), as float32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    up = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return up.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("cd,cp,widths", [
    (0, 4, (64, 64, 128)),  # SA1: the planes alone
    (128, 3, (128, 128, 256)),  # SA2
    (5, 3, (8, 24, 40)),  # no width a multiple of 16
], ids=["sa1", "sa2", "odd"])
def test_b3_bf16_weight_pack_unpacks_to_the_rounded_weights(cd, cp, widths):
    """The bf16 passes' shared weight block (``_packed_bf16``, the first part
    of ``pack_bwd``), cut into W1^T, W2^T and W3 as their kernels lay them out
    in shared memory (each part a whole number of 16-byte pieces, each row
    SKEW_H values longer), holds the weights rounded to bf16 (W1's dense rows
    at columns 0.., its plane rows from CD rounded up to 16) and zeros
    everywhere else."""
    rng = np.random.default_rng(3)
    dims = (cd + cp,) + widths
    w = [rng.normal(size=dims[i:i + 2]).astype(np.float32) for i in range(3)]
    params = {f"w{i + 1}": torch.from_numpy(w[i]) for i in range(3)}
    params.update({f"b{i}": torch.zeros(widths[i - 1]) for i in (1, 2, 3)})
    c1, c2, c3 = widths
    c1p, c2p, c3p = (-(-c // 64) * 64 for c in widths)
    kx, skew = sa_train_kernel.edge_width(cd, cp), sa_train_kernel.SKEW_H
    assert kx % 16 == 0 and kx >= cd + cp
    wb = sa_train_kernel._packed_bf16(params, cd, cp, c1p, c2p, c3p, torch.device("cpu"))
    mask = torch.ones((1, 1, 64), dtype=torch.bool)
    dense = torch.zeros((1, 1, 64, cd)) if cd else None
    ones = [(torch.ones(c), torch.ones(c)) for c in widths[:2]]
    shared, _ = sa_train_kernel.pack_bwd(dense, torch.zeros((1, 1, 64, cp)), mask, params, ones,
                                         ones)
    assert torch.equal(shared, wb)
    shapes = [(c1p, kx + skew), (c2p, c1p + skew), (c2p, c3p + skew)]
    sizes = [r * c for r, c in shapes]
    assert wb.dtype == torch.bfloat16 and wb.numel() == sum(sizes)
    assert all(2 * n % 16 == 0 for n in sizes)
    w1t, w2t, w3 = (p.view(shape).float().numpy().copy()
                    for p, shape in zip(wb.split(sizes), shapes))
    cols = [i if i < cd else -(-cd // 16) * 16 + (i - cd) for i in range(cd + cp)]
    for got, (rows, at), want in ((w1t, (slice(0, c1), cols), _bf16_rne(w[0]).T),
                                  (w2t, (slice(0, c2), slice(0, c1)), _bf16_rne(w[1]).T),
                                  (w3, (slice(0, c2), slice(0, c3)), _bf16_rne(w[2]))):
        np.testing.assert_array_equal(got[rows][:, at], want)
        got[rows, at] = 0.0
        assert not got.any()  # the padding and the skew


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_b3_bf16_vectors_lie_in_the_kernels_order(stage):
    """The bf16 passes' f32 vector block (``_vectors``, with ``_with_terms``
    adding the correction terms a pass has): b1, sc1, sh1, mean1, inv1, t1a,
    t1b, each zero-padded to C1, then the same seven of layer 2 padded to C2,
    as the kernels read them; the terms a pass does not have yet (B1: both
    layers', B2: layer 1's) 0, and the shared block unchanged."""
    rng = np.random.default_rng(4)
    c1, c2, c1p, c2p = 40, 24, 64, 64

    def vec(c):
        return torch.from_numpy(rng.normal(size=c).astype(np.float32))

    params = {"b1": vec(c1), "b2": vec(c2)}
    folds = [(vec(c1), vec(c1)), (vec(c2), vec(c2))]
    stats = [(vec(c1), vec(c1)), (vec(c2), vec(c2))]
    terms = [(vec(c2), vec(c2)), (vec(c1), vec(c1))]
    shared = sa_train_kernel._vectors(params, folds, stats, c1p, c2p)
    before = shared.clone()
    got = sa_train_kernel._with_terms(shared, terms[:stage - 1], c1p, c2p)
    assert torch.equal(shared, before)
    assert got.dtype == torch.float32 and got.shape == (7 * (c1p + c2p),)
    l1, l2 = got[:7 * c1p].view(7, c1p), got[7 * c1p:].view(7, c2p)
    zero1, zero2 = (torch.zeros(c) for c in (c1, c2))
    t2 = terms[0] if stage >= 2 else (zero2, zero2)
    t1 = terms[1] if stage == 3 else (zero1, zero1)
    for rows, c, want in ((l1, c1, [params["b1"], *folds[0], *stats[0], *t1]),
                          (l2, c2, [params["b2"], *folds[1], *stats[1], *t2])):
        assert torch.equal(rows[:, :c], torch.stack(want))
        assert not rows[:, c:].any()


def test_packed_block_check_refuses_other_widths():
    """``_check_packed`` takes the ``pack_bwd`` block of this call's widths and
    refuses one packed for another C3 or edge width, or in another type: the
    kernels copy as many bytes as the call's widths give."""
    rng = np.random.default_rng(5)
    cd, cp, widths = 0, 4, (64, 64, 128)
    dims = (cd + cp,) + widths
    params = {f"w{i + 1}": torch.from_numpy(rng.normal(size=dims[i:i + 2]).astype(np.float32))
              for i in range(3)}
    params.update({f"b{i}": torch.zeros(widths[i - 1]) for i in (1, 2, 3)})
    ones = [(torch.ones(c), torch.ones(c)) for c in widths[:2]]
    mask = torch.ones((1, 1, 64), dtype=torch.bool)
    packed = sa_train_kernel.pack_bwd(None, torch.zeros((1, 1, 64, cp)), mask, params, ones, ones)
    kx, cpu = sa_train_kernel.edge_width(cd, cp), torch.device("cpu")
    sa_train_kernel._check_packed(packed, kx, 64, 64, 128, cpu)
    for bad, args in (("c3", (packed, kx, 64, 64, 192)), ("kx", (packed, kx + 16, 64, 64, 128)),
                      ("type", ((packed[0], packed[1].double()), kx, 64, 64, 128))):
        with pytest.raises(ValueError, match="packed block"):
            sa_train_kernel._check_packed(*args, cpu)


@pytest.mark.parametrize("bf16,plain", [(True, False), (False, False), (True, True)],
                         ids=["bf16", "f32", "bf16-plain"])
def test_backward_packs_once_per_layer(monkeypatch, bf16, plain):
    """On CPU tensors a layer's backward packs nothing (every pass takes the
    plain version, which reads no block), in bf16 and f32, through the kernels'
    passes and the plain chain; ``_backward`` with ``pack`` (as a bf16 backward
    on the card runs it) packs the shared block once (``pack_bwd``) and hands
    that one block to B1, B2 and B3, and without it (f32) hands none; the
    gradients are those of the plain chain."""
    dense, planes, mask, p, _ = _case(11, 4, 3)
    calls, seen = [], []
    real_pack, real_stage = sa_train_kernel.pack_bwd, sa_train_kernel.fused_sa_bwd_stage

    def pack(*args, **kwargs):
        calls.append(real_pack(*args, **kwargs))
        return calls[-1]

    def stage(*args, **kwargs):
        seen.append(kwargs.get("packed"))
        return real_stage(*args, **kwargs)

    monkeypatch.setattr(sa_train_kernel, "pack_bwd", pack)
    monkeypatch.setattr(sa_train_kernel, "fused_sa_bwd_stage", stage)
    r = _cotangent(6, 16)
    fn = sa_train_kernel.fused_sa_mlp_plain if plain else sa_train_kernel.fused_sa_mlp
    args = (dense, planes, mask, p, None, r, "ReLU", bf16, True)
    td, tg = _torch_grads(fn, *args)
    assert not calls
    assert len(seen) == (0 if plain else 3) and all(x is None for x in seen)
    tt = torch.bfloat16 if bf16 else torch.float32
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x, pl, mk = torch.from_numpy(dense).to(tt), torch.from_numpy(planes), torch.from_numpy(mask)
    _, _, amax, state = sa_train_kernel._forward(sa_train_kernel.fused_sa_stage_plain, x, pl,
                                                 mk, tp, None, "ReLU", bf16, True)
    seen.clear()
    d, grads = sa_train_kernel._backward(stage, x, pl, mk, tp, state, torch.from_numpy(r), amax,
                                         "ReLU", bf16, True, pack=bf16)
    assert len(calls) == int(bf16) and len(seen) == 3
    assert all(s is (calls[0] if bf16 else None) for s in seen)
    assert torch.equal(d, td.grad.detach()) and all(torch.equal(grads[k], tg[k]) for k in PARAMS)
    monkeypatch.undo()
    pd, pg = _torch_grads(sa_train_kernel.fused_sa_mlp_plain, *args)
    assert torch.equal(td.grad, pd.grad) and all(torch.equal(tg[k], pg[k]) for k in PARAMS)
