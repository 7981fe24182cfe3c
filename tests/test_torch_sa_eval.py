"""Kernel 5, the fused SA1 eval layer: its plain version
(``ops/sa_eval_kernel.sa1_fused_eval_plain``, which the wrapper runs on a CPU
tensor) against the JAX package's ``sa1_fused_eval`` in interpret mode, and the
serving engine with ``fused_eval=True`` against the JAX engine with the same
flag, on the same weights through the bridge."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.inference import compile_inference as jax_compile_inference
from dl_biomass_tpu.ops.pallas_sa_eval import sa1_fused_eval as jax_sa1_fused_eval
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.ops import sa_eval_kernel
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

# f32: the two sum each dot product in another order; bf16: JAX's own bound for
# the fused kernel against the unfused chain (tests/test_pallas_sa_eval.py)
TOL = {False: 1e-5, True: 2e-2}


def _cloud(seed, b=2, n=512, m=128, f=1):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    mask = rng.random((b, n)) > 0.1
    feat = rng.normal(size=(b, n, f)).astype(np.float32)
    return pos, mask, feat, pos[:, :m].copy(), mask[:, :m].copy()


def _weights(seed, cin, h1, h2, cout):
    rng = np.random.default_rng(seed)
    shapes = ((cin, h1), (h1,), (h1, h2), (h2,), (h2, cout), (cout,))
    return [(rng.normal(size=s) * 0.3).astype(np.float32) for s in shapes]


def _both(pos, mask, feat, centers, cmask, ws, radius, bf16):
    """(port, JAX) outputs as float32 numpy."""
    want = jax_sa1_fused_eval(jnp.asarray(centers), jnp.asarray(cmask), jnp.asarray(pos),
                              jnp.asarray(mask), jnp.asarray(feat), [jnp.asarray(w) for w in ws],
                              radius=radius, interpret=True, bf16=bf16,
                              out_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    t = torch.from_numpy
    got = sa_eval_kernel.sa1_fused_eval(t(centers), t(cmask), t(pos), t(mask), t(feat),
                                        [t(w) for w in ws], radius=radius, bf16=bf16,
                                        out_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,m,f,widths", [
    (512, 128, 1, (16, 16, 32)),
    (512, 128, 1, (64, 64, 128)),  # the production widths
    (300, 50, 1, (8, 8, 16)),  # M no multiple of 32, N none of 128
    (384, 64, 4, (16, 16, 32)),  # the most features the engine's fused layer takes
    (256, 32, 6, (64, 64, 128)),  # 6 features: layer 1 deeper than 8 (f32) values
])
def test_plain_version_matches_jax_interpret(n, m, f, widths, bf16):
    pos, mask, feat, centers, cmask = _cloud(n + f, n=n, m=m, f=f)
    ws = _weights(m, f + 3, *widths)
    got, want = _both(pos, mask, feat, centers, cmask, ws, 0.9, bf16)
    assert got.shape == (2, m, widths[-1])
    np.testing.assert_allclose(got, want, atol=TOL[bf16], rtol=TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
def test_masked_and_isolated_centroids_give_zero_rows(bf16):
    """Centroids 40.. are masked and centroid 0 of cloud 0 has no point within
    the radius: both give exactly 0 in the port and in JAX."""
    pos, mask, feat, centers, cmask = _cloud(7, m=64)
    cmask &= np.arange(64)[None, :] < 40
    centers[0, 0] = 50.0
    ws = _weights(8, 4, 8, 8, 16)
    got, want = _both(pos, mask, feat, centers, cmask, ws, 0.9, bf16)
    for out in (got, want):
        assert (out[:, 40:] == 0).all() and (out[0, 0] == 0).all()
        assert np.abs(out[:, 1:40]).max() > 0
    np.testing.assert_allclose(got, want, atol=TOL[bf16], rtol=TOL[bf16])


def test_first_layer_rows_must_match_the_features():
    pos, mask, feat, centers, cmask = _cloud(9, m=32)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="features\\+3"):
        sa_eval_kernel.sa1_fused_eval(t(centers), t(cmask), t(pos), t(mask), t(feat),
                                      [t(w) for w in _weights(1, 5, 8, 8, 16)], radius=0.9)


@pytest.mark.parametrize("dtype,rtol,valid", [
    ("float32", F32_RTOL, [640, 517]),
    ("bfloat16", BF16_RTOL, [640, 517]),
    ("float32", F32_RTOL, [640, 300, 129]),  # a ragged mask
])
def test_fused_eval_engine_matches_jax_engine(dtype, rtol, valid):
    jb, tb = batches(4, len(valid), 640, valid)
    jm, v, tm = models("production", dtype, jb)
    want = np.asarray(jax_compile_inference(jm, v, fused_eval=True)(jb))
    got = compile_inference(tm, device="cpu", fused_eval=True)(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(valid), 4)
    assert rel_err(got.numpy(), want) <= rtol


def test_fused_eval_engine_matches_the_default_engine():
    """The fused layer computes what the default chain computes: kernel 2, the
    folded layers, masked_max (float32: to rounding of the sums)."""
    jb, tb = batches(5, 2, 640, [640, 517])
    _, _, tm = models("production", "float32", jb)
    fused = compile_inference(tm, device="cpu", fused_eval=True)(tb)
    default = compile_inference(tm, device="cpu")(tb)
    assert rel_err(fused.numpy(), default.numpy()) <= 1e-5


def _unpack(block, parts):
    """The block's parts, (dtype, shape) each in order, as float32 numpy."""
    out, at = [], 0
    for dt, shape in parts:
        n = int(np.prod(shape)) * (2 if dt == torch.bfloat16 else 4)
        out.append(block[at:at + n].view(dt).view(shape).float().numpy().copy())
        at += n
    assert at == block.numel()
    return out


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("f,widths", [(1, (64, 64, 128)), (4, (16, 48, 32))],
                         ids=["production", "padded"])
def test_pack_sa1_eval_lays_out_the_kernels_block(f, widths, bf16):
    """``pack_sa1_eval`` is the layout ``csrc/sa1_fused_eval.cu`` keeps in
    shared memory: in bf16 W1^T (H1 x 16), W2^T, W3^T rounded to bf16, each
    row 8 values longer, the biases float32 between them; in float32 w1 (8 x
    H1), w2, w3 as given, the biases beside each; the widths zero-padded to 64,
    zeros in the padding and the skew, every part a whole number of 16 bytes."""
    ws = _weights(3 + f, f + 3, *widths)
    block = sa_eval_kernel.pack_sa1_eval([torch.from_numpy(w) for w in ws], bf16, "cpu")
    h1, h2, c = (-(-w // 64) * 64 for w in widths)
    skew, bf, f32 = sa_eval_kernel.SKEW_H, torch.bfloat16, torch.float32
    if bf16:
        parts = [(bf, (h1, 16 + skew)), (f32, (h1,)), (bf, (h2, h1 + skew)), (f32, (h2,)),
                 (bf, (c, h2 + skew)), (f32, (c,))]
    else:
        parts = [(f32, (8, h1)), (f32, (h1,)), (f32, (h1, h2)), (f32, (h2,)), (f32, (h2, c)),
                 (f32, (c,))]
    assert block.dtype == torch.uint8
    assert block.numel() == sa_eval_kernel.block_bytes(h1, h2, c, bf16)
    assert all(np.prod(shape) * (2 if dt == bf else 4) % 16 == 0 for dt, shape in parts)
    got = _unpack(block, parts)
    for i, (part, w) in enumerate(zip(got, ws)):
        if w.ndim == 2:
            w = torch.from_numpy(w).to(bf).float().numpy().T if bf16 else w
        np.testing.assert_array_equal(part[tuple(slice(0, k) for k in w.shape)], w)
        part[tuple(slice(0, k) for k in w.shape)] = 0.0
        assert not part.any(), i  # the padding and the skew


def test_fused_eval_engine_packs_once(monkeypatch):
    """The fused_eval engine packs kernel 5's weight block once, when it is
    built, and hands that block to the kernel in every ``serve``."""
    packs, blocks = [], []
    real_pack, real_k5 = sa_eval_kernel.pack_sa1_eval, sa_eval_kernel.sa1_fused_eval

    def pack(*args, **kwargs):
        packs.append(real_pack(*args, **kwargs))
        return packs[-1]

    def k5(*args, **kwargs):
        blocks.append(kwargs["packed"])
        return real_k5(*args, **kwargs)

    monkeypatch.setattr(sa_eval_kernel, "pack_sa1_eval", pack)
    monkeypatch.setattr(sa_eval_kernel, "sa1_fused_eval", k5)
    _, tb = batches(6, 2, 640, [640, 517])
    _, _, tm = models("production", "bfloat16", batches(6, 2, 640, [640, 517])[0])
    serve = compile_inference(tm, device="cpu", fused_eval=True)
    assert len(packs) == 1 and packs[0].dtype == torch.uint8
    outs = [serve(tb) for _ in range(3)]
    assert len(packs) == 1 and len(blocks) == 3 and all(b is packs[0] for b in blocks)
    assert all(torch.equal(o, outs[0]) for o in outs)


# ---- the widths the fused_eval engine serves (neuron_multiplier 1, 2, 3) ------

# (neuron_multiplier, bf16) -> sa_eval_kernel.plan: the kernel, layer 3's column
# groups over gridDim.y and the shared memory of a block, as the card's own
# planner (csrc/sa1_fused_eval.cu plan_of) reported them on an H100
# (chip_compare.py eval5)
PLANS = {(1, True): ("mma", 1, 89216), (2, True): ("mma", 1, 170112),
         (3, True): ("mma", 2, 222592), (1, False): ("fma", 1, 92928),
         (2, False): ("fma_stream", 1, 147200), (3, False): ("fma_stream", 1, 217856)}


@pytest.mark.parametrize("nm,bf16", list(PLANS))
def test_plan_names_the_launch_at_every_width(nm, bf16):
    """SA1's widths at neuron_multiplier 1-3 (64, 64, 128) x nm each have a
    launch that fits a block's shared memory: bf16 on the tensor cores, at 3
    with layer 3 in two column groups; f32 with the weight block resident at 1
    and W2 and W3 streamed above."""
    p = sa_eval_kernel.plan(64 * nm, 64 * nm, 128 * nm, bf16)
    assert (p.kernel, p.column_groups, p.smem_bytes) == PLANS[nm, bf16]
    assert p.smem_bytes <= sa_eval_kernel.SMEM_MAX


@pytest.mark.parametrize("widths,bf16", [
    ((256, 256, 500), True), ((256, 256, 500), False),  # C no multiple of 64
    ((64, 100, 128), True),  # H2 no multiple of 64
    ((0, 64, 128), True),  # no H1
    ((64, 64, 100), False),  # no multiple of 64
])
def test_plan_refuses_widths_no_launch_takes(widths, bf16):
    """``plan`` takes padded widths only: multiples of 64, none empty."""
    assert sa_eval_kernel.plan(*widths, bf16) is None


# the wide kernel's launch at SA1's widths above neuron_multiplier 3, (64, 64, 128) x
# nm, in (bf16, f32): shared memory a block and the scratch bytes a block (a1 and a2
# in device memory where they do not fit beside the weight tiles)
WIDE_PLANS = {4: ((90880, 0), (170752, 0)), 8: ((156416, 0), (37632, 264192)),
              16: ((23296, 264192), (37632, 526336)), 32: ((23296, 526336), (37632, 1050624))}


@pytest.mark.parametrize("nm", list(WIDE_PLANS))
def test_plan_names_the_wide_launch_above_three(nm):
    """Above neuron_multiplier 3 SA1 runs the wide kernel in both dtypes: one
    centroid a 128-thread block, every weight streamed in tiles of 64 columns,
    a1 and a2 in shared memory up to x8 in bf16 and x4 in f32, in scratch
    above."""
    for bf16, want in zip((True, False), WIDE_PLANS[nm]):
        p = sa_eval_kernel.plan(64 * nm, 64 * nm, 128 * nm, bf16)
        assert (p.kernel, p.column_groups, (p.smem_bytes, p.scratch_bytes)) == ("wide", 1, want)
        assert p.smem_bytes <= sa_eval_kernel.SMEM_MAX


def test_plan_takes_every_sa1_width_and_input_width():
    """SA1 at every neuron_multiplier 1-32 and 1-16 point features has a launch
    in both dtypes: the resident kernels at 1-3 where layer 1 is one step deep
    (bf16 to 13 features, f32 to 5), the wide kernel everywhere else. The card
    holds csrc/sa1_fused_eval.cu's plan_of to these (tests/test_torch_cuda.py)."""
    for bf16 in (True, False):
        for nm in range(1, 33):
            for f in range(1, 17):
                p = sa_eval_kernel.plan(64 * nm, 64 * nm, 128 * nm, bf16, f=f)
                resident = nm <= 3 and f + 3 <= (16 if bf16 else 8)
                assert p is not None and (p.kernel != "wide") == resident, (bf16, nm, f, p)
                assert p.smem_bytes <= sa_eval_kernel.SMEM_MAX


def _wide_model(nm, dtype, num_features=1):
    import dataclasses

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.pointnet2 import build_model

    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype),
                              hp=dataclasses.replace(cfg.hp, neuron_multiplier=nm))
    torch.manual_seed(nm)
    return build_model(cfg, num_features=num_features).eval()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_refuses_widths_the_kernel_does_not_take_when_built(dtype, monkeypatch):
    """Where kernel 5 has no launch (here a card whose blocks hold 16 KiB of
    shared memory, less than any of its kernels needs), ``compile_inference``
    raises when the engine is built, citing ROADMAP C.2, not at its first
    ``serve``; the default engine of the same model builds."""
    model = _wide_model(4, dtype)
    monkeypatch.setattr(sa_eval_kernel, "SMEM_MAX", 16 * 1024)
    with pytest.raises(NotImplementedError, match="ROADMAP C.2"):
        compile_inference(model, device="cpu", fused_eval=True)
    compile_inference(model, device="cpu")


@pytest.mark.parametrize("nm", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_builds_at_every_sa1_width(nm, dtype):
    """``compile_inference(fused_eval=True)`` builds at neuron_multiplier 4, 8,
    16 and 32, as the JAX engine does, kernel 5 on the wide launch. At 16 and 32
    the model's SA1 is put on the x1 model: the engine reads SA1's widths only,
    and the rest of a x32 model (over 900 M parameters) is not built here."""
    from dl_biomass_tpu_torch.models.pointnet2 import SAModule

    if nm <= 8:
        model = _wide_model(nm, dtype)
    else:
        model = _wide_model(1, dtype)
        sa1 = model.sa1
        model.sa1 = SAModule(sa1.ratio, sa1.radius, [4, 64 * nm, 64 * nm, 128 * nm],
                             compute_dtype=sa1.compute_dtype, fast_group=True,
                             fast_fps=True).eval()
    captured = []
    real = sa_eval_kernel.check_widths
    with mock.patch.object(sa_eval_kernel, "check_widths",
                           lambda *a: captured.append(real(*a)) or captured[-1]):
        compile_inference(model, device="cpu", fused_eval=True)
    assert [p.kernel for p in captured] == ["wide"]


def test_engine_at_six_features_refuses_fused_eval_as_jax_does():
    """At 6 point features neither engine takes ``fused_eval``: both need the
    stratified SA1 path, which takes at most 4 features (kernel 5 itself takes
    6: ``test_plain_version_matches_jax_interpret``)."""
    jb, _ = batches(11, 2, 256, [256, 200])
    jb = type(jb)(pos=jb.pos, feat=jnp.zeros((2, 256, 6), jnp.float32), mask=jb.mask)
    jm, v, tm = models("production", "float32", jb, num_features=6)
    with pytest.raises(NotImplementedError, match="fused_eval requires"):
        jax_compile_inference(jm, v, fused_eval=True)
    with pytest.raises(NotImplementedError, match="fused_eval requires"):
        compile_inference(tm, device="cpu", fused_eval=True)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_eval_engine_at_x4_matches_jax_engine(dtype, rtol):
    """The fused_eval engine at neuron_multiplier 4 (the plain versions on the
    CPU) against the JAX engine with ``fused_eval=True`` on bridged weights,
    its fused SA1 kernel in interpret mode: B=2 x 512, one cloud cut to 400
    points; float32 to rounding of the sums (relative), bf16 within JAX's bound
    of the fused kernel against the unfused chain."""
    jb, tb = batches(12, 2, 512, [512, 400])
    jm, v, tm = models("production", dtype, jb, neuron_multiplier=4)
    want = np.asarray(jax_compile_inference(jm, v, fused_eval=True)(jb))
    got = compile_inference(tm, device="cpu", fused_eval=True)(tb)
    assert got.shape == (2, 4)
    assert rel_err(got.numpy(), want) <= rtol


@pytest.mark.parametrize("nm", [2, 3])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_eval_engine_serves_the_wide_widths(nm, dtype, rtol):
    """The fused_eval engine of the model at neuron_multiplier 2 and 3 builds
    and serves (the plain versions on the CPU), and computes what the default
    engine computes: float32 to rounding of the sums, bf16 within JAX's bound
    of the fused kernel against the unfused chain."""
    _, tb = batches(7, 2, 640, [640, 517])
    model = _wide_model(nm, dtype)
    fused = compile_inference(model, device="cpu", fused_eval=True)(tb)
    default = compile_inference(model, device="cpu")(tb)
    assert fused.shape == (2, 4) and bool(torch.isfinite(fused).all())
    assert rel_err(fused.numpy(), default.numpy()) <= rtol


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nm", [2, 3])
def test_plain_version_at_wide_widths_matches_jax_interpret(nm, bf16):
    """The plain version at SA1's neuron_multiplier 2 and 3 widths, (128, 128,
    256) and (192, 192, 384), against the JAX package's sa1_fused_eval in
    interpret mode: one cloud, 8 centroids."""
    pos, mask, feat, centers, cmask = _cloud(40 + nm, b=1, n=256, m=8)
    ws = _weights(50 + nm, 4, 64 * nm, 64 * nm, 128 * nm)
    got, want = _both(pos, mask, feat, centers, cmask, ws, 0.9, bf16)
    assert got.shape == (1, 8, 128 * nm) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=TOL[bf16], rtol=TOL[bf16])
