"""Kernel 6 at the widths ``neuron_multiplier`` gives the fused_sa model: the
routing rule that sends each bf16 pass to the tensor-core kernels or to the
CUDA-core ones (``sa_train_kernel.mma_takes``, ``pass_source``), the forward's
packed weight block (``pack_fwd``) and vectors, and the plain version at the
neuron_multiplier 2 widths against the JAX package's ``fused_sa_mlp`` in
interpret mode, forward and gradients.

Tolerances are those of ``test_torch_sa_train.py`` (forward, max|diff| /
max|y|: 1e-5 in float32, 2e-3 in bf16) and ``test_torch_sa_train_bwd.py``
(gradients: 1e-4 of the call's largest in float32, and in bf16 1e-2 in
relative L2 norm per gradient whose true value is not 0). The bf16 gradients
are not held to 1e-4 of the largest element by element: at these widths a
bf16-rounded dh1 or dh2 that lies at a rounding boundary rounds one step the
other way under another float32 summation order, which moves single elements
of dW1 by up to 2.7e-4 (SA1) and 6.5e-4 (SA2) of the largest gradient; the
plain version moves that far against itself when only its products' sums are
taken in float64, as far as it lies from JAX.
"""

import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.pallas_sa_train import fused_sa_mlp as jax_fused_sa_mlp
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.ops import sa_train_kernel
from test_torch_sa_train import TOL
from test_torch_sa_train_bwd import BF16_L2, F32_TOL, PARAMS, _jax_grads, _torch_grads

import jax.numpy as jnp

torch.set_num_threads(1)

K = sa_train_kernel.K
# (CD, CP) of each layer of the fused_sa model: SA1 takes kernel 2's four
# plane channels, SA2 SA1's output as dense rows and three plane channels
FORMS = {"SA1": lambda nm: (0, 4), "SA2": lambda nm: (128 * nm, 3)}
# which layers' bf16 passes take the tensor cores, by neuron_multiplier
VERDICTS = {1: {"SA1": True, "SA2": True}, 2: {"SA1": True, "SA2": False},
            3: {"SA1": False, "SA2": False}}


def _model_widths(nm):
    model = PointNet2Regressor(num_features=1, fused_sa=True, neuron_multiplier=nm)
    return {name: tuple(lin.out_features for lin in sa.mlp.linears())
            for name, sa in (("SA1", model.sa1), ("SA2", model.sa2))}


@pytest.mark.parametrize("nm", [1, 2, 3])
def test_mma_takes_gives_the_widths_tables_verdicts(nm):
    """Every layer at neuron_multiplier 1 and SA1 at 2 run their bf16 passes
    F1-F3 and B1-B3 on the tensor cores; SA2 at 2 and both layers at 3 (C1 of
    192 or more) on the CUDA cores. Every f32 pass runs on the CUDA cores at
    any width."""
    widths = _model_widths(nm)
    assert widths["SA1"] == (64 * nm, 64 * nm, 128 * nm)
    assert widths["SA2"] == (128 * nm, 128 * nm, 256 * nm)
    for layer, form in FORMS.items():
        cd, cp = form(nm)
        takes = sa_train_kernel.mma_takes(cd, cp, *widths[layer])
        assert takes == VERDICTS[nm][layer], (nm, layer)
        params = {f"w{i + 1}": torch.zeros(1, c) for i, c in enumerate(widths[layer])}
        for stage in (1, 2, 3):
            for backward in (False, True):
                kind = "b" if backward else "f"
                on_cores = takes
                want = (f"csrc/fused_sa_{kind}{stage}.cu" if on_cores else
                        f"csrc/fused_sa_{'bwd' if backward else 'fwd'}.cu")
                assert sa_train_kernel.pass_source(stage, backward, cd, cp, params, True) == want
                assert sa_train_kernel.pass_source(stage, backward, cd, cp, params, False) == \
                    f"csrc/fused_sa_{'bwd' if backward else 'fwd'}.cu"


@pytest.mark.parametrize("layer", ["SA1", "SA2"])
@pytest.mark.parametrize("nm", [1, 2, 3])
def test_f1_runs_where_the_rule_takes_the_layer(nm, layer):
    """F1 in bf16 names ``csrc/fused_sa_f1.cu`` wherever ``mma_takes`` holds
    (both layers at neuron_multiplier 1, SA1 at 2) and ``csrc/fused_sa_fwd.cu``
    elsewhere and in f32; its shared memory, W1^T, b1, two input buffers and
    the sums, is never more than F2's."""
    cd, cp = FORMS[layer](nm)
    widths = _model_widths(nm)[layer]
    params = {f"w{i + 1}": torch.zeros(1, c) for i, c in enumerate(widths)}
    takes = sa_train_kernel.mma_takes(cd, cp, *widths)
    assert takes == VERDICTS[nm][layer]
    assert sa_train_kernel.pass_source(1, False, cd, cp, params, True) == (
        "csrc/fused_sa_f1.cu" if takes else "csrc/fused_sa_fwd.cu")
    assert sa_train_kernel.pass_source(1, False, cd, cp, params, False) == "csrc/fused_sa_fwd.cu"
    smem = sa_train_kernel._mma_smem(cd, cp, *widths)
    assert smem["f1"] <= smem["f2"]
    # csrc/fused_sa_f1.cu's Layout: W1^T, b1, two input buffers, the sums
    want = {(1, "SA1"): 3072 + 256 + 2 * 4160 + 2048, (1, "SA2"): 38912 + 512 + 2 * 20288 + 4096,
            (2, "SA1"): 6144 + 512 + 2 * 4160 + 4096}
    if (nm, layer) in want:
        assert smem["f1"] == want[nm, layer]


def test_mma_takes_holds_each_kernels_limits():
    """The rule's edges: C1 other than 64 or 128, C2 above 128 where C3 is 256
    (B1's dW3 tiles), more than 72 of B3's dW1 tiles (edge width 160 at C1
    128), and a weight block past a block's 227 KiB of shared memory (C3 at
    SA2 of 512)."""
    assert sa_train_kernel.mma_takes(128, 3, 128, 128, 256)
    assert not sa_train_kernel.mma_takes(128, 3, 192, 128, 256)
    assert sa_train_kernel.mma_takes(0, 4, 64, 192, 128)
    assert not sa_train_kernel.mma_takes(0, 4, 64, 192, 256)
    assert not sa_train_kernel.mma_takes(144, 3, 128, 128, 256)  # 160: 80 tiles
    assert not sa_train_kernel.mma_takes(128, 3, 128, 128, 512)
    smem = sa_train_kernel._mma_smem(128, 3, 128, 128, 256)  # SA2 x1: B3 the fullest
    assert max(smem, key=smem.get) == "b3" and smem["b3"] == 232064
    assert smem["b3"] <= sa_train_kernel.SMEM_MAX < sa_train_kernel._mma_smem(
        128, 3, 128, 128, 320)["b3"]


def _bf16_rne(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def test_pack_fwd_lays_out_the_weights_and_vectors():
    """``pack_fwd`` at SA1's neuron_multiplier 2 widths is ``_packed_bf16``:
    cut into W1^T (C1 x KX, the planes at column 0), W2^T (C2 x C1) and W3 (C2 x
    C3, as the backward also reads it), each row SKEW_H longer, it holds the
    weights rounded to bf16 and zeros elsewhere; ``pack_bwd`` hands on the
    forward's block itself. The forward's vectors are b1, sc1, sh1 (C1 each,
    the statistics' and terms' rows 0), then b2, sc2, sh2 likewise, then b3;
    F2's, before layer 2's fold exists, hold zeros there. Where the rule sends
    the layer to the CUDA cores there is no block."""
    rng = np.random.default_rng(6)
    cd, cp, (c1, c2, c3) = 0, 4, (128, 128, 256)
    dims = (cd + cp, c1, c2, c3)
    w = [rng.normal(size=dims[i:i + 2]).astype(np.float32) for i in range(3)]
    params = {f"w{i + 1}": torch.from_numpy(w[i]) for i in range(3)}
    params.update({f"b{i + 1}": torch.from_numpy(rng.normal(size=dims[i + 1]).astype(np.float32))
                   for i in range(3)})
    mask = torch.ones((1, 1, K), dtype=torch.bool)
    planes = torch.zeros((1, 1, K, cp))
    wb = sa_train_kernel.pack_fwd(None, planes, mask, params)
    assert torch.equal(wb, sa_train_kernel._packed_bf16(params, cd, cp, c1, c2, c3,
                                                         torch.device("cpu")))
    kx, skew = sa_train_kernel.edge_width(cd, cp), sa_train_kernel.SKEW_H
    shapes = [(c1, kx + skew), (c2, c1 + skew), (c2, c3 + skew)]
    parts = [p.view(s).float().numpy().copy() for p, s in
             zip(wb.split([r * c for r, c in shapes]), shapes)]
    for got, want in zip(parts, (_bf16_rne(w[0]).T, _bf16_rne(w[1]).T, _bf16_rne(w[2]))):
        np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]], want)
        got[:want.shape[0], :want.shape[1]] = 0.0
        assert not got.any()  # the padding and the skew
    folds = [(torch.from_numpy(rng.normal(size=c).astype(np.float32)),
              torch.from_numpy(rng.normal(size=c).astype(np.float32))) for c in (c1, c2)]
    stats = [(torch.ones(c), torch.ones(c)) for c in (c1, c2)]
    assert sa_train_kernel.pack_bwd(None, planes, mask, params, folds, stats, wb)[0] is wb
    for given in (1, 2):
        vec = sa_train_kernel._vectors_fwd(params, folds[:given], c1, c2, c3)
        assert vec.shape == (7 * (c1 + c2) + c3,)
        l1, l2 = vec[:7 * c1].view(7, c1), vec[7 * c1:7 * (c1 + c2)].view(7, c2)
        f2 = folds[1] if given == 2 else (torch.zeros(c2), torch.zeros(c2))
        assert torch.equal(l1[:3], torch.stack([params["b1"], *folds[0]]))
        assert torch.equal(l2[:3], torch.stack([params["b2"], *f2]))
        assert not l1[3:].any() and not l2[3:].any()
        assert torch.equal(vec[7 * (c1 + c2):], params["b3"])
    wide = {f"w{i + 1}": torch.zeros(d, c) for i, (d, c) in enumerate(((259, 256), (256, 256),
                                                                       (256, 512)))}
    assert sa_train_kernel.pack_fwd(torch.zeros((1, 1, K, 256)), torch.zeros((1, 1, K, 3)),
                                    mask, wide) is None


def _case(seed, cd, cp, widths, b=1, m=8):
    """numpy dense (invalid rows zero), planes, mask (centroid 3 without a valid
    slot), params scaled 1/sqrt(fan-in), as a layer's initialisation is."""
    rng = np.random.default_rng(seed)
    mask = rng.random((b, m, K)) > 0.3
    mask[0, 3] = False
    dense = (np.where(mask[..., None], rng.normal(size=(b, m, K, cd)), 0).astype(np.float32)
             if cd else None)
    planes = rng.normal(size=(b, m, K, cp)).astype(np.float32)
    ch = (cd + cp,) + tuple(widths)
    p = {}
    for i in range(3):
        p[f"w{i + 1}"] = (rng.normal(size=(ch[i], ch[i + 1])) / np.sqrt(ch[i])).astype(np.float32)
        p[f"b{i + 1}"] = (rng.normal(size=ch[i + 1]) * 0.1).astype(np.float32)
    for i in (1, 2):
        p[f"gamma{i}"] = rng.uniform(0.5, 1.5, ch[i]).astype(np.float32)
        p[f"beta{i}"] = (rng.normal(size=ch[i]) * 0.1).astype(np.float32)
    return dense, planes, mask, p


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("layer,act", [("SA1", "ReLU"), ("SA2", "ELU")])
def test_plain_version_at_x2_widths_matches_jax_interpret(layer, act, bf16):
    """The plain forward (output, statistics, argmax where the winner leads)
    and the gradients of the plain chain at neuron_multiplier 2's widths
    (SA1 [4, 128, 128, 256], SA2 [259, 256, 256, 512]) against the JAX
    function in interpret mode and ``jax.grad`` of it, at B=1 and M=8."""
    cd, cp = FORMS[layer](2)
    widths = _model_widths(2)[layer]
    dense, planes, mask, p = _case(20 + cd, cd, cp, widths)
    jt, tt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jd = None if dense is None else jnp.asarray(dense, jt)
    want_out, want_stats, want_am = jax_fused_sa_mlp(
        jd, [jnp.asarray(planes[..., c]) for c in range(cp)], jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in p.items()}, act=act, bf16=bf16, interpret=True,
        return_argmax=True)
    td = None if dense is None else torch.from_numpy(dense).to(tt)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, stats, am = sa_train_kernel._mlp(True, td, torch.from_numpy(planes),
                                          torch.from_numpy(mask), tp, None, act, bf16, True,
                                          True)
    want_out = np.asarray(want_out)
    scale = np.abs(want_out).max()
    assert np.abs(out.numpy() - want_out).max() <= TOL[bf16] * scale
    for g, w in zip(stats, want_stats):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL[bf16] * np.abs(w).max()
    srt = np.sort(np.where(mask[..., None], np.asarray(
        sa_train_kernel.hidden_plain(3, td, torch.from_numpy(planes), torch.from_numpy(mask), tp,
                                     _folds(tp, stats), act=act, bf16=bf16)
        .view(*mask.shape, -1)), -np.inf), axis=2)
    with np.errstate(invalid="ignore"):
        lead = (srt[:, :, -1] - srt[:, :, -2]) > TOL[bf16] * scale
    assert lead.sum() > 0 and np.array_equal(am.numpy()[lead], np.asarray(want_am)[lead])

    r = np.random.default_rng(21).normal(size=want_out.shape).astype(np.float32)
    jd_grad, jg = _jax_grads(dense, planes, mask, p, None, r, act, bf16, True)
    td, tg = _torch_grads(sa_train_kernel.fused_sa_mlp_plain, dense, planes, mask, p, None, r,
                          act, bf16, True)
    want = {k: np.asarray(jg[k], np.float64) for k in PARAMS}
    got = {k: tg[k].double().numpy() for k in PARAMS}
    if td is not None:
        want["dense"] = np.asarray(jd_grad.astype(jnp.float32), np.float64)
        got["dense"] = td.grad.double().numpy()
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if not bf16:
            assert np.abs(got[k] - w).max() <= F32_TOL * top, k
        elif k not in ("b1", "b2"):
            assert np.linalg.norm(got[k] - w) <= BF16_L2 * np.linalg.norm(w), k


def _folds(params, stats):
    """(sc, sh) of both layers from the batch statistics (mean1, var1, mean2,
    var2), as the forward folds them."""
    return [sa_train_kernel._fold(params[f"gamma{i}"], params[f"beta{i}"], stats[2 * i - 2],
                                  stats[2 * i - 1]) for i in (1, 2)]
