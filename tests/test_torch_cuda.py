"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the launches of a serving forward and of a training step.

Marked ``cuda``: without a card each test skips with the reason. On a machine
with one, ``python -m pytest tests/test_torch_cuda.py -m cuda`` builds the
kernels from ``dl_biomass_tpu_torch/csrc`` and runs these; ``chip_smoke.py``
holds the same comparisons at the serving shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor, build_model
from dl_biomass_tpu_torch.train.trainer import Trainer
from dl_biomass_tpu_torch.ops import (_build, ball_group_kernel, ball_query_kernel, fps_kernel,
                                      gather_kernel, sa_eval_kernel, sa_train_kernel,
                                      sum_slices_kernel, tail_kernel)
from dl_biomass_tpu_torch.tools import bn_stats_bench, bq_phase_bench, dma_probe
from fps_cases import EDGE_CASES, edge_case
from group_cases import CASES as GROUP_CASES
from group_cases import RADIUS as GROUP_RADIUS
from group_cases import group_case
from query_cases import CASES as QUERY_CASES
from query_cases import RADIUS as QUERY_RADIUS
from query_cases import query_case
from test_torch_sum_plan import planned_sum

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _cloud(dev, b=2, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.normal(size=(b, n, 3)) * 3).astype(np.float32)).to(dev)
    mask = torch.arange(n, device=dev)[None] < torch.tensor([n, n * 3 // 4], device=dev)[:, None]
    feat = torch.from_numpy(rng.normal(size=(b, n, 1)).astype(np.float32)).to(dev)
    return pos, mask, feat


# kernel 1 on each path of fps_kernel.plan: one warp a row (P 2 and 8, five
# rows so a block of four is left part-filled), 4 to 32 warps a row (the 7168
# splits, 1434 and 3584, fill no whole number of the row's threads), and the
# planes in scratch; then each edge case of tests/fps_cases.py on each path
FPS_SHAPES = [("gauss", 1, 1), ("gauss", 33, 8), ("gauss", 256, 64), ("gauss", 1280, 256),
              ("gauss", 1434, 359), ("gauss", 3584, 717), ("gauss", 10240, 128),
              ("gauss", 12000, 64)] + [(case, n, None) for case in EDGE_CASES
                                        for n in (64, 1434, 12000)]


@pytest.mark.parametrize("case,n,k", FPS_SHAPES)
def test_fps_kernel_matches_plain(dev, case, n, k):
    if case == "gauss":
        rng = np.random.default_rng(n)
        pos = torch.from_numpy((rng.normal(size=(5, n, 3)) * 3).astype(np.float32)).to(dev)
        valid = torch.tensor([n, n * 3 // 4, n // 2, 1, n], device=dev)
        mask = torch.arange(n, device=dev)[None] < valid[:, None]
        starts = torch.from_numpy(rng.integers(0, n, size=5).astype(np.int32)).to(dev)
    else:
        pos, mask, starts, k = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                                for a in edge_case(case, n))
    got = fps_kernel.fps_rows(pos, mask, starts, k)
    again = fps_kernel.fps_rows(pos, mask, starts, k)
    assert torch.equal(got, fps_kernel.fps_rows_plain(pos, mask, starts, k))
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ball_group_kernel_matches_plain(dev, dtype):
    pos, mask, feat = _cloud(dev)
    centers, cmask = pos[:, :200].contiguous(), mask[:, :200].contiguous()
    got = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, radius=2.0,
                                       out_dtype=dtype)
    want = ball_group_kernel.ball_group_plain(centers, cmask, pos, mask, feat, radius=2.0,
                                              out_dtype=dtype)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


def _same_group(got, want):
    assert torch.equal(got[1], want[1])
    assert (got[0] is None and want[0] is None) or torch.equal(got[0], want[0])
    bits = torch.int16 if got[2].dtype == torch.bfloat16 else torch.int32
    assert got[2].dtype == want[2].dtype and torch.equal(got[2].view(bits), want[2].view(bits))


# kernel 2 on each edge case of tests/group_cases.py with 0, 1 and 4 features,
# bf16 and f32 out, with and without indices: bit-identical to the plain
# version and across two launches
@pytest.mark.parametrize("case", list(GROUP_CASES))
@pytest.mark.parametrize("f", [0, 1, 4])
def test_ball_group_edge_cases_match_plain(dev, case, f):
    centers, cmask, pos, mask, _ = (torch.from_numpy(a).to(dev) if a is not None else None
                                    for a in group_case(case))
    rng = np.random.default_rng(f)
    feat = (torch.from_numpy(rng.normal(size=(*pos.shape[:2], f)).astype(np.float32)).to(dev)
            if f else None)
    for dtype in (torch.bfloat16, torch.float32):
        for need_idx in (True, False):
            kw = dict(radius=GROUP_RADIUS, out_dtype=dtype, need_idx=need_idx)
            got = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, **kw)
            again = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, **kw)
            _same_group(got, ball_group_kernel.ball_group_plain(centers, cmask, pos, mask, feat,
                                                                **kw))
            _same_group(got, again)


# the paths' cloud sizes (each of ball_group_kernel.plan's chunks), 20608 points
# beyond what one shared-memory cloud would hold, and garbage in masked points
@pytest.mark.parametrize("n", [7168, 10240, 20608])
def test_ball_group_kernel_at_path_widths_matches_plain(dev, n):
    pos, mask, feat = _cloud(dev, n=n, seed=n)
    pos = torch.where(mask[..., None], pos, torch.full_like(pos, 1e4))
    centers, cmask = pos[:, :300].contiguous(), mask[:, :300].contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        kw = dict(radius=2.0, out_dtype=dtype, need_idx=True)
        _same_group(ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, **kw),
                    ball_group_kernel.ball_group_plain(centers, cmask, pos, mask, feat, **kw))


def _same_query(args, radius, k):
    """Kernel 3 index-exact against its plain version, two launches identical,
    and its full-scan instantiation equal to both."""
    got = ball_query_kernel.ball_query_first_k(*args, radius=radius, k=k)
    again = ball_query_kernel.ball_query_first_k(*args, radius=radius, k=k)
    full = ball_query_kernel.probe(*args, radius=radius, k=k, mode="full_scan")
    want = ball_query_kernel.ball_query_plain(*args, radius=radius, k=k)
    torch.cuda.synchronize()
    for x in (want, again, full):
        assert torch.equal(got[0], x[0]) and torch.equal(got[1], x[1])


def test_ball_query_kernel_matches_plain(dev):
    pos, mask, _ = _cloud(dev)
    centers, cmask = pos[:, :300].contiguous(), mask[:, :300].contiguous()
    _same_query((centers, cmask, pos, mask), 3.0, 64)


@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_ball_query_kernel_cases_match_plain(dev, case):
    """Each case of tests/query_cases.py (N on either side of 32 and 128, k
    below and above N, empty, full and coincident balls, masked points,
    clouds and centroids, points a rounding step either side of the radius)."""
    centers, cmask, pos, mask, k = query_case(case)
    _same_query([torch.from_numpy(a).to(dev) for a in (centers, cmask, pos, mask)],
                QUERY_RADIUS, k)


# the largest cloud ball_query_kernel.plan stages whole at k=64
QUERY_WHOLE_EDGE = max(n for n in range(128, 20608, 128)
                       if ball_query_kernel.plan(n, 300, 64).whole)


# whole clouds (2048, 10240 and the largest a block stages) and clouds staged
# in chunks (one point more, and 20609 points: no multiple of 32 or of the
# chunk), at SA1's and SA2's radius, with garbage in the masked points
@pytest.mark.parametrize("n", [2048, 10240, QUERY_WHOLE_EDGE, QUERY_WHOLE_EDGE + 1, 20609])
@pytest.mark.parametrize("radius", [2.0, 8.0])
def test_ball_query_kernel_at_path_widths_matches_plain(dev, n, radius):
    pos, mask, _ = _cloud(dev, n=n, seed=n)
    pos = torch.where(mask[..., None], pos, torch.full_like(pos, 1e4))
    centers, cmask = pos[:, :300].contiguous(), mask[:, :300].contiguous()
    assert ball_query_kernel.plan(n, 300, 64).whole == (n <= QUERY_WHOLE_EDGE)
    _same_query((centers, cmask, pos, mask), radius, 64)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 128), (torch.float32, 3)])
def test_gather_kernel_matches_plain(dev, dtype, c):
    values = torch.randn(2, 500, c, device=dev).to(dtype)
    idx = torch.randint(-2, 502, (2, 37, 64), device=dev, dtype=torch.int32)
    assert torch.equal(gather_kernel.gather_rows(values, idx),
                       gather_kernel.gather_rows_plain(values, idx))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 128), (torch.float32, 24),
                                     (torch.bfloat16, 3)])
def test_gather_aux_kernel_matches_plain_bit_for_bit(dev, dtype, c):
    values = torch.randn(2, 500, c, device=dev).to(dtype)
    aux = torch.randn(2, 500, 3, device=dev) * 7
    idx = torch.randint(-2, 502, (2, 37, 64), device=dev, dtype=torch.int32)
    got = gather_kernel.gather_rows_aux(values, idx, aux)
    want = gather_kernel.gather_rows_aux_plain(values, idx, aux)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sa_weights(dev, widths, f=1, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dims = (f + 3,) + widths
    out = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        out += [torch.randn(cin, cout, device=dev, generator=g) * 0.3,
                torch.randn(cout, device=dev, generator=g) * 0.3]
    return out


@pytest.mark.parametrize("bf16,widths,tol", [(True, (64, 64, 128), 1e-2),
                                             (False, (64, 64, 128), 1e-5),
                                             (False, (16, 16, 32), 1e-5)])  # padded widths
def test_sa1_fused_eval_kernel_matches_plain(dev, bf16, widths, tol):
    """Against the plain version at max|diff| <= tol * max|y|; masked and
    isolated centroids give rows of exactly 0 in both."""
    pos, mask, feat = _cloud(dev)
    centers, cmask = pos[:, :200].clone(), mask[:, :200].clone()
    cmask[:, 150:] = False
    centers[0, 0] = 50.0
    ws = _sa_weights(dev, widths)
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    got = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, radius=2.0,
                                        bf16=bf16, out_dtype=out_dtype)
    want = sa_eval_kernel.sa1_fused_eval_plain(centers, cmask, pos, mask, feat, ws, radius=2.0,
                                               bf16=bf16, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    for out in (got, want):
        assert bool((out[:, 150:] == 0).all()) and bool((out[0, 0] == 0).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_sa1_fused_eval_packed_block_is_the_wrappers_own(dev, bf16):
    """Kernel 5 on a ``pack_sa1_eval`` block made once gives the bits it gives
    when the wrapper packs for itself, within 1e-2 (bf16) of the plain
    version; a block of other widths, dtype or device raises ``ValueError``
    and launches nothing."""
    pos, mask, feat = _cloud(dev)
    centers, cmask = pos[:, :300].contiguous(), mask[:, :300].contiguous()
    ws = _sa_weights(dev, (64, 64, 128))
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    kw = dict(radius=2.0, bf16=bf16, out_dtype=out_dtype)
    block = sa_eval_kernel.pack_sa1_eval(ws, bf16, dev)
    got = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, packed=block, **kw)
    again = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, packed=block, **kw)
    alone = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, **kw)
    want = sa_eval_kernel.sa1_fused_eval_plain(centers, cmask, pos, mask, feat, ws, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, alone)
    err = float((got.float() - want.float()).abs().max())
    assert err <= (1e-2 if bf16 else 1e-5) * float(want.float().abs().max())
    for bad in (sa_eval_kernel.pack_sa1_eval(_sa_weights(dev, (64, 64, 192)), bf16, dev),
                sa_eval_kernel.pack_sa1_eval(ws, not bf16, dev), block.cpu()):
        _build.launch_counts.clear()
        with pytest.raises(ValueError, match="packed block"):
            sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, packed=bad, **kw)
        assert not _build.launch_counts


@pytest.mark.parametrize("dtype,n,c", [(torch.bfloat16, 500, 128), (torch.float32, 300, 24),
                                       (torch.bfloat16, 2048, 128)])
def test_scatter_kernel_matches_plain_bit_for_bit(dev, dtype, n, c):
    """Both sum each output row in ascending flat-row order in float32."""
    g = torch.Generator(device=dev).manual_seed(0)
    ct = torch.randn(3, 37, 64, c, device=dev, generator=g).to(dtype)
    idx = torch.randint(-2, n + 2, (3, 37, 64), device=dev, dtype=torch.int32, generator=g)
    idx[2, 10:] = 0  # a long segment: pad slots at index 0
    got = gather_kernel.scatter_rows(ct, idx, n)
    want = gather_kernel.scatter_rows_plain(ct, idx, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


# kernel 4b at the cases the model's index gives it: row 0 takes a cloud's pad
# slots beside its true neighbours (a segment of about 500 rows), a cloud with
# no contribution, N no multiple of 32, the training batch of 36 clouds (R =
# 32768 rows: eight blocks a cloud of the count and place passes); each also
# bit-identical across two launches
SCATTER_CASES = {"row0_500": (2, 100, 300, 128), "empty_cloud": (3, 37, 500, 128),
                 "n_odd": (2, 70, 1003, 24), "b36": (36, 512, 2048, 128)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_kernel_at_the_models_cases(dev, case, dtype):
    """Bit for bit the plain version's, and a second launch's; no float atomics."""
    b, m, n, c = SCATTER_CASES[case]
    g = torch.Generator(device=dev).manual_seed(len(case))
    ct = torch.randn(b, m, 64, c, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, n, (b, m, 64), device=dev, dtype=torch.int32, generator=g)
    if case == "row0_500":  # true neighbours of row 0 and about 510 pad slots (index 0)
        idx[0, :, 62:] = 0
        idx[0, 95:] = 0
        assert int((idx[0] == 0).sum()) >= 500
    if case == "empty_cloud":
        idx[1] = -1  # out of range: contributes nothing
        idx[2] = 0  # every slot a pad
    got = gather_kernel.scatter_rows(ct, idx, n)
    again = gather_kernel.scatter_rows(ct, idx, n)
    want = gather_kernel.scatter_rows_plain(ct, idx, n)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, n, c)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(got, again)
    if case == "empty_cloud":
        assert not got[1].any()


# kernel 5 at the widths neuron_multiplier 2 to 32 give SA1, in bf16 and f32: at 2
# and 3 the resident kernels (bf16 at 3 with layer 3 split over gridDim.y, f32 with
# W2 and W3 streamed), above them the wide kernel (a1 and a2 in scratch from 16 in
# bf16, from 8 in f32); widths no SA1 has (H2 other than H1, C other than 2 H1); and
# 6 and 16 features (layer 1 one or two MMA steps deep), at 1
WIDE_SA1 = [(True, (128, 128, 256), 1), (True, (192, 192, 384), 1),
            (False, (128, 128, 256), 1), (False, (192, 192, 384), 1),
            (True, (256, 256, 512), 1), (False, (256, 256, 512), 1),
            (True, (512, 512, 1024), 1), (False, (512, 512, 1024), 1),
            (True, (1024, 1024, 2048), 1), (False, (1024, 1024, 2048), 1),
            (True, (2048, 2048, 4096), 1), (False, (2048, 2048, 4096), 1),
            (True, (64, 128, 192), 1), (False, (128, 64, 64), 1),
            (True, (64, 64, 128), 6), (False, (64, 64, 128), 6),
            (True, (64, 64, 128), 16), (False, (256, 256, 512), 16)]
WIDE_IDS = ["bf16x2", "bf16x3", "f32x2", "f32x3", "bf16x4", "f32x4", "bf16x8", "f32x8",
            "bf16x16", "f32x16", "bf16x32", "f32x32", "bf16_h2", "f32_c", "bf16_f6", "f32_f6",
            "bf16_f16", "f32x4_f16"]


@pytest.mark.parametrize("bf16,widths,f", WIDE_SA1, ids=WIDE_IDS)
def test_sa1_fused_eval_kernel_at_wide_widths(dev, bf16, widths, f):
    """Against the plain version (1e-2 of max|y| in bf16, 1e-5 in f32) at an odd
    M, masked and isolated centroids 0 in both, a repeat bit-identical, and the
    launch the card reports the one ``plan`` names."""
    pos, mask, _ = _cloud(dev)
    feat = torch.randn(*pos.shape[:2], f, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(f))
    centers, cmask = pos[:, :201].clone(), mask[:, :201].clone()
    cmask[:, 150:] = False
    centers[0, 0] = 50.0
    ws = _sa_weights(dev, widths, f=f, seed=3)
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    kw = dict(radius=2.0, bf16=bf16, out_dtype=out_dtype)
    got = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, **kw)
    again = sa_eval_kernel.sa1_fused_eval(centers, cmask, pos, mask, feat, ws, **kw)
    want = sa_eval_kernel.sa1_fused_eval_plain(centers, cmask, pos, mask, feat, ws, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape == (2, 201, widths[2])
    assert torch.equal(got, again)
    for out in (got, want):
        assert bool((out[:, 150:] == 0).all()) and bool((out[0, 0] == 0).all())
    assert torch.equal((got == 0).all(-1), (want == 0).all(-1))
    err = float((got.float() - want.float()).abs().max())
    assert err <= (1e-2 if bf16 else 1e-5) * float(want.float().abs().max())
    occ = sa_eval_kernel.occupancy(bf16, *widths, f=f)
    p = sa_eval_kernel.plan(*widths, bf16, f=f)
    assert (occ["kernel"], occ["column_groups"], occ["smem_bytes"], occ["scratch_bytes"]) == \
        (p.kernel, p.column_groups, p.smem_bytes, p.scratch_bytes)
    assert occ["blocks_per_sm"] >= 1


def test_plan_of_agrees_with_plan_on_every_sa1_width(dev):
    """csrc/sa1_fused_eval.cu's plan_of names the launch ``plan`` names at SA1's
    widths for neuron_multiplier 1-32 and 1-16 point features, in both dtypes
    (the sweep of tests/test_torch_sa_eval.py), and the card holds a block of
    each at once."""
    for bf16 in (True, False):
        for nm in range(1, 33):
            for f in range(1, 17):
                widths = (64 * nm, 64 * nm, 128 * nm)
                occ = sa_eval_kernel.occupancy(bf16, *widths, f=f)
                p = sa_eval_kernel.plan(*widths, bf16, f=f)
                assert (occ["kernel"], occ["column_groups"], occ["smem_bytes"],
                        occ["scratch_bytes"]) == (p.kernel, p.column_groups, p.smem_bytes,
                                                  p.scratch_bytes), (bf16, nm, f)
                assert occ["blocks_per_sm"] >= 1


@pytest.mark.parametrize("nm", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_eval_engine_at_wide_widths_matches_the_plain_engine(dev, nm, dtype):
    """``compile_inference(fused_eval=True)`` serves the model at
    neuron_multiplier 2, 3, 4 and 8 through kernel 5, within the serving bound of
    the plain-version engine of the same weights (the engine on the CPU): 1e-2
    of max|y| in bf16, 1e-4 in f32."""
    rng = np.random.default_rng(nm)
    pos = [rng.normal(size=(1024, 3)).astype(np.float32) * 3 for _ in range(2)]
    feat = [rng.normal(size=(1024, 1)).astype(np.float32) for _ in range(2)]
    y = rng.normal(size=(2, 4)).astype(np.float32)
    torch.manual_seed(nm)
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=str(dtype).replace("torch.", "")), hp=dataclasses.replace(
            cfg.hp, neuron_multiplier=nm))
    model = build_model(cfg, num_features=1).eval()  # the production flags at these widths
    batch = CloudBatch.from_numpy(pos, feat, y, capacity=1024, device=dev)
    serve = compile_inference(model.to(dev), dev, fused_eval=True)
    _build.launch_counts.clear()
    got = serve(batch)
    torch.cuda.synchronize()
    assert _build.launch_counts["dlbt_sa1_fused_eval"] == 1
    plain = compile_inference(model.cpu(), "cpu", fused_eval=True)(batch.to("cpu"))
    rel = float((got.cpu() - plain).abs().max() / plain.abs().max())
    assert rel <= (1e-2 if dtype == torch.bfloat16 else 1e-4)


def test_train_step_launches_every_kernel(dev):
    rng = np.random.default_rng(2)
    pos = [rng.normal(size=(640, 3)).astype(np.float32) * 3 for _ in range(4)]
    feat = [rng.normal(size=(640, 1)).astype(np.float32) for _ in range(4)]
    y = rng.normal(size=(4, 4)).astype(np.float32)
    batch = CloudBatch.from_numpy(pos, feat, y, device=dev)
    model = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                               compute_dtype=torch.bfloat16)
    trainer = Trainer(model, TrainConfig())
    _build.launch_counts.clear()
    loss = trainer.step(batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert dict(_build.launch_counts) == {"dlbt_fps": 2, "dlbt_ball_group": 1,
                                          "dlbt_ball_query": 1, "dlbt_gather": 1,
                                          "dlbt_scatter_rows": 1}


def test_unsplit_train_step_launches_the_aux_gather(dev):
    rng = np.random.default_rng(3)
    pos = [rng.normal(size=(640, 3)).astype(np.float32) * 3 for _ in range(4)]
    feat = [rng.normal(size=(640, 1)).astype(np.float32) for _ in range(4)]
    y = rng.normal(size=(4, 4)).astype(np.float32)
    batch = CloudBatch.from_numpy(pos, feat, y, device=dev)
    model = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                               split_first_layer=False, compute_dtype=torch.bfloat16)
    trainer = Trainer(model, TrainConfig())
    _build.launch_counts.clear()
    loss = trainer.step(batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert dict(_build.launch_counts) == {"dlbt_fps": 2, "dlbt_ball_group": 1,
                                          "dlbt_ball_query": 1, "dlbt_gather_aux": 1,
                                          "dlbt_scatter_rows": 1}


@pytest.mark.parametrize("fused_eval,split,launched", [
    (False, True, {"dlbt_fps": 2, "dlbt_ball_group": 1, "dlbt_ball_query": 1, "dlbt_gather": 1}),
    (True, True, {"dlbt_fps": 2, "dlbt_sa1_fused_eval": 1, "dlbt_ball_query": 1,
                  "dlbt_gather": 1}),
    (False, False, {"dlbt_fps": 2, "dlbt_ball_group": 1, "dlbt_ball_query": 1,
                    "dlbt_gather_aux": 1}),
])
def test_serving_launches_every_kernel(dev, fused_eval, split, launched):
    rng = np.random.default_rng(1)
    pos = [rng.normal(size=(640, 3)).astype(np.float32) * 3 for _ in range(2)]
    feat = [rng.normal(size=(640, 1)).astype(np.float32) for _ in range(2)]
    batch = CloudBatch.from_numpy(pos, feat, device=dev)
    model = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True,
                               split_first_layer=split, compute_dtype=torch.bfloat16).to(dev)
    _build.launch_counts.clear()
    out = compile_inference(model, fused_eval=fused_eval)(batch)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 4) and bool(torch.isfinite(out).all())
    assert dict(_build.launch_counts) == launched


def _fused_sa_case(dev, b, m, cd, cp, widths, bf16, seed=0):
    """Kernel 6's inputs: dense (invalid rows zero) in the compute type,
    planes, a mask with one centroid without a valid slot, the weights and
    two folded BatchNorms."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(b, m, 64, device=dev, generator=g) > 0.3
    mask[0, 3] = False
    dense = None
    if cd:
        dense = torch.randn(b, m, 64, cd, device=dev, generator=g) * mask[..., None]
        dense = dense.to(torch.bfloat16 if bf16 else torch.float32)
    planes = torch.randn(b, m, 64, cp, device=dev, generator=g) if cp else None
    dims = (cd + cp,) + widths
    params = {}
    for i in range(3):
        params[f"w{i + 1}"] = torch.randn(dims[i], dims[i + 1], device=dev, generator=g) * 0.2
        params[f"b{i + 1}"] = torch.randn(dims[i + 1], device=dev, generator=g) * 0.1
    folds = [(0.5 + torch.rand(c, device=dev, generator=g),
              0.1 * torch.randn(c, device=dev, generator=g)) for c in widths[:2]]
    return dense, planes, mask, params, folds


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,m,cd,cp,widths", [
    (2, 12, 0, 4, (8, 8, 16)),  # small widths: zero-padded to 64
    (2, 12, 4, 3, (8, 8, 16)),
    (2, 300, 0, 4, (64, 64, 128)),  # SA1's production widths
    (2, 128, 128, 3, (128, 128, 256)),  # SA2's
], ids=["small-planes", "small-both", "sa1", "sa2"])
def test_fused_sa_kernel_matches_plain(dev, b, m, cd, cp, widths, bf16):
    """Each pass against the plain version: statistics and output within
    1e-5 (f32) or 1e-2 (bf16) of max|y|, the argmax wherever the winner leads
    by more, 0 and -1 for the centroid without a valid slot, and a second
    launch bit-identical."""
    dense, planes, mask, params, folds = _fused_sa_case(dev, b, m, cd, cp, widths, bf16)
    tol = 1e-2 if bf16 else 1e-5
    for stage in (1, 2, 3):
        args = (stage, dense, planes, mask, params, folds)
        got = sa_train_kernel.fused_sa_stage(*args, bf16=bf16)
        again = sa_train_kernel.fused_sa_stage(*args, bf16=bf16)
        want = sa_train_kernel.fused_sa_stage_plain(*args, bf16=bf16)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        scale = float(want[0].abs().max())
        assert float((got[0] - want[0]).abs().max()) <= tol * scale
        if stage < 3:
            assert float((got[1] - want[1]).abs().max()) <= tol * float(want[1].abs().max())
            continue
        out, am = got
        assert bool((out[0, 3] == 0).all()) and bool((am[0, 3] == -1).all())
        h3 = sa_train_kernel.hidden_plain(3, *args[1:], bf16=bf16).view(b, m, 64, -1)
        top2 = torch.where(mask[..., None], h3, float("-inf")).topk(2, dim=2).values
        lead = (top2[:, :, 0] - top2[:, :, 1]) > tol * scale
        assert torch.equal(am[lead], want[1][lead])


def _fused_sa_bwd_case(dev, b, m, cd, cp, widths, bf16, seed=1, empty_every=0):
    """The backward's inputs beside the forward's: the forward's first argmax
    (the centroids without a valid slot: -1), a cotangent, the statistics
    (mean, inv) and the correction terms. ``empty_every`` > 0 empties every
    such centroid of each cloud besides centroid 3 of the first."""
    dense, planes, mask, params, folds = _fused_sa_case(dev, b, m, cd, cp, widths, bf16, seed)
    if empty_every:
        mask[:, ::empty_every] = False
        if dense is not None:
            dense = dense * mask[..., None]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    _, amax = sa_train_kernel.fused_sa_stage_plain(3, dense, planes, mask, params, folds,
                                                   bf16=bf16)
    cot = torch.randn(b, m, widths[2], device=dev, generator=g)
    stats = [(0.1 * torch.randn(c, device=dev, generator=g),
              0.5 + torch.rand(c, device=dev, generator=g)) for c in widths[:2]]
    terms = [(0.01 * torch.randn(c, device=dev, generator=g),
              0.01 * torch.randn(c, device=dev, generator=g)) for c in (widths[1], widths[0])]
    return dense, planes, mask, params, folds, stats, terms, cot, amax


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,m,cd,cp,widths,empty_every", [
    (2, 13, 0, 4, (8, 8, 16), 0),  # odd M, small widths zero-padded to 64
    (3, 37, 5, 3, (8, 8, 16), 0),
    (2, 300, 0, 4, (64, 64, 128), 0),  # SA1's production widths
    (2, 129, 128, 3, (128, 128, 256), 0),  # SA2's
    # every 7th centroid empty; 3 x 211 centroids, a multiple of no grid of
    # whole SMs, so the blocks of the persistent grid end on other counts
    (3, 211, 128, 3, (128, 128, 256), 7),
    # bf16 B3's two other tile counts: SA1 at neuron_multiplier 2 (C1 128, one
    # dW1 tile a warp) and 40 plane channels at SA1's widths (more than one)
    (2, 40, 0, 4, (128, 128, 256), 0),
    (2, 40, 0, 40, (64, 64, 128), 0),
    # bf16 B1 splits C3 into groups of 256 columns: 320 leaves a last group of 64
    (2, 45, 0, 4, (128, 128, 320), 0),
], ids=["small-planes", "small-both", "sa1", "sa2", "sa2-empty", "sa1-x2", "wide-planes",
        "b1-groups"])
def test_fused_sa_bwd_kernel_matches_plain(dev, b, m, cd, cp, widths, empty_every, bf16):
    """Each backward pass against the plain version: every output within
    1e-5 (f32) or 1e-2 (bf16) of its max|.|, d(dense) 0 on every row of each
    centroid without a valid slot, and a second launch bit-identical."""
    args = _fused_sa_bwd_case(dev, b, m, cd, cp, widths, bf16, empty_every=empty_every)
    empty = ~args[2].any(-1)
    tol = 1e-2 if bf16 else 1e-5
    for stage in (1, 2, 3):
        got = sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=bf16)
        again = sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=bf16)
        want = sa_train_kernel.fused_sa_bwd_stage_plain(stage, *args, bf16=bf16)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for x, y, z in zip(got, again, want):
            if z is None:
                assert x is None and stage == 3 and cd == 0
                continue
            assert x.shape == z.shape and torch.equal(x, y)
            err = float((x.float() - z.float()).abs().max())
            assert err <= tol * float(z.float().abs().max()), (stage, err)
        if stage == 3 and cd:
            assert got[2].dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert bool(empty[0, 3]) and bool((got[2][empty] == 0).all())


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fused_sa_bwd_bf16_refuses_widths_its_kernels_do_not_take(dev, stage):
    """At C1 = 192 no bf16 pass has a tensor-core kernel (``mma_takes`` says
    so before any launch): each bf16 pass runs the CUDA-core kernel instead,
    within 1e-2 of the plain version, its launch counted, as the f32 pass
    does within 1e-5; a tensor-core block handed to it raises and launches
    nothing."""
    for bf16, tol in ((True, 1e-2), (False, 1e-5)):
        args = _fused_sa_bwd_case(dev, 2, 20, 0, 4, (192, 64, 64), bf16)
        assert not sa_train_kernel.mma_takes(0, 4, 192, 64, 64)
        assert sa_train_kernel.pass_source(stage, True, 0, 4, args[3], bf16) == \
            "csrc/fused_sa_bwd.cu"
        assert sa_train_kernel.pack_bwd(*args[:6]) is None
        _build.launch_counts.clear()
        got = sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=bf16)
        want = sa_train_kernel.fused_sa_bwd_stage_plain(stage, *args, bf16=bf16)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {f"dlbt_fused_sa_b{stage}": 1}
        for x, z in zip(got, want):
            if z is not None:
                assert float((x.float() - z.float()).abs().max()) <= \
                    tol * float(z.float().abs().max())
    block = sa_train_kernel._packed_bf16(args[3], 0, 4, 192, 64, 64, dev)
    _build.launch_counts.clear()
    with pytest.raises(ValueError, match="tensor-core block"):
        sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=True,
                                           packed=(block, torch.zeros(7 * 256, device=dev)))
    assert not _build.launch_counts


def _planted_ties(dense, planes, mask, every=5):
    """Empty every ``every``-th centroid; in the others copy slot 1's inputs
    into slot 40 (both valid), so that the two tie in every column: the
    later slot may never win. Returns the pairs' centroid mask."""
    mask[:, ::every] = False
    tied = mask.any(-1)
    mask[..., 1] = mask[..., 40] = tied
    for x in (dense, planes):
        if x is not None:
            x[..., 40, :] = x[..., 1, :]
            x *= mask[..., None]
    return tied


@pytest.mark.parametrize("b,m,cd,cp,widths", [
    (2, 301, 0, 4, (64, 64, 128)),  # SA1's widths, odd M
    (3, 129, 128, 3, (128, 128, 256)),  # SA2's
    (2, 45, 0, 4, (128, 128, 256)),  # SA1 at neuron_multiplier 2
], ids=["sa1", "sa2", "sa1-x2"])
def test_fused_sa_forward_tensor_cores_match_plain(dev, b, m, cd, cp, widths):
    """bf16 F1, F2 and F3 on the tensor cores (``csrc/fused_sa_f1.cu``,
    ``_f2.cu``, ``_f3.cu``; ``mma_takes`` these widths): F1's and F2's
    statistics and F3's output
    within 1e-2 of the plain version's max|y|, F3's argmax equal wherever the
    winner leads by more, 0 and -1 at every centroid without a valid slot, a
    planted tie won by the first slot, and two launches bit-identical, on one
    ``pack_fwd`` block and on one each pass packs for itself."""
    dense, planes, mask, params, folds = _fused_sa_case(dev, b, m, cd, cp, widths, True)
    tied = _planted_ties(dense, planes, mask)
    empty = ~mask.any(-1)
    assert sa_train_kernel.mma_takes(cd, cp, *widths)
    wb = sa_train_kernel.pack_fwd(dense, planes, mask, params)
    assert wb is not None and wb.dtype == torch.bfloat16
    for stage in (1, 2, 3):
        assert sa_train_kernel.pass_source(stage, False, cd, cp, params, True) == \
            f"csrc/fused_sa_f{stage}.cu"
        args = (stage, dense, planes, mask, params, folds)
        _build.launch_counts.clear()
        got = sa_train_kernel.fused_sa_stage(*args, bf16=True, packed=wb)
        again = sa_train_kernel.fused_sa_stage(*args, bf16=True)
        want = sa_train_kernel.fused_sa_stage_plain(*args, bf16=True)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {f"dlbt_fused_sa_f{stage}": 2}
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        scale = float(want[0].abs().max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-2 * scale
        if stage < 3:
            assert float((got[1] - want[1]).abs().max()) <= 1e-2 * float(want[1].abs().max())
            continue
        out, am = got
        assert bool((out[empty] == 0).all()) and bool((am[empty] == -1).all())
        assert bool((am[~empty] >= 0).all())
        assert not bool((am[tied] == 40).any()) and not bool((want[1][tied] == 40).any())
        h3 = sa_train_kernel.hidden_plain(3, *args[1:], bf16=True).view(b, m, 64, -1)
        top2 = torch.where(mask[..., None], h3, float("-inf")).topk(3, dim=2).values
        # the planted pair fills the top two where slot 1 wins: compare with the third
        second = torch.where(top2[:, :, 0] == top2[:, :, 1], top2[:, :, 2], top2[:, :, 1])
        lead = (top2[:, :, 0] - second) > 1e-2 * scale
        assert int(lead.sum()) > 0 and torch.equal(am[lead], want[1][lead])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fused_sa_forward_refuses_a_packed_block_of_other_widths(dev, stage):
    """A bf16 forward pass on the tensor cores handed a ``pack_fwd`` block made
    for other widths raises ``ValueError`` and launches nothing, where the
    block of its own widths runs."""
    dense, planes, mask, params, folds = _fused_sa_case(dev, 2, 20, 0, 4, (64, 64, 128), True)
    other = _fused_sa_case(dev, 2, 20, 0, 4, (64, 64, 192), True)
    args = (stage, dense, planes, mask, params, folds)
    _build.launch_counts.clear()
    with pytest.raises(ValueError, match="packed block"):
        sa_train_kernel.fused_sa_stage(*args, bf16=True,
                                       packed=sa_train_kernel.pack_fwd(*other[:4]))
    assert not _build.launch_counts
    sa_train_kernel.fused_sa_stage(*args, bf16=True,
                                   packed=sa_train_kernel.pack_fwd(dense, planes, mask, params))
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {f"dlbt_fused_sa_f{stage}": 1}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,m,cd,cp,widths", [
    (2, 20, 0, 4, (192, 192, 384)),  # SA1 at neuron_multiplier 3 (C1 = 192)
    (2, 21, 256, 3, (256, 256, 512)),  # SA2 at neuron_multiplier 2
    (1, 13, 384, 3, (384, 384, 768)),  # SA2 at neuron_multiplier 3
], ids=["sa1-x3", "sa2-x2", "sa2-x3"])
def test_fused_sa_passes_beyond_the_tensor_cores_match_plain(dev, b, m, cd, cp, widths, bf16):
    """Every pass at widths the tensor-core kernels do not take runs the
    CUDA-core kernel (``pass_source`` and the launch counts say which), in
    bf16 and f32, within 1e-2 (bf16) or 1e-5 (f32) of the plain version, F3's
    zero rows and d(dense)'s zero rows at the centroid without a valid slot,
    and two launches bit-identical. At SA2's widths B2 and B3 keep buffers in
    the scratch buffer (``_bwd_slice_bytes`` > 0); F3 at neuron_multiplier 3
    takes the widest forward layout. ELU in both types: at these widths some
    of the 10^5 hidden ReLU inputs lie within rounding of 0, where the kernel's
    and the plain version's sums fall on either side and move a whole term of
    d(dense) (with ReLU at SA2 x2 and x3 of the model, 2.9e-2 and 3.0e-2 of its
    max on an H100; with ELU 2.1e-3: chip_compare.py acts)."""
    act = "ELU"
    tol = 1e-2 if bf16 else 1e-5
    args = _fused_sa_bwd_case(dev, b, m, cd, cp, widths, bf16)
    dense, planes, mask, params, folds = args[:5]
    assert not sa_train_kernel.mma_takes(cd, cp, *widths)
    assert sa_train_kernel.pack_fwd(dense, planes, mask, params) is None
    if cd:
        kp = -(-(cd + cp) // 4) * 4
        assert all(sa_train_kernel._bwd_slice_bytes(s, kp, *widths) > 0 for s in (2, 3))
    for stage in (1, 2, 3):
        assert sa_train_kernel.pass_source(stage, False, cd, cp, params, bf16) == \
            "csrc/fused_sa_fwd.cu"
        fargs = (stage, dense, planes, mask, params, folds)
        _build.launch_counts.clear()
        got = sa_train_kernel.fused_sa_stage(*fargs, bf16=bf16, act=act)
        again = sa_train_kernel.fused_sa_stage(*fargs, bf16=bf16, act=act)
        want = sa_train_kernel.fused_sa_stage_plain(*fargs, bf16=bf16, act=act)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {f"dlbt_fused_sa_f{stage}": 2}
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for x, z in zip(got, want) if stage < 3 else zip(got[:1], want[:1]):
            assert float((x - z).abs().max()) <= tol * float(z.abs().max()), (stage, "fwd")
        if stage == 3:
            assert bool((got[0][0, 3] == 0).all()) and bool((got[1][0, 3] == -1).all())
    for stage in (1, 2, 3):
        assert sa_train_kernel.pass_source(stage, True, cd, cp, params, bf16) == \
            "csrc/fused_sa_bwd.cu"
        _build.launch_counts.clear()
        got = sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=bf16, act=act)
        again = sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=bf16, act=act)
        want = sa_train_kernel.fused_sa_bwd_stage_plain(stage, *args, bf16=bf16, act=act)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {f"dlbt_fused_sa_b{stage}": 2}
        for x, y, z in zip(got, again, want):
            if z is None:
                continue
            assert torch.equal(x, y)
            err = float((x.float() - z.float()).abs().max())
            assert err <= tol * float(z.float().abs().max()), (stage, err)
        if stage == 3 and cd:
            assert got[2].dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert bool((got[2][0, 3] == 0).all())


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fused_sa_bwd_refuses_a_packed_block_of_other_widths(dev, stage):
    """A bf16 pass handed a ``pack_bwd`` block made for other widths raises
    ``ValueError`` and launches nothing, where the block of its own widths
    runs."""
    args = _fused_sa_bwd_case(dev, 2, 20, 0, 4, (64, 64, 128), True)
    other = _fused_sa_bwd_case(dev, 2, 20, 0, 4, (64, 64, 192), True)
    dense, planes, mask, params, folds, stats = other[:6]
    _build.launch_counts.clear()
    with pytest.raises(ValueError, match="packed block"):
        sa_train_kernel.fused_sa_bwd_stage(
            stage, *args, bf16=True,
            packed=sa_train_kernel.pack_bwd(dense, planes, mask, params, folds, stats))
    assert not _build.launch_counts
    own = sa_train_kernel.pack_bwd(*args[:6])
    sa_train_kernel.fused_sa_bwd_stage(stage, *args, bf16=True, packed=own)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {f"dlbt_fused_sa_b{stage}": 1}


def test_fused_sa_backward_shares_one_packed_block(dev, monkeypatch):
    """A bf16 backward through ``fused_sa_mlp`` hands B1, B2 and B3 one packed
    block, and each pass's outputs, and so the gradients, are bit-identical to
    those of the same pass called alone (which packs for itself)."""
    dense, planes, mask, params, _ = _fused_sa_case(dev, 2, 129, 128, 3, (128, 128, 256), True)
    g = torch.Generator(device=dev).manual_seed(7)
    for i, c in ((1, 128), (2, 128)):
        params[f"gamma{i}"] = 0.5 + torch.rand(c, device=dev, generator=g)
        params[f"beta{i}"] = 0.1 * torch.randn(c, device=dev, generator=g)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = dense.clone().requires_grad_()
    calls, real = [], sa_train_kernel.fused_sa_bwd_stage

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(sa_train_kernel, "fused_sa_bwd_stage", record)
    out, _ = sa_train_kernel.fused_sa_mlp(x, planes, mask, leaves, bf16=True)
    out.backward(torch.randn(out.shape, device=dev, generator=g))
    torch.cuda.synchronize()
    assert [c[0][0] for c in calls] == [1, 2, 3]
    packed = calls[0][1]["packed"]
    assert packed is not None and all(c[1]["packed"] is packed for c in calls)
    alone = []
    for args, kwargs, got in calls:
        want = real(*args, **{k: v for k, v in kwargs.items() if k != "packed"})
        assert all(torch.equal(a, b) for a, b in zip(got, want) if b is not None)
        alone.append(want)
    torch.cuda.synchronize()
    (dw3, db3, sdb2, sdb2x), (dw2, db2, sdb1, sdb1x), (dw1, db1, d_dense) = alone
    for name, want in dict(w3=dw3, b3=db3, gamma2=sdb2x, beta2=sdb2, w2=dw2, b2=db2,
                           gamma1=sdb1x, beta1=sdb1, w1=dw1, b1=db1).items():
        assert torch.equal(leaves[name].grad, want), name
    assert torch.equal(x.grad, d_dense)


def test_fused_sa_model_launches_kernel_6(dev):
    """The fused_sa model's eval forward runs F3 at both SA layers, its
    train-mode forward F1, F2 and F3, and its training step F1-F3 and B1-B3
    at both, with kernel 4b carrying SA2's d(dense) back to SA1, and every
    parameter gets a finite gradient."""
    rng = np.random.default_rng(4)
    pos = [rng.normal(size=(640, 3)).astype(np.float32) * 3 for _ in range(2)]
    feat = [rng.normal(size=(640, 1)).astype(np.float32) for _ in range(2)]
    y = rng.normal(size=(2, 4)).astype(np.float32)
    batch = CloudBatch.from_numpy(pos, feat, y, device=dev)
    model = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, fused_sa=True,
                               compute_dtype=torch.bfloat16).to(dev)
    common = {"dlbt_fps": 2, "dlbt_ball_group": 1, "dlbt_ball_query": 1, "dlbt_gather_aux": 1}
    _build.launch_counts.clear()
    with torch.inference_mode():
        out = model(batch)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 4) and bool(torch.isfinite(out).all())
    assert dict(_build.launch_counts) == dict(common, dlbt_fused_sa_f3=2)
    _build.launch_counts.clear()
    with torch.no_grad():
        out = model(batch, train=True, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert dict(_build.launch_counts) == dict(common, dlbt_fused_sa_f1=2, dlbt_fused_sa_f2=2,
                                              dlbt_fused_sa_f3=2)
    _build.launch_counts.clear()
    loss = Trainer(model, TrainConfig()).step(batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert dict(_build.launch_counts) == dict(
        common, dlbt_scatter_rows=1, **{f"dlbt_fused_sa_{p}{i}": 2 for p in "fb" for i in (1, 2, 3)})
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def _tail_inputs(dev, b, m, c2, c3, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a2 = torch.randn((b, m, 64, c2), device=dev, generator=g).to(torch.bfloat16)
    mask = torch.rand((b, m, 64), device=dev, generator=g) > 0.3
    mask[0, 3] = False
    w3 = 0.1 * torch.randn((c2, c3), device=dev, generator=g)
    b3 = 0.1 * torch.randn((c3,), device=dev, generator=g)
    return a2, mask, w3, b3


@pytest.mark.parametrize("b,m,c2,c3", [(2, 32, 64, 128), (2, 20, 128, 256), (3, 500, 64, 128)])
def test_fused_tail_kernel_matches_plain(dev, b, m, c2, c3):
    """Kernel 7's forward and backward against their plain versions (bf16:
    1e-2 of the largest), empty rows 0 with argmax 64, NaN junk at invalid
    slots changing nothing, da2 exactly 0 at every slot no column routes to,
    and two launches bit-identical."""
    a2, mask, w3, b3 = _tail_inputs(dev, b, m, c2, c3)
    out, am = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    again = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    want, w_am = tail_kernel.fused_tail_fwd_plain(a2, mask, w3, b3, with_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), again[0].view(torch.int16))
    assert torch.equal(am, again[1])
    assert float((out.float() - want.float()).abs().max()) <= 1e-2 * float(want.float().abs().max())
    assert bool((out[0, 3] == 0).all()) and bool((am[0, 3] == 64).all())
    assert float((am != w_am).float().mean()) < 0.01  # near ties only
    junk = torch.where(mask[..., None], a2, torch.tensor(float("nan"), dtype=a2.dtype, device=dev))
    assert torch.equal(tail_kernel.fused_tail_fwd(junk, mask, w3, b3)[0].view(torch.int16),
                       out.view(torch.int16))
    gb = torch.randn((b, m, c3), device=dev).to(torch.bfloat16)
    da2, dw3 = tail_kernel.fused_tail_bwd(a2, gb, am, w3)
    da2_b, dw3_b = tail_kernel.fused_tail_bwd(a2, gb, am, w3)
    w_da2, w_dw3 = tail_kernel.fused_tail_bwd_plain(a2, gb, am, w3)
    torch.cuda.synchronize()
    assert torch.equal(da2.view(torch.int16), da2_b.view(torch.int16))
    assert torch.equal(dw3.view(torch.int32), dw3_b.view(torch.int32))
    for got, ref in ((da2, w_da2), (dw3, w_dw3)):
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 1e-2 * float(ref.float().abs().max())
    hit = torch.zeros((b, m, 65), dtype=torch.bool, device=dev).scatter_(2, am.long(), True)
    assert bool((da2[~hit[:, :, :64]] == 0).all())  # invalid slots among them


# wgmma at tail_bench's (64, 128) and (128, 256); mma.sync at the rest, among
# them the widest the plan takes in C2 and in C3
TAIL_WIDTHS = [(16, 32), (64, 128), (128, 256), (96, 160), (704, 32), (16, 4320)]


def _tail_case(dev, m, c2, c3, seed=3):
    """Three clouds of m centroids: NaN junk at every invalid slot, NaN at
    valid slots (one feature of one slot of centroid (0, 0), and every valid
    slot of centroid (1, 0)), and one row with no valid slot (the last of
    cloud 2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a2 = torch.randn((3, m, 64, c2), device=dev, generator=g).to(torch.bfloat16)
    mask = torch.rand((3, m, 64), device=dev, generator=g) > 0.3
    mask[2, m - 1] = False
    mask[0, 0, 5] = True
    a2 = torch.where(mask[..., None], a2, torch.tensor(float("nan"), dtype=a2.dtype, device=dev))
    a2[0, 0, 5, c2 // 2] = float("nan")
    a2[1, 0, :, 1] = float("nan")  # every slot, so every valid one
    w3 = 0.1 * torch.randn((c2, c3), device=dev, generator=g)
    b3 = 0.1 * torch.randn((c3,), device=dev, generator=g)
    return a2, mask, w3, b3


def _tail_lead(a2, mask, w3, b3):
    """Where the plain max leads the second value by more than one bf16 step:
    there the kernel's argmax, summed in another order, must agree."""
    b, m, k, c2 = a2.shape
    z = ((a2.float().reshape(-1, c2) @ w3.to(torch.bfloat16).float()) + b3).to(torch.bfloat16)
    z = torch.where(mask[..., None], z.view(b, m, k, -1), float("-inf"))
    top2 = z.topk(2, dim=2).values.float()
    _, e = torch.frexp(top2[:, :, 0])
    return (top2[:, :, 0] - top2[:, :, 1]) > torch.ldexp(torch.ones_like(top2[:, :, 0]), e - 8)


@pytest.mark.parametrize("m", [1, 13, 500])
@pytest.mark.parametrize("c2,c3", TAIL_WIDTHS)
def test_fused_tail_forward_kernel_cases(dev, c2, c3, m):
    """Kernel 7's forward on the plan's widths against its plain version:
    NaN exactly where the plain version's is, with argmax 64 (the JAX rule);
    0 and 64 on the row with no valid slot; the rest within 1e-2 of the
    largest, the argmax equal where the winner leads; the output the same
    bits with and without the argmax and across two launches."""
    a2, mask, w3, b3 = _tail_case(dev, m, c2, c3)
    want, w_am = tail_kernel.fused_tail_fwd_plain(a2, mask, w3, b3, with_argmax=True)
    out, am = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    again, am_again = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    alone, none = tail_kernel.fused_tail_fwd(a2, mask, w3, b3)
    alone_again, _ = tail_kernel.fused_tail_fwd(a2, mask, w3, b3)
    torch.cuda.synchronize()
    assert none is None
    for x in (again, alone, alone_again):
        assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    assert torch.equal(am, am_again)
    nan = want.isnan()
    assert bool(nan[0, 0].all()) and bool(nan[1, 0].all())
    assert torch.equal(out.isnan(), nan) and bool((am[nan] == 64).all())
    assert torch.equal(w_am[nan], am[nan])
    assert bool((out[2, m - 1] == 0).all()) and bool((am[2, m - 1] == 64).all())
    assert torch.equal(w_am[2, m - 1], am[2, m - 1])
    ok = ~nan
    err = float((out[ok].float() - want[ok].float()).abs().max())
    assert err <= 1e-2 * float(want[ok].float().abs().max())
    lead = _tail_lead(a2, mask, w3, b3) & ok
    assert torch.equal(am[lead], w_am[lead])
    assert m == 1 or float(lead.float().mean()) > 0.5


@pytest.mark.parametrize("c2,c3", TAIL_WIDTHS)
def test_fused_tail_forward_launch_is_the_plans(dev, c2, c3):
    """The launch ``tail_kernel.plan`` names is the one the source makes (its
    shared memory and threads), with and without the argmax; the measurement
    modes run on it: staging alone writes zeros, staging and products a
    finite checksum."""
    p = tail_kernel.plan(c2, c3)
    for argmax in (False, True):
        occ = tail_kernel.occupancy(c2, c3, argmax)
        assert occ["smem_bytes"] == p.smem_bytes and occ["threads"] == 32 * p.warps
        assert occ["blocks_per_sm"] >= 1
    a2, mask, w3, b3 = _tail_inputs(dev, 2, 40, c2, c3)
    _build.launch_counts.clear()
    staged = tail_kernel.probe(a2, mask, w3, b3, "stage_only")
    summed = tail_kernel.probe(a2, mask, w3, b3, "mma_only")
    tail_kernel.probe(a2, mask, w3, b3, "compute_only")
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"dlbt_fused_tail_fwd": 3}
    assert bool((staged == 0).all()) and bool(torch.isfinite(summed).all())


def _bwd_case(dev, m, c2, c3, junk, w_bad):
    """``_tail_case`` with Inf in a2 (+Inf at a slot of centroid (2, 0), -Inf at
    one of (1, m - 1)), NaN and Inf in the cotangent, and, where ``w_bad``, one
    Inf in W3; ``junk`` "nan" keeps its NaN at every invalid slot (every dW3
    entry is then NaN, as the dense sum makes it), "1e4" puts 1e4 there, so
    that only the features with a NaN or Inf slot carry them. Returns a2,
    mask, w3, b3, the forward kernel's argmax and the bf16 cotangent."""
    a2, mask, w3, b3 = _tail_case(dev, m, c2, c3)
    if junk == "1e4":
        a2 = torch.where(mask[..., None], a2, torch.tensor(1e4, dtype=a2.dtype, device=dev))
    a2[2, 0, 7, 2] = float("inf")
    a2[1, m - 1, 9, 0] = float("-inf")
    if w_bad:
        w3[c2 // 3, c3 // 2] = float("inf")
    with torch.no_grad():
        _, am = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    g = torch.Generator(device=dev).manual_seed(5)
    gb = torch.randn((3, m, c3), device=dev, generator=g).to(torch.bfloat16)
    gb[0, m - 1, c3 // 3] = float("nan")
    gb[2, 0, 0] = float("inf")
    return a2, mask, w3, b3, am, gb


def _same_nonfinite(got, want):
    """NaN, +Inf and -Inf at the same positions; the rest within 1e-2 of the
    largest finite value."""
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isposinf(), want.isposinf())
    assert torch.equal(got.isneginf(), want.isneginf())
    ok = want.isfinite()
    if bool(ok.any()):
        err = float((got[ok] - want[ok]).abs().max())
        assert err <= 1e-2 * max(float(want[ok].abs().max()), 1e-30)


@pytest.mark.parametrize("w_bad", [False, True])
@pytest.mark.parametrize("junk", ["nan", "1e4"])
@pytest.mark.parametrize("m", [1, 13, 500])
@pytest.mark.parametrize("c2,c3", TAIL_WIDTHS)
def test_fused_tail_backward_kernel_cases(dev, c2, c3, m, junk, w_bad):
    """Kernel 7's backward at the forward's widths against its plain (dense)
    version, with NaN and Inf in a2 (at invalid, unrouted valid and routed
    slots), in the cotangent and in W3: da2 and dW3 NaN or +-Inf exactly where
    the plain version's are, the rest within 1e-2 of the largest; da2 exactly
    0 at every slot no column routes to where W3 is finite; two launches
    bit-identical; the autograd op's gradients the same."""
    a2, mask, w3, b3, am, gb = _bwd_case(dev, m, c2, c3, junk, w_bad)
    da2, dw3 = tail_kernel.fused_tail_bwd(a2, gb, am, w3)
    da2_b, dw3_b = tail_kernel.fused_tail_bwd(a2, gb, am, w3)
    w_da2, w_dw3 = tail_kernel.fused_tail_bwd_plain(a2, gb, am, w3)
    torch.cuda.synchronize()
    assert torch.equal(da2.view(torch.int16), da2_b.view(torch.int16))
    assert torch.equal(dw3.view(torch.int32), dw3_b.view(torch.int32))
    _same_nonfinite(da2, w_da2)
    _same_nonfinite(dw3, w_dw3)
    if junk == "nan":
        assert bool(w_dw3.isnan().all())
    else:
        assert bool(w_dw3.isnan().any()) and bool(w_dw3.isfinite().any())
    hit = torch.zeros((3, m, 65), dtype=torch.bool, device=dev).scatter_(2, am.long(), True)
    if not w_bad:
        assert bool((da2[~hit[:, :, :64]] == 0).all())
    else:
        assert bool(w_da2[..., c2 // 3].isnan().any())
    leaves = [a2.clone().requires_grad_(), w3.clone().requires_grad_(),
              b3.clone().requires_grad_()]
    out = tail_kernel.fused_tail(leaves[0], mask, leaves[1], leaves[2])
    grads = torch.autograd.grad(out, leaves, gb)
    torch.cuda.synchronize()
    assert torch.equal(grads[0].view(torch.int16), da2.view(torch.int16))
    assert torch.equal(grads[1].view(torch.int32), dw3.view(torch.int32))


@pytest.mark.parametrize("c2,c3", TAIL_WIDTHS)
def test_fused_tail_backward_launch_is_the_plans(dev, c2, c3):
    """The launch ``tail_kernel.bwd_plan`` names is the one the source makes
    (its shared memory and threads); the measurement modes run on it:
    staging alone writes zeros, staging and da2 the kernel's da2 and zero
    slices, staging and dW3 zero da2 and the kernel's slices."""
    p = tail_kernel.bwd_plan(c2, c3)
    occ = tail_kernel.occupancy_bwd(c2, c3)
    assert occ["smem_bytes"] == p.smem_bytes and occ["threads"] == p.threads
    assert occ["blocks_per_sm"] >= 1
    a2, mask, w3, b3 = _tail_inputs(dev, 2, 40, c2, c3)
    _, am = tail_kernel.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    gb = torch.randn((2, 40, c3), device=dev).to(torch.bfloat16)
    _build.launch_counts.clear()
    da2, slices = tail_kernel.fused_tail_bwd_slices(a2, gb, am, w3)
    runs = {mode: tail_kernel.probe_bwd(a2, gb, am, w3, mode)
            for mode in ("stage_only", "stage_da2", "stage_dw3")}
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"dlbt_fused_tail_bwd": 4}
    zero_da2, zero_sl = torch.zeros_like(da2), torch.zeros_like(slices)
    for mode, (want_da2, want_sl) in (("stage_only", (zero_da2, zero_sl)),
                                      ("stage_da2", (da2, zero_sl)),
                                      ("stage_dw3", (zero_da2, slices))):
        got_da2, got_sl = runs[mode]
        assert torch.equal(got_da2.view(torch.int16), want_da2.view(torch.int16)), mode
        assert torch.equal(got_sl.view(torch.int32), want_sl.view(torch.int32)), mode


def test_fused_tail_autograd_launches_kernel_7(dev):
    a2, mask, w3, b3 = _tail_inputs(dev, 2, 40, 64, 128)
    leaves = [t.requires_grad_() for t in (a2, w3, b3)]
    _build.launch_counts.clear()
    out = tail_kernel.fused_tail(*leaves[:1], mask, *leaves[1:])
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"dlbt_fused_tail_fwd": 1, "dlbt_fused_tail_bwd": 1,
                                          "dlbt_sum_slices": 1}
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


@pytest.mark.parametrize("c", [64, 128, 24])
def test_masked_stats_kernel_matches_plain(dev, c):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((3, 70, 64, c), device=dev, generator=g).to(torch.bfloat16)
    m3 = torch.rand((3, 70, 64), device=dev, generator=g) > 0.1
    _build.launch_counts.clear()
    got, again = bn_stats_bench.stats_kernel(x, m3), bn_stats_bench.stats_kernel(x, m3)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"dlbt_masked_stats": 2, "dlbt_sum_slices": 2}
    want = bn_stats_bench.stats_current(x, m3)
    for p, q, r in zip(got, again, want):
        assert torch.equal(p.view(torch.int32), q.view(torch.int32))
        assert float((p - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("blocks,n", [(0, 300), (1, 300), (660, 128), (660, 256), (396, 8192),
                                      (132, 32768), (133, 5000), (7, 1001)])
def test_sum_slices_kernel_matches_plain(dev, blocks, n):
    """Within 1e-6 of the plain version, a repeat bit-identical, and bit for
    bit the planned order's numpy emulation."""
    g = torch.Generator(device=dev).manual_seed(2)
    slices = torch.randn((blocks, n), device=dev, generator=g)
    got = sum_slices_kernel.sum_slices(slices)
    assert torch.equal(got.view(torch.int32), sum_slices_kernel.sum_slices(slices).view(torch.int32))
    want = sum_slices_kernel.sum_slices_plain(slices)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    ordered = torch.from_numpy(planned_sum(slices.cpu().numpy())).to(dev)
    assert torch.equal(got.view(torch.int32), ordered.view(torch.int32))


@pytest.mark.parametrize("blocks,rows", [
    (5, 2), (5, 512), (5, 777),
    (3, 1),  # 96 vectors: less than one thread block's share
    (7, 9999),  # 2,239,776 vectors: a multiple of no grid's step
    (300, 8),  # more blocks than SMs
])
def test_block_copy_kernel_matches_plain(dev, blocks, rows):
    x = torch.randn((blocks, rows, 128), device=dev)
    assert torch.equal(dma_probe.block_copy(x), x + 1.0)


def _bq_case(dev, b, m, n, seed, cluster):
    """Points ``normal * 5`` with 10% masked, the first m as centroids with 20%
    masked; ``cluster`` moves point 0 of cloud 0 far from the cloud and bucket
    5's points around it, so that the caps drop some of them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = 5 * torch.randn((b, n, 3), device=dev, generator=g)
    mask = torch.rand((b, n), device=dev, generator=g) > 0.1
    cmask = torch.rand((b, m), device=dev, generator=g) > 0.2
    if cluster:
        pos[0, 0] = 100.0
        pos[0, 5::128] = 100.0 + 0.1 * torch.randn((len(range(5, n, 128)), 3), device=dev,
                                                   generator=g)
        mask[0, 0] = True
        mask[0, 5::128] = True
        cmask[0, 0] = True
    return pos[:, :m].contiguous(), cmask, pos, mask


# M no multiple of the tile (37, 100), whole clouds (300, 1200, 1300, 2048)
# and a chunked one (20608), k 1, 64 and 127
@pytest.mark.parametrize("b,m,n,k,cm,cluster", [
    (2, 37, 300, 64, 1, False), (3, 100, 1300, 64, 7, True), (4, 512, 2048, 64, 32, True),
    (2, 70, 1200, 1, 32, True), (2, 70, 1200, 127, 32, True), (2, 45, 20608, 64, 32, True),
    (1, 33, 20608, 127, 32, False)])
def test_bq_phase_kernel_matches_plain(dev, b, m, n, k, cm, cluster):
    """Every variant, when127 too, bit-exact against the plain version, two
    launches identical, and the launch the plan's."""
    args = _bq_case(dev, b, m, n, seed=b, cluster=cluster)
    dropped = False
    for phase in bq_phase_bench.PHASES + ("when127",):
        _build.launch_counts.clear()
        got = bq_phase_bench.bq(*args, radius=8.0, k=k, cm=cm, phase=phase)
        again = bq_phase_bench.bq(*args, radius=8.0, k=k, cm=cm, phase=phase)
        torch.cuda.synchronize()
        assert _build.launch_counts["dlbt_bq_phase"] == 2
        want = bq_phase_bench.bq_plain(*args, radius=8.0, k=k, cm=cm, phase=phase)
        assert torch.equal(got, want), phase
        assert torch.equal(got, again), phase
        if phase == "full":
            exact = bq_phase_bench.bq_plain(*args, radius=8.0, k=k, phase="dyn")
            dropped = not torch.equal(got, exact)
    assert dropped == (cluster and k > 8)  # the cap drops only past a bucket's 8th
    p = bq_phase_bench.plan(n, m, k)
    launch = bq_phase_bench.launch_of(b, n, m, k)
    assert (p.whole, p.points) == ((True, -(-n // 256) * 256) if n < 13824 else (False, 8192))
    assert launch["threads"] == 32 * p.warps and launch["grid"] == (-(-m // p.centroids), b)
    assert launch["smem_bytes"] == bq_phase_bench.dynamic_smem(p, k)
    assert launch["blocks_per_sm"] >= 1 and launch["local_bytes"] == 0


def test_bq_phase_is_one_launch_a_call(dev):
    """No copy of the points beside the kernel: one launch, by the counts and
    by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    args = _bq_case(dev, 2, 64, 2048, seed=5, cluster=True)
    bq_phase_bench.bq(*args, radius=8.0)
    torch.cuda.synchronize()
    for phase in ("full", "dist", "rank"):
        _build.launch_counts.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bq_phase_bench.bq(*args, radius=8.0, phase=phase)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert dict(_build.launch_counts) == {"dlbt_bq_phase": 1}
        assert len(kernels) == 1 and "bq_" in kernels[0].name, [e.name for e in kernels]
