"""The plain reference agrees with the port's plain CPU path at a toy size:
selection index for index, the augmented batch exactly, the float32
forward, training step and serving engine to rounding."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import build_model
from dl_biomass_tpu_torch.ops import ball_group_kernel, ball_query_kernel
from dl_biomass_tpu_torch.ops.fps import fps_sectored
from dl_biomass_tpu_torch.train.trainer import Trainer
from portbench import generate
from portbench.reference import augment as ra
from portbench.reference import model as rm
from portbench.reference import select

CONFIGS = Path(generate.__file__).resolve().parent / "configs"
POINTS = 256
CPU = torch.device("cpu")


def config(name="pn2_ssg_biomass", dtype="float32"):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg["model"]["compute_dtype"] = dtype
    cfg["hp"].update(batch_size=4, num_augs=1)
    return cfg


def corpus(n=4, seed=3):
    pos, feat, y, ids = generate.corpus(n, POINTS, seed)
    t = lambda a: torch.as_tensor(np.stack(a))  # noqa: E731
    return pos, feat, y, ids, t(pos), t(feat)


def port_model(cfg, weights):
    m = build_model(TrainConfig.from_dict({"hp": cfg["hp"], "model": cfg["model"]}),
                    cfg["num_features"])
    m.load_state_dict(weights, strict=True)
    return m


def test_param_spec_names_the_ports_state_dict():
    for name in ("pn2_ssg_biomass", "pn2_msg_biomass"):
        cfg = config(name)
        m = port_model(cfg, rm.make_weights(cfg, 1, CPU))
        assert {n for n, _, _, _ in rm.param_spec(cfg)} == set(m.state_dict())
        assert sum(p.numel() for p in m.parameters()) == cfg["parameters"]


@pytest.mark.parametrize("k", [51, 64, 77])
def test_sectored_fps_equals_the_ports(k):
    _, _, _, _, pos, _ = corpus()
    mask = torch.ones(pos.shape[:2], dtype=torch.bool)
    mask[1, 200:] = False
    for seed in (None, 5):
        g1 = None if seed is None else torch.Generator().manual_seed(seed)
        g2 = None if seed is None else torch.Generator().manual_seed(seed)
        got = fps_sectored(pos, mask, k, generator=g1).long()
        assert torch.equal(got, select.fps_sectored(pos, mask, k, g2))


@pytest.mark.parametrize("radius", [2.0, 4.0])
def test_ball_group_and_query_equal_the_ports(radius):
    _, _, _, _, pos, feat = corpus()
    mask = torch.ones(pos.shape[:2], dtype=torch.bool)
    mask[2, 150:] = False
    c, cm = select.centroids(pos, mask, 52, None)
    idx, nm, _ = ball_group_kernel.ball_group_plain(c, cm, pos, mask, feat, radius=radius)
    ridx, rv = select.ball_group(c, cm, pos, mask, radius)
    assert torch.equal(nm, rv) and torch.equal(idx.long(), ridx)
    idx, nm = ball_query_kernel.ball_query_plain(c, cm, pos, mask, radius=4 * radius, k=64)
    ridx, rv = select.ball_query(c, cm, pos, mask, 4 * radius)
    assert torch.equal(nm, rv) and torch.equal(idx.long(), ridx)


def test_augmented_batches_equal_the_device_datasets():
    pos_l, feat_l, y, ids, _, _ = corpus()
    ds = DeviceDataset.from_clouds(pos_l, feat_l, y, ids, base_n=POINTS, device="cpu")
    cap = ra.capacity(POINTS)
    assert ds.pos.shape[1] == cap
    seed = 2**40 + 3
    i2, a2, v2, b0 = ds.epoch_spec_arrays(3, seed=seed, num_augs=2, shuffle=True)
    idx, aug, valid = ra.epoch_specs(len(ids), seed, 2, 3)
    assert np.array_equal(i2, idx) and np.array_equal(a2, aug) and np.array_equal(v2, valid)
    for s in range(len(b0)):
        got = ds.assemble(i2[s], a2[s], v2[s], ds.aug_seed(seed, int(b0[s])), bool(a2[s].any()))
        want = ra.assemble(ds.pos, ds.feat, ds.mask, ds.y, idx[s], aug[s], valid[s], seed,
                           int(b0[s]), POINTS)
        for a, b in zip((got.pos, got.feat, got.mask, got.y), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["pn2_ssg_biomass", "pn2_msg_biomass"])
def test_float32_training_step_agrees_with_the_port(name):
    cfg = config(name)
    weights = rm.make_weights(cfg, 11, CPU)
    pos_l, feat_l, y, ids, _, _ = corpus()
    ds = DeviceDataset.from_clouds(pos_l, feat_l, y, ids, base_n=POINTS, device="cpu")
    seed = 99
    i2, a2, v2, _ = ds.epoch_spec_arrays(4, seed=seed, num_augs=1, shuffle=True)
    batch = ds.assemble(i2[0], a2[0], v2[0], ds.aug_seed(seed, 0), True)
    tc = TrainConfig.from_dict({"hp": cfg["hp"], "model": cfg["model"]})
    trainer = Trainer(port_model(cfg, weights), tc, device="cpu")
    loss = float(trainer.step(batch, torch.Generator().manual_seed(seed)))
    g = torch.Generator().manual_seed(seed)
    p = {k: v.clone().requires_grad_(rm.trainable(k)) for k, v in weights.items()}
    sel = rm.select_all(cfg, batch.pos, batch.mask, g)
    keep = rm.dropout_keeps(cfg, 4, g, CPU)
    pred = rm.forward(cfg, p, batch.pos, batch.feat, batch.mask, sel, True, keep,
                      checkpoint=True)
    ref_loss = rm.loss(pred, batch.y, torch.as_tensor(v2[0]))
    ref_loss.backward()
    assert abs(loss - float(ref_loss.detach())) <= 1e-5 * abs(float(ref_loss.detach()))
    # leaves whose gradient is rounding alone (a bias before BatchNorm) are held
    # to the median leaf's norm
    med = float(np.median([float(v.grad.norm()) for v in p.values() if v.requires_grad]))
    for n, prm in trainer.model.named_parameters():
        want = p[n].grad
        scale = max(float(want.norm()), med)
        assert float((prm.grad - want).norm()) <= 1e-4 * scale, n


def test_float32_serving_engine_agrees_with_the_reference():
    cfg = config()
    weights = rm.make_weights(cfg, 12, CPU)
    _, _, _, _, pos, feat = corpus()
    mask = torch.ones(pos.shape[:2], dtype=torch.bool)
    m = port_model(cfg, weights).eval()
    from dl_biomass_tpu_torch.core.cloud import CloudBatch
    got = compile_inference(m, "cpu")(CloudBatch(pos=pos, feat=feat, mask=mask))
    sel = rm.select_all(cfg, pos, mask, None)
    want = rm.forward(cfg, weights, pos, feat, mask, sel, False)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096)
    fp8 = float((rm.round_fp8(x) - x).abs().max() / x.abs().max())
    bf16 = float((x.to(torch.bfloat16).float() - x).abs().max() / x.abs().max())
    assert fp8 > 8 * bf16
