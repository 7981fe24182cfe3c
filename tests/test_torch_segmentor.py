"""The per-point segmentor on the port's normal path (``build_model`` under
``model.family = "segmentor"``, ``Trainer.train_epoch`` over a
``DeviceDataset`` with per-point targets and augmentation, ``per_point_mse``)
against the plain reference ``portbench/reference/segmentor.py``, at B = 2
clouds of 640 points with ragged masks, in float32 on the kernels' plain
versions (sectored FPS, stratified SA1 grouping, split SA2: the benchmark
cell's configuration), on seeded random weights; the family's sidecar round
trip and its refusals; per-point targets through the augmentation, and the
per-cloud path unchanged bit for bit; the decoder's spans and counters; the
loss over a 2-rank gloo ``dp`` mesh."""

import copy
import hashlib
import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_seg_mesh_worker
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models.decoder import PointNet2Segmentor
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import build_model, model_from_dict, model_to_dict
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.train.loss import per_point_mse
from dl_biomass_tpu_torch.train.trainer import Trainer
from dl_biomass_tpu_torch.transforms.augment import apply_augment, aug_capacity, draw_augment
from dl_biomass_tpu_torch.utils import profiling
from portbench.kinds.train_point_epochs import targets
from portbench.reference import augment as ra
from portbench.reference import model as rm
from portbench.reference import segmentor as rs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "pn2_seg_biomass.json").read_text())
B, N, VALID = 2, 640, [640, 517, 588, 433]
EPOCH_SEED, STEPS = 2**33 + 7, 3
CPU = torch.device("cpu")


def config(dtype="float32", **model):
    cfg = copy.deepcopy(CONFIG)
    cfg["model"].update(compute_dtype=dtype, **model)
    cfg["hp"].update(batch_size=B, num_augs=1)
    return cfg


def train_config(cfg, **mesh):
    return TrainConfig.from_dict({"hp": cfg["hp"], "model": cfg["model"], "mesh": mesh})


def corpus():
    """Four synthetic plots cut to ragged sizes, with their per-point targets."""
    pos, feat, y, ids = synthetic_dataset(len(VALID), N, seed=31)
    pos = [p[:v] for p, v in zip(pos, VALID)]
    feat = [f[:v] for f, v in zip(feat, VALID)]
    return pos, feat, targets(pos, y), ids


def port_model(cfg, weights):
    m = build_model(train_config(cfg), cfg["num_features"])
    m.load_state_dict(weights, strict=True)
    return m


@pytest.fixture(scope="module")
def runs():
    """The first STEPS steps of one epoch: the port's (through
    ``train_epoch``, hooks keeping each step's output, step 1's gradients and
    the parameters after step STEPS) and the reference's, from one state."""
    cfg = config()
    weights = rs.make_weights(cfg, 5, CPU)
    pos, feat, y, ids = corpus()
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=N, device="cpu")
    trainer = Trainer(port_model(cfg, weights), train_config(cfg), device="cpu")
    model, opt = trainer.model, trainer.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    got = {"out": [], "steps": 0}

    def on_forward(_m, _inp, out):
        got["out"].append(out.detach().clone())

    def before_step(o, _args, _kwargs):
        if not got["steps"]:
            got["grad"] = {names[id(p)]: p.grad.clone() for g in o.param_groups
                           for p in g["params"]}

    def after_step(_o, _args, _kwargs):
        got["steps"] += 1
        if got["steps"] == STEPS:
            got["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}

    hooks = [model.register_forward_hook(on_forward), opt.register_step_pre_hook(before_step),
             opt.register_step_post_hook(after_step)]
    trainer.train_epoch(ds, seed=EPOCH_SEED)
    for h in hooks:
        h.remove()

    cap = ra.capacity(N)
    pos_t = torch.zeros((len(pos), cap, 3))
    feat_t = torch.zeros((len(pos), cap, 1))
    y_t = torch.zeros((len(pos), cap, 1))
    mask = torch.zeros((len(pos), cap), dtype=torch.bool)
    for i, (p, f, t) in enumerate(zip(pos, feat, y)):
        pos_t[i, :len(p)], feat_t[i, :len(p)], y_t[i, :len(p)] = map(torch.as_tensor, (p, f, t))
        mask[i, :len(p)] = True
    idx, aug, valid = ra.epoch_specs(len(pos), EPOCH_SEED, 1, B)
    gen = torch.Generator().manual_seed(EPOCH_SEED)
    params = {k: v.clone().requires_grad_(rm.trainable(k)) for k, v in weights.items()}
    train = {k: v for k, v in params.items() if v.requires_grad}
    adam = rm.Adam(train, cfg["hp"]["lr"], cfg["hp"]["weight_decay"])
    want = {"out": [], "loss": [], "batch": []}
    for s in range(STEPS):
        bt = rs.assemble(pos_t, feat_t, mask, y_t, idx[s], aug[s], valid[s], EPOCH_SEED, s * B, N)
        sel = rm.select_all(cfg, bt.pos, bt.mask, gen)
        keep = rs.dropout_keeps(cfg, B, cap, gen, CPU)
        pred = rs.forward(cfg, params, bt.pos, bt.feat, bt.mask, sel, True, keep)
        loss = rs.loss(pred, bt.y, bt.mask)
        grads = torch.autograd.grad(loss, list(train.values()))
        if s == 0:
            want["grad"] = dict(zip(train, grads))
        adam.step(dict(zip(train, grads)))
        want["out"].append(pred.detach())
        want["loss"].append(float(loss.detach()))
        want["batch"].append(bt)
    want["params"] = {k: v.detach().clone() for k, v in train.items()}
    assert aug[:STEPS].any() and not aug[:STEPS].all()  # both kinds of sample are compared
    return dict(got=got, want=want, weights=weights, cfg=cfg, ds=ds)


def test_per_point_outputs_match_the_reference(runs):
    """Each step's (B, N, 1) output, 0 at invalid points. Step 1, from one
    state, to float32 rounding (the port sums BatchNorm statistics in float64
    over float32 chunk partials, the reference in float32: 7e-6 of the
    largest output read, 2e-5 allowed). Steps 2 and 3 within 2e-2 (9e-4 and
    7e-3 read): Adam's first step moves every weight by about lr whatever
    its gradient's size, so the elements whose gradient is rounding alone
    (up to 0.5% of a leaf) step either way on the two sides."""
    got, want = runs["got"], runs["want"]
    for s in range(STEPS):
        o, w, bt = got["out"][s], want["out"][s], want["batch"][s]
        assert o.shape == w.shape == (B, ra.capacity(N), 1)
        assert (o[~bt.mask] == 0).all()
        tol = 2e-5 if s == 0 else 2e-2
        assert float((o - w).abs().max()) <= tol * float(w.abs().max()), s


def test_per_point_mse_matches_the_reference(runs):
    """The port's loss of each step on the reference's batch (the targets the
    augmentation carried), within 1e-5 (read: 0, 3e-7, 9e-6): the targets,
    hundreds, outweigh the outputs' gaps above."""
    got, want = runs["got"], runs["want"]
    for s in range(STEPS):
        bt = want["batch"][s]
        loss = float(per_point_mse(got["out"][s], bt.y, bt.mask))
        assert abs(loss - want["loss"][s]) <= 1e-5 * want["loss"][s], s


def test_every_leafs_gradient_matches_the_reference(runs):
    """Step 1's gradient of every leaf, within 1e-4 of the larger of its norm
    and the median leaf's (float32 rounding; 1.2e-5 read): the biases that a
    BatchNorm, a max or an interpolation follows have a true gradient of 0,
    and theirs is rounding, held by the median leaf's norm."""
    got, want = runs["got"]["grad"], runs["want"]["grad"]
    assert set(got) == set(want)
    med = statistics.median(float(g.norm()) for g in want.values())
    for name, w in want.items():
        scale = max(float(w.norm()), med)
        assert float((got[name] - w).norm()) <= 1e-4 * scale, name


def test_parameters_after_three_adam_steps_match_the_reference(runs):
    """The change of every leaf after STEPS steps of Adam. Adam moves each
    element by about lr a step whatever its gradient's size, so an element
    whose gradient is rounding alone steps either way on the two sides. A
    leaf whose gradient is more than rounding: its change within 0.15 of its
    norm (0.079 read) and at most 1% of its elements, or 2, apart by lr / 2
    (0.45% read, sa3.mlp.lin2; one of 64 and of 128, BatchNorm scales); a
    leaf whose true gradient is 0 (a bias before a BatchNorm) moves by Adam's
    bound alone, about lr a step an element (1% over where a gradient grows
    between steps)."""
    got, want = runs["got"]["params"], runs["want"]["params"]
    p0 = {k: v for k, v in runs["weights"].items() if rm.trainable(k)}
    grads = runs["want"]["grad"]
    med = statistics.median(float(g.norm()) for g in grads.values())
    lr = runs["cfg"]["hp"]["lr"]
    moved = 0
    for name, w in want.items():
        dg, dw = got[name] - p0[name], w - p0[name]
        if float(grads[name].norm()) >= 1e-3 * med:
            moved += 1
            assert float((dg - dw).norm()) <= 0.15 * float(dw.norm()), name
            assert int(((dg - dw).abs() > lr / 2).sum()) <= max(2, 0.01 * dg.numel()), name
        else:
            assert float(dg.abs().max()) <= STEPS * lr * 1.01, name
    assert moved >= len(want) // 2


def test_build_model_passes_the_encoder_settings():
    """The configuration's encoder keys reach SA1 and SA2 as the regressor's
    do; the FP layers and the head compute in its dtype."""
    m = build_model(train_config(config("bfloat16")), 1)
    assert isinstance(m, PointNet2Segmentor) and m.num_outputs == 1
    assert m.head.dropout == CONFIG["hp"]["dropout_probability"]
    for sa in (m.sa1, m.sa2):
        assert sa.compute_dtype == torch.bfloat16 and sa.fast_fps and sa.max_neighbors == 64
        assert sa.split_first_layer and not sa.exact_selection
    assert m.sa1.fast_group and m.sa1.radius == 2.0 and m.sa2.radius == 8.0
    for mlp in (m.sa3.mlp, m.fp3.mlp, m.fp2.mlp, m.fp1.mlp, m.head):
        assert mlp.compute_dtype == torch.bfloat16
    assert sum(p.numel() for p in m.parameters()) == CONFIG["parameters"]
    assert {n for n, _, _, _ in rs.param_spec(CONFIG)} == set(m.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_dict_round_trip(dtype):
    m = build_model(train_config(config(dtype, fast_group=False, exact_selection=True)), 1)
    d = model_to_dict(m)
    assert d["family"] == "segmentor" and json.loads(json.dumps(d)) == d
    back = model_from_dict(d)
    assert isinstance(back, PointNet2Segmentor) and model_to_dict(back) == d
    back.load_state_dict(m.state_dict(), strict=True)


@pytest.mark.parametrize("option", ["msg", "remat", "fused_sa", "analytic_bn", "doubled_radius",
                                    "mp", "neuron_multiplier"])
def test_options_the_segmentor_does_not_take_are_refused(option):
    cfg = config()
    mesh = {}
    if option == "mp":
        mesh = {"mp": 2}
    elif option == "neuron_multiplier":
        cfg["hp"]["neuron_multiplier"] = 2
    else:
        cfg["model"][option] = True
    with pytest.raises(ValueError, match=option):
        build_model(train_config(cfg, **mesh), 1)


def test_the_serving_engine_refuses_the_family():
    m = build_model(train_config(config()), 1)
    with pytest.raises(NotImplementedError, match="PointNet2Segmentor"):
        compile_inference(m, "cpu")


def test_predict_and_evaluate_are_per_point(runs):
    trainer = Trainer(port_model(runs["cfg"], runs["weights"]), train_config(runs["cfg"]),
                      device="cpu")
    ds = runs["ds"]
    pred = trainer.predict(ds.batches(B))
    assert pred.shape == (len(VALID), ds.pos.shape[1], 1)
    assert (pred[~ds.mask.numpy()] == 0).all()
    want = np.mean([float(per_point_mse(torch.from_numpy(pred[i:i + B]), ds.y[i:i + B],
                                        ds.mask[i:i + B])) for i in range(0, len(VALID), B)])
    assert abs(trainer.evaluate(ds) - want) <= 1e-5 * want


def _dataset(y):
    pos, feat, _, ids = corpus()
    return DeviceDataset.from_clouds(pos, feat, y, ids, base_n=N, device="cpu")


def test_per_point_targets_are_packed_like_the_features():
    pos, _, y, _ = corpus()
    ds = _dataset(y)
    assert ds.y.shape == (len(VALID), aug_capacity(N), 1)
    for i, t in enumerate(y):
        assert torch.equal(ds.y[i, :len(t)], torch.as_tensor(t))
        assert (ds.y[i, len(t):] == 0).all()


def test_append_slots_carry_their_sources_target():
    """Targets numbered by slot: each appended point's target is the number of
    the slot whose noisy copy it is (its features are that slot's, jittered),
    with no noise on the target; the base slots keep theirs."""
    pos, feat, _, _ = corpus()
    ds = _dataset([np.arange(len(p), dtype=np.float32)[:, None] for p in pos])
    g = torch.Generator().manual_seed(4)
    c = ds.pos.shape[1]
    draws = draw_augment(g, len(VALID), c, 1)
    apos, afeat, amask, ay = apply_augment(draws, ds.pos, ds.feat, ds.mask, N, y=ds.y)
    step = (draws.sign * draws.sd)[:, None]
    appended = 0
    for b in range(len(VALID)):
        assert torch.equal(ay[b, :N], ds.y[b, :N])
        for j in torch.nonzero(amask[b, N:]).flatten().tolist():
            src = int(ay[b, N + j, 0])
            assert float(ay[b, N + j, 0]) == src and ds.mask[b, src]
            want = ds.feat[b, src] + step[b] * draws.noise_feat[b, src]
            assert torch.equal(afeat[b, N + j], want)
            appended += 1
        assert (ay[b, N:][~amask[b, N:]] == 0).all()
    assert appended > 0


def test_removed_points_leave_the_loss():
    """Targets at points the augmentation removed (and at pads) do not move
    the loss: only the valid points of the batch count."""
    _, _, y, _ = corpus()
    ds = _dataset(y)
    i2, a2, v2, b0 = ds.epoch_spec_arrays(B, seed=EPOCH_SEED, num_augs=1, shuffle=True)
    s = int(np.flatnonzero(a2.any(1))[0])
    bt = ds.assemble(i2[s], a2[s], v2[s], ds.aug_seed(EPOCH_SEED, int(b0[s])), True)
    removed = ds.mask[torch.as_tensor(i2[s]).long()] & ~bt.mask
    assert removed.any()
    pred = torch.randn(bt.y.shape, generator=torch.Generator().manual_seed(1))
    moved = torch.where((~bt.mask)[..., None], torch.full_like(bt.y, 1e6), bt.y)
    assert float(per_point_mse(pred, moved, bt.mask)) == float(per_point_mse(pred, bt.y, bt.mask))
    n = bt.mask.sum()
    want = float(((pred - bt.y) ** 2)[bt.mask].sum() / n)
    assert abs(float(per_point_mse(pred, bt.y, bt.mask)) - want) <= 1e-6 * want


# sha256 of every assembled batch's (pos, feat, mask, y) of the per-cloud
# targets below, recorded before per-point targets were added
PER_CLOUD_GOLDEN = "5f3e67f3e7916c1a25db06ef6bbfc9db7b14f3cf9791e24b7282d83dacb4827a"


def test_per_cloud_targets_assemble_as_before_bit_for_bit():
    pos, feat, y, ids = synthetic_dataset(4, 640, seed=21)
    pos[1], feat[1] = pos[1][:517], feat[1][:517]
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=640, device="cpu")
    h = hashlib.sha256()
    seed = 2**33 + 5
    i2, a2, v2, b0 = ds.epoch_spec_arrays(3, seed=seed, num_augs=2, shuffle=True)
    for s in range(len(b0)):
        b = ds.assemble(i2[s], a2[s], v2[s], ds.aug_seed(seed, int(b0[s])), bool(a2[s].any()))
        for t in (b.pos, b.feat, b.mask, b.y):
            h.update(t.contiguous().numpy().tobytes())
    assert ds.y.shape == (4, 4) and h.hexdigest() == PER_CLOUD_GOLDEN


def test_reference_assembles_the_ports_augmented_targets():
    _, _, y, _ = corpus()
    ds = _dataset(y)
    i2, a2, v2, b0 = ds.epoch_spec_arrays(B, seed=EPOCH_SEED, num_augs=1, shuffle=True)
    for s in range(len(b0)):
        got = ds.assemble(i2[s], a2[s], v2[s], ds.aug_seed(EPOCH_SEED, int(b0[s])),
                          bool(a2[s].any()))
        want = rs.assemble(ds.pos, ds.feat, ds.mask, ds.y, i2[s], a2[s], v2[s], EPOCH_SEED,
                           int(b0[s]), N)
        for a, b in zip((got.pos, got.feat, got.mask, got.y), want):
            assert torch.equal(a, b), s


def test_spans_and_counters_of_the_decoder(runs):
    """Under ``recording()`` a forward records the SA, FP and head spans, one
    ``fp.knn`` an FP layer, and the kNN counters: the valid pairs and the
    dense slots of the three interpolations."""
    m = port_model(runs["cfg"], runs["weights"])
    bt = runs["want"]["batch"][0]
    profiling.clear()
    with profiling.recording(), torch.no_grad():
        m(CloudBatch(pos=bt.pos, feat=bt.feat, mask=bt.mask))
    rec = profiling.collect()
    profiling.clear()
    names = [s.name for s in rec["spans"]]
    for name in ("model.sa1", "model.sa2", "model.sa3", "model.fp3", "model.fp2", "model.fp1",
                 "model.seg_head"):
        assert names.count(name) == 1, name
    assert names.count("fp.knn") == 3
    (c1, cm1, _), (c2, cm2, _) = rm.select_all(runs["cfg"], bt.pos, bt.mask, None).layers
    pairs = sum(int((d.sum(1) * s.sum(1)).sum()) for d, s in
                ((cm2, cm2), (cm1, cm2), (bt.mask, cm1)))
    slots = B * (c2.shape[1] ** 2 + c1.shape[1] * c2.shape[1] + bt.mask.shape[1] * c1.shape[1])
    assert rec["counters"]["knn.pairs"] == pairs and rec["counters"]["knn.slots"] == slots


def test_mp_point_sharding_is_refused_in_the_forward(monkeypatch):
    """A model built outside ``build_model`` refuses ``mp`` slices of the points."""
    monkeypatch.setattr(dp, "point_parts", lambda: 2)
    batch = CloudBatch(pos=torch.zeros(1, 128, 3), feat=torch.zeros(1, 128, 1),
                       mask=torch.ones(1, 128, dtype=torch.bool))
    with pytest.raises(ValueError, match="mp"):
        PointNet2Segmentor(1)(batch)


@pytest.fixture(scope="module")
def mesh_group(tmp_path_factory):
    """One 2-rank gloo group: a step of the segmentor (dropout 0, FPS from
    the first valid point) and the loss's shares, against one process."""
    tmp = tmp_path_factory.mktemp("seg_mesh")
    cfg = config()
    cfg["hp"]["dropout_probability"] = 0.0
    model = port_model(cfg, rs.make_weights(cfg, 8, CPU))
    _, _, y, _ = corpus()
    ds = _dataset(y)
    i2, a2, v2, b0 = ds.epoch_spec_arrays(4, seed=EPOCH_SEED, num_augs=1, shuffle=True)
    bt = ds.assemble(i2[0], a2[0], v2[0], ds.aug_seed(EPOCH_SEED, int(b0[0])), True)
    bt = CloudBatch(pos=bt.pos, feat=bt.feat, mask=bt.mask & (torch.arange(4) != 3)[:, None],
                    y=bt.y)  # rank 1 holds one real cloud, rank 0 two
    out = torch.randn(bt.y.shape, generator=torch.Generator().manual_seed(2))
    torch.save(dict(batch=dict(pos=bt.pos, feat=bt.feat, mask=bt.mask, y=bt.y),
                    model=model_to_dict(model), state=model.state_dict(), out=out),
               tmp / "seg_inputs.pt")
    dp.spawn(torch_seg_mesh_worker.run_checks, 2, str(tmp / "store"), args=(str(tmp),),
             device="cpu")
    ranks = [torch.load(tmp / f"seg_rank{r}.pt", weights_only=False) for r in range(2)]
    one = Trainer(model_from_dict(model_to_dict(model)), TrainConfig(), device="cpu")
    one.model.load_state_dict(model.state_dict())
    loss = float(one.step(bt))
    grads = {n: p.grad.double() for n, p in one.model.named_parameters()}
    whole = out.clone().requires_grad_(True)
    full = per_point_mse(whole, bt.y, bt.mask)
    full.backward()
    return ranks, dict(loss=loss, grads=grads, full=float(full.detach()), out_grad=whole.grad)


def test_per_point_mse_over_a_dp_mesh_equals_the_whole_batchs(mesh_group):
    """Each rank's share over the whole batch's valid points adds up to the
    whole batch's loss, and its gradient is the whole loss's on its rows."""
    ranks, one = mesh_group
    assert abs(sum(r["share"] for r in ranks) - one["full"]) <= 1e-6 * one["full"]
    for r in ranks:
        assert abs(r["total"] - one["full"]) <= 1e-6 * one["full"]
    grad = torch.cat([r["out_grad"] for r in ranks])
    assert torch.allclose(grad, one["out_grad"], rtol=1e-6, atol=0)


def test_two_rank_segmentor_step_matches_one_process(mesh_group):
    """``Trainer.step`` over the mesh: the loss to float32 rounding (1e-5) and
    every gradient within 1e-4 of the largest, the bounds of the regressor's
    mesh step (``tests/test_torch_mesh.py``)."""
    ranks, one = mesh_group
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for r in ranks:
        assert abs(r["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        for name, g in one["grads"].items():
            assert float((r["grads"][name] - g).abs().max()) <= 1e-4 * top, name
