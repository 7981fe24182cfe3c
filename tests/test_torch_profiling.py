"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- Off (no profiler session, no ``recording()``): ``span`` is one shared
  no-op context that allocates nothing and calls nothing of CUDA; a training
  epoch and a served dataset record nothing.
- Recording follows torch's own profiler flag, pinned here.
- Under ``torch.profiler``: the spans of a training step and of a served
  request, nested as the code nests them, one ``train.step`` a step, and the
  counters ``edges.valid`` / ``edges.slots`` equal to the neighbour masks'
  sums taken directly (SSG and MSG).
- ``torch.export`` of the engine with a profiler session active traces no
  span or counter, and the artifact serves the engine's rows.
- ``trace``: a span around a CPU matmul encloses that operation in the
  written Chrome trace (the clock), in a process lane of its own.
- On a card (marked ``cuda``): device marks resolve with no host sync inside
  the span.
"""

import copy
import dataclasses
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dl_biomass_tpu_torch.models.inference as inference
import dl_biomass_tpu_torch.models.pointnet2 as pointnet2
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.models.export import export_serving, load_serving
from dl_biomass_tpu_torch.models.inference import compile_dataset_inference, compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.train.trainer import Trainer
from dl_biomass_tpu_torch.utils import profiling

torch.set_num_threads(1)

STEP_SPANS = ("train.forward", "train.backward", "train.optimizer")
MODEL_SPANS = ("model.sa1", "model.sa2", "model.sa3", "model.head")
ENGINE_SPANS = ("engine.sa1", "engine.sa2", "engine.tail")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def clouds(p=5, n=256, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(n // 2, n + 1, size=p)
    pos = [(rng.normal(size=(k, 3)) * 3).astype(np.float32) for k in sizes]
    feat = [rng.normal(size=(k, 1)).astype(np.float32) for k in sizes]
    y = (rng.normal(size=(p, 4)) * 3).astype(np.float32)
    return pos, feat, y, [f"P{i}" for i in range(p)]


def small_model(**kw):
    torch.manual_seed(0)
    return PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, **kw)


def trainer(model, batch_size=4, num_augs=1):
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, hp=dataclasses.replace(cfg.hp, batch_size=batch_size,
                                                          num_augs=num_augs))
    return Trainer(model, cfg, device="cpu")


@pytest.fixture
def masks(monkeypatch):
    """Every neighbour mask the model and the engine make, as they make it."""
    seen = []
    group, query = pointnet2.ball_group_kernel.ball_group, pointnet2.ball_query

    def grouped(*a, **k):
        out = group(*a, **k)
        seen.append(out[1])
        return out

    def queried(*a, **k):
        out = query(*a, **k)
        seen.append(out[1])
        return out

    monkeypatch.setattr(pointnet2.ball_group_kernel, "ball_group", grouped)
    monkeypatch.setattr(pointnet2, "ball_query", queried)
    monkeypatch.setattr(inference, "ball_query", queried)
    return seen


def edge_counts(seen):
    return {"edges.valid": sum(int(m.sum()) for m in seen),
            "edges.slots": sum(m.numel() for m in seen)}


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def assert_nested(spans):
    """Each span with a parent lies inside a span of that name with its seq."""
    for s in spans:
        if s.parent is None:
            continue
        assert any(p.name == s.parent and p.seq == s.seq and p.start_ns <= s.start_ns
                   and s.end_ns <= p.end_ns for p in spans), s


# ---- off ------------------------------------------------------------------------------------


def test_span_off_is_one_shared_noop_that_allocates_nothing(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call while recording is off")

    for name in ("Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    assert not profiling.enabled()
    x = torch.zeros(2)
    first = profiling.span("a")
    assert profiling.span("b", device=torch.device("cuda", 0)) is first
    assert profiling.span("c", device=x) is first
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(20000):
            with profiling.span("train.step", device=x):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024
    profiling.count("edges.valid", x.sum())
    assert profiling.collect() == {"spans": [], "counters": {}, "dropped": 0}


def test_recording_follows_torchs_profiler_flag():
    """The flag ``span`` reads is torch's own, set for the whole of a
    ``torch.profiler`` session however few its activities."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profiling.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert profiling.enabled()
        with profiling.span("inside"):
            pass
    assert not profiling.enabled()
    with profiling.recording():
        assert profiling.enabled()
        with profiling.span("forced"):
            pass
    assert not profiling.enabled()
    assert [s.name for s in profiling.collect()["spans"]] == ["inside", "forced"]


def test_a_training_epoch_and_a_served_dataset_record_nothing_off():
    ds = DeviceDataset.from_clouds(*clouds(), base_n=256, device="cpu")
    trainer(small_model()).train_epoch(ds, seed=3)
    compile_dataset_inference(small_model().eval(), "cpu")(ds.pad_plots(6), 4)
    assert profiling.collect() == {"spans": [], "counters": {}, "dropped": 0}


# ---- on: training and serving ---------------------------------------------------------------


@pytest.mark.parametrize("msg", [False, True], ids=["ssg", "msg"])
def test_training_steps_record_their_spans_and_edge_counts(msg, masks):
    ds = DeviceDataset.from_clouds(*clouds(), base_n=256, device="cpu")
    tr = trainer(small_model(msg=msg))
    masks.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _, n = tr.train_epoch(ds, seed=3)
    rec = profiling.collect()
    spans = by_name(rec["spans"])
    steps = -(-10 // 4)  # 5 plots and one augmented copy each, batches of 4
    assert n == 10
    assert len(spans["train.step"]) == len(spans["train.assemble"]) == steps
    assert len(spans["train.readback"]) == 1
    assert all(s.parent is None for s in spans["train.step"] + spans["train.assemble"])
    assert len({s.seq for s in spans["train.step"]}) == steps
    for name in STEP_SPANS:
        assert [s.parent for s in spans[name]] == ["train.step"] * steps
    for name in MODEL_SPANS:
        assert [s.parent for s in spans[name]] == ["train.forward"] * steps
    for step in spans["train.step"]:  # a step's spans share its seq
        assert sorted(s.name for s in rec["spans"] if s.seq == step.seq) == \
            sorted(("train.step",) + STEP_SPANS + MODEL_SPANS)
    assert_nested(rec["spans"])
    assert all(s.device_ms is None for s in rec["spans"])  # no card, no marks
    assert len(masks) == steps * (4 if msg else 2)  # a mask a scale of SA1 and SA2
    counters = dict(rec["counters"])
    # the train-mode BatchNorms' values, none on kernel 11 on the CPU
    # (tests/test_torch_bn_train.py counts them exactly)
    assert counters.pop("bn.fused") == 0 < counters.pop("bn.values")
    assert counters == edge_counts(masks)
    assert 0 < rec["counters"]["edges.valid"] < rec["counters"]["edges.slots"]


def test_a_served_request_records_its_spans_and_edge_counts(masks):
    serve_ds = compile_dataset_inference(small_model().eval(), "cpu")
    pos, feat, y, ids = clouds()
    masks.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=256,
                                       for_augmentation=False, device="cpu")
        rows = serve_ds(ds.pad_plots(8), 2)  # the caller keeps the first 5
    assert rows.shape == (8, 4)
    rec = profiling.collect()
    spans = by_name(rec["spans"])
    assert [len(spans[n]) for n in ("io.pack", "io.pad_plots", "serve.readback")] == [1, 1, 1]
    assert [s.parent for s in spans["io.upload"]] == [None, "io.pad_plots"]
    assert len(spans["serve.batch"]) == 4
    for name in ENGINE_SPANS:
        assert [s.parent for s in spans[name]] == ["serve.batch"] * 4
    assert_nested(rec["spans"])
    assert len(masks) == 8  # SA1's grouping and SA2's query, a batch
    assert rec["counters"] == edge_counts(masks)
    assert rec["counters"]["edges.valid"] < 5 / 8 * rec["counters"]["edges.slots"]


def test_export_with_a_profiler_session_active_traces_no_span(tmp_path):
    model = small_model().eval()
    ds = DeviceDataset.from_clouds(*clouds(p=2), base_n=256, for_augmentation=False,
                                   device="cpu")
    batch = CloudBatch(pos=ds.pos, feat=ds.feat, mask=ds.mask)
    with profile(activities=[ProfilerActivity.CPU]):
        export_serving(model, batch_size=2, num_points=256, path=str(tmp_path), device="cpu")
        got = load_serving(str(tmp_path), device="cpu")(batch.pos, batch.feat, batch.mask)
    rec = profiling.collect()
    assert not rec["counters"] and not [s for s in rec["spans"] if s.name.startswith("engine.")]
    assert torch.equal(got, compile_inference(model, "cpu")(batch))


# ---- the recorder ---------------------------------------------------------------------------


def test_counters_fold_device_values_and_add_host_numbers():
    with profiling.recording():
        for i in range(200):
            profiling.count("c", torch.tensor(i))
        profiling.count("c", 5)
        profiling.count("h", 2.5)
    assert profiling.collect()["counters"] == {"c": sum(range(200)) + 5, "h": 2.5}
    assert profiling.collect()["counters"]["c"] == sum(range(200)) + 5  # collect keeps them


def test_the_buffer_is_bounded_and_clear_empties_it(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        with profiling.span("outer"):
            for _ in range(4):
                with profiling.span("inner"):
                    pass
    items = profiling.spans_items()  # the outer span started before the buffer filled
    assert [n for _, _, n in items] == ["inner", "inner", "inner", "outer"]
    assert all(isinstance(a, int) and a <= b for a, b, _ in items)
    assert profiling.collect()["dropped"] == 1
    profiling.clear()
    assert profiling.collect() == {"spans": [], "counters": {}, "dropped": 0}


def test_trace_writes_the_spans_beside_the_operations_they_enclose(tmp_path):
    a = torch.ones(128, 128)
    with profiling.trace(str(tmp_path)):
        with profiling.span("around.mm"):
            a @ a
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    lane = [e for e in events if e.get("ph") == "M" and e["name"] == "process_name"
            and e["args"]["name"] == profiling.SPANS_LANE]
    assert len(lane) == 1
    (s,) = [e for e in events if e.get("name") == "around.mm" and e.get("ph") == "X"]
    assert s["pid"] == lane[0]["pid"]
    assert s["pid"] not in {e.get("pid") for e in events if e.get("cat") == "cpu_op"}
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert s["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= s["ts"] + s["dur"]


# ---- on a card ------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device marks are CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_marks_resolve_with_no_host_sync_inside_the_span(card, monkeypatch):
    x = torch.randn(2048, 2048, device=card)
    x @ x
    torch.cuda.synchronize()
    syncs = []
    for owner, name in ((torch.cuda, "synchronize"), (torch.cuda.Event, "synchronize"),
                        (torch.cuda.Event, "elapsed_time"), (torch.cuda.Event, "query")):
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, _r=real, _n=name, **k: (syncs.append(_n),
                                                                             _r(*a, **k))[1])
    with profiling.recording():
        with profiling.span("mm", device=x):
            for _ in range(8):
                y = x @ x
            inside = list(syncs)
    assert inside == []
    (s,) = profiling.collect()["spans"]
    assert s.device_ms is not None and s.device_ms > 0
    assert torch.isfinite(y).all()
    pooled = sum(len(v) for v in profiling._REC.free.values())
    with profiling.recording():
        with profiling.span("again", device=card):
            copy.copy(x).sum()
    assert sum(len(v) for v in profiling._REC.free.values()) == pooled - 2  # reused
    assert profiling.collect()["spans"][-1].device_ms is not None
