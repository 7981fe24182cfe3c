"""The readers of the port's own spans and counters (``program_spans.py`` and
the metrics of source ``program_span`` and ``program_counter``) on a
synthetic summary and span buffer, and on a program that records none."""

import json
from pathlib import Path

import pytest

from portbench import program_spans, run
from dl_biomass_tpu_torch.utils import profiling
from dl_biomass_tpu_torch.utils.profiling import Span

MANIFEST = json.loads((Path(run.__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
NAMES = ([f"{n}.train" for n in ("step_host_ms", "assemble_device_ms", "fwd_device_ms",
                                  "bwd_device_ms", "opt_device_ms", "sa1_device_ms",
                                  "sa2_device_ms", "edge_fill")]
         + [f"{n}.serve" for n in ("sa1_device_ms", "sa2_device_ms", "pack_ms", "upload_ms",
                                   "edge_fill")])
PROGRAM = [m for m in MANIFEST["per_layer"] if m["name"] in NAMES]


def span(name, host_ms, device_ms=None, parent=None, seq=1):
    return Span(0, int(host_ms * 1e6), name, parent, seq, 0, device_ms)


TRAIN = [span("train.assemble", 0.5, 2.0, seq=1), span("train.step", 80.0, seq=2),
         span("train.forward", 20.0, 30.0, "train.step", 2),
         span("model.sa1", 5.0, 12.0, "train.forward", 2),
         span("model.sa2", 4.0, 9.0, "train.forward", 2),
         span("train.backward", 30.0, 50.0, "train.step", 2),
         span("train.optimizer", 10.0, 4.0, "train.step", 2),
         span("train.assemble", 0.5, 2.0, seq=3), span("train.step", 84.0, seq=4),
         span("train.forward", 20.0, 34.0, "train.step", 4),
         span("model.sa1", 5.0, 14.0, "train.forward", 4),
         span("model.sa2", 4.0, 11.0, "train.forward", 4),
         span("train.backward", 30.0, 54.0, "train.step", 4),
         span("train.optimizer", 10.0, 6.0, "train.step", 4),
         span("train.readback", 1.0)]
SERVE = [span("io.pack", 12.0, seq=1), span("io.upload", 3.0, seq=2),
         span("io.pad_plots", 0.25, seq=3), span("io.upload", 0.01, None, "io.pad_plots", 3),
         span("serve.batch", 2.0, seq=4), span("engine.sa1", 0.4, 4.0, "serve.batch", 4),
         span("engine.sa2", 0.3, 3.0, "serve.batch", 4),
         span("engine.tail", 0.2, 2.0, "serve.batch", 4),
         span("serve.batch", 2.0, seq=5), span("engine.sa1", 0.4, 6.0, "serve.batch", 5),
         span("engine.sa2", 0.3, 5.0, "serve.batch", 5),
         span("engine.tail", 0.2, 2.0, "serve.batch", 5), span("serve.readback", 9.0, seq=6)]
TRACED = {"trace": {"window_s": 0.2, "busy_s": 0.18}, "trace_units": 2}


def record(spans, valid=90, slots=128):
    return {"spans": spans, "counters": {"edges.valid": valid, "edges.slots": slots},
            "dropped": 0}


@pytest.fixture
def buffer(monkeypatch):
    """Hand the readers ``record(...)`` as the program's ``collect()``."""
    def use(rec):
        monkeypatch.setattr(profiling, "collect", lambda: rec)
    return use


def read(name, s=TRACED):
    return run.metric_reader(name)(s)


def test_the_manifest_names_the_thirteen_program_metrics():
    assert sorted(m["name"] for m in PROGRAM) == sorted(NAMES)
    for m in PROGRAM:
        train = m["name"].endswith(".train")
        assert m["workloads"] == (["ssg_train_b36", "msg_train_b36"] if train
                                  else ["ssg_serve_watch"])
        assert m["moves"] == ("train_clouds_per_s" if train else "serve_clouds_per_s")
        assert (m["source"] == "program_counter") == m["name"].startswith("edge_fill")


def test_training_readers_per_step(buffer):
    buffer(record(TRAIN))
    assert read("step_host_ms.train") == pytest.approx(82.0)
    assert read("assemble_device_ms.train") == pytest.approx(2.0)
    assert read("fwd_device_ms.train") == pytest.approx(32.0)
    assert read("bwd_device_ms.train") == pytest.approx(52.0)
    assert read("opt_device_ms.train") == pytest.approx(5.0)
    assert read("sa1_device_ms.train") == pytest.approx(13.0)
    assert read("sa2_device_ms.train") == pytest.approx(10.0)
    assert read("edge_fill.train") == pytest.approx(100 * 90 / 128)


def test_serving_readers_per_batch(buffer):
    buffer(record(SERVE, valid=288, slots=640))
    assert read("sa1_device_ms.serve") == pytest.approx(5.0)
    assert read("sa2_device_ms.serve") == pytest.approx(4.0)
    assert read("pack_ms.serve") == pytest.approx(6.0)
    assert read("upload_ms.serve") == pytest.approx((3.0 + 0.01) / 2)
    assert read("edge_fill.serve") == pytest.approx(45.0)


def test_spans_without_device_marks_give_no_device_time(buffer):
    buffer(record([s._replace(device_ms=None) for s in TRAIN]))
    assert read("fwd_device_ms.train") is None
    assert read("step_host_ms.train") == pytest.approx(82.0)


@pytest.mark.parametrize("name", [m["name"] for m in PROGRAM])
def test_nothing_without_a_trace_units_or_a_record(name, buffer):
    buffer(record(TRAIN + SERVE))
    assert read(name, {}) is None
    assert read(name, {"trace": TRACED["trace"], "trace_units": 0}) is None
    buffer({"spans": [], "counters": {}, "dropped": 0})
    assert read(name) is None


@pytest.mark.parametrize("name", [m["name"] for m in PROGRAM])
def test_a_program_without_the_recorder_gives_nothing_and_raises_nothing(name, monkeypatch):
    """The parent of the change that brought the spans has no ``collect``."""
    monkeypatch.delattr(profiling, "collect")
    assert read(name) is None


def test_no_counter_no_share(buffer):
    buffer({"spans": TRAIN, "counters": {"edges.valid": 3}, "dropped": 0})
    assert read("edge_fill.train") is None
    assert program_spans.percent(TRACED, "edges.valid", "edges.slots") is None
