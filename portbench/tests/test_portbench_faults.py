"""The harness, driven at a toy size on the CPU past its look for a chip, says
``correct`` is false when the timed path is broken underneath it, and when
the control (the reference computed in fp8) stands in the program's place;
a sound run at the same size is correct. The cells' own limits judge."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import dl_biomass_tpu_torch.models.inference as inference
import dl_biomass_tpu_torch.train.trainer as trainer_mod
from portbench import run

SEED = 2**31 + 17


def tiny(workload):
    spec = run.resolve(run.load_manifest(), workload)
    spec.config = copy.deepcopy(spec.config)
    spec.config["hp"].update(batch_size=8, num_augs=1)
    tr = dict(spec.traffic)
    if tr["kind"] == "train_epochs":
        tr.update(plots=12, points=384, check_steps=3)
    else:
        # every request fills a batch of 8, so each holds rows of both
        # halves of a batch
        tr.update(pool_plots=24, points=384, size_law={"dist": "fixed", "plots": 12},
                  sizes_per_cycle=1, cycles=160, plot_bucket=8, batch_size=8,
                  trace_requests=2, check_plots=24)
    spec.traffic = tr
    return spec


def correct(workload, seconds=0.5):
    torch.manual_seed(0)
    return run.run_cell(tiny(workload), SEED, seconds, False, "cpu")["correct"]


@pytest.mark.parametrize("workload", ["ssg_train_b36", "ssg_serve_watch"])
def test_a_sound_run_is_correct(workload):
    assert correct(workload)


def test_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    real = trainer_mod.make_optimizer

    def frozen(params, hp):
        return real(params, dataclasses.replace(hp, lr=0.0))

    monkeypatch.setattr(trainer_mod, "make_optimizer", frozen)
    assert not correct("ssg_train_b36")


def test_half_of_the_batch_left_out_of_the_loss_is_not_correct(monkeypatch):
    real = trainer_mod.weighted_component_mse

    def half(pred, target, w=None, total_weight=None):
        h = pred.shape[0] // 2
        return real(pred[:h], target[:h], None if w is None else w[:h])

    monkeypatch.setattr(trainer_mod, "weighted_component_mse", half)
    assert not correct("ssg_train_b36")


def _broken_engine(monkeypatch, alter):
    real = inference.compile_dataset_inference

    def compiled(model, device=None, **kw):
        serve_ds = real(model, device, **kw)
        return lambda ds, batch_size: alter(np.array(serve_ds(ds, batch_size)), batch_size)

    monkeypatch.setattr(inference, "compile_dataset_inference", compiled)


def test_an_altered_answer_is_not_correct(monkeypatch):
    def alter(rows, _bs):
        rows[0] *= 2.0
        return rows

    _broken_engine(monkeypatch, alter)
    assert not correct("ssg_serve_watch")


def test_half_of_each_served_batch_left_out_is_not_correct(monkeypatch):
    def alter(rows, bs):
        for b0 in range(0, len(rows), bs):
            rows[b0 + bs // 2:b0 + bs] = 0.0
        return rows

    _broken_engine(monkeypatch, alter)
    assert not correct("ssg_serve_watch")


@pytest.mark.parametrize("workload", ["ssg_train_b36", "msg_train_b36", "ssg_serve_watch"])
def test_the_control_in_fp8_is_not_correct(workload):
    import importlib
    from types import SimpleNamespace

    spec = tiny(workload)
    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    k = kind.Kind(SimpleNamespace(seed=SEED, config=spec.config, traffic=spec.traffic,
                                  device=torch.device("cpu")))
    k.setup()
    if spec.traffic["kind"] == "serve_requests":
        k.window(0.5)
    k.release()
    assert run.judge(k.check("program"), spec.limits)
    assert not run.judge(k.check("control"), spec.limits)
