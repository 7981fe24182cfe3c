"""The per-point cell ``seg_train_b36`` at a toy size on the CPU, past the
harness's look for a chip: a sound run is ``correct``, and it is not when the
timed path is broken underneath it (the loss over half the batch, the state
left unchanged, every interpolation from its single nearest source) or when
the control (the reference in fp8) stands in the program's place; the kind's
own faults, planted in the reference, fail the cell's limits too. The cell's
limits judge."""

import copy
import dataclasses
import importlib
from types import SimpleNamespace

import pytest
import torch

import dl_biomass_tpu_torch.models.decoder as decoder
import dl_biomass_tpu_torch.train.trainer as trainer_mod
from portbench import run

SEED = 2**31 + 29
CELL = "seg_train_b36"


def tiny():
    spec = run.resolve(run.load_manifest(), CELL)
    spec.config = copy.deepcopy(spec.config)
    spec.config["hp"].update(batch_size=8, num_augs=1)
    spec.traffic = dict(spec.traffic, plots=12, points=384, check_steps=3)
    return spec


def correct():
    torch.manual_seed(0)
    return run.run_cell(tiny(), SEED, 0.5, False, "cpu")["correct"]


def test_the_cell_runs_the_segmentor_through_its_kind():
    spec = tiny()
    assert spec.traffic["kind"] == "train_point_epochs"
    assert spec.config["model"]["family"] == "segmentor"
    assert {m["name"] for m in spec.per_layer} >= {
        "decoder_device_ms.train", "knn_device_ms.train", "knn_fill.train",
        "sa1_device_ms.train", "mfu.train", "kernels_roofline.train"}


def test_a_sound_run_is_correct():
    assert correct()


def test_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    real = trainer_mod.make_optimizer

    def frozen(params, hp):
        return real(params, dataclasses.replace(hp, lr=0.0))

    monkeypatch.setattr(trainer_mod, "make_optimizer", frozen)
    assert not correct()


def test_half_of_the_batch_left_out_of_the_loss_is_not_correct(monkeypatch):
    real = trainer_mod.per_point_mse

    def half(pred, target, mask, total_points=None):
        h = pred.shape[0] // 2
        return real(pred[:h], target[:h], mask[:h])

    monkeypatch.setattr(trainer_mod, "per_point_mse", half)
    assert not correct()


def test_interpolating_from_the_nearest_source_alone_is_not_correct(monkeypatch):
    real = decoder.knn_interpolate

    def nearest(feat_src, pos_src, src_mask, pos_dst, dst_mask, k=3):
        return real(feat_src, pos_src, src_mask, pos_dst, dst_mask, 1)

    monkeypatch.setattr(decoder, "knn_interpolate", nearest)
    assert not correct()


@pytest.fixture(scope="module")
def checked():
    spec = tiny()
    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    k = kind.Kind(SimpleNamespace(seed=SEED, config=spec.config, traffic=spec.traffic,
                                  device=torch.device("cpu")))
    k.setup()
    k.release()
    return spec, kind, k


def test_the_program_passes_and_the_control_in_fp8_fails(checked):
    spec, _, k = checked
    assert run.judge(k.check("program"), spec.limits)
    assert not run.judge(k.check("control"), spec.limits)


@pytest.mark.parametrize("fault", ["fault:half_batch", "fault:unchanged", "fault:nearest_only"])
def test_each_planted_fault_fails_the_limits(checked, fault):
    spec, kind, k = checked
    assert fault in kind.FAULTS
    assert not run.judge(k.check(fault), spec.limits)


def test_the_step_work_counts_the_decoder(checked):
    """``mfu.train`` reads the whole step: the encoder's products and the
    decoder's and head's over the valid points."""
    _, _, k = checked
    from portbench.reference import model as rm
    from portbench.yardstick import decoder_work, work

    bt = k._want
    assert k.summary["flops_per_unit"] > 0 and set(k.summary["bound_s_per_unit"]) == {
        "fps", "ball_group", "ball_query", "gather", "gather_bwd"}
    mask = bt["mask"][0]
    g = torch.Generator().manual_seed(1)
    pos = torch.randn(mask.shape + (3,), generator=g) * 5
    sel = rm.select_all(k.cfg, pos, mask, None)
    enc = work.model_flops({**k.cfg, "widths": {**k.cfg["widths"], "head": []}}, sel,
                           mask.shape[0], True)
    dec = decoder_work.decoder_flops(k.cfg, sel, mask, True)
    points = int(mask.sum())
    assert dec >= 3 * 2 * points * (129 * 128 + 128 * 128 * 2 + 128 * 128 + 128)
    assert decoder_work.model_flops(k.cfg, sel, mask, True) == enc + dec
