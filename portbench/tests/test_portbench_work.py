"""The yardstick's FLOP and byte arithmetic against hand counts at toy shapes."""

import json
from pathlib import Path

import pytest
import torch

from portbench.reference.model import Selection
from portbench.yardstick import work

CFG = json.loads((Path(work.__file__).resolve().parents[1] / "configs"
                  / "pn2_ssg_biomass.json").read_text())


def toy_selection(v1: int, v2: int, c2: int) -> Selection:
    sel = Selection()
    valid1 = torch.zeros(2, 4, 64, dtype=torch.bool)
    valid1.view(-1)[:v1] = True
    valid2 = torch.zeros(2, 3, 64, dtype=torch.bool)
    valid2.view(-1)[:v2] = True
    cm2 = torch.zeros(2, 3, dtype=torch.bool)
    cm2.view(-1)[:c2] = True
    sel.layers = [(torch.zeros(2, 4, 3), torch.ones(2, 4, dtype=torch.bool),
                   [(torch.zeros(2, 4, 64, dtype=torch.long), valid1)]),
                  (torch.zeros(2, 3, 3), cm2, [(torch.zeros(2, 3, 64, dtype=torch.long), valid2)])]
    return sel


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_by_hand(train):
    sa1 = 4 * 64 + 64 * 64 + 64 * 128
    sa2 = 131 * 128 + 128 * 128 + 128 * 256
    sa3 = 259 * 256 + 256 * 512 + 512 * 1024
    head = 1024 * 128 + 128 * 128 + 128 * 4
    want = 2 * (10 * sa1 + 6 * sa2 + 3 * sa3 + 2 * head) * (3 if train else 1)
    assert work.model_flops(CFG, toy_selection(10, 6, 3), 2, train) == want


def test_fps_counts_by_hand():
    # bytes: 13 a point (xyz and its mask byte), 4 a start, 4 a pick
    assert work.fps_work(2, 8, 3) == (2 * 8 * 13 + 2 * 4 + 2 * 3 * 4,
                                      2 * 8 * 5 + 2 * 2 * 8 * 9)
    # 7936 slots to 1588 picks: 4 sectors (8 does not divide 1588)
    assert work.fps_launch(1, 7936, 1588) == work.fps_work(4, 1984, 397)
    # 1588 to 397 picks: 397 is odd, so exact FPS
    assert work.fps_launch(3, 1588, 397) == work.fps_work(3, 1588, 397)


def test_bucket_tests_by_hand():
    pos = torch.zeros(1, 256, 3)
    mask = torch.ones(1, 256, dtype=torch.bool)
    centers = torch.zeros(1, 2, 3)
    # every point in radius: each residue's first point is its first test
    assert work.bucket_tests(centers, torch.tensor([[True, True]]), pos, mask, 1.0) == 256
    # one valid centroid, no point in radius: every point of every residue tested
    far = torch.full((1, 2, 3), 100.0)
    assert work.bucket_tests(far, torch.tensor([[True, False]]), pos, mask, 1.0) == 256


def test_bound_seconds_takes_the_larger_bound_per_launch():
    bw, f32 = work.PEAKS["bytes_per_s"], work.PEAKS["f32_flop_per_s"]
    assert work.bound_seconds([(bw, 0)]) == pytest.approx(1.0)
    assert work.bound_seconds([(0, f32)]) == pytest.approx(1.0)
    assert work.bound_seconds([(bw, 2 * f32), (2 * bw, 0)]) == pytest.approx(4.0)


def test_kernel_work_counts_the_gathers_by_hand():
    sel = toy_selection(10, 6, 3)
    pos = torch.zeros(2, 20, 3)
    mask = torch.ones(2, 20, dtype=torch.bool)
    got = work.kernel_work(CFG, sel, pos, mask, train=True)
    b, m1, m2, k, w = 2, 4, 3, 64, 128
    gather = b * m2 * k * w * 2 + b * m2 * k * 4 + b * m1 * w * 2
    assert got["gather"] == [(gather, 0)]
    assert got["gather_bwd"] == [(gather, 6 * w)]
    assert got["ball_query"][0][0] == b * m1 * 13 + b * m2 * 13 + b * m2 * k * 5
    assert len(got["ball_group"]) == 1 and len(got["fps"]) == 2
