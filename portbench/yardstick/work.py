"""The work a forward or a training step needs, counted from the configuration's
widths, the batch's shapes and the reference's own selection of its inputs.

* ``model_flops``: the matrix products of the reference's edge-list network
  (PointConv over the valid in-radius neighbours, at most 64 a centroid, as
  the reference computes them): 2 operations a multiply-add; a training step
  counts the forward three times (forward and backward).
* ``kernel_work``: per kernel of the port (classes of ``kernel_classes.json``)
  the bytes and operations of each launch, by the counts the port's own
  roofline tool uses (``dl_biomass_tpu_torch/tools/roofline.py``): each
  input read once and each output written once; FPS's 9 operations a point a
  step; the distance tests these inputs need, 8 operations each. A launch is
  bound by the larger of bytes over the memory peak and operations over the
  float32 peak; ``bound_seconds`` sums the launches.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from portbench.reference import select
from portbench.reference.model import radii

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
FPS_OPS_PER_POINT_STEP = 9
DIST_TEST_OPS = 8


def _linear_macs(channels: List[int]) -> int:
    return sum(a * b for a, b in zip(channels[:-1], channels[1:]))


def model_flops(cfg: dict, sel, batch: int, train: bool) -> float:
    """FLOPs of one forward (x3 for a training step) over the selection ``sel``
    (``reference.model.select_all``) of ``batch`` clouds."""
    w = cfg["widths"]
    total = 0
    for li, (_, cm, nbs) in enumerate(sel.layers):
        ch = w["sa1" if li == 0 else "sa2"]
        for _, valid in nbs:
            total += 2 * int(valid.sum()) * _linear_macs(ch)
    total += 2 * int(sel.layers[-1][1].sum()) * _linear_macs(w["sa3"])
    total += 2 * batch * _linear_macs(w["head"])
    return float(total * (3 if train else 1))


def fps_work(rows: int, n: int, k: int) -> Tuple[int, int]:
    return (rows * n * 13 + rows * 4 + rows * k * 4,
            rows * n * 5 + rows * (k - 1) * n * FPS_OPS_PER_POINT_STEP)


def fps_launch(b: int, n: int, k: int) -> Tuple[int, int]:
    """The sectored FPS of b clouds of n points to k picks: one launch."""
    s = select.SECTORS
    while s > 1 and (n % s or k % s or (n // s) < 2 * (k // s)):
        s //= 2
    return fps_work(b * s, n // s, k // s)


def bucket_tests(centers, cmask, pos, mask, r2: float) -> int:
    """Distance tests kernel 2's data needs: per valid centroid and residue g,
    the points g, g + 128, ... up to the first in-radius one."""
    b, m, _ = centers.shape
    n = pos.shape[1]
    n_pad = -(-n // 128) * 128
    order = torch.arange(n, device=pos.device)
    g = torch.arange(128, device=pos.device)
    full = (n - g + 127) // 128
    total = 0
    for s in range(0, m, select.CHUNK):
        ok = select.in_radius(centers[:, s:s + select.CHUNK], cmask[:, s:s + select.CHUNK],
                              pos, mask, r2)
        keys = torch.nn.functional.pad(torch.where(ok, order, n), (0, n_pad - n), value=n)
        first = keys.view(b, ok.shape[1], -1, 128).amin(2)
        scanned = torch.where(first < n, (first - g) // 128 + 1, full)
        total += int((scanned * cmask[:, s:s + select.CHUNK, None]).sum())
    return total


def kernel_work(cfg: dict, sel, pos, mask, train: bool) -> Dict[str, List[Tuple[int, int]]]:
    """{kernel class: [(bytes, operations) of each launch]} of one forward (with
    a training step's backward gathers) of the clouds ``pos``, ``mask``."""
    m = cfg["model"]
    es = 2 if m["compute_dtype"] == "bfloat16" else 4
    f = cfg["num_features"]
    b, n, _ = pos.shape
    (c1, cm1, nb1), (c2, cm2, nb2) = sel.layers
    m1, m2 = c1.shape[1], c2.shape[1]
    out = {"fps": [fps_launch(b, n, m1), fps_launch(b, m1, m2)],
           "ball_group": [], "ball_query": [], "gather": [], "gather_bwd": []}
    for r in radii(cfg, "sa1"):
        tests = bucket_tests(c1, cm1, pos, mask, select.radius2(r))
        out["ball_group"].append((b * n * (12 + 4 * f + 1) + b * m1 * 13
                                  + b * m1 * 64 * ((f + 3) * es + 1), tests * DIST_TEST_OPS))
    k = 64
    width = cfg["widths"]["sa2"][1]  # the per-point first layer's z-table
    for idx, valid in nb2:
        last_ok, last = valid[..., k - 1], idx[..., k - 1]
        scan = torch.where(last_ok, last + 1, torch.full_like(last, m1))[cm2]
        out["ball_query"].append((b * m1 * 13 + b * m2 * 13 + b * m2 * k * 5,
                                  int(scan.sum()) * DIST_TEST_OPS))
        out["gather"].append((b * m2 * k * width * es + b * m2 * k * 4 + b * m1 * width * es, 0))
        if train:
            out["gather_bwd"].append((b * m2 * k * width * es + b * m2 * k * 4
                                      + b * m1 * width * es, int(valid.sum()) * width))
    return out


def bound_seconds(launches: List[Tuple[int, int]]) -> float:
    return sum(max(nb / PEAKS["bytes_per_s"], ops / PEAKS["f32_flop_per_s"])
               for nb, ops in launches)
