"""Traffic kind ``train_point_epochs``: ``train_epochs`` for a per-point model
(the segmentor, ``configs/pn2_seg_biomass.json``), a target a point.

The corpus, the window, the traced stretch and the captured first steps are
``train_epochs``' own; the plots carry per-point targets (``targets``) into
the ``DeviceDataset``, and the check replays the first ``check_steps`` steps
in ``reference/segmentor.py``. The numbers keep ``train_epochs``' names and
sense, with ``pred_gap`` step 1's widest per-point gap over the median norm
of the reference's valid points, and the loss the per-point MSE; one more,
``pred_gap_rms``, is the root mean square of step 1's per-point gaps, as
serving's ``row_gap_rms`` is of its rows, over the standard deviation of the
reference's valid outputs (their spread: the median |output| moves with each
seed's offset of the outputs, so it would move the number with it). The faults:
the loss over half the batch, the state left unchanged, and ``nearest_only``
(every interpolation from its single nearest source).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import generate
from portbench.kinds import train_epochs
from portbench.kinds.train_epochs import leaf_gaps, row_gap
from portbench.reference import augment as ref_aug
from portbench.reference import model as ref
from portbench.reference import segmentor as seg
from portbench.yardstick import decoder_work, work

NUMBERS = train_epochs.NUMBERS + ("pred_gap_rms",)
FAULTS = ("fault:half_batch", "fault:unchanged", "fault:nearest_only")


def targets(pos: List[np.ndarray], y: np.ndarray) -> List[np.ndarray]:
    """A plot's (N_i, 1) targets: its total biomass (the four components'
    sum) x each point's height above the plot's lowest point / the mean of
    those heights."""
    out = []
    for p, row in zip(pos, y):
        h = p[:, 2] - p[:, 2].min()
        out.append((float(np.sum(row)) * h / max(float(h.mean()), 1e-6))[:, None]
                   .astype(np.float32))
    return out


def point_gap_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """The root mean square of the points' gaps (rows of (P, k)), over the
    standard deviation of ``want``'s values."""
    gap = torch.linalg.vector_norm((got - want).double(), dim=1)
    return float(gap.square().mean().sqrt() / want.double().std())


class Kind(train_epochs.Kind):
    def inputs(self) -> None:
        """The corpus with its per-point targets, and the weights, from the seed."""
        pos, feat, y, ids = generate.corpus(self.tr["plots"], self.tr["points"], self.ctx.seed)
        self.plots = (pos, feat, targets(pos, y), ids)
        self.weights = seg.make_weights(self.cfg, generate.sub_seed(self.ctx.seed, "weights"),
                                        self.dev)
        self.summary["chips"] = self.world

    def _reference(self, lowp=None, fault: Optional[str] = None) -> dict:
        """The first ``check_steps`` steps of epoch 0 in the reference (in
        ``lowp`` for the control; with ``fault`` planted)."""
        cfg, dev, b = self.cfg, self.dev, self.batch
        points = self.tr["points"]
        pos_l, feat_l, y_l, _ = self.plots
        cap = ref_aug.capacity(points)
        p_n = len(pos_l)
        pos = torch.zeros((p_n, cap, 3), device=dev)
        feat = torch.zeros((p_n, cap, cfg["num_features"]), device=dev)
        y = torch.zeros((p_n, cap, cfg["num_outputs"]), device=dev)
        mask = torch.zeros((p_n, cap), dtype=torch.bool, device=dev)
        for i, (p, f, t) in enumerate(zip(pos_l, feat_l, y_l)):
            n = min(len(p), points)
            pos[i, :n] = torch.as_tensor(p[:n], device=dev)
            feat[i, :n] = torch.as_tensor(f.reshape(len(f), -1)[:n], device=dev)
            y[i, :n] = torch.as_tensor(t[:n], device=dev)
            mask[i, :n] = True
        seed = self.epoch_seed(0)
        idx, aug, valid = ref_aug.epoch_specs(p_n, seed, self.hp["num_augs"], b)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = {k: v.clone().requires_grad_(ref.trainable(k)) for k, v in self.weights.items()}
        train = {k: v for k, v in params.items() if v.requires_grad}
        opt = ref.Adam(train, self.hp["lr"], self.hp["weight_decay"])
        k = 1 if fault == "nearest_only" else cfg["knn"]
        rows = slice(0, b // 2) if fault == "half_batch" else slice(0, b)
        out = {"loss": [], "y": [], "mask": [], "flops": [], "bounds": []}
        for s in range(self.check_steps):
            bt = seg.assemble(pos, feat, mask, y, idx[s], aug[s], valid[s], seed, s * b, points)
            sel = ref.select_all(cfg, bt.pos, bt.mask, gen)
            keep = seg.dropout_keeps(cfg, b, bt.pos.shape[1], gen, dev)
            if lowp is None and fault is None:  # the step's work
                out["flops"].append(decoder_work.model_flops(cfg, sel, bt.mask, train=True))
                out["bounds"].append({c: work.bound_seconds(l) for c, l in
                                      work.kernel_work(cfg, sel, bt.pos, bt.mask, True).items()})
            pred = seg.forward(cfg, params, bt.pos, bt.feat, bt.mask, sel, True, keep, lowp,
                               checkpoint=True, k=k)
            loss = seg.loss(pred[rows], bt.y[rows], bt.mask[rows])
            grads = torch.autograd.grad(loss, list(train.values()))
            taken = opt.step(dict(zip(train, grads)))
            out["loss"].append(float(loss.detach()))
            out["y"].append(bt.y)
            out["mask"].append(bt.mask)
            if s == 0:
                out["pred"] = pred.detach().float()
                out["grad"] = {k: v.detach().clone() for k, v in taken.items()}
                out["raw"] = {k: g.detach().clone() for k, g in zip(train, grads)}
        out["params"] = {k: v.detach().clone() for k, v in train.items()}
        return out

    def check(self, variant: str = "program") -> Dict[str, float]:
        """The numbers compared for ``variant``: ``program`` (the captured run),
        ``control`` (the reference in fp8), ``fault:half_batch`` (the loss over
        half the batch), ``fault:nearest_only`` (every interpolation from its
        nearest source) or ``fault:unchanged`` (no step taken)."""
        ref.strict_float32()
        if getattr(self, "_want", None) is None:
            self._want = self._reference()
        want = self._want
        if want["flops"]:
            self.summary["flops_per_unit"] = float(np.mean(want["flops"]))
            self.summary["bound_s_per_unit"] = {
                c: float(np.mean([bd[c] for bd in want["bounds"]])) for c in want["bounds"][0]}
        p0 = {k: v for k, v in self.weights.items() if ref.trainable(k)}
        if variant == "program":
            cap = self.captured
            loss = [float(seg.loss(o, y, m)) for o, y, m in
                    zip(cap["out"], want["y"], want["mask"])]
            got = {"loss": loss, "grad": cap["grad"], "params": cap["params"],
                   "pred": cap["out"][0]}
        elif variant == "control":
            got = self._reference(lowp=ref.round_fp8)
        elif variant in ("fault:half_batch", "fault:nearest_only"):
            got = self._reference(fault=variant.split(":")[1])
        elif variant == "fault:unchanged":
            got = dict(want, params=p0)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        if len(got["loss"]) < self.check_steps or "grad" not in got or "params" not in got:
            return {n: float("inf") for n in NUMBERS}
        med = statistics.median(train_epochs._norm(g) for g in want["raw"].values())
        moved = [k for k, g in want["raw"].items() if train_epochs._norm(g) >= 1e-3 * med]
        self.summary["still_leaves"] = sorted(set(p0) - set(moved))
        grad = leaf_gaps(got["grad"], want["grad"], p0)
        update = leaf_gaps({k: got["params"][k] - p0[k] for k in moved},
                           {k: want["params"][k] - p0[k] for k in moved}, moved)
        for name, gaps in (("grad", grad), ("update", update)):
            worst = max(gaps, key=gaps.get)
            self.summary[f"{name}_gap_worst_leaf"] = [worst, gaps[worst]]
        valid = want["mask"][0]
        return {
            "pred_gap": row_gap(got["pred"][valid], want["pred"][valid]),
            "pred_gap_rms": point_gap_rms(got["pred"][valid], want["pred"][valid]),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap": max(update.values()),
            "update_gap_median": statistics.median(update.values()),
        }
