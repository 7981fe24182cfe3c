"""Traffic kind ``train_epochs``: back-to-back epochs of ``Trainer.train_epoch``
over an on-device corpus, as ``train``, ``seed-study`` and ``tune`` run them.

Set-up makes the corpus and the weights from the seed, builds one
``Trainer`` and runs its first epoch (the warm-up) through the window's own
call, ``train_epoch(ds, seed=...)``; hooks on the model and the optimizer
keep the first ``check_steps`` steps' predictions, the optimizer's first
moment after step 1 and the parameters after the last of them. The window
then runs whole epochs until ``--seconds`` have passed: the trainer
synchronises with the host once an epoch. The check replays those first
steps in the plain reference (``reference/``) from the same corpus, weights
and seeds.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import generate, trace
from portbench.reference import augment as ref_aug
from portbench.reference import model as ref
from portbench.yardstick import work

NUMBERS = ("pred_gap", "loss_gap", "grad_gap_median", "update_gap", "update_gap_median")
FAULTS = ("fault:half_batch", "fault:unchanged")  # what ``check`` plants, on any cell
MESH_FAULTS = ("fault:no_exchange",)  # and on a cell over several ranks


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys
              ) -> Dict[str, float]:
    """Each leaf's gap of norms, | |got| - |want| |, over the larger of the
    leaf's reference norm and the median leaf's."""
    keys = list(keys)
    wn = {k: _norm(want[k]) for k in keys}
    med = statistics.median(wn.values())
    return {k: abs(_norm(got[k]) - wn[k]) / max(wn[k], med, 1e-30) for k in keys}


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of a prediction row, over the median row's norm."""
    gap = torch.linalg.vector_norm((got - want).double(), dim=1)
    return float(gap.max() / torch.linalg.vector_norm(want.double(), dim=1).median())


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr, self.dev = ctx.config, ctx.traffic, ctx.device
        self.hp = self.cfg["hp"]
        self.mesh = getattr(ctx, "mesh", None)
        self.world = getattr(ctx, "world", 1)
        self.batch = self.hp["batch_size"] * self.world  # the whole batch of a step
        self.check_steps = self.tr["check_steps"]
        self.e2e: Dict[str, float] = {}
        self.summary: Dict[str, object] = {}
        self.attempted = self.failed = 0
        self.spans = trace.Spans()

    def epoch_seed(self, e: int) -> int:
        return generate.sub_seed(self.ctx.seed, "epoch", e)

    # ---- set-up -----------------------------------------------------------------

    def inputs(self) -> None:
        """The corpus and the weights, from the seed alone."""
        self.plots = generate.corpus(self.tr["plots"], self.tr["points"], self.ctx.seed)
        self.weights = ref.make_weights(self.cfg, generate.sub_seed(self.ctx.seed, "weights"),
                                        self.dev)
        self.summary["chips"] = self.world

    def setup(self) -> None:
        from dl_biomass_tpu_torch.core.config import TrainConfig
        from dl_biomass_tpu_torch.io.device_data import DeviceDataset
        from dl_biomass_tpu_torch.models.pointnet2 import build_model
        from dl_biomass_tpu_torch.train.trainer import Trainer

        cfg, tr, dev = self.cfg, self.tr, self.dev
        t0 = time.perf_counter()
        self.inputs()
        pos, feat, y, ids = self.plots
        t1 = time.perf_counter()
        tc = TrainConfig.from_dict({"hp": dict(cfg["hp"], batch_size=self.batch),
                                    "model": cfg["model"]})
        with torch.device(dev):
            model = build_model(tc, cfg["num_features"])
        model.load_state_dict(self.weights, strict=True)
        self.trainer = Trainer(model, tc, device=dev, mesh=self.mesh)
        self.ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=tr["points"],
                                            for_augmentation=True, device=dev)
        self.steps_per_epoch = -(-len(ids) * (1 + self.hp["num_augs"]) // self.batch)
        t2 = time.perf_counter()
        self.captured = self._first_epoch()
        self.summary["setup_parts_s"] = {"inputs": t1 - t0, "program": t2 - t1,
                                         "first_epoch": time.perf_counter() - t2}

    def _first_epoch(self) -> dict:
        """Epoch 0 through ``train_epoch``, keeping what the check compares."""
        model, opt = self.trainer.model, self.trainer.optimizer
        k = self.check_steps
        names = {id(p): n for n, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        got = {"out": [], "steps": 0}

        def on_forward(_m, _inp, out):
            if len(got["out"]) < k:
                got["out"].append(out.detach().float().clone())

        def on_step(o, _args, _kwargs):
            got["steps"] += 1
            if got["steps"] == 1:
                got["grad"] = {names[id(p)]: o.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                               for g in o.param_groups for p in g["params"]}
            if got["steps"] == k:
                got["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}

        hooks = [model.register_forward_hook(on_forward), opt.register_step_post_hook(on_step)]
        try:
            with self.spans("portbench.epoch"):
                self.trainer.train_epoch(self.ds, seed=self.epoch_seed(0))
        finally:
            for h in hooks:
                h.remove()
        if self.world > 1:  # every rank's rows, in batch order
            import torch.distributed as dist

            for i, out in enumerate(got["out"]):
                parts = [torch.empty_like(out) for _ in range(self.world)]
                dist.all_gather(parts, out)
                got["out"][i] = torch.cat(parts)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return got

    # ---- the window ---------------------------------------------------------------

    def _epoch(self, e: int) -> int:
        with self.spans("portbench.epoch"):
            loss, n = self.trainer.train_epoch(self.ds, seed=self.epoch_seed(e))
        self.attempted += n
        if not np.isfinite(loss):
            self.failed += n
        return n

    def window(self, seconds: float) -> None:
        self.next_epoch = 1
        samples = 0
        t0 = time.perf_counter()
        while True:
            samples += self._epoch(self.next_epoch)
            self.next_epoch += 1
            if self._all_stop(time.perf_counter() - t0 >= seconds):
                break
        secs = time.perf_counter() - t0
        self.e2e["train_clouds_per_s"] = samples / secs
        self.summary.update(window_s=secs, window_units=(self.next_epoch - 1) * self.steps_per_epoch)

    def _all_stop(self, stop: bool) -> bool:
        """Rank 0's decision on every rank."""
        if self.world == 1:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([float(stop)], device=self.dev)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def traced(self) -> None:
        e = self.next_epoch
        self.summary["trace"] = trace.profile(lambda: self._epoch(e), self.spans)
        self.summary["trace_units"] = self.steps_per_epoch
        self.next_epoch += 1

    def release(self) -> None:
        self.trainer = self.ds = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ------------------------------------------------------------------

    def _reference(self, lowp=None, fault: Optional[str] = None) -> dict:
        """The first ``check_steps`` steps of epoch 0 in the reference (in
        ``lowp`` for the control; with ``fault`` planted)."""
        cfg, dev, b = self.cfg, self.dev, self.batch
        points = self.tr["points"]
        pos_l, feat_l, y, _ = self.plots
        cap = ref_aug.capacity(points)
        p_n = len(pos_l)
        pos = torch.zeros((p_n, cap, 3), device=dev)
        feat = torch.zeros((p_n, cap, cfg["num_features"]), device=dev)
        mask = torch.zeros((p_n, cap), dtype=torch.bool, device=dev)
        for i, (p, f) in enumerate(zip(pos_l, feat_l)):
            n = min(len(p), points)
            pos[i, :n] = torch.as_tensor(p[:n], device=dev)
            feat[i, :n] = torch.as_tensor(f.reshape(len(f), -1)[:n], device=dev)
            mask[i, :n] = True
        yt = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        seed = self.epoch_seed(0)
        idx, aug, valid = ref_aug.epoch_specs(p_n, seed, self.hp["num_augs"], b)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = {k: v.clone().requires_grad_(ref.trainable(k))
                  for k, v in self.weights.items()}
        train = {k: v for k, v in params.items() if v.requires_grad}
        opt = ref.Adam(train, self.hp["lr"], self.hp["weight_decay"])
        out = {"loss": [], "y": [], "valid": [], "flops": [], "bounds": []}
        for s in range(self.check_steps):
            bt = ref_aug.assemble(pos, feat, mask, yt, idx[s], aug[s], valid[s], seed, s * b,
                                  points)
            sel = ref.select_all(cfg, bt.pos, bt.mask, gen)
            keep = ref.dropout_keeps(cfg, b, gen, dev)
            vt = torch.as_tensor(valid[s], device=dev)
            if lowp is None and fault is None:  # a rank's share of the step's kernel work
                out["flops"].append(work.model_flops(cfg, sel, b, train=True))
                out["bounds"].append({c: work.bound_seconds(l) / self.world for c, l in
                                      work.kernel_work(cfg, sel, bt.pos, bt.mask, True).items()})
            pred = ref.forward(cfg, params, bt.pos, bt.feat, bt.mask, sel, True, keep, lowp,
                               checkpoint=True)
            rows = {"half_batch": slice(0, b // 2),
                    "no_exchange": slice(0, b // self.world)}.get(fault, slice(0, b))
            total = vt.sum() if fault == "no_exchange" else None
            loss = ref.loss(pred[rows], bt.y[rows], vt[rows], total)
            grads = torch.autograd.grad(loss, list(train.values()))
            taken = opt.step(dict(zip(train, grads)))
            out["loss"].append(float(loss.detach()))
            if s == 0:
                out["pred"] = pred.detach().float()
            out["y"].append(bt.y)
            out["valid"].append(vt)
            if s == 0:
                out["grad"] = {k: v.detach().clone() for k, v in taken.items()}
                out["raw"] = {k: g.detach().clone() for k, g in zip(train, grads)}
        out["params"] = {k: v.detach().clone() for k, v in train.items()}
        return out

    def check(self, variant: str = "program") -> Dict[str, float]:
        """The numbers compared for ``variant``: ``program`` (the captured run),
        ``control`` (the reference in fp8), ``fault:half_batch`` (the loss over
        half the batch), ``fault:no_exchange`` (rank 0's gradient alone, not
        summed over the ranks) or ``fault:unchanged`` (no step taken)."""
        ref.strict_float32()
        if getattr(self, "_want", None) is None:
            self._want = self._reference()
        want = self._want
        if "flops" in want and want["flops"]:
            self.summary["flops_per_unit"] = float(np.mean(want["flops"]))
            classes = want["bounds"][0].keys()
            self.summary["bound_s_per_unit"] = {
                c: float(np.mean([bd[c] for bd in want["bounds"]])) for c in classes}
        p0 = {k: v for k, v in self.weights.items() if ref.trainable(k)}
        if variant == "program":
            cap = self.captured
            loss = [float(ref.loss(o, y, v)) for o, y, v in
                    zip(cap["out"], want["y"], want["valid"])]
            got = {"loss": loss, "grad": cap["grad"], "params": cap["params"],
                   "pred": cap["out"][0]}
        elif variant == "control":
            got = self._reference(lowp=ref.round_fp8)
        elif variant in ("fault:half_batch", "fault:no_exchange"):
            got = self._reference(fault=variant.split(":")[1])
        elif variant == "fault:unchanged":
            got = dict(want, params=p0)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        if len(got["loss"]) < self.check_steps or "grad" not in got or "params" not in got:
            return {n: float("inf") for n in NUMBERS}
        med = statistics.median(_norm(g) for g in want["raw"].values())
        moved = [k for k, g in want["raw"].items() if _norm(g) >= 1e-3 * med]
        self.summary["still_leaves"] = sorted(set(p0) - set(moved))
        grad = leaf_gaps(got["grad"], want["grad"], p0)
        update = leaf_gaps({k: got["params"][k] - p0[k] for k in moved},
                           {k: want["params"][k] - p0[k] for k in moved}, moved)
        for name, gaps in (("grad", grad), ("update", update)):
            worst = max(gaps, key=gaps.get)
            self.summary[f"{name}_gap_worst_leaf"] = [worst, gaps[worst]]
        return {
            "pred_gap": row_gap(got["pred"], want["pred"]),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap": max(update.values()),
            "update_gap_median": statistics.median(update.values()),
        }
