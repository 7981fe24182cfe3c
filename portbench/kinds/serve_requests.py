"""Traffic kind ``serve_requests``: one client in a closed loop of prediction
requests, as ``predict`` and ``watch`` serve a poll's new plots.

A request of n plots goes the port's bulk-serving way: the plots packed by
``DeviceDataset.from_clouds``, the plot count padded to a multiple of
``plot_bucket`` by ``pad_plots``, ``compile_dataset_inference(model)``'s
``serve_dataset`` at ``batch_size``, the first n rows in host memory. It is
timed from its issue until those rows are there. Set-up makes the plot
pool, the request sizes and the weights from the seed, builds the engine
and serves one request of each padded size the traffic holds. The window
ends with the first request that completes after ``--seconds``. The check
compares a sample of the window's requests, drawn from the seed and with
the longest among them, with the plain reference's evaluation forward.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import generate, trace
from portbench.reference import model as ref
from portbench.yardstick import work

NUMBERS = ("row_gap", "row_gap_rms")
FAULTS = ()  # the served path's faults are planted in the program (tests/)
REF_BATCH = 32  # plots a block of the reference's forward


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr, self.dev = ctx.config, ctx.traffic, ctx.device
        self.e2e: Dict[str, float] = {}
        self.summary: Dict[str, object] = {}
        self.attempted = self.failed = 0
        self.spans = trace.Spans()
        self.done: List[tuple] = []  # (request, latency s, rows) in the window

    def _bucket(self, n: int) -> int:
        q = self.tr["plot_bucket"]
        return -(-n // q) * q

    def setup(self) -> None:
        from dl_biomass_tpu_torch.core.config import TrainConfig
        from dl_biomass_tpu_torch.models.inference import compile_dataset_inference
        from dl_biomass_tpu_torch.models.pointnet2 import build_model

        cfg, tr, dev, seed = self.cfg, self.tr, self.dev, self.ctx.seed
        t0 = time.perf_counter()
        self.pool = generate.corpus(tr["pool_plots"], tr["points"], seed, "pool")
        self.sizes = generate.request_sizes(tr["size_law"], tr["sizes_per_cycle"],
                                            tr["cycles"], seed)
        self.picks = generate.request_plots(self.sizes, tr["pool_plots"], seed)
        self.weights = ref.make_weights(cfg, generate.sub_seed(seed, "weights"), dev)
        tc = TrainConfig.from_dict({"hp": cfg["hp"], "model": cfg["model"]})
        with torch.device(dev):
            model = build_model(tc, cfg["num_features"])
        model.load_state_dict(self.weights, strict=True)
        self.model = model.eval()
        self.serve_ds = compile_dataset_inference(self.model, dev)
        t1 = time.perf_counter()
        for size in sorted({self._bucket(n) for n in self.sizes}):
            self._request(np.arange(min(size, tr["pool_plots"])))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.summary["setup_parts_s"] = {"inputs_and_engine": t1 - t0,
                                         "warm_up": time.perf_counter() - t1}

    def _request(self, picks: np.ndarray) -> np.ndarray:
        from dl_biomass_tpu_torch.io.device_data import DeviceDataset

        pos, feat, _, _ = self.pool
        n = len(picks)
        with self.spans("portbench.request"):
            with self.spans("portbench.from_clouds"):
                ds = DeviceDataset.from_clouds(
                    [pos[j] for j in picks], [feat[j] for j in picks],
                    np.zeros((n, 4), np.float32), [f"p{j}" for j in picks],
                    base_n=self.tr["points"], for_augmentation=False, device=self.dev)
            with self.spans("portbench.pad_plots"):
                ds = ds.pad_plots(self._bucket(n))
            with self.spans("portbench.serve_dataset"):
                rows = self.serve_ds(ds, self.tr["batch_size"])
        return np.asarray(rows)[:n]

    def _serve(self, i: int) -> tuple:
        t = time.perf_counter()
        rows = self._request(self.picks[i])
        lat = time.perf_counter() - t
        self.attempted += 1
        if rows.shape != (self.sizes[i], 4) or not np.isfinite(rows).all():
            self.failed += 1
        return i, lat, rows

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        i = 0
        while True:
            if i >= len(self.sizes):
                raise RuntimeError("the traffic ran out of requests: raise its cycles")
            self.done.append(self._serve(i))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        secs = time.perf_counter() - t0
        self.next_request = i
        plots = sum(self.sizes[j] for j, _, _ in self.done)
        lat = np.asarray([l for _, l, _ in self.done])
        self.e2e["serve_clouds_per_s"] = plots / secs
        self.e2e["serve_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        self.summary.update(window_s=secs, window_units=plots, requests=len(self.done),
                            latency_p50_ms=float(np.percentile(lat, 50)) * 1e3)

    def traced(self) -> None:
        first = self.next_request
        reqs = list(range(first, first + self.tr["trace_requests"]))

        def stretch():
            for i in reqs:
                self._request(self.picks[i])

        self.summary["trace"] = trace.profile(stretch, self.spans)
        bs = self.tr["batch_size"]
        self.summary["trace_units"] = sum(-(-self._bucket(self.sizes[i]) // bs) for i in reqs)
        self.trace_requests = reqs

    def release(self) -> None:
        self.model = self.serve_ds = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ------------------------------------------------------------------

    def sample(self) -> List[int]:
        """Indices into the window's requests: the longest, then others drawn
        from the seed until ``check_plots`` plots are held."""
        order = sorted(range(len(self.done)), key=lambda k: -self.sizes[self.done[k][0]])
        rng = np.random.default_rng(generate.sub_seed(self.ctx.seed, "check"))
        rest = [int(k) for k in rng.permutation(order[1:])]
        chosen, plots = [order[0]], self.sizes[self.done[order[0]][0]]
        for k in rest:
            if plots >= self.tr["check_plots"]:
                break
            chosen.append(k)
            plots += self.sizes[self.done[k][0]]
        return chosen

    def _reference_rows(self, plots: np.ndarray, lowp=None) -> np.ndarray:
        cfg, dev, points = self.cfg, self.dev, self.tr["points"]
        pos_l, feat_l, _, _ = self.pool
        cap = -(-points // 128) * 128
        out = []
        for s in range(0, len(plots), REF_BATCH):
            chunk = plots[s:s + REF_BATCH]
            pos = torch.zeros((len(chunk), cap, 3), device=dev)
            feat = torch.zeros((len(chunk), cap, cfg["num_features"]), device=dev)
            mask = torch.zeros((len(chunk), cap), dtype=torch.bool, device=dev)
            for i, j in enumerate(chunk):
                n = min(len(pos_l[j]), points)
                pos[i, :n] = torch.as_tensor(pos_l[j][:n], device=dev)
                feat[i, :n] = torch.as_tensor(feat_l[j].reshape(n, -1)[:n], device=dev)
                mask[i, :n] = True
            with torch.no_grad():
                sel = ref.select_all(cfg, pos, mask, None)
                if lowp is None and s == 0:
                    self.summary["flops_per_unit"] = work.model_flops(cfg, sel, len(chunk),
                                                                      False) / len(chunk)
                    self._bounds_of(sel, pos, mask, len(chunk))
                pred = ref.forward(cfg, self.weights, pos, feat, mask, sel, False, lowp=lowp)
            out.append(pred.cpu().numpy())
        return np.concatenate(out)

    def _bounds_of(self, sel, pos, mask, real: int) -> None:
        """The kernel bound a traced batch: a batch of this block's data
        for its real plots, the data-dependent operations scaled by the share
        of real plots in each batch of the traced stretch."""
        launches = work.kernel_work(self.cfg, sel, pos, mask, train=False)
        if not getattr(self, "trace_requests", None):
            return
        bs = self.tr["batch_size"]
        shares = []
        for i in self.trace_requests:
            n, padded = self.sizes[i], self._bucket(self.sizes[i])
            shares += [min(max(n - b0, 0), bs) / bs for b0 in range(0, padded, bs)]
        scale = bs / real
        total = {}
        for c, ls in launches.items():
            shape_only = c == "fps"
            total[c] = sum(work.bound_seconds(
                [(nb * scale, ops * scale * (1.0 if shape_only else sh)) for nb, ops in ls])
                for sh in shares) / len(shares)
        self.summary["bound_s_per_unit"] = total

    def check(self, variant: str = "program") -> Dict[str, float]:
        """``row_gap`` (the widest row gap) and ``row_gap_rms`` (the root mean
        square of the row gaps), each over the median row's norm, of
        ``variant``: ``program`` (the served rows) or ``control`` (the
        reference in fp8), against the float32 reference."""
        ref.strict_float32()
        chosen = self.sample()
        plots = np.concatenate([self.picks[self.done[k][0]] for k in chosen])
        if getattr(self, "_want", None) is None:
            self._want = self._reference_rows(plots)
        want = self._want
        if variant == "program":
            got = np.concatenate([self.done[k][2] for k in chosen])
        elif variant == "control":
            got = self._reference_rows(plots, lowp=ref.round_fp8)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.summary["checked_plots"] = len(plots)
        if got.shape != want.shape or not np.isfinite(got).all():
            return {n: float("inf") for n in NUMBERS}
        norms = np.linalg.norm(want.astype(np.float64), axis=1)
        gap = np.linalg.norm(got.astype(np.float64) - want, axis=1)
        scale = max(statistics.median(norms), 1e-30)
        return {"row_gap": float(gap.max() / scale),
                "row_gap_rms": float(np.sqrt(np.mean(gap ** 2)) / scale)}
