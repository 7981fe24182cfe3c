"""The ports of the JAX package's tools that run no kernel of their own
(``dl_biomass_tpu_torch/tools/``: ``profile_step``, ``roofline``,
``batch_sweep``, ``serving_matrix``, ``dispatch_probe`` with
``multistep_probe`` folded in, ``bq_tile_sweep``, ``fps_divergence_probe``
and ``torch_cpu_anchor``), on the CPU at toy sizes:

- each tool's ``main()`` with ``device="cpu"`` (the kernels' plain versions)
  returns its numbers, each naming the CPU; the same call without a device
  raises, since this machine has no card (a tool never falls back);
- ``roofline``'s counts of kernels 1, 2, 3, 4a, 4b and 4c equal those of the
  bound functions of ``chip_smoke.py`` on the same inputs;
- ``fps_divergence_probe.old_keys`` seeds batch 0's augmentation as the
  steps' generator, so their draws are one stream; the package keeps them
  apart.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.tools import (batch_sweep, bq_tile_sweep, dispatch_probe,
                                        fps_divergence_probe, profile_step, roofline,
                                        serving_matrix, torch_cpu_anchor)
from dl_biomass_tpu_torch.train.trainer import Trainer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

B, N = 2, 256
STUDY = dict(num_plots=12, n_points=N, batch_size=4, num_augs=1, max_epochs=1)
CALLS = {
    "profile_step": lambda dev: profile_step.main("train", B, N, device=dev, steps=1),
    "roofline": lambda dev: roofline.main(B, N, dev, repeats=1),
    "batch_sweep": lambda dev: batch_sweep.main((B,), N, dev, steps=1, repeats=1),
    "serving_matrix": lambda dev: serving_matrix.main((1, B), device=dev, steps=1, repeats=1,
                                                      n=N),
    "dispatch_probe": lambda dev: dispatch_probe.main(B, N, dev, groups=(1, 2), steps=1,
                                                      repeats=1),
    "bq_tile_sweep": lambda dev: bq_tile_sweep.main(64, N, dev, b=B, steps=1, repeats=1),
    "fps_divergence_probe": lambda dev: fps_divergence_probe.main(1, device=dev, **STUDY),
    "torch_cpu_anchor": lambda dev: torch_cpu_anchor.main(B, N, 1, dev),
}


_RUNS = {}


def run_on_cpu(tool):
    """``CALLS[tool]("cpu")``, once per test run: (its return, what it printed)."""
    if tool not in _RUNS:
        import contextlib
        import io

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = CALLS[tool]("cpu")
        _RUNS[tool] = (out, printed.getvalue())
    return _RUNS[tool]


@pytest.mark.parametrize("tool", sorted(CALLS))
def test_main_on_the_cpu_names_the_cpu(tool):
    out, printed = run_on_cpu(tool)
    assert "cpu (" in printed
    rows = out if isinstance(out, list) else [out]
    assert rows and all(r.get("card", r.get("device", "")).startswith("cpu (") for r in rows)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a card")
@pytest.mark.parametrize("tool", sorted(CALLS))
def test_main_without_a_card_raises(tool):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CALLS[tool](None)


def test_profile_step_covers_eval_and_engine_and_fused_sa():
    assert run_on_cpu("profile_step")[0]["kernels"] == []  # no device on the CPU
    for which in ("eval", "engine"):
        r = profile_step.main(which, B, N, device="cpu", steps=1)
        assert r["step"] == which and r["busy_ms"] > 0 and r["ops"]
    r = profile_step.main("train", B, N, fused_sa=True, device="cpu", steps=1)
    assert r["fused_sa"] and r["wall_ms"] > 0
    with pytest.raises(ValueError, match="unknown step"):
        profile_step.main("bogus", B, N, device="cpu", steps=1)


def test_roofline_counts_equal_the_bound_functions():
    trainer, batch = roofline.flagship(B, N, torch.device("cpu"))
    calls = roofline.record(lambda: trainer.step(batch, torch.Generator().manual_seed(1)))
    counts = roofline.kernel_counts(calls)
    assert sorted(k for k, c in calls.items() if c) == ["1", "2", "3", "4a", "4b"]

    def from_bound(ms_by):
        return ms_by[0] * 1e-3

    def seconds(nbytes, ops, peak=chip_smoke.PEAK_F32_FLOP_PER_S):
        return max(nbytes / chip_smoke.PEAK_BYTES_PER_S, ops / peak)

    want = {}
    for args, kwargs, _ in calls["1"]:
        pos, mask, starts, k = args
        want["1"] = want.get("1", 0) + from_bound(chip_smoke.fps_bound(pos.shape[0],
                                                                       pos.shape[1], k))
    (args, kwargs, _), = calls["2"]
    want["2"] = from_bound(chip_smoke.group_bound(*args, kwargs["radius"], kwargs["out_dtype"]))
    (args, kwargs, res), = calls["3"]
    tests = chip_smoke.query_scan(args, kwargs, res)["tests"]
    want["3"] = from_bound(chip_smoke.query_bound(args, kwargs, tests)[0])
    got = {k: seconds(*counts[k]) for k in ("2", "3")}
    got["1"] = sum(seconds(*roofline.fps_counts(*a, **kw)) for a, kw, _ in calls["1"])
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-12), k
    (args, _, _), = calls["4a"]
    values, idx = args
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    assert counts["4a"] == (b * m * k * c * es + b * m * k * 4 + b * n * c * es, 0)
    (args, _, _), = calls["4b"]
    ct, idx, n = args
    valid = int(((idx >= 0) & (idx < n)).sum())
    assert counts["4b"] == (ct.numel() * ct.element_size() + idx.numel() * 4
                            + ct.shape[0] * n * ct.shape[-1] * ct.element_size(),
                            valid * ct.shape[-1])


def test_roofline_counts_kernel_4c_in_the_unsplit_model():
    trainer, batch = roofline.flagship(B, N, torch.device("cpu"), split_first_layer=False)
    calls = roofline.record(lambda: trainer._eval_batch(batch))
    (args, _, _), = calls["4c"]
    values, idx, aux = args
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    assert roofline.kernel_counts(calls)["4c"] == (
        b * m * k * (c * es + aux.shape[-1] * 4 + 4) + b * n * (c * es + aux.shape[-1] * 4), 0)


def _draws(gen, n=64):
    return torch.rand(n, generator=gen)


@pytest.mark.parametrize("old", [False, True])
def test_old_keys_put_batch_zero_on_the_step_stream(old):
    pos, feat, y, ids = synthetic_dataset(4, 64, seed=0)
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, device="cpu")
    trainer = Trainer(torch.nn.Linear(1, 1), TrainConfig(), device="cpu")
    seed = 1_000_003
    with fps_divergence_probe.old_keys() if old else fps_divergence_probe.contextlib.nullcontext():
        aug0 = torch.Generator().manual_seed(ds.aug_seed(seed, 0))
        aug4 = torch.Generator().manual_seed(ds.aug_seed(seed, 4))
    steps = trainer.step_generator(seed)
    a0, a4, s = _draws(aug0), _draws(aug4), _draws(steps)
    assert torch.equal(a0, s) == old
    assert not torch.equal(a4, s)


def test_the_probe_reruns_a_seed_study_row_both_ways():
    rows = [run_on_cpu("fps_divergence_probe")[0],
            fps_divergence_probe.main(1, old=True, device="cpu", **STUDY)]
    assert [r["old_keys"] for r in rows] == [False, True]
    assert all(r["epochs"] == 1 and np.isfinite(r["min_val_mse"]) for r in rows)
    assert rows[0]["min_val_mse"] != rows[1]["min_val_mse"]


def test_bq_tile_sweep_starts_at_the_plan_and_keeps_its_neighbours():
    rows, _ = run_on_cpu("bq_tile_sweep")
    assert rows[0]["plan"] == tuple(bq_tile_sweep.k3.plan(N, 64, bq_tile_sweep.K))
    assert len(rows) > 1 and all(r["same"] for r in rows)


def test_dispatch_probe_measures_both_steps():
    rows, _ = run_on_cpu("dispatch_probe")
    assert [r["step"] for r in rows] == ["default", "fused_sa"]
    assert all(set(r["wall_ms_by_group"]) == {1, 2} and r["issue_ms"] > 0 for r in rows)


def test_serving_matrix_times_every_path_and_cold_starts():
    rows, _ = run_on_cpu("serving_matrix")
    assert [r["batch"] for r in rows] == [1, B]
    assert all({"eval_step_ms", "engine_ms", "fused_eval_engine_ms",
                "export_artifact_ms"} <= set(r) for r in rows)
    cold = serving_matrix.cold_start("cpu", plots=2, points=N)
    assert cold["ok"] and cold["rows"] == 2 and cold["wall_s"] > 0


def test_the_reference_algorithm_trains():
    torch.manual_seed(0)
    net = torch_cpu_anchor.Net()
    clouds = [(torch.randn(N, 1), torch.randn(N, 3) * 5) for _ in range(B)]
    out = net(clouds)
    assert out.shape == (B, 4)
    out.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    idx, mask = torch_cpu_anchor.radius_first_k(clouds[0][1][:8], clouds[0][1], 2.0, 64)
    d2 = torch.cdist(clouds[0][1][:8], clouds[0][1]) ** 2
    first = [torch.nonzero(row <= 4.0).flatten()[:64] for row in d2]
    for i, f in enumerate(first):
        assert torch.equal(idx[i][mask[i]], f)
