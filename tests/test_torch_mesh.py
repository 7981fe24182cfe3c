"""The port's data parallelism (``parallel/mesh.py``, ``Trainer(mesh=)``, the
serving engines and the sweep over a mesh) on the CPU.

- ``mesh_shape`` against the JAX package's ``make_mesh`` on the 8 virtual CPU
  devices of ``tests/conftest.py`` (the counterpart of
  ``tests/test_parallel.py:29-35``).
- One spawned 2-rank gloo group (a file store under ``tmp_path``) runs every
  check of ``tests/torch_mesh_worker.py`` in one spawn and saves what it saw;
  the tests below read it:
  * the statistics every train-mode BatchNorm of that step used, against
    one process's, bit for bit (ROADMAP C.4's repair: the sums in float64
    over float32 partials of chunks of one cloud's rows);
  * the port's float32 step (ELU, dropout 0, FPS from the first valid point)
    on bridged weights against JAX's step under ``make_mesh(dp=2)``, within
    ``tests/test_parallel.py``'s bounds (loss rtol 1e-5; each gradient over
    its largest, atol 1e-4; the biases whose true gradient is 0 held by size,
    as ``tests/test_torch_step.py`` holds them), on a batch whose pad clouds
    fall evenly and on one where rank 1 holds one real cloud and rank 0 four;
  * ``train_epoch``, the fused and the scan epochs under the mesh (the
    counterpart of ``tests/test_parallel.py:77-108``) against each other and
    against one process;
  * kernel 6's plain passes (``fused_sa``) under the mesh against one process;
  * serving, ``predict``, the sweep and ``fit`` under the mesh against one
    process, and ``train`` through the CLI in the group.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dl_biomass_tpu.parallel.mesh import replicated_sharding, shard_batch
from dl_biomass_tpu.train.loss import weighted_component_mse as jax_loss
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
from test_torch_step import flat, torch_name, zero_gradient
from torch_mesh_worker import EPOCH_PLOTS
from torch_port_helpers import batches, models

torch.set_num_threads(1)

B, N = 8, 640
BATCHES = {"even": [640, 517, 600, 300, 640, 420, 333, 640],
           # rank 0 holds four real clouds, rank 1 one: an average of the
           # ranks' means is not the batch's mean
           "uneven": [640, 517, 600, 300, 640, 0, 0, 0]}
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4  # tests/test_parallel.py:37-66


@pytest.mark.parametrize("dp_, mp", [(-1, 1), (4, 2), (2, 1), (-1, 2), (16, 1), (-1, 3),
                                     (3, 3)])
def test_mesh_shape_follows_jax_make_mesh(dp_, mp):
    try:
        want = tuple(jax_make_mesh(dp=dp_, mp=mp).shape.values())
    except ValueError:
        with pytest.raises(ValueError):
            dp.mesh_shape(len(jax.devices()), dp_, mp)
        return
    assert dp.mesh_shape(len(jax.devices()), dp_, mp) == want


def test_backend_follows_the_devices():
    assert dp.backend_for(torch.device("cpu"), 2) == "gloo"
    if torch.cuda.device_count() < 2:  # ranks that share a card (or none) take gloo
        assert dp.backend_for(torch.device("cuda"), 2) == "gloo"


def _arrays(valid, seed=0):
    jb, tb = batches(seed, B, N, valid)
    y = (np.random.default_rng(9).normal(size=(B, 4)) * 3).astype(np.float32)
    return tuple(np.asarray(a) for a in (tb.pos, tb.feat, tb.mask)) + (y,)


def _jax_step(jm, v, arrays):
    """JAX's train-mode loss, gradients and new statistics under make_mesh(dp=2)."""
    pos, feat, mask, y = (jnp.asarray(a) for a in arrays)
    mesh = jax_make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    repl = replicated_sharding(mesh)
    params = jax.device_put(v["params"], repl)
    stats = jax.device_put(v["batch_stats"], repl)

    def loss_fn(p, b):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, b, train=True,
                            mutable=["batch_stats"])
        return jax_loss(out, b.y, jnp.any(b.mask, axis=1)), upd

    batch = shard_batch(JaxBatch(pos=pos, feat=feat, mask=mask, y=y), mesh)
    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    return float(loss), dict(flat(grads)), dict(flat(upd["batch_stats"]))


def _cli_corpus(root):
    make_corpus(str(root / "raw"), 12, 600, seed=2,
                splits=(("train", 8 / 12), ("val", 2 / 12), ("test", 2 / 12)))
    cfg = {"hp": {"batch_size": 4, "num_augs": 0, "num_points": 256},
           "data": {"train_dir": "raw/train", "val_dir": "raw/val",
                    "biomass_csv": "raw/biomass.csv", "use_presampled": False},
           "seed": 0, "num_epochs": 2}
    (root / "cfg.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 2-rank group once; (rank results, JAX results, one-process CLI log)."""
    import contextlib
    import io

    import torch_mesh_worker
    from dl_biomass_tpu_torch.__main__ import main

    tmp = tmp_path_factory.mktemp("mesh")
    arrays = {case: _arrays(valid) for case, valid in BATCHES.items()}
    jb, _ = batches(0, B, N, BATCHES["even"])
    jm, v, tm = models("production", "float32", jb, dropout_probability=0.0,
                       activation_function="ELU")
    kwargs = dict(num_features=1, fast_group=True, fast_fps=True, dropout_probability=0.0,
                  activation_function="ELU", compute_dtype=torch.float32)
    _, _, fused = models("production", "float32", jb, dropout_probability=0.0,
                         activation_function="ELU", fused_sa=True, seed=1)
    small_kwargs = dict(num_features=1, fast_group=True, fast_fps=True,
                        compute_dtype=torch.float32)
    torch.manual_seed(4)
    small = torch_mesh_worker.PointNet2Regressor(**small_kwargs)
    cli_dir = tmp / "cli"
    cli_dir.mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        _cli_corpus(cli_dir)
        cwd = os.getcwd()
        os.chdir(cli_dir)
        try:
            assert main(["train", "--config", "cfg.json", "--model_dir", "one_models",
                         "--device", "cpu"]) == 0
        finally:
            os.chdir(cwd)
    torch.save(dict(batches=arrays, cli_dir=str(cli_dir), models=dict(
        f32=(kwargs, tm.state_dict()), fused_sa=(dict(kwargs, fused_sa=True), fused.state_dict()),
        analytic_remat=(dict(kwargs, analytic_bn=True, remat=True), tm.state_dict()),
        small=(small_kwargs, small.state_dict()))), tmp / "inputs.pt")
    dp.spawn(torch_mesh_worker.run_checks, 2, str(tmp / "store"), args=(str(tmp),),
             device="cpu")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    jax_steps = {case: _jax_step(jm, v, a) for case, a in arrays.items()}
    return ranks, jax_steps, tmp


def test_each_rank_holds_its_coordinate_and_the_whole_batch_draws(group):
    ranks, _, _ = group
    assert [r["coordinate"] for r in ranks] == [(0, 0), (1, 0)]
    assert all(r["draws"] for r in ranks)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_two_rank_step_matches_jax_under_make_mesh(group, case):
    ranks, jax_steps, _ = group
    jloss, jgrads, jstats = jax_steps[case]
    got = ranks[0][f"step_{case}"]
    assert abs(got["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, jg in jgrads.items():
        name = torch_name(path)
        tg = got["grads"][name]
        tg = tg.T if path[-1] == "kernel" else tg
        if zero_gradient(name) and np.abs(jg).max() <= 1e-5 * top:
            # (with empty clouds in the batch SA3's last bias has a gradient:
            # the head's BatchNorm sees their rows at 0 whatever the bias)
            assert np.abs(tg).max() <= 1e-5 * top, name
            continue
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(tg / scale, jg / scale, atol=GRAD_ATOL, err_msg=name)
    for path, js in jstats.items():
        ts = got["state"][".".join(path[:-1]) + ".running_" + {"mean": "mean", "var": "var"}[
            path[-1]]]
        scale = np.abs(js).max()
        np.testing.assert_allclose(ts / scale, js / scale, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_two_rank_batchnorm_statistics_equal_one_process_bit_for_bit(group, case):
    """ROADMAP C.4: summed over the ranks in another order than one process
    sums them, whole-batch float32 statistics parted where E[x^2] is many times
    the variance; the sums in float64 over float32 chunk partials give one
    process's statistics bit for bit wherever the BatchNorm's input rows are
    one process's (SA1's, SA2's and SA3's six, and the head's first, here),
    and within 1e-5 of their largest where a matmul of fewer rows rounded
    the inputs otherwise (the head's second, 4 rows a rank: its inputs 7e-7
    apart)."""
    ranks, _, _ = group
    one = ranks[1]["stats_one"][case]
    same_inputs = []
    for i, (mean1, var1, halves) in enumerate(one):
        got = [r[f"stats_{case}"][i] for r in ranks]
        if all(g[2] == [h] for g, h in zip(got, halves)):
            same_inputs.append(i)
            for mean, var, _ in got:
                np.testing.assert_array_equal(mean, mean1)
                np.testing.assert_array_equal(var, var1)
        else:
            for mean, var, _ in got:
                np.testing.assert_allclose(mean, mean1, rtol=0, atol=1e-5 * np.abs(mean1).max())
                np.testing.assert_allclose(var, var1, rtol=0, atol=1e-5 * np.abs(var1).max())
    assert len(one) == 8 and same_inputs[:6] == list(range(6))


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_the_ranks_hold_the_same_state_after_a_step(group, case):
    ranks, _, _ = group
    a, b = ranks[0][f"step_{case}"], ranks[1][f"step_{case}"]
    assert a["loss"] == b["loss"]
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def test_kernel6_plain_passes_under_the_mesh_match_one_process(group):
    """``fused_sa``: F1's and F2's sums, the count and the backward's terms
    summed over the ranks give the one-process step on the whole batch."""
    ranks, _, _ = group
    _hold_to_one_process(ranks[0]["fused_sa_mesh"], ranks[1]["fused_sa_one"])


def test_analytic_bn_and_remat_under_the_mesh_match_one_process(group):
    """``analytic_bn`` + ``remat``: the folded layers' input moments and
    count summed over the ranks, also when the SA MLPs recompute in the
    backward (the sums run again there, on both ranks in one order), give the
    one-process step on the whole batch."""
    ranks, _, _ = group
    _hold_to_one_process(ranks[0]["analytic_remat_mesh"], ranks[1]["analytic_remat_one"])


def _hold_to_one_process(mesh, one):
    assert abs(mesh["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    top = max(np.abs(g).max() for g in one["grads"].values())
    for name, g in one["grads"].items():
        if zero_gradient(name) and np.abs(g).max() <= 1e-5 * top:
            assert np.abs(mesh["grads"][name]).max() <= 1e-5 * top, name
            continue
        scale = np.abs(g).max() + 1e-12
        np.testing.assert_allclose(mesh["grads"][name] / scale, g / scale, atol=GRAD_ATOL,
                                   err_msg=name)
    for k, s in one["state"].items():
        if "running" in k:
            scale = np.abs(s).max()
            np.testing.assert_allclose(mesh["state"][k] / scale, s / scale, atol=GRAD_ATOL)


def test_fused_and_scan_epochs_under_the_mesh_match_train_epoch(group):
    """As in one process, the three epochs take the same steps bit for bit."""
    ranks, _, _ = group
    for r in ranks:
        ep = r["epochs_mesh"]
        assert ep["plain"]["n"] == ep["fused"]["n"] == ep["scan"]["n"] == 16
        for path in ("fused", "scan"):
            assert ep[path]["loss"] == ep["plain"]["loss"], path
            for a, b in zip(ep[path]["params"], ep["plain"]["params"]):
                np.testing.assert_array_equal(a, b)
        assert ep["evaluate_scan"] == ep["evaluate_fused"] == ep["evaluate"]


def test_a_mesh_epoch_matches_one_process(group):
    """FPS starts and dropout drawn for the whole batch and sliced: the mesh's
    epoch is the one-process epoch, to float32 summation order."""
    ranks, _, _ = group
    mesh, one = ranks[0]["epochs_mesh"], ranks[0]["epochs_one"]
    for path in ("plain", "scan"):
        np.testing.assert_allclose(mesh[path]["loss"], one[path]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(mesh["evaluate"], one["evaluate"], rtol=1e-4)
    np.testing.assert_allclose(mesh["predict"], one["predict"], rtol=1e-3, atol=1e-4)
    assert mesh["predict"].shape == one["predict"].shape == (EPOCH_PLOTS, 4)
    np.testing.assert_array_equal(ranks[1]["epochs_mesh"]["predict"], mesh["predict"])


def test_serving_under_the_mesh_matches_one_process(group):
    """Each rank serves its slice, every rank gets every row in batch order;
    a request the dp size does not divide raises."""
    ranks, _, _ = group
    one = ranks[1]["serving_one"]
    for r in ranks:
        got = r["serving_mesh"]
        np.testing.assert_allclose(got["serve"], one["serve"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dataset"], one["dataset"], rtol=1e-6, atol=1e-6)
        assert got["dataset"].shape == (EPOCH_PLOTS, 4)
        assert "does not split over the mesh's dp=2" in got["odd_batch"]
    np.testing.assert_array_equal(ranks[0]["serving_mesh"]["dataset"],
                                  ranks[1]["serving_mesh"]["dataset"])


def test_sweep_under_the_mesh_matches_one_process(group):
    """Trial t runs on rank t (one trial a rank) exactly as in one process;
    the results are every rank's."""
    ranks, _, _ = group
    assert [r["sweep_mesh"]["local"] for r in ranks] == [[0], [1]]
    assert [r["sweep_mesh"]["built"] for r in ranks] == [[True, False], [False, True]]
    for r in ranks:
        assert r["sweep_mesh"]["results"] == ranks[1]["sweep_one"]["results"]


def test_fit_under_the_mesh(group):
    """Both ranks take rank 0's numbers; only rank 0 logs and writes."""
    ranks, _, tmp = group
    a, b = ranks[0]["fit_mesh"], ranks[1]["fit_mesh"]
    assert a["val"] == b["val"] and a["train"] == b["train"] and a["best"] == b["best"]
    assert a["logged"] > 0 and b["logged"] == 0
    assert len((tmp / "fit" / "log.csv").read_text().splitlines()) == 2
    assert sorted((tmp / "fit" / "ckpt").glob("epoch_*.pt"))


def test_a_batch_the_mesh_does_not_divide_raises(group):
    ranks, _, _ = group
    assert all("a batch of 7 clouds does not split over the mesh's dp=2" in r["odd_step"]
               for r in ranks)


def test_train_through_the_cli_under_the_mesh(group):
    """``train`` in a 2-rank group builds the mesh: rank 0 prints and writes a
    log that agrees with one process's; rank 1 prints nothing. The CLI trains
    the production model in bf16, whose sums in another order round
    differently, and Adam carries that through 4 steps: the bound is the bf16
    step bound 2^-8 (``PERF.md`` section 2; measured 1.6e-4)."""
    ranks, _, tmp = group
    assert [r["cli"]["rc"] for r in ranks] == [0, 0]
    assert "mesh {'dp': 2, 'mp': 1}" in ranks[0]["cli"]["printed"]
    assert ranks[1]["cli"]["printed"] == ""
    read = lambda d: np.loadtxt(tmp / "cli" / d / "training_log.csv", delimiter=",")
    mesh, one = read("mesh_models"), read("one_models")
    assert mesh.shape == one.shape == (2, 3)
    np.testing.assert_allclose(mesh, one, rtol=2.0**-8)

