"""The port's point parallelism (``parallel/mesh.shard_points``, the model's
split of SA1 and SA2 by centroid over ``mp``, ``Trainer(mesh=)`` with ``mp``
> 1) on the CPU.

One spawned 2-rank gloo group (``mp`` = 2) and one 4-rank group (``dp`` = 2 x
``mp`` = 2) run the checks of ``tests/torch_mesh_mp_worker.py`` and save what
they saw; the tests below read it:

- the eval forward against ``tests/test_parallel.py``'s ``TestModelParallel``
  (the JAX package's default model on ``synthetic_dataset(8, 128)``, its
  plain forward, which that test holds its point-sharded forward to) on
  bridged weights, within that test's rtol = atol = 2e-4;
- the float32 production step (ELU, dropout 0) against JAX's step with the
  batch placed ``P("dp", "mp", None)`` under ``make_mesh(dp=1, mp=2)``, and
  against one process, within ``tests/test_parallel.py``'s bounds (loss rtol
  1e-5; each gradient over its largest, atol 1e-4), as
  ``tests/test_torch_mesh.py`` holds the ``dp`` step;
- the share of the centroids kernel 2 takes on each rank (half of SA1's, the
  last share padded where the count is odd);
- a point count ``mp`` does not divide raises ``ValueError``;
- a ``fused_sa`` model (kernel 6 runs replicated over ``mp``) against one
  process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.io.device_data import DeviceDataset as JaxDataset
from dl_biomass_tpu.io.synthetic import synthetic_dataset
from dl_biomass_tpu.models import PointNet2Regressor as JaxModel
from dl_biomass_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dl_biomass_tpu.parallel.mesh import replicated_sharding
from dl_biomass_tpu.train.loss import weighted_component_mse as jax_loss
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.parallel import mesh as dp
from test_torch_mesh import GRAD_ATOL, LOSS_RTOL, _hold_to_one_process
from test_torch_step import flat, torch_name, zero_gradient
from torch_port_helpers import batches, models

torch.set_num_threads(1)

B, N = 8, 640
VALID = [640, 517, 600, 300, 640, 420, 333, 640]
# 4 clouds of 650 points: SA1 takes 130 centroids (65 a rank), SA2 33 (17 and
# 16, the second share padded by one)
ODD_B, ODD_N, ODD_VALID = 4, 650, [650, 601, 420, 650]
MP_RTOL = 2e-4  # tests/test_parallel.py:131-133


def _arrays(b, n, valid, seed=0):
    _, tb = batches(seed, b, n, valid)
    y = (np.random.default_rng(9).normal(size=(b, 4)) * 3).astype(np.float32)
    return tuple(np.asarray(a) for a in (tb.pos, tb.feat, tb.mask)) + (y,)


def _parallel_batch():
    """``TestModelParallel``'s batch: synthetic_dataset(8, 128), one batch of 8."""
    pos, feat, y, ids = synthetic_dataset(8, 128, seed=0)
    batch = next(JaxDataset.from_clouds(pos, feat, y, ids, base_n=128).batches(8))
    return batch, tuple(np.asarray(a) for a in (batch.pos, batch.feat, batch.mask, batch.y))


def _jax_mp_step(jm, v, arrays):
    """JAX's train-mode loss and gradients with the batch's points sharded
    over mp (make_mesh(dp=1, mp=2), ``P("dp", "mp", None)``)."""
    pos, feat, mask, y = (jnp.asarray(a) for a in arrays)
    mesh = jax_make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    repl = replicated_sharding(mesh)
    params = jax.device_put(v["params"], repl)
    stats = jax.device_put(v["batch_stats"], repl)

    def loss_fn(p, b):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, b, train=True,
                          mutable=["batch_stats"])
        return jax_loss(out, b.y, jnp.any(b.mask, axis=1))

    points = NamedSharding(mesh, P("dp", "mp", None))
    batch = JaxBatch(pos=jax.device_put(pos, points), feat=jax.device_put(feat, points),
                     mask=jax.device_put(mask, NamedSharding(mesh, P("dp", "mp"))),
                     y=jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("dp", None))))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    return float(loss), dict(flat(grads))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn the mp=2 group and the dp=2 x mp=2 group once; (rank results by
    group, the JAX results)."""
    import torch_mesh_mp_worker

    tmp = tmp_path_factory.mktemp("mesh_mp")
    step_arrays = _arrays(B, N, VALID)
    jb, _ = batches(0, B, N, VALID)
    jm, v, tm = models("production", "float32", jb, dropout_probability=0.0,
                       activation_function="ELU")
    kwargs = dict(num_features=1, fast_group=True, fast_fps=True, dropout_probability=0.0,
                  activation_function="ELU", compute_dtype=torch.float32)
    _, _, fused = models("production", "float32", jb, dropout_probability=0.0,
                         activation_function="ELU", fused_sa=True, seed=1)
    jbatch, eval_arrays = _parallel_batch()
    jdefault = JaxModel(num_features=1)
    vdefault = jdefault.init({"params": jax.random.key(0)}, jbatch, train=False)
    default = torch_mesh_mp_worker.PointNet2Regressor(num_features=1)
    default.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, vdefault)))
    torch.save(dict(step_batch=step_arrays, eval_batch=eval_arrays,
                    odd_share_batch=_arrays(ODD_B, ODD_N, ODD_VALID, seed=3),
                    models=dict(f32=(kwargs, tm.state_dict()),
                                fused_sa=(dict(kwargs, fused_sa=True), fused.state_dict()),
                                default=(dict(num_features=1), default.state_dict()))),
               tmp / "inputs.pt")
    ranks = {}
    for tag, (d, m) in {"mp2": (1, 2), "dp2mp2": (2, 2)}.items():
        dp.spawn(torch_mesh_mp_worker.run_checks, d * m, str(tmp / f"store_{tag}"),
                 args=(str(tmp), tag, d, m), device="cpu")
        ranks[tag] = [torch.load(tmp / f"{tag}_rank{r}.pt", weights_only=False)
                      for r in range(d * m)]
    want = dict(eval=np.asarray(jdefault.apply(vdefault, jbatch, train=False)),
                step=_jax_mp_step(jm, v, step_arrays))
    return ranks, want


def test_each_rank_holds_its_coordinate(groups):
    ranks, _ = groups
    assert [r["coordinate"] for r in ranks["mp2"]] == [(0, 0), (0, 1)]
    assert [r["coordinate"] for r in ranks["dp2mp2"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_point_sharded_eval_matches_the_jax_forward(groups):
    """``TestModelParallel``'s check, on the port: every rank's rows of the
    point-sharded eval forward against JAX's plain forward."""
    ranks, want = groups
    for r in ranks["mp2"]:
        np.testing.assert_allclose(r["eval"], want["eval"], rtol=MP_RTOL, atol=MP_RTOL)
    np.testing.assert_allclose(ranks["mp2"][-1]["eval_one"], want["eval"], rtol=MP_RTOL,
                               atol=MP_RTOL)


@pytest.mark.parametrize("tag", ["mp2", "dp2mp2"])
def test_point_sharded_step_matches_jax_and_one_process(groups, tag):
    ranks, want = groups
    jloss, jgrads = want["step"]
    got = ranks[tag][0]["step"]
    assert abs(got["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, jg in jgrads.items():
        name = torch_name(path)
        tg = got["grads"][name]
        tg = tg.T if path[-1] == "kernel" else tg
        if zero_gradient(name) and np.abs(jg).max() <= 1e-5 * top:
            assert np.abs(tg).max() <= 1e-5 * top, name
            continue
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(tg / scale, jg / scale, atol=GRAD_ATOL, err_msg=name)
    _hold_to_one_process(got, ranks[tag][-1]["step_one"])


@pytest.mark.parametrize("tag", ["mp2", "dp2mp2"])
def test_the_ranks_hold_the_same_gradients(groups, tag):
    ranks, _ = groups
    first = ranks[tag][0]["step"]
    for r in ranks[tag][1:]:
        assert r["step"]["loss"] == first["loss"]
        for k, g in first["grads"].items():
            np.testing.assert_array_equal(r["step"]["grads"][k], g, err_msg=k)


def test_each_rank_groups_its_share_of_the_centroids(groups):
    """Kernel 2 takes half of SA1's centroids on each rank: 64 of 128 at 640
    points, 65 of 130 at 650; one process takes them all."""
    ranks, _ = groups
    for r in ranks["mp2"]:
        assert r["step"]["centroids"] == [64]
        assert r["odd_share"]["centroids"] == [65]
    assert ranks["mp2"][-1]["step_one"]["centroids"] == [128]
    assert ranks["mp2"][-1]["odd_share_one"]["centroids"] == [130]


def test_an_odd_share_matches_one_process(groups):
    """SA2's 33 centroids split 17 and 16 (the second share padded)."""
    ranks, _ = groups
    _hold_to_one_process(ranks["mp2"][0]["odd_share"], ranks["mp2"][-1]["odd_share_one"])


def test_a_point_count_mp_does_not_divide_raises(groups):
    ranks, _ = groups
    assert all("clouds of 639 points do not split over the mesh's mp=2" in r["odd_points"]
               for r in ranks["mp2"])


def test_fused_sa_under_mp_runs_replicated_and_matches_one_process(groups):
    ranks, _ = groups
    assert all(r["fused_sa"]["centroids"] == [130] for r in ranks["mp2"])
    _hold_to_one_process(ranks["mp2"][0]["fused_sa"], ranks["mp2"][-1]["fused_sa_one"])
