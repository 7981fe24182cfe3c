"""The rank body of ``tests/test_torch_mesh_mp.py``: spawned gloo groups on
the CPU whose mesh shards each cloud's points over ``mp`` run the port's
point-parallel paths and save what they saw to ``<tag>_rank<r>.pt``; the test
process holds those results against the JAX package and against one process.
Imports torch and the port only (a spawned rank imports this module, never
jax)."""

import os
from unittest import mock

import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.ops import ball_group_kernel
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.train.trainer import Trainer


def _model(kwargs, state):
    model = PointNet2Regressor(**kwargs)
    model.load_state_dict(state)
    return model


def _batch(arrays):
    pos, feat, mask, y = (torch.from_numpy(a) for a in arrays)
    return CloudBatch(pos=pos, feat=feat, mask=mask, y=y)


def _eval(kwargs, state, batch, mesh):
    """``Trainer.predict`` on one batch: (clouds, 4) numpy."""
    return Trainer(_model(kwargs, state), TrainConfig(), device="cpu", mesh=mesh).predict([batch])


def _step(kwargs, state, batch, mesh):
    """One ``Trainer.step`` without a generator (FPS from the first valid
    point, dropout 0): the loss, every gradient, the new state, and the
    centroid count of each of kernel 2's calls."""
    trainer = Trainer(_model(kwargs, state), TrainConfig(), device="cpu", mesh=mesh)
    real, centroids = ball_group_kernel.ball_group, []

    def group(centers, *args, **kwargs):
        centroids.append(centers.shape[1])
        return real(centers, *args, **kwargs)

    with mock.patch.object(ball_group_kernel, "ball_group", group):
        loss = float(trainer.step(batch))
    grads = {n: p.grad.double().numpy().copy() for n, p in trainer.model.named_parameters()}
    new = {k: v.double().numpy().copy() for k, v in trainer.model.state_dict().items()}
    return dict(loss=loss, grads=grads, state=new, centroids=centroids)


def _odd_points(kwargs, state, arrays, mesh):
    """A batch whose point count the mp size does not divide."""
    odd = _batch(tuple(a[:, :-1] if a.ndim > 1 and i < 3 else a for i, a in enumerate(arrays)))
    try:
        Trainer(_model(kwargs, state), TrainConfig(), device="cpu", mesh=mesh).step(odd)
        return "stepped"
    except ValueError as e:
        return str(e)


def run_checks(rank, world, device, tmp, tag, dp_size, mp_size):
    """Every check over a (dp_size, mp_size) mesh, then the one-process runs
    they are held against on the last rank (they need no collective)."""
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = dp.make_mesh(dp_size, mp_size, "cpu")
    res = dict(coordinate=tuple(mesh.get_coordinate()))
    models = inputs["models"]
    if tag == "mp2":
        res["eval"] = _eval(*models["default"], _batch(inputs["eval_batch"]), mesh)
        res["step"] = _step(*models["f32"], _batch(inputs["step_batch"]), mesh)
        res["odd_share"] = _step(*models["f32"], _batch(inputs["odd_share_batch"]), mesh)
        res["fused_sa"] = _step(*models["fused_sa"], _batch(inputs["odd_share_batch"]), mesh)
        res["odd_points"] = _odd_points(*models["f32"], inputs["step_batch"], mesh)
        if rank == world - 1:
            res["eval_one"] = _eval(*models["default"], _batch(inputs["eval_batch"]), None)
            res["odd_share_one"] = _step(*models["f32"], _batch(inputs["odd_share_batch"]), None)
            res["fused_sa_one"] = _step(*models["fused_sa"], _batch(inputs["odd_share_batch"]),
                                        None)
    else:
        res["step"] = _step(*models["f32"], _batch(inputs["step_batch"]), mesh)
    if rank == world - 1:
        res["step_one"] = _step(*models["f32"], _batch(inputs["step_batch"]), None)
    torch.save(res, os.path.join(tmp, f"{tag}_rank{rank}.pt"))
