"""The rank body of ``tests/test_torch_segmentor.py``'s mesh test: a spawned
2-rank gloo group on the CPU takes one ``Trainer.step`` of the per-point
segmentor over a ``dp`` mesh, and each rank's share of ``per_point_mse``
with the whole batch's valid points as its denominator; each rank saves
what it saw to ``seg_rank<r>.pt``. Imports torch and the port only."""

import os

import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models.pointnet2 import model_from_dict
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.train.loss import per_point_mse
from dl_biomass_tpu_torch.train.trainer import Trainer


def run_checks(rank, world, device, tmp):
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "seg_inputs.pt"), weights_only=False)
    mesh = dp.make_mesh(world, 1, "cpu")
    batch = CloudBatch(**inputs["batch"])
    model = model_from_dict(inputs["model"])
    model.load_state_dict(inputs["state"])
    trainer = Trainer(model, TrainConfig(), device="cpu", mesh=mesh)
    loss = float(trainer.step(batch))
    grads = {n: p.grad.double().clone() for n, p in trainer.model.named_parameters()}
    # the loss alone: this rank's points over the whole batch's valid points
    local = dp.shard_batch(batch, mesh)
    out = inputs["out"][dp.dp_slice(batch.pos.shape[0], mesh)].clone().requires_grad_(True)
    share = per_point_mse(out, local.y, local.mask,
                          total_points=dp.sum_dp(local.mask.sum().float(), mesh))
    share.backward()
    torch.save(dict(loss=loss, grads=grads, share=float(share),
                    total=float(dp.sum_dp(share.detach(), mesh)), out_grad=out.grad),
               os.path.join(tmp, f"seg_rank{rank}.pt"))
