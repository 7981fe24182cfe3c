"""Serving engine (port of ``dl_biomass_tpu/models/inference.py``).

``compile_inference`` folds each eval-mode BatchNorm into the Linear before
it and returns ``serve(batch) -> (B, num_outputs)``: a flat chain of the kernels (FPS,
stratified ball grouping or the fused SA1 layer, exact ball query, row
gather) and folded matmuls, with bf16 activations in production. It follows
``compile_inference`` of the JAX package branch for branch: the stratified SA1
branch, as one fused kernel under ``fused_eval`` (kernel 5), and the exact SA1
branch (``inference.py:198-226``); while SA1 keeps at most ``MXU_MAX_POINTS``
centroids, the split SA2 path with the gathered z-table (``:232-269``) or,
with ``split_first_layer=False``, the features and positions gathered by one
index (kernel 4c); and the unsplit per-edge gather beyond (``:270-279``).
``compile_dataset_inference`` serves a whole ``DeviceDataset`` through the
same engine, its batches gathered on the device, with one host sync. The
engine is a flat function of the folded weights and the batch
(``serving_function``, ``serving_weights``), the function
``models/export.py`` hands to ``torch.export``. Under a mesh each rank
serves its ``dp`` slice and every rank gets every answer.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch, resolve_device
from dl_biomass_tpu_torch.models.layers import MLP, dot_f32
from dl_biomass_tpu_torch.models.pointnet2 import (MXU_MAX_POINTS, PointNet2Regressor,
                                                   count_edges, sample_centroids)
from dl_biomass_tpu_torch.ops import ball_group_kernel, gather_kernel, sa_eval_kernel
from dl_biomass_tpu_torch.ops.ballquery import ball_query
from dl_biomass_tpu_torch.ops.grouping import edges_from_gathered, group_neighborhoods
from dl_biomass_tpu_torch.ops.pooling import masked_max
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.utils import profiling

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def fold_bn(kernel, bias, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold an eval-mode BatchNorm into the preceding Linear; ``kernel`` is (in, out)."""
    inv = bn_scale / torch.sqrt(bn_var + eps)
    return kernel * inv[None, :], (bias - bn_mean) * inv + bn_bias


def _folded_mlp(mlp: MLP) -> Layers:
    """[(W' (in, out), b'), ...] in float32, hidden-layer BN folded, final layer plain."""
    lins, bns = mlp.linears(), mlp.norms()
    out = []
    for i, lin in enumerate(lins):
        w, b = lin.weight.detach().t().float(), lin.bias.detach().float()
        if i < len(bns):
            bn = bns[i]
            w, b = fold_bn(w, b, bn.weight.detach(), bn.bias.detach(), bn.running_mean,
                           bn.running_var, eps=bn.eps)
        out.append((w, b))
    return out


def _run_folded(x: torch.Tensor, layers, act: bool = True,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each layer: compute-dtype matmul with float32 output, + float32 bias,
    ReLU on hidden layers when ``act``, then rounding to ``compute_dtype``.
    ``layers`` hold weights already in ``compute_dtype``."""
    for i, (w, b) in enumerate(layers):
        y = dot_f32(x.to(compute_dtype), w)
        y += b
        if act and i < len(layers) - 1:
            y.relu_()
        x = y.to(compute_dtype)
    return x


def _check_engine(model, fused_eval: bool) -> bool:
    """Raise where the engine does not cover ``model``; returns whether SA1
    takes the stratified branch."""
    if not isinstance(model, PointNet2Regressor):
        raise NotImplementedError(
            f"inference engine covers PointNet2Regressor; got {type(model).__name__} "
            "(the voxel and per-point families predict through the module, Trainer.predict)")
    if model.activation_function != "ReLU" or model.msg or model.max_neighbors != 64:
        # analytic_bn, remat and the v2 widths fold as the standard model does
        raise NotImplementedError("inference engine covers the flagship SSG/ReLU/K=64 config; "
                                  "serve other variants through the module")
    stratified = (model.fast_group and (model.num_features or 3) <= 4
                  and not model.exact_selection)
    if fused_eval and not stratified:
        raise NotImplementedError(
            "fused_eval requires the stratified SA1 production path (fast_group, <= 4 "
            "features, not exact_selection)")
    return stratified


def serving_weights(model: PointNet2Regressor, device=None, *,
                    fused_eval: bool = False) -> List[torch.Tensor]:
    """The folded weights as one flat list, the order of the JAX package's
    ``tree_flatten`` of ``serve._folded``: SA1's, SA2's, SA3's and the head's
    layers, each layer's (W (in, out) in the compute dtype, b float32); under
    ``fused_eval`` kernel 5's packed weight block last. Made once, on
    ``device`` (None: the card)."""
    _check_engine(model, fused_eval)
    dev = resolve_device(device)
    ct = model.compute_dtype
    flat = []
    with torch.no_grad():
        for mlp in (model.sa1.mlp, model.sa2.mlp, model.sa3.mlp, model.head):
            for w, b in _folded_mlp(mlp):
                flat += [w.to(dev, ct), b.to(dev)]
        if fused_eval:  # kernel 5's weight block, packed once per engine
            sa1 = flat[:2 * len(model.sa1.mlp.linears())]
            sa_eval_kernel.check_widths(sa1, ct == torch.bfloat16)
            flat.append(sa_eval_kernel.pack_sa1_eval(sa1, ct == torch.bfloat16, dev))
    return flat


def serving_function(model: PointNet2Regressor, *, fused_eval: bool = False) -> Callable:
    """The flat serving function ``infer(*weights, pos, feat, mask) -> (B, num_outputs)``
    float32 of ``serving_weights`` (the JAX package's ``serve._infer`` over
    ``serve._folded``): no module, no state, no read of a tensor's value on
    the host, so that ``torch.export`` traces it (under ``torch.no_grad``)."""
    stratified = _check_engine(model, fused_eval)
    ct = model.compute_dtype
    sizes = [len(m.linears()) for m in (model.sa1.mlp, model.sa2.mlp, model.sa3.mlp,
                                         model.head)]
    n_weights = 2 * sum(sizes) + int(fused_eval)
    r1, r2 = model.sa1_radius, model.sa2_radius
    sectored = model.fast_fps and not model.exact_selection
    sa1_ratio, sa2_ratio = model.sa1_ratio, model.sa2_ratio
    split = model.split_first_layer

    def infer(*args) -> torch.Tensor:
        if len(args) != n_weights + 3:
            raise ValueError(f"infer takes {n_weights} weights and pos, feat, mask; got "
                             f"{len(args)} arguments")
        weights, (pos, feat, mask) = args[:n_weights], args[n_weights:]
        layers, i = [], 0
        for k in sizes:
            layers.append([(weights[i + 2 * j], weights[i + 2 * j + 1]) for j in range(k)])
            i += 2 * k
        sa1, sa2, sa3, head = layers
        if feat.shape[-1] == 0:
            feat = pos
        n = pos.shape[1]
        m1 = math.ceil(sa1_ratio * n)
        m2 = math.ceil(sa2_ratio * m1)

        with profiling.span("engine.sa1", device=pos):
            _, c1, cm1 = sample_centroids(pos, mask, m1, sectored=sectored)
            if stratified and fused_eval:  # kernel 5 keeps its neighbourhoods: not counted
                h1 = sa_eval_kernel.sa1_fused_eval(c1, cm1, pos, mask, feat,
                                                   [w for wb in sa1 for w in wb], radius=r1,
                                                   bf16=(ct == torch.bfloat16), out_dtype=ct,
                                                   packed=weights[-1])
            else:
                if stratified:
                    _, nm1, e1 = ball_group_kernel.ball_group(c1, cm1, pos, mask, feat,
                                                              radius=r1, out_dtype=ct,
                                                              need_idx=False)
                else:
                    nidx1, nm1 = ball_query(c1, cm1, pos, mask, radius=r1, k=64)
                    e1 = group_neighborhoods(pos, feat, c1, nidx1, nm1)
                count_edges(nm1)
                h1 = masked_max(_run_folded(e1, sa1, compute_dtype=ct), nm1, dim=2)

        with profiling.span("engine.sa2", device=pos):
            _, c2, cm2 = sample_centroids(c1, cm1, m2, sectored=sectored)
            nidx, nm = ball_query(c2, cm2, c1, cm1, radius=r2, k=64)
            count_edges(nm)
            if m1 <= MXU_MAX_POINTS and split:
                # per-point first layer: folded layer 0 is linear in [h1_j, c1_j - c2_i],
                # so it runs once per point and kernel 4 gathers the z-table. Pad
                # slots carry index 0, so their gathered rows are point 0's finite
                # row, and masked_max leaves them out through nm.
                w0, b0 = sa2[0]
                fdim = h1.shape[-1]
                zpt = (dot_f32(h1.to(ct), w0[:fdim]) + dot_f32(c1.to(ct), w0[fdim:])
                       + b0).to(ct)
                gz = gather_kernel.gather_rows(zpt, nidx)
                cshift = dot_f32(c2.to(ct), w0[fdim:])
                z0 = (gz - cshift[:, :, None, :].to(gz.dtype)).clamp_min_(0)  # layer 0 is hidden
                h2 = masked_max(_run_folded(z0, sa2[1:], compute_dtype=ct), nm, dim=2)
            else:
                if m1 <= MXU_MAX_POINTS:  # h1 and c1 gathered by one index, kernel 4c
                    gfeat, gpos = gather_kernel.gather_rows(h1, nidx, aux=c1)
                    e2 = edges_from_gathered(gfeat, gpos, c2, nm)
                else:  # [h1_j, c1_j - c2_i], 0 on pads
                    e2 = group_neighborhoods(c1, h1, c2, nidx, nm)
                h2 = masked_max(_run_folded(e2, sa2, compute_dtype=ct), nm, dim=2)

        with profiling.span("engine.tail", device=pos):
            g = torch.cat([h2, c2], dim=-1)
            h3 = masked_max(_run_folded(g, sa3, compute_dtype=ct), cm2, dim=1)
            return _run_folded(h3, head, act=False, compute_dtype=ct).float()

    infer.n_weights = n_weights
    return infer


def compile_inference(model: PointNet2Regressor, device=None, *, fused_eval: bool = False,
                      mesh=None) -> Callable[[CloudBatch], torch.Tensor]:
    """Returns ``serve(batch) -> (B, num_outputs)`` float32 on ``device``.

    ``device=None`` means the card, and raises without one; ``device="cpu"``
    runs the plain PyTorch versions of the kernels. The folded weights are
    made once, here, on ``device``, and so is kernel 5's weight block under
    ``fused_eval``: ``serve.weights`` (``serving_weights``), run by
    ``serve.infer`` (``serving_function``).

    ``fused_eval=True`` runs SA1 as one kernel (selection, capture, folded MLP
    and max: ``ops/sa_eval_kernel.py``); it needs the stratified SA1 path, as
    in the JAX package, and SA1 widths the kernel takes
    (``sa_eval_kernel.check_widths``, which takes those of every
    ``neuron_multiplier`` 1-32 in bf16 and float32); others raise
    ``NotImplementedError`` here, when the engine is built.

    ``mesh`` (``parallel.make_mesh``; every rank of it builds the engine and
    is handed the same requests): each rank serves its ``dp`` slice of a
    request, and the answers are gathered to every rank in batch order (the
    JAX package's ``shard_batch`` with replicated weights); a request must
    be a multiple of the ``dp`` size."""
    infer = serving_function(model, fused_eval=fused_eval)
    dev = resolve_device(device)
    weights = serving_weights(model, dev, fused_eval=fused_eval)

    @torch.inference_mode()
    def serve(batch: CloudBatch) -> torch.Tensor:
        batch = dp.shard_batch(batch.to(dev), mesh)
        return dp.gather_dp(infer(*weights, batch.pos, batch.feat, batch.mask), mesh)

    serve.infer, serve.weights = infer, weights
    return serve


def compile_dataset_inference(model: PointNet2Regressor, device=None, *, fused_eval: bool = False,
                              mesh=None) -> Callable:
    """Serving over a whole ``DeviceDataset`` (``io/device_data.py``).

    Returns ``serve_dataset(ds, batch_size) -> (P, 4)`` float32 numpy: every
    batch of ``ds`` in order, gathered on the device and run through the
    engine ``compile_inference(model, device, fused_eval=fused_eval)`` builds,
    the pad samples of the partial last batch dropped, rows in the order of
    ``ds.plot_ids``; every batch is queued before the one host sync. Under
    ``mesh`` each rank serves its ``dp`` slice of every batch and every rank
    gets every row (``batch_size`` a multiple of the ``dp`` size)."""
    serve = compile_inference(model, device, fused_eval=fused_eval, mesh=mesh)

    def serve_dataset(ds, batch_size: int) -> np.ndarray:
        idxs, augs, valids, _ = ds.epoch_spec_arrays(batch_size)
        outs = []
        for idx, aug, valid in zip(idxs, augs, valids):
            batch = ds.assemble(idx, aug, valid, 0, False)
            with profiling.span("serve.batch"):
                outs.append(serve(batch))
        with profiling.span("serve.readback"):
            rows = torch.cat(outs).cpu().numpy()
        return rows[valids.reshape(-1)]

    return serve_dataset
