"""The plain reference of the per-point PointNet++ segmentor (the reference
repository's historical per-point biomass regressor,
``Misc/Lukas_OG_Scripts/pn2_regressor.py:34-59``, after PyTorch Geometric's
``examples/pointnet2_segmentation.py``; Qi et al. 2017, section 3.4), in
float32 PyTorch with TF32 off. It imports nothing of the port.

The encoder is ``reference/model.py``'s, on its selection (``select_all``),
``mlp`` and ``masked_max``; the decoder is added here:

* SA1, SA2 and the global SA3 as in ``reference/model.py``.
* FP3: the global vector broadcast to SA2's centroids, interpolated onto
  them, concatenated with SA2's features, MLP [1280, 256, 256].
* FP2: FP3's output interpolated onto SA1's centroids, concatenated with
  SA1's features, MLP [384, 256, 128].
* FP1: FP2's output interpolated onto every point, concatenated with the
  point's features, MLP [129, 128, 128, 128].
* head: MLP [128, 128, 1], BatchNorm, ReLU and dropout 0.5 after its hidden
  layer, one output a point; 0 at invalid points.
* An interpolation (``knn_interpolate``): the k = 3 nearest valid sources of
  each target by squared distance (dense, then ``torch.topk``), weights
  1 / d^2 normalised to sum 1, the weighted sum of their features.
* The loss (``loss``): the squared error summed over the valid points, over
  the number of valid points (one output).

Departures from the published description, as the port computes it:

* FP3 interpolates the broadcast global vector at k = 3, where PyG takes
  k = 1 from the one global point: equal in exact arithmetic.
* BatchNorm normalises by the statistics of the valid points alone (PyG's
  batches hold no pads); a cloud with fewer than k valid sources weighs the
  missing neighbours 0.
* The head keeps its BatchNorm and its activation after the hidden layer
  (``MLP([128, 128, 1])`` as torch_geometric's MLP builds it).
* Weights and plots are random from the seed; the per-point target is made
  from the plot (the kind's ``targets``).

A training batch is ``reference/augment.py``'s, with the per-point targets
carried along (``assemble``): an appended copy takes its source slot's
target, found by drawing the augmentation's permutation again from the same
seed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from portbench.reference import augment as ref_aug
from portbench.reference import model as ref
from portbench.reference.model import Params, Round, _gather, masked_max, mlp

# (name, key of cfg["widths"]) of every MLP, in the port's order
MLPS = (("sa1.mlp", "sa1"), ("sa2.mlp", "sa2"), ("sa3.mlp", "sa3"), ("fp3.mlp", "fp3"),
        ("fp2.mlp", "fp2"), ("fp1.mlp", "fp1"), ("head", "head"))
# the interpolation's skip sources: (source layer, target layer) by FP layer
FP = (("fp3.mlp", 2, 2), ("fp2.mlp", 2, 1), ("fp1.mlp", 1, 0))


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor, as ``reference.model.param_spec``."""
    spec = []
    for name, key in MLPS:
        ch = cfg["widths"][key]
        for i in range(len(ch) - 1):
            spec.append((f"{name}.lin{i}.weight", (ch[i + 1], ch[i]), "weight", ch[i]))
            spec.append((f"{name}.lin{i}.bias", (ch[i + 1],), "bias", ch[i]))
        for i, c in enumerate(ch[1:-1]):
            for kind in ("weight", "bias", "running_mean", "running_var"):
                spec.append((f"{name}.bn{i}.{kind}", (c,), "bn_" + kind, c))
    return spec


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every tensor drawn from ``seed`` on ``device`` by ``reference.model``'s
    rule (two calls; He-normal weights, uniform biases, BatchNorm scales
    1 +- 0.1 and shifts +-0.1, running means N(0, 0.25), running variances
    uniform in [0.5, 2))."""
    spec = param_spec(cfg)
    total = sum(math.prod(s) for _, s, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    init = {"weight": lambda z, u, fan: z * math.sqrt(2.0 / fan),
            "bias": lambda z, u, fan: (2 * u - 1) / math.sqrt(fan),
            "bn_weight": lambda z, u, fan: 1.0 + 0.1 * z,
            "bn_bias": lambda z, u, fan: 0.1 * z,
            "bn_running_mean": lambda z, u, fan: 0.5 * z,
            "bn_running_var": lambda z, u, fan: 0.5 + 1.5 * u}
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        out[name] = init[kind](z, u, fan_in).clone()
    return out


def knn_interpolate(feat_src, pos_src, src_mask, pos_dst, dst_mask, k: int = 3):
    """(B, N, C): each valid target's k nearest valid sources, weighted by
    1 / d^2 normalised to 1; 0 at invalid targets. The squared distance sums
    dx^2, dy^2 and dz^2 in that order, so near ties fall as the port's do."""
    k = min(k, pos_src.shape[1])
    with torch.no_grad():
        d2 = sum((pos_dst[:, :, None, c] - pos_src[:, None, :, c]) ** 2 for c in range(3))
        d2 = torch.where(src_mask[:, None, :], d2, torch.inf)
        neg, idx = torch.topk(-d2, k, dim=-1)
        w = 1.0 / torch.clamp_min(-neg, 1e-16)
        w = torch.where(torch.isfinite(w), w, 0.0)
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-16)
    out = (_gather(feat_src, idx) * w[..., None]).sum(dim=2)
    return torch.where(dst_mask[..., None], out, torch.zeros((), device=out.device))


def forward(cfg: dict, p: Params, pos, feat, mask, sel: ref.Selection, train: bool,
            keep: Optional[List[torch.Tensor]] = None, lowp: Optional[Round] = None,
            checkpoint: bool = False, k: int = 3):
    """(B, N, 1) float32 per-point predictions over the selection ``sel``
    (``reference.model.select_all``); ``keep`` the head's dropout masks;
    ``k`` the neighbours an interpolation takes (the fault ``nearest_only``:
    1)."""
    w = cfg["widths"]
    h, src = feat, pos
    levels = [(feat, pos, mask)]
    for li, (c, cm, ((idx, valid),)) in enumerate(sel.layers):
        name = f"sa{li + 1}.mlp"

        def sa(h, src, c, idx, valid, name=name, n_lin=len(w[f"sa{li + 1}"]) - 1):
            e = torch.cat([_gather(h, idx), _gather(src, idx) - c[:, :, None, :]], -1)
            e = torch.where(valid[..., None], e, torch.zeros((), device=e.device))
            return masked_max(mlp(e, valid, p, name, n_lin, train, lowp), valid, dim=2)

        h = (torch.utils.checkpoint.checkpoint(sa, h, src, c, idx, valid, use_reentrant=False)
             if checkpoint and train else sa(h, src, c, idx, valid))
        src = c
        levels.append((h, c, cm))
    h2, c2, cm2 = levels[2]
    g = masked_max(mlp(torch.cat([h2, c2], -1), cm2, p, "sa3.mlp", len(w["sa3"]) - 1, train,
                       lowp), cm2, dim=1)
    d = g[:, None, :].expand(*h2.shape[:2], g.shape[-1])
    for name, s, t in FP:
        skip, pos_t, mask_t = levels[t]
        x = knn_interpolate(d, levels[s][1], levels[s][2], pos_t, mask_t, k)
        d = mlp(torch.cat([x, skip], -1), mask_t, p, name, len(w[name[:3]]) - 1, train, lowp)
    out = mlp(d, mask, p, "head", len(w["head"]) - 1, train, lowp, keep,
              cfg["hp"]["dropout_probability"])
    return torch.where(mask[..., None], out, torch.zeros((), device=out.device))


def dropout_keeps(cfg: dict, b: int, n: int, generator: torch.Generator, device
                  ) -> List[torch.Tensor]:
    """The head's keep masks (B, N, width), drawn after the FPS starts."""
    pd = cfg["hp"]["dropout_probability"]
    return [torch.rand((b, n, w), generator=generator, device=device) < 1.0 - pd
            for w in cfg["widths"]["head"][1:-1]]


def loss(pred, y, mask, total=None) -> torch.Tensor:
    """The squared error over the valid points and outputs, over the outputs
    times the valid points (``total`` points where given)."""
    n = mask.sum() if total is None else total
    se = torch.where(mask[..., None], torch.square(pred - y), torch.zeros((), device=y.device))
    return se.sum() / (n.float().clamp_min(1.0) * pred.shape[-1])


def append_sources(seed: int, b0: int, mask, f: int, base_n: int):
    """The source slot (B, C - base_n) of each append slot of the batch at
    offset ``b0`` of the epoch of ``seed``: ``reference.augment.augment``'s
    draws made again, in its order, up to its permutation scores, and the
    permutation's first slots. ``mask`` the batch's before augmentation."""
    b, c = mask.shape
    dev = mask.device
    g = torch.Generator(device=dev).manual_seed(ref_aug.derive_seed(seed, ref_aug.AUG, b0))
    for shape in ((b,), (b,), (b,), (b,), (b, c, 3), (b, c, f), (b,)):
        draw = torch.randn if len(shape) == 3 else torch.rand
        draw(shape, generator=g, device=dev)
    scores = torch.rand((b, c), generator=g, device=dev)
    return ref_aug._ranks(mask, scores)[1][..., :c - base_n]


def assemble(pos, feat, mask, y, idx, aug, valid, seed: int, b0: int, base_n: int
             ) -> ref_aug.Batch:
    """``reference.augment.assemble`` with per-point targets y (P, C, k): an
    augmented sample's append slots take their source slots' targets."""
    bt = ref_aug.assemble(pos, feat, mask, y, idx, aug, valid, seed, b0, base_n)
    if not aug.any():
        return bt
    dev = pos.device
    idx_t = torch.as_tensor(idx, device=dev)
    before = mask[idx_t] & torch.as_tensor(valid, device=dev)[:, None]
    src = append_sources(seed, b0, before, feat.shape[-1], base_n)
    by = y[idx_t]
    rows = torch.gather(by, 1, src[..., None].expand(*src.shape, by.shape[-1]))
    aug_y = by.clone()
    aug_y[:, base_n:] = torch.where(bt.mask[:, base_n:, None], rows, 0.0)
    flag = torch.as_tensor(aug, device=dev)[:, None, None]
    return bt._replace(y=torch.where(flag, aug_y, by))
