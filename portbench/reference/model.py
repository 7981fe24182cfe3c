"""The plain reference of the biomass PointNet++ (the reference repository's
``Net``, ``pointnet2_regressor.py:36-58``; multi-scale grouping after Qi et
al. 2017, section 3.3), in float32 PyTorch with TF32 off.

A network is a dict of float32 tensors named as the port's ``state_dict``
names them (``sa1.mlp.lin0.weight``, ``head.bn1.running_var``, ...), so the
same weights load into both. Each MLP is torch_geometric's: hidden
Linear -> BatchNorm -> ReLU (-> dropout in the head), then a plain Linear.
BatchNorm normalises by the batch statistics of the valid slots in training
(biased variance, eps 1e-5) and by the running statistics in evaluation.

* SA1: sectored FPS picks ceil(0.2 N) centroids; each radius (2, and 4 under
  multi-scale grouping) groups 64 neighbours by the stratified rule; the
  edges ``[feat_j, pos_j - c_i]`` run through the scale's MLP and a max over
  the valid slots; the scales are concatenated.
* SA2: the same over SA1's centroids at ratio 0.25, radii 8 (and 16), with
  the exact first 64 neighbours; the edges are ``[h1_j, c1_j - c2_i]``.
* SA3: the MLP over ``[h2, c2]`` and a max over the valid centroids.
* head: MLP to 4 outputs with no activation (the reference's ``act=None``),
  dropout 0.5 after each hidden BatchNorm in training.

``lowp`` rounds every matrix product's two inputs (the control): the
reference computed in a lower precision than float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.reference import select

Params = Dict[str, torch.Tensor]
COMPONENT_WEIGHTS = (1 / 11, 1 / 12, 1 / 5, 1 / 72)
BN_EPS = 1e-5


def mlps(cfg: dict) -> List[Tuple[str, List[int]]]:
    """(name, channels) of every MLP of the configuration, in the port's order."""
    w = cfg["widths"]
    scales = 2 if cfg["model"]["msg"] else 1
    out = []
    for layer in ("sa1", "sa2"):
        out += [(f"{layer}.mlp" + (str(i) if i else ""), w[layer]) for i in range(scales)]
    return out + [("sa3.mlp", w["sa3"]), ("head", w["head"])]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor, parameters and running statistics."""
    spec = []
    for name, ch in mlps(cfg):
        for i in range(len(ch) - 1):
            spec.append((f"{name}.lin{i}.weight", (ch[i + 1], ch[i]), "weight", ch[i]))
            spec.append((f"{name}.lin{i}.bias", (ch[i + 1],), "bias", ch[i]))
        for i, c in enumerate(ch[1:-1]):
            for kind in ("weight", "bias", "running_mean", "running_var"):
                spec.append((f"{name}.bn{i}.{kind}", (c,), "bn_" + kind, c))
    return spec


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every tensor drawn from ``seed`` on ``device``, in two calls: weights
    He-normal (std sqrt(2 / fan_in)), biases uniform in +-1/sqrt(fan_in),
    BatchNorm scales 1 +- 0.1 and shifts +-0.1, running means N(0, 0.25),
    running variances uniform in [0.5, 2)."""
    spec = param_spec(cfg)
    total = sum(math.prod(s) for _, s, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "weight":
            t = z * math.sqrt(2.0 / fan_in)
        elif kind == "bias":
            t = (2 * u - 1) / math.sqrt(fan_in)
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * z
        elif kind == "bn_bias":
            t = 0.1 * z
        elif kind == "bn_running_mean":
            t = 0.5 * z
        else:
            t = 0.5 + 1.5 * u
        out[name] = t.clone()
    return out


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


Round = Callable[[torch.Tensor], torch.Tensor]


def _masked_bn(x, mask, p: Params, pre: str, train: bool):
    if not train:
        mean, var = p[pre + ".running_mean"], p[pre + ".running_var"]
    else:
        m = (torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device) if mask is None
             else mask).unsqueeze(-1).float()
        cnt = m.sum().clamp_min(1.0)
        mean = (x * m).sum(dim=tuple(range(x.dim() - 1))) / cnt
        var = (((x - mean) * m) ** 2).sum(dim=tuple(range(x.dim() - 1))) / cnt
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p[pre + ".weight"] + p[pre + ".bias"]


def mlp(x, mask, p: Params, name: str, n_lin: int, train: bool, lowp: Optional[Round],
        keep: Optional[List[torch.Tensor]] = None, p_drop: float = 0.0, act: bool = True):
    """The MLP ``name`` over x (..., Cin), ReLU after each hidden BatchNorm
    where ``act``; ``keep`` the head's dropout masks."""
    rnd = lowp or (lambda t: t)
    for i in range(n_lin):
        w, b = p[f"{name}.lin{i}.weight"], p[f"{name}.lin{i}.bias"]
        x = rnd(x) @ rnd(w).t() + b
        if i < n_lin - 1:
            x = _masked_bn(x, mask, p, f"{name}.bn{i}", train)
            x = torch.relu(x) if act else x
            if train and p_drop > 0.0:
                x = torch.where(keep[i], x / (1.0 - p_drop), torch.zeros((), device=x.device))
    return x


def masked_max(x, mask, dim: int):
    filled = x.masked_fill(~mask.unsqueeze(-1), float("-inf"))
    out = filled.max(dim=dim).values
    return torch.where(mask.any(dim=dim).unsqueeze(-1), out, torch.zeros((), device=x.device))


def _gather(x, idx):
    b, _, c = x.shape
    return x.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c)).reshape(*idx.shape, c)


class Selection:
    """The neighbours of one forward: per SA layer its centroids and per scale
    (idx, valid); drawn once, so that a control or a fault reuses them."""

    def __init__(self):
        self.layers = []


def radii(cfg: dict, layer: str) -> Tuple[float, ...]:
    """The radii an SA layer groups at: its radius (doubled under
    ``doubled_radius``), and twice that too under multi-scale grouping."""
    m = cfg["model"]
    r = m[f"{layer}_radius"] * (2 if m["doubled_radius"] else 1)
    return (r, 2 * r) if m["msg"] else (r,)


def select_all(cfg: dict, pos, mask, generator: Optional[torch.Generator]) -> Selection:
    """Every selection of a forward, drawing the FPS starts from ``generator``
    in the port's order (SA1, then SA2)."""
    m = cfg["model"]
    sel = Selection()
    p, pm = pos, mask
    for layer, find in (("sa1", select.ball_group), ("sa2", select.ball_query)):
        k = math.ceil(m[f"{layer}_ratio"] * p.shape[1])
        c, cm = select.centroids(p, pm, k, generator)
        nb = [find(c, cm, p, pm, r) for r in radii(cfg, layer)]
        sel.layers.append((c, cm, nb))
        p, pm = c, cm
    return sel


def forward(cfg: dict, p: Params, pos, feat, mask, sel: Selection, train: bool,
            keep: Optional[List[torch.Tensor]] = None, lowp: Optional[Round] = None,
            checkpoint: bool = False):
    """(B, 4) float32 predictions over the selection ``sel`` of these clouds."""
    widths = dict(mlps(cfg))
    h, src = feat, pos
    for li, (c, cm, nbs) in enumerate(sel.layers):
        outs = []
        for si, (idx, valid) in enumerate(nbs):
            name = f"sa{li + 1}.mlp" + (str(si) if si else "")
            n_lin = len(widths[name]) - 1

            def scale(h, src, c, idx, valid, name=name, n_lin=n_lin):
                e = torch.cat([_gather(h, idx), _gather(src, idx) - c[:, :, None, :]], -1)
                e = torch.where(valid[..., None], e, torch.zeros((), device=e.device))
                return masked_max(mlp(e, valid, p, name, n_lin, train, lowp), valid, dim=2)

            if checkpoint and train:
                outs.append(torch.utils.checkpoint.checkpoint(
                    scale, h, src, c, idx, valid, use_reentrant=False))
            else:
                outs.append(scale(h, src, c, idx, valid))
        h, src = torch.cat(outs, -1), c
    c2, cm2 = sel.layers[-1][0], sel.layers[-1][1]
    g = mlp(torch.cat([h, c2], -1), cm2, p, "sa3.mlp", len(widths["sa3.mlp"]) - 1, train, lowp)
    g = masked_max(g, cm2, dim=1)
    return mlp(g, None, p, "head", len(widths["head"]) - 1, train, lowp, keep,
               cfg["hp"]["dropout_probability"], act=False)


def dropout_keeps(cfg: dict, b: int, generator: torch.Generator, device) -> List[torch.Tensor]:
    """The head's keep masks, drawn after the FPS starts, one per hidden layer."""
    pd = cfg["hp"]["dropout_probability"]
    return [torch.rand((b, w), generator=generator, device=device) < 1.0 - pd
            for w in cfg["widths"]["head"][1:-1]]


def loss(pred, y, valid, total=None) -> torch.Tensor:
    """The weighted component MSE over the valid clouds (divided by ``total``
    clouds where given)."""
    w = valid.float()[:, None]
    n = w.sum() if total is None else total.float()
    per = (torch.square(pred - y) * w).sum(0) / n.clamp_min(1.0)
    return (per * torch.tensor(COMPONENT_WEIGHTS, device=pred.device)).sum()


class Adam:
    """torch's Adam with L2 weight decay added to the gradient (the reference's
    optimizer): beta (0.9, 0.999), eps 1e-8, bias-corrected."""

    def __init__(self, params: Params, lr: float, weight_decay: float):
        self.p, self.lr, self.wd = params, lr, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Params) -> Params:
        """Applies one step; returns the gradients as the optimizer took them."""
        self.t += 1
        b1, b2 = 0.9, 0.999
        taken = {}
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + 1e-8
            p.sub_(self.lr * (self.m[k] / (1 - b1 ** self.t)) / denom)
        return taken


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448) and back, its cotangent likewise: a product input, and
    the gradient that flows back through it, computed in fp8."""
    return _RoundFP8.apply(t)


def strict_float32():
    """Matrix products in full float32 (no TF32) from here on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
