"""The reference algorithm in plain PyTorch, timed beside the port's own
training step at the same shape (port of the JAX package's
``tools/torch_cpu_anchor.py``, which times it on the host's CPU beside the
JAX package's CPU path).

The reference (cczls1991/DL_Biomass, ``pointnet2_regressor.py:5-58``) trains
PointNet++ SSG through PyG: fps(ratio) -> radius(r, max 64 neighbours,
first K by index) -> PointConv MLP([x_j, p_j - p_i]) + max -> global MLP +
max -> head, with torch BatchNorm and Adam. ``Net`` re-implements that
algorithm in plain tensor operations (no PyG: FPS a step at a time, the
radius search from ``torch.cdist``), each cloud's set abstraction on its
own as PyG's ragged batch runs it, the head's BatchNorm over the batch. No
reference code is copied.

On the card by default (16 clouds of 10240 points: the first measured
clouds/s of the reference algorithm on an H100, the figure ``bench.py``
estimates as 50); ``--device cpu`` (8 clouds of 1024 points) is the JAX
tool's same-host CPU anchor. The port's step (``Trainer.step`` of the
production model, its kernels on the card, their plain versions on the CPU)
runs on the same clouds. Both are timed a step at a time, each ended by a
synchronisation, best of ``steps`` after one warm-up; the line names the card
and its power limit.

    python -m dl_biomass_tpu_torch.tools.torch_cpu_anchor [B] [N] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn as nn

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import best_synced_s, card, flagship

SHAPES = {"cuda": (16, 10240), "cpu": (8, 1024)}
STEPS = 3


def fps(pos: torch.Tensor, m: int) -> torch.Tensor:
    """Farthest point sampling from index 0 (torch_cluster starts at a random
    point: the same work)."""
    sel = torch.zeros(m, dtype=torch.long, device=pos.device)
    d2 = ((pos - pos[0]) ** 2).sum(-1)
    for i in range(1, m):
        sel[i] = torch.argmax(d2)
        d2 = torch.minimum(d2, ((pos - pos[sel[i]]) ** 2).sum(-1))
    return sel


def radius_first_k(centers: torch.Tensor, pos: torch.Tensor, r: float, k: int):
    """(M, K) neighbour indices and mask: the first K in-radius points by
    index (torch_cluster ``radius(..., max_num_neighbors=k)``)."""
    ok = torch.cdist(centers, pos) ** 2 <= r * r
    csum = torch.cumsum(ok.to(torch.int32), dim=1)
    rows, cols = torch.nonzero(ok & (csum <= k), as_tuple=True)
    m = centers.shape[0]
    idx = torch.zeros(m, k, dtype=torch.long, device=pos.device)
    idx[rows, csum[rows, cols] - 1] = cols
    cnt = torch.zeros(m, dtype=torch.long, device=pos.device).scatter_add_(
        0, rows, torch.ones_like(rows))
    return idx, torch.arange(k, device=pos.device)[None, :] < cnt[:, None]


def mlp(channels, plain_last: bool = False) -> nn.Sequential:
    layers = []
    for i, (a, b) in enumerate(zip(channels[:-1], channels[1:])):
        layers.append(nn.Linear(a, b))
        if not (plain_last and i == len(channels) - 2):
            layers += [nn.BatchNorm1d(b), nn.ReLU()]
    return nn.Sequential(*layers)


class SA(nn.Module):
    def __init__(self, ratio: float, r: float, channels):
        super().__init__()
        self.ratio, self.r = ratio, r
        self.mlp = mlp(channels)

    def forward(self, x, pos):
        m = int(np.ceil(self.ratio * pos.shape[0]))
        centers = pos[fps(pos, m)]
        idx, mask = radius_first_k(centers, pos, self.r, 64)
        edge = torch.cat([x[idx], pos[idx] - centers[:, None, :]], dim=-1)  # (M, K, C+3)
        h = self.mlp(edge.reshape(-1, edge.shape[-1])).reshape(m, 64, -1)
        h = torch.where(mask[..., None], h, torch.full_like(h, -torch.inf))
        return h.max(dim=1).values, centers


class GlobalSA(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.mlp = mlp(channels)

    def forward(self, x, pos):
        return self.mlp(torch.cat([x, pos], dim=-1)).max(dim=0, keepdim=True).values


class Net(nn.Module):
    """The reference ``Net(num_features=1)``'s widths
    (``pointnet2_regressor.py:36-58``)."""

    def __init__(self, f: int = 1):
        super().__init__()
        self.sa1 = SA(0.2, 2.0, [3 + f, 64, 64, 128])
        self.sa2 = SA(0.25, 8.0, [128 + 3, 128, 128, 256])
        self.sa3 = GlobalSA([256 + 3, 256, 512, 1024])
        self.head = mlp([1024, 128, 128, 4], plain_last=True)

    def forward(self, clouds):
        g = []
        for x, p in clouds:
            h, p = self.sa1(x, p)
            h, p = self.sa2(h, p)
            g.append(self.sa3(h, p))
        return self.head(torch.cat(g))


def main(b=None, n=None, steps: int = STEPS, device=None) -> dict:
    """Time both at ``b`` x ``n`` (by default ``SHAPES`` for the device);
    prints the line and returns it as a dict."""
    dev = resolve_device(device)
    b0, n0 = SHAPES["cuda" if dev.type == "cuda" else "cpu"]
    b, n = b or b0, n or n0
    trainer, batch = flagship(b, n, dev)
    torch.manual_seed(0)
    net = Net().to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1.79966e-3)
    clouds = [(batch.feat[i], batch.pos[i]) for i in range(b)]

    def reference():
        opt.zero_grad()
        loss = ((net(clouds) - batch.y) ** 2).mean()
        loss.backward()
        opt.step()

    gen = torch.Generator(device=dev).manual_seed(1)
    ref_s = best_synced_s(reference, dev, 1, steps)
    port_s = best_synced_s(lambda: trainer.step(batch, gen), dev, 1, steps)
    row = dict(b=b, n=n, reference_ms=ref_s * 1e3, reference_clouds_per_sec=b / ref_s,
               port_ms=port_s * 1e3, port_clouds_per_sec=b / port_s,
               speedup=ref_s / port_s, card=card(dev))
    print(f"torch_cpu_anchor B={b} x {n}: the reference algorithm in plain PyTorch "
          f"{row['reference_ms']:.1f} ms a step, {row['reference_clouds_per_sec']:.2f} clouds/s; "
          f"the port's step {row['port_ms']:.1f} ms, {row['port_clouds_per_sec']:.2f} clouds/s "
          f"({row['speedup']:.1f}x); best of {steps} [{row['card']}]", flush=True)
    return row


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="torch_cpu_anchor")
    p.add_argument("b", nargs="?", type=int, default=None)
    p.add_argument("n", nargs="?", type=int, default=None)
    p.add_argument("steps", nargs="?", type=int, default=STEPS)
    p.add_argument("--device", default=None, help="cpu: the JAX tool's CPU anchor")
    a = p.parse_args()
    main(a.b, a.n, a.steps, a.device)
