"""Point selection of the plain reference: frozen copies of the port's plain
selection functions, in plain PyTorch.

* ``fps_rows``: exact masked farthest-point sampling from given starts, with
  the distance in the form ``|p|^2 - 2 p.l + |l|^2`` and ties to the first
  index (``dl_biomass_tpu_torch/ops/fps_kernel.fps_rows_plain``);
* ``fps_sectored``: the production's sectored FPS: point i in sector i % S,
  S halved from 8 until the points and picks split evenly and a sector holds
  at least twice its picks (``ops/fps.fps_sectored``); the starts are a
  uniform random valid point of each sector row, drawn as the argmax of
  ``torch.rand`` over the valid points, or the first valid point;
* ``ball_group``: the stratified selection of kernel 2: slot j of 64 holds the
  smallest in-radius valid index whose residue mod 128 is j or j + 64
  (``ops/ball_group_kernel.ball_group_plain``);
* ``ball_query``: the exact first 64 in-radius indices, ascending
  (``ops/ball_query_kernel.ball_query_plain``).

The in-radius test is ``dx*dx + dy*dy + dz*dz <= r^2``, each operation
rounded on its own, with r^2 rounded to float32 once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

SECTORS = 8
BUCKETS = 128
SLOTS = 64
CHUNK = 128  # centroids a block of the distance tests


def radius2(radius: float) -> float:
    return float(torch.tensor(float(radius) ** 2, dtype=torch.float32))


def in_radius(centers, center_mask, pos, mask, r2: float) -> torch.Tensor:
    dx = pos[:, None, :, 0] - centers[:, :, None, 0]
    dy = pos[:, None, :, 1] - centers[:, :, None, 1]
    dz = pos[:, None, :, 2] - centers[:, :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    return (d2 <= r2) & mask[:, None, :] & center_mask[:, :, None]


def fps_rows(pos, mask, starts, k: int) -> torch.Tensor:
    """pos (R, N, 3), mask (R, N), starts (R,) -> (R, k) int64 picks."""
    rows, n, _ = pos.shape
    px, py, pz = pos.unbind(-1)
    sq = px * px + py * py + pz * pz
    neg = torch.tensor(-math.inf, device=pos.device)
    dist = torch.where(mask, torch.tensor(math.inf, device=pos.device), neg)
    lane = torch.arange(n, device=pos.device)
    prev = starts.long()
    out = torch.empty((rows, k), dtype=torch.long, device=pos.device)
    out[:, 0] = prev
    for s in range(1, k):
        last = pos.gather(1, prev[:, None, None].expand(-1, 1, 3))[:, 0]
        lx, ly, lz = last[:, 0:1], last[:, 1:2], last[:, 2:3]
        d = sq - 2.0 * (px * lx + py * ly + pz * lz) + (lx * lx + ly * ly + lz * lz)
        dist = torch.where(lane == prev[:, None], neg, torch.fmin(dist, d))
        prev = dist.argmax(dim=1)
        out[:, s] = prev
    return out


def _starts(mask, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        return mask.to(torch.uint8).argmax(dim=1)
    u = torch.rand(tuple(mask.shape), generator=generator, device=mask.device)
    return torch.where(mask, u, -1.0).argmax(dim=1)


def fps_sectored(pos, mask, k: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, k) int64 picks of the sectored FPS."""
    b, n, _ = pos.shape
    s = SECTORS
    while s > 1 and (n % s or k % s or (n // s) < 2 * (k // s)):
        s //= 2
    if s <= 1:
        return fps_rows(pos, mask, _starts(mask, generator), k)
    m, ks = n // s, k // s
    pos_s = pos.reshape(b, m, s, 3).transpose(1, 2).reshape(b * s, m, 3).contiguous()
    mask_s = mask.reshape(b, m, s).transpose(1, 2).reshape(b * s, m).contiguous()
    sub = fps_rows(pos_s, mask_s, _starts(mask_s, generator), ks)
    sec = torch.arange(s, device=pos.device).view(1, s, 1)
    return (sub.view(b, s, ks) * s + sec).reshape(b, k)


def centroids(pos, mask, m: int, generator: Optional[torch.Generator]):
    """(centroid positions (B, m, 3), their mask (B, m))."""
    idx = fps_sectored(pos, mask, m, generator)
    c = pos.gather(1, idx[..., None].expand(-1, -1, 3))
    return c, mask.gather(1, idx)


def ball_group(centers, center_mask, pos, mask, radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified selection: (idx (B, M, 64) int64, 0 where invalid; valid (B, M, 64))."""
    b, m, _ = centers.shape
    n = pos.shape[1]
    r2 = radius2(radius)
    n_pad = -(-n // BUCKETS) * BUCKETS
    order = torch.arange(n, device=pos.device)
    idx = torch.empty((b, m, SLOTS), dtype=torch.long, device=pos.device)
    valid = torch.empty((b, m, SLOTS), dtype=torch.bool, device=pos.device)
    for s in range(0, m, CHUNK):
        ok = in_radius(centers[:, s:s + CHUNK], center_mask[:, s:s + CHUNK], pos, mask, r2)
        mc = ok.shape[1]
        keys = F.pad(torch.where(ok, order, n), (0, n_pad - n), value=n)
        bmin = keys.view(b, mc, n_pad // BUCKETS, BUCKETS).amin(dim=2)
        pair = torch.minimum(bmin[..., :SLOTS], bmin[..., SLOTS:])
        valid[:, s:s + mc] = pair < n
        idx[:, s:s + mc] = torch.where(pair < n, pair, 0)
    return idx, valid


def ball_query(centers, center_mask, pos, mask, radius: float, k: int = SLOTS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact first-k: (idx (B, M, k) int64, 0 where invalid; valid (B, M, k))."""
    b, m, _ = centers.shape
    n = pos.shape[1]
    r2 = radius2(radius)
    kk = min(k, n)
    order = torch.arange(n, device=pos.device)
    idx = torch.zeros((b, m, k), dtype=torch.long, device=pos.device)
    valid = torch.zeros((b, m, k), dtype=torch.bool, device=pos.device)
    for s in range(0, m, CHUNK):
        ok = in_radius(centers[:, s:s + CHUNK], center_mask[:, s:s + CHUNK], pos, mask, r2)
        mc = ok.shape[1]
        first = torch.where(ok, order, n).topk(kk, dim=-1, largest=False, sorted=True).values
        valid[:, s:s + mc, :kk] = first < n
        idx[:, s:s + mc, :kk] = torch.where(first < n, first, 0)
    return idx, valid
