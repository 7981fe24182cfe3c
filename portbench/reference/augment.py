"""The reference's epoch layout and augmentation: what a training epoch over an
on-device corpus feeds each step, worked out again in plain PyTorch.

The rules are the ones the port documents for its ``DeviceDataset``
(``dl_biomass_tpu_torch/io/device_data.py``) and its augmentation
(``transforms/augment.py``), themselves the reference's
(``augmentation.py:54-122``, ``main.py:96-106``):

* an epoch of seed ``s`` lists the P plots and ``num_augs`` augmented copies
  of each, shuffled by ``torch.randperm`` on a CPU generator seeded with
  ``derive_seed(s, ORDER)``, cut into batches, the last padded with invalid
  samples;
* the batch at offset b0 draws its augmentation from a generator on the
  card seeded with ``derive_seed(s, AUG, b0)``: point removal, then noisy
  copies of up to 10% of the kept points appended in the pad slots, then a
  z-rotation; the samples that are not augmented copies keep the plot as it
  is.
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch

AUG = 0x617567
ORDER = 0x6F7264


def derive_seed(*parts: int) -> int:
    digest = hashlib.sha256(b",".join(str(int(p)).encode() for p in parts)).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def capacity(n: int) -> int:
    """Slots a plot of n points takes when it will be augmented (10% headroom, 128s)."""
    need = n + -(-n // 10)
    return -(-need // 128) * 128


class Batch(NamedTuple):
    pos: torch.Tensor  # (B, C, 3)
    feat: torch.Tensor  # (B, C, F)
    mask: torch.Tensor  # (B, C)
    y: torch.Tensor  # (B, 4)


def epoch_specs(n_plots: int, seed: int, num_augs: int, batch: int):
    """(idx (S, B), augmented (S, B), valid (S, B)) numpy, the epoch's batches."""
    idx = np.tile(np.arange(n_plots), 1 + num_augs)
    aug = np.repeat(np.arange(1 + num_augs) > 0, n_plots)
    perm = torch.randperm(len(idx), generator=torch.Generator().manual_seed(
        derive_seed(seed, ORDER))).numpy()
    idx, aug = idx[perm], aug[perm]
    steps = -(-len(idx) // batch)
    out = [np.zeros((steps, batch), t) for t in (np.int64, bool, bool)]
    for s in range(steps):
        chunk = slice(s * batch, (s + 1) * batch)
        n = len(idx[chunk])
        out[0][s, :n], out[1][s, :n], out[2][s, :n] = idx[chunk], aug[chunk], True
    return tuple(out)


def _ranks(mask, scores):
    keyed = torch.where(mask, scores, torch.full_like(scores, math.inf))
    order = torch.argsort(keyed, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    return ranks, order


def _randint(u, lo, hi):
    return lo + torch.floor(u * (hi - lo + 1).float()).int()


def augment(generator: torch.Generator, pos, feat, mask, base_n: int):
    """Point removal, noise append and rotation of every cloud, drawn from
    ``generator`` in the port's order of draws."""
    b, c = mask.shape
    f = feat.shape[-1]
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u

    theta = uniform((b,), -math.pi, math.pi)
    keep_u = uniform((b,))
    sd = uniform((b,), 0.01, 0.025)
    sign = torch.where(uniform((b,)) >= 0.5, 1.0, -1.0)
    noise_pos = torch.randn((b, c, 3), generator=generator, device=dev)
    noise_feat = torch.randn((b, c, f), generator=generator, device=dev)
    extra_u = uniform((b,))
    scores = uniform((b, c))
    uniform((b,), 0.9, 1.1)  # the scale draw, unused by the reference chain

    ranks, order = _ranks(mask, scores)
    nv = mask.sum(-1, dtype=torch.int32)
    keep = _randint(keep_u, torch.round(0.9 * nv.float()).int(), nv)
    mask = mask & (ranks < keep[..., None])

    cap_extra = c - base_n
    step = (sign * sd)[..., None, None]
    hi = torch.round(0.1 * mask.sum(-1, dtype=torch.int32).float()).int()
    n_extra = torch.clamp(_randint(extra_u, torch.zeros_like(hi), hi), max=cap_extra)
    src = order[..., :cap_extra]
    app = torch.arange(cap_extra, device=dev) < n_extra[..., None]

    def append(base, noisy):
        rows = torch.gather(noisy, -2, src[..., None].expand(*src.shape, noisy.shape[-1]))
        out = base.clone()
        out[..., base_n:, :] = torch.where(app[..., None], rows, 0.0)
        return out

    new_pos = append(pos, pos + step * noise_pos)
    new_feat = append(feat, feat + step * noise_feat)
    new_mask = mask.clone()
    new_mask[..., base_n:] = app
    cth, sth = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    x, y, z = new_pos[..., 0], new_pos[..., 1], new_pos[..., 2]
    new_pos = torch.stack([x * cth + y * sth, -x * sth + y * cth, z], dim=-1)
    return new_pos, new_feat, new_mask


def assemble(pos, feat, mask, y, idx, aug, valid, seed: int, b0: int, base_n: int) -> Batch:
    """One training batch of the epoch of ``seed``, at offset ``b0``."""
    dev = pos.device
    idx_t = torch.as_tensor(idx, device=dev)
    aug_t = torch.as_tensor(aug, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    bpos, bfeat, by = pos[idx_t], feat[idx_t], y[idx_t]
    bmask = mask[idx_t] & valid_t[:, None]
    if not aug.any():
        return Batch(bpos, bfeat, bmask, by)
    g = torch.Generator(device=dev).manual_seed(derive_seed(seed, AUG, b0))
    apos, afeat, amask = augment(g, bpos, bfeat, bmask, base_n)
    f = aug_t[:, None]
    return Batch(torch.where(f[..., None], apos, bpos), torch.where(f[..., None], afeat, bfeat),
                 torch.where(f, amask, bmask), by)
