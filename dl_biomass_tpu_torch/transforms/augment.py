"""Batched on-device point-cloud augmentation (port of
``dl_biomass_tpu/transforms/augment.py``).

The reference transforms (``augmentation.py:54-122``) with the same chain and
distributions, on static shapes with masks:

  * ``point_removal`` — a uniform-random subset is masked out so that the
    kept count is ~ U[round(0.9 nv), nv] (``augmentation.py:73-88``);
  * ``random_noise`` — sigma ~ U(0.01, 0.025), added or subtracted (50/50)
    as gaussian noise on a *copy* of coordinates and features; a
    uniform-random subset of up to 10% of those noisy copies is *appended*
    to the un-jittered cloud in the pad slots [base_n, C), the base slots
    staying clean (``augmentation.py:91-122``);
  * ``rotate_points`` — a uniform z-rotation in (-180, 180) degrees
    (``augmentation.py:54-70``); features are not rotated.

One uniform permutation of the valid slots serves both subset draws: the
removal keeps a prefix of it, and the append set is a shorter prefix, which
given the kept set is a uniform subset of it.

Randomness comes from an explicit ``torch.Generator`` on the batch's device.
``draw_augment(generator, B, C, F)`` makes every draw of a batch (the angle,
the removal's keep count, sigma, the sign, the two normal tensors, the append
count and the permutation scores); ``apply_augment(draws, pos, feat, mask,
base_n)`` applies them, batched over the clouds. Per-point targets (the
segmentor's) travel with their points through ``apply_augment``'s ``y``:
a removed point's target leaves with its mask, an appended copy takes its
source slot's target (no noise is added to a target), and the rotation
leaves them as they are. The JAX package draws from
``jax.random`` keys, so a parity test computes its draws from the same key
splits and hands them to ``apply_augment``. The JAX transform is plain XLA
with no Pallas kernel; this one is plain PyTorch.

Shape contract: valid input points lie in slots [0, base_n) of a capacity-C
buffer with C >= ceil(1.1 base_n) (``aug_capacity``); appended noise points
are written to slots [base_n, C).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch, round_up


def aug_capacity(n: int, align: int = 128) -> int:
    """Capacity needed to hold a cloud of n points after noise-append (<= 1.1 n)."""
    return round_up(n + int(-(-n // 10)), align)


class AugmentDraws(NamedTuple):
    """Every draw of the augmentation of B clouds of capacity C, F features."""

    theta: torch.Tensor  # (B,) rotation angle in (-pi, pi)
    keep_u: torch.Tensor  # (B,) uniform [0, 1): the removal's keep count
    sd: torch.Tensor  # (B,) noise sigma in [0.01, 0.025)
    sign: torch.Tensor  # (B,) +1.0 or -1.0
    noise_pos: torch.Tensor  # (B, C, 3) standard normal
    noise_feat: torch.Tensor  # (B, C, F) standard normal
    extra_u: torch.Tensor  # (B,) uniform [0, 1): the append count
    scores: torch.Tensor  # (B, C) uniform [0, 1): the shared permutation
    scale: torch.Tensor  # (B,) isotropic scale in [0.9, 1.1), used only with_scale


def _uniform(generator: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def draw_augment(generator: torch.Generator, b: int, c: int, f: int) -> AugmentDraws:
    """The draws of one batch, on the generator's device, in a fixed order."""
    theta = _uniform(generator, (b,), -math.pi, math.pi)
    keep_u = _uniform(generator, (b,))
    sd = _uniform(generator, (b,), 0.01, 0.025)
    sign = torch.where(_uniform(generator, (b,)) >= 0.5, 1.0, -1.0)
    noise_pos = torch.randn((b, c, 3), generator=generator, device=generator.device)
    noise_feat = torch.randn((b, c, f), generator=generator, device=generator.device)
    extra_u = _uniform(generator, (b,))
    scores = _uniform(generator, (b, c))
    scale = _uniform(generator, (b,), 0.9, 1.1)
    return AugmentDraws(theta, keep_u, sd, sign, noise_pos, noise_feat, extra_u, scores, scale)


def _randint(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Uniform integer in [lo, hi] from u in [0, 1), in float32 as the JAX
    package computes it."""
    span = (hi - lo + 1).float()
    return lo + torch.floor(u * span).int()


def _ranks_over_valid(mask: torch.Tensor, scores: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random permutation over the valid slots of each cloud (the last axis):
    ``(ranks, order)``, valid slots ranked 0..nv-1 in the order of their
    scores (invalid ones >= nv), ``order[r]`` the slot of rank r."""
    keyed = torch.where(mask, scores, torch.full_like(scores, math.inf))
    order = torch.argsort(keyed, dim=-1, stable=True)  # valid slots first, in random order
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    return ranks, order


def _valid_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(-1, dtype=torch.int32)


def _removal(mask: torch.Tensor, ranks: torch.Tensor, keep_u: torch.Tensor) -> torch.Tensor:
    nv = _valid_count(mask)
    lo = torch.round(0.9 * nv.float()).int()
    keep = _randint(keep_u, lo, nv)
    return mask & (ranks < keep[..., None])


def _append_noise(pos, feat, mask, base_n: int, order, sd, sign, noise_pos, noise_feat,
                  extra_u, y=None):
    """(pos, feat, mask, y) with the noisy copies appended; ``y`` (per-point
    targets, or None) appended unjittered from the same source slots."""
    cap_extra = mask.shape[-1] - base_n
    step = (sign * sd)[..., None, None]
    noisy_pos = pos + step * noise_pos
    noisy_feat = feat + step * noise_feat
    hi = torch.round(0.1 * _valid_count(mask).float()).int()
    n_extra = torch.clamp(_randint(extra_u, torch.zeros_like(hi), hi), max=cap_extra)
    app_src = order[..., :cap_extra]  # the source slot of each append slot
    app_valid = torch.arange(cap_extra, device=mask.device) < n_extra[..., None]

    def append(base, noisy):
        src = torch.gather(noisy, -2, app_src[..., None].expand(*app_src.shape, noisy.shape[-1]))
        out = base.clone()
        out[..., base_n:, :] = torch.where(app_valid[..., None], src, 0.0)
        return out

    out_mask = mask.clone()
    out_mask[..., base_n:] = app_valid
    return (append(pos, noisy_pos), append(feat, noisy_feat), out_mask,
            None if y is None else append(y, y))


def _rotate(pos: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    # the reference's row-vector product: coords @ [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return torch.stack([x * c + y * s, -x * s + y * c, z], dim=-1)


def apply_augment(draws: AugmentDraws, pos: torch.Tensor, feat: torch.Tensor,
                  mask: torch.Tensor, base_n: int, with_scale: bool = False,
                  y: Optional[torch.Tensor] = None):
    """The reference chain point_removal -> random_noise -> rotate_points
    (``augmentation.py:278-280``), then the optional random_scale, on clouds
    pos (B, C, 3), feat (B, C, F), mask (B, C) with the draws given: returns
    (pos, feat, mask), and with per-point targets ``y`` (B, C, k) given also
    y after them, each appended slot's target its source slot's, the removed
    points' left in place (their mask is False)."""
    ranks, order = _ranks_over_valid(mask, draws.scores)
    mask = _removal(mask, ranks, draws.keep_u)
    pos, feat, mask, y_out = _append_noise(pos, feat, mask, base_n, order, draws.sd, draws.sign,
                                           draws.noise_pos, draws.noise_feat, draws.extra_u, y)
    pos = _rotate(pos, draws.theta)
    if with_scale:
        pos = pos * draws.scale[..., None, None]
    return (pos, feat, mask) if y is None else (pos, feat, mask, y_out)


# ---- the transforms one at a time, each drawing from a generator ----------------


def random_scale(generator: torch.Generator, pos: torch.Tensor, lo: float = 0.9,
                 hi: float = 1.1) -> torch.Tensor:
    """Uniform isotropic scale of one cloud (not in the reference's chain: the
    BASELINE 'rotate/jitter/scale' config; off by default)."""
    return pos * _uniform(generator, (), lo, hi)


def rotate_points(generator: torch.Generator, pos: torch.Tensor) -> torch.Tensor:
    """Random z-rotation of one cloud, angle ~ U(-180, 180) degrees. pos (..., 3)."""
    return _rotate(pos, _uniform(generator, (), -math.pi, math.pi))


def point_removal(generator: torch.Generator, mask: torch.Tensor,
                  ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask out a random subset of one cloud so that the kept count ~
    U[round(0.9 nv), nv]; ``ranks`` (``_ranks_over_valid``) may be shared with
    ``random_noise``."""
    if ranks is None:
        ranks, _ = _ranks_over_valid(mask, _uniform(generator, mask.shape))
    return _removal(mask, ranks, _uniform(generator, ()))


def random_noise(generator: torch.Generator, pos: torch.Tensor, feat: torch.Tensor,
                 mask: torch.Tensor, base_n: int, order: Optional[torch.Tensor] = None):
    """Append jittered duplicates to the original (un-jittered) cloud, in slots
    [base_n, C) (``augmentation.py:113-120``); ``order`` is the shared
    valid-slot permutation. Returns (pos, feat, mask)."""
    sd = _uniform(generator, (), 0.01, 0.025)
    sign = torch.where(_uniform(generator, ()) >= 0.5, 1.0, -1.0)
    noise_pos = torch.randn(pos.shape, generator=generator, device=generator.device)
    noise_feat = torch.randn(feat.shape, generator=generator, device=generator.device)
    if order is None:
        _, order = _ranks_over_valid(mask, _uniform(generator, mask.shape))
    return _append_noise(pos, feat, mask, base_n, order, sd, sign, noise_pos, noise_feat,
                         _uniform(generator, ()))[:3]


def augment_cloud(generator: torch.Generator, pos: torch.Tensor, feat: torch.Tensor,
                  mask: torch.Tensor, base_n: Optional[int] = None, with_scale: bool = False):
    """The full chain on one cloud, pos (C, 3), feat (C, F), mask (C,)."""
    if base_n is None:
        base_n = mask.shape[0] - mask.shape[0] // 11  # default: cap = ceil(1.1 n)
    draws = draw_augment(generator, 1, mask.shape[0], feat.shape[-1])
    out = apply_augment(draws, pos[None], feat[None], mask[None], base_n, with_scale)
    return tuple(t[0] for t in out)


def augment_batch(generator: torch.Generator, batch: CloudBatch, base_n: int) -> CloudBatch:
    """The chain over every cloud of a batch whose valid points occupy slots
    [0, base_n) of a capacity >= aug_capacity(base_n) buffer, each cloud with
    its own draws."""
    b, c = batch.mask.shape
    draws = draw_augment(generator, b, c, batch.feat.shape[-1])
    pos, feat, mask = apply_augment(draws, batch.pos, batch.feat, batch.mask, base_n)
    return CloudBatch(pos=pos, feat=feat, mask=mask, y=batch.y)
