"""On-device dataset (port of ``dl_biomass_tpu/io/device_data.py``): the
replacement for the reference's dataloader stack (``PointCloudsInFiles*`` +
``AugmentPointCloudsInFiles*`` + ``ConcatDataset`` + ``DataListLoader``).

The decoded dataset (a few hundred plots x ~7k points) is put on the card once;
every epoch the sample list (the P originals and ``num_augs`` augmented copies
of each, reference ``main.py:96-106``) is shuffled on the host, and each batch
is gathered and augmented on the device (``_assemble_batch``). Nothing moves
to the device per step but a handful of int32 indices and flags.

Randomness: an epoch is drawn from one integer seed. The order comes from a
``torch.Generator`` seeded with (seed, ``ORDER_KEY_DOMAIN``); each batch's
augmentation from a generator on the dataset's device seeded with (seed,
``AUG_KEY_DOMAIN``, b0), b0 the batch's offset in the epoch. The trainer's
steps draw from a generator seeded with the seed itself, so the augmentation
noise of a batch is never the stream of its step's FPS starts and dropout
(the separation the JAX package's domain tag keeps between ``fold_in(key,
b0)`` and its per-step ``fold_in(key, i)``).

Pad samples of a partial last batch carry an all-False mask, and the loss
weighs them 0.

Targets are a plot's (``y`` (P, k), the regressor's four components) or a
point's (``y`` (P, C, k), the segmentor's, packed like the features): these
travel with their points through the augmentation
(``transforms/augment.apply_augment``).
"""

from __future__ import annotations

import hashlib
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch, resolve_device, round_up
from dl_biomass_tpu_torch.transforms.augment import (AugmentDraws, apply_augment,
                                                     aug_capacity, draw_augment)
from dl_biomass_tpu_torch.utils import profiling

# domain tags mixed into an epoch's seed: the augmentation of each batch and the
# epoch's order, each apart from the steps' own stream (seeded with the seed)
AUG_KEY_DOMAIN = 0x617567  # "aug"
ORDER_KEY_DOMAIN = 0x6F7264  # "ord"


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from integers, the same on every machine and in every run."""
    digest = hashlib.sha256(b",".join(str(int(p)).encode() for p in parts)).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _assemble_batch(pos, feat, mask, y, idx, aug_flag, sample_valid,
                    draws: Optional[AugmentDraws], *, base_n: int) -> CloudBatch:
    """Gather clouds ``idx`` (device int64) from the dataset's tensors, augment
    those with ``aug_flag`` with ``draws`` (None: no sample of the batch is
    augmented), and mask out the invalid (pad) samples. Per-point targets
    (``y`` (P, C, k)) are augmented with their points."""
    bpos, bfeat, by = pos[idx], feat[idx], y[idx]
    bmask = mask[idx] & sample_valid[:, None]
    if draws is None:
        return CloudBatch(pos=bpos, feat=bfeat, mask=bmask, y=by)
    f = aug_flag[:, None]
    per_point = by.dim() == 3
    out = apply_augment(draws, bpos, bfeat, bmask, base_n, y=by if per_point else None)
    apos, afeat, amask = out[:3]
    if per_point:
        by = torch.where(f[..., None], out[3], by)
    return CloudBatch(pos=torch.where(f[..., None], apos, bpos),
                      feat=torch.where(f[..., None], afeat, bfeat),
                      mask=torch.where(f, amask, bmask), y=by)


class DeviceDataset:
    """A fixed set of point clouds resident on a device.

    Args:
      pos:  (P, C, 3) float32, valid points in slots [0, base_n).
      feat: (P, C, F) float32.
      mask: (P, C) bool.
      y:    (P, 4) float32 biomass targets, or (P, C, k) per-point targets.
      plot_ids: host-side list of P plot IDs.
      base_n: nominal points per cloud (e.g. 7168 for the presampled path).
      device: None for the card (which must exist), or e.g. ``"cpu"``.
    """

    def __init__(self, pos, feat, mask, y, plot_ids: Sequence[str], base_n: int, device=None):
        dev = resolve_device(device)
        with profiling.span("io.upload"):
            self.pos = torch.as_tensor(pos, dtype=torch.float32).to(dev)
            self.feat = torch.as_tensor(feat, dtype=torch.float32).to(dev)
            self.mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
            self.y = torch.as_tensor(y, dtype=torch.float32).to(dev)
        self.plot_ids = list(plot_ids)
        self.base_n = int(base_n)

    def __len__(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def num_features(self) -> int:
        return self.feat.shape[-1]

    @classmethod
    def from_clouds(cls, pos_list: Sequence[np.ndarray], feat_list: Sequence[np.ndarray],
                    y: np.ndarray, plot_ids: Sequence[str], base_n: Optional[int] = None,
                    for_augmentation: bool = True, device=None) -> "DeviceDataset":
        """Pack host numpy clouds (each (n_i, 3) + (n_i, F)) into device tensors.
        ``y`` is (P, k), a row a plot, or a list of (n_i, k) arrays, a row a
        point, packed as the features are.

        Capacity is ``aug_capacity(base_n)`` when the dataset will be augmented
        (noise-append needs ~10% headroom, reference ``augmentation.py:113-120``),
        else ``base_n`` rounded up to 128, as the JAX package packs them.
        """
        if not pos_list:
            raise ValueError("from_clouds: empty cloud list (no plots matched?)")
        if base_n is None:
            base_n = max(int(p.shape[0]) for p in pos_list)
        cap = aug_capacity(base_n) if for_augmentation else round_up(base_n, 128)
        with profiling.span("io.pack"):
            p_arr = np.zeros((len(pos_list), cap, 3), np.float32)
            f_dim = feat_list[0].reshape(len(feat_list[0]), -1).shape[-1]
            f_arr = np.zeros((len(pos_list), cap, f_dim), np.float32)
            m_arr = np.zeros((len(pos_list), cap), bool)
            per_point = not isinstance(y, np.ndarray) and np.ndim(y[0]) == 2
            y_arr = (np.zeros((len(pos_list), cap, np.shape(y[0])[1]), np.float32) if per_point
                     else np.asarray(y, np.float32))
            for i, (p, x) in enumerate(zip(pos_list, feat_list)):
                n = min(int(p.shape[0]), base_n)
                p_arr[i, :n] = p[:n]
                f_arr[i, :n] = x.reshape(len(x), -1)[:n]
                m_arr[i, :n] = True
                if per_point:
                    y_arr[i, :n] = y[i][:n]
        return cls(p_arr, f_arr, m_arr, y_arr, plot_ids, base_n, device)

    def pad_plots(self, p_to: int) -> "DeviceDataset":
        """Zero-pad the plot axis to ``p_to`` (all-False masks, ``__pad__`` ids):
        bulk serving buckets plot counts and slices the real rows back out."""
        p = len(self)
        if p_to < p:
            raise ValueError(f"pad_plots: {p_to} < current {p}")
        if p_to == p:
            return self

        def z(a):
            return torch.cat([a, a.new_zeros((p_to - p, *a.shape[1:]))])

        with profiling.span("io.pad_plots"):
            return DeviceDataset(z(self.pos), z(self.feat), z(self.mask), z(self.y),
                                 self.plot_ids + ["__pad__"] * (p_to - p), self.base_n,
                                 self.device)

    # ---- batch serving --------------------------------------------------------

    def epoch_order(self, seed: Optional[int], num_augs: int, shuffle: bool
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Sample list for one epoch: P originals + num_augs augmented copies of
        each plot (the reference's ConcatDataset, ``main.py:96-106``), shuffled
        by a generator seeded from ``seed`` where ``shuffle``."""
        p = len(self)
        idx = np.tile(np.arange(p, dtype=np.int32), 1 + num_augs)
        aug = np.repeat(np.arange(1 + num_augs, dtype=np.int32) > 0, p)
        if shuffle:
            if seed is None:
                raise ValueError("epoch_order(shuffle=True) needs a seed")
            g = torch.Generator().manual_seed(derive_seed(seed, ORDER_KEY_DOMAIN))
            perm = torch.randperm(len(idx), generator=g).numpy()
            idx, aug = idx[perm], aug[perm]
        return idx, aug

    def epoch_spec_arrays(self, batch_size: int, *, seed: Optional[int] = None,
                          num_augs: int = 0, shuffle: bool = False
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All of one epoch's batch specs stacked, host numpy: ``(idxs (S, B),
        aug_flags (S, B), valids (S, B), b0s (S,))``, b0 the offset of each
        batch in the epoch, from which its augmentation seed derives. The one
        source of the chunk and pad layout for every epoch path."""
        if num_augs > 0 and seed is None:
            raise ValueError("epoch_spec_arrays(num_augs>0) needs a seed: without one every "
                             "epoch would see identical augmentations")
        order, aug = self.epoch_order(seed, num_augs, shuffle)
        n = len(order)
        s = (n + batch_size - 1) // batch_size
        idxs = np.zeros((s, batch_size), np.int32)
        augs = np.zeros((s, batch_size), bool)
        valids = np.zeros((s, batch_size), bool)
        b0s = np.arange(s, dtype=np.int32) * batch_size
        for si, b0 in enumerate(range(0, n, batch_size)):
            chunk = order[b0:b0 + batch_size]
            idxs[si, :len(chunk)] = chunk
            augs[si, :len(chunk)] = aug[b0:b0 + batch_size]
            valids[si, :len(chunk)] = True
        return idxs, augs, valids, b0s

    def aug_seed(self, seed: Optional[int], b0: int) -> int:
        """The augmentation seed of the batch at offset b0 of the epoch of ``seed``."""
        return derive_seed(0 if seed is None else seed, AUG_KEY_DOMAIN, b0)

    def epoch_specs(self, batch_size: int, *, seed: Optional[int] = None, num_augs: int = 0,
                    shuffle: bool = False) -> Iterator[tuple]:
        """Per-batch host specs ``(idx, aug_flag, valid, aug_seed)``, numpy
        arrays and an int, in the layout of ``epoch_spec_arrays``."""
        idxs, augs, valids, b0s = self.epoch_spec_arrays(batch_size, seed=seed,
                                                         num_augs=num_augs, shuffle=shuffle)
        for si in range(len(b0s)):
            yield idxs[si], augs[si], valids[si], self.aug_seed(seed, int(b0s[si]))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host spec on the dataset's device, without waiting for the device:
        from pinned memory, asynchronously, on a card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def assemble(self, idx, aug_flag, valid, aug_seed: int, augment: bool) -> CloudBatch:
        """One batch from its specs (numpy, or tensors on the device) on the
        device: gathered, and augmented with the draws of ``aug_seed`` where
        ``augment`` (the host's knowledge that some ``aug_flag`` is set)."""
        idx, aug_flag, valid = (a if torch.is_tensor(a) else self._to_device(a)
                                for a in (idx, aug_flag, valid))
        draws = None
        if augment:
            g = torch.Generator(device=self.device).manual_seed(aug_seed)
            draws = draw_augment(g, idx.shape[0], self.pos.shape[1], self.num_features)
        return _assemble_batch(self.pos, self.feat, self.mask, self.y, idx.long(), aug_flag,
                               valid, draws, base_n=self.base_n)

    def batches(self, batch_size: int, *, seed: Optional[int] = None, num_augs: int = 0,
                shuffle: bool = False) -> Iterator[CloudBatch]:
        """Fixed-shape CloudBatches; the final partial batch is padded with
        zero-weight clouds."""
        for idx, aug_flag, valid, aug_seed in self.epoch_specs(
                batch_size, seed=seed, num_augs=num_augs, shuffle=shuffle):
            yield self.assemble(idx, aug_flag, valid, aug_seed, bool(aug_flag.any()))

    def batch_plot_ids(self, batch_size: int) -> List[List[str]]:
        """Plot IDs per (unshuffled, unaugmented) batch, for eval reporting."""
        ids = self.plot_ids
        return [ids[i:i + batch_size] for i in range(0, len(ids), batch_size)]
