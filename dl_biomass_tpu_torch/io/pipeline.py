"""Host->device prefetching input pipeline (port of ``dl_biomass_tpu/io/pipeline.py``).

For datasets that do not fit on the card (``DeviceDataset`` holds the
reference-scale corpus), a background thread decodes LAS files and assembles
padded batches (fresh random subsets each epoch — the reference's
per-``__getitem__`` resampling, ``pointcloud_dataloader.py:98-101``) into
pinned host buffers while the device trains on the previous batches; each
batch moves to the device with ``non_blocking=True`` through a bounded queue
(double buffering).

Augmentation happens on the device (``transforms/augment.augment_batch``)
after the transfer, drawn from a ``torch.Generator`` seeded with (seed,
``AUG_KEY_DOMAIN``, batch index), where the JAX package folds its key; the
host thread does IO and packing only. The order and the subsets are numpy
draws from the epoch's seed, as in the JAX package, so a seed gives the same
batches in both.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch, resolve_device
from dl_biomass_tpu_torch.io.device_data import AUG_KEY_DOMAIN, derive_seed
from dl_biomass_tpu_torch.transforms.augment import aug_capacity, augment_batch


class PrefetchingLoader:
    """Streams shuffled, augmented CloudBatches from a file-based dataset.

    Args:
      fileset: a ``PointCloudsInFiles``-style object with ``__len__`` and
        ``get(idx, rng) -> (pos, feat, y, plot_id) | None``.
      batch_size: clouds per batch (fixed; final partial batch is padded).
      num_augs: augmented copies per plot per epoch (reference ``main.py:96``).
      prefetch: queue depth of decoded batches (2 = double buffering).
      device: where the batches go (None: the card, which must exist).
    """

    def __init__(self, fileset, batch_size: int, base_n: int,
                 num_augs: int = 0, prefetch: int = 2, device=None):
        self.fileset = fileset
        self.batch_size = batch_size
        self.base_n = base_n
        self.num_augs = num_augs
        self.prefetch = prefetch
        self.capacity = aug_capacity(base_n) if num_augs > 0 else base_n
        self.device = resolve_device(device)

    def _buffer(self, shape, dtype) -> torch.Tensor:
        """A zeroed host buffer, pinned where the batches go to a card (the
        caching host allocator keeps it until its copy has run)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _produce(self, q: queue.Queue, seed: int, shuffle: bool,
                 stop: threading.Event):
        rng = np.random.default_rng(seed)
        p = len(self.fileset)
        order = np.tile(np.arange(p), 1 + self.num_augs)
        flags = np.repeat(np.arange(1 + self.num_augs) > 0, p)
        if shuffle:
            perm = rng.permutation(len(order))
            order, flags = order[perm], flags[perm]
        bs, cap = self.batch_size, self.capacity

        def put(item) -> bool:
            # bounded-queue put that gives up when the consumer abandons the
            # epoch (else a consumer that breaks mid-epoch would leave this
            # thread blocked on a full queue, holding batches)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for b0 in range(0, len(order), bs):
                if stop.is_set():
                    return
                sel = order[b0 : b0 + bs]
                fl = flags[b0 : b0 + bs]
                pos = self._buffer((bs, cap, 3), torch.float32)
                feat = None
                mask = self._buffer((bs, cap), torch.bool)
                y = self._buffer((bs, 4), torch.float32)
                aflag = np.zeros(bs, bool)
                for j, (i, f) in enumerate(zip(sel, fl)):
                    item = self.fileset.get(int(i), rng)
                    if item is None:
                        continue
                    p_, x_, y_, _ = item
                    x_ = x_.reshape(len(x_), -1)
                    if feat is None:
                        feat = self._buffer((bs, cap, x_.shape[1]), torch.float32)
                    n = min(len(p_), self.base_n)
                    pos.numpy()[j, :n] = p_[:n]
                    feat.numpy()[j, :n] = x_[:n]
                    mask.numpy()[j, :n] = True
                    y.numpy()[j] = y_
                    aflag[j] = f
                if feat is None:
                    continue
                if not put((pos, feat, mask, y, aflag)):
                    return
        except BaseException as e:  # surfaced by the consumer: a swallowed decode
            # error would silently truncate the epoch mid-training
            put(("error", e))
            return
        finally:
            put(None)

    def epoch(self, seed: int, shuffle: bool = True) -> Iterator[CloudBatch]:
        """One epoch's batches on the device, drawn from the integer ``seed``."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, seed, shuffle, stop),
                             daemon=True)
        t.start()
        try:
            yield from self._consume(q, seed)
            t.join()
        finally:
            stop.set()  # unblock/terminate the producer if we exit early

    def _consume(self, q: queue.Queue, seed: int) -> Iterator[CloudBatch]:
        dev = self.device
        i = 0
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "error":
                raise RuntimeError("PrefetchingLoader producer failed mid-epoch") from item[1]
            pos, feat, mask, y, aflag = item
            batch = CloudBatch(pos=pos.to(dev, non_blocking=True),
                               feat=feat.to(dev, non_blocking=True),
                               mask=mask.to(dev, non_blocking=True),
                               y=y.to(dev, non_blocking=True))
            if self.num_augs > 0 and aflag.any():
                # apart from the trainer's step stream, which fit seeds with the
                # epoch's seed itself
                g = torch.Generator(device=dev).manual_seed(derive_seed(seed, AUG_KEY_DOMAIN, i))
                aug = augment_batch(g, batch, self.base_n)
                f = torch.from_numpy(aflag).to(dev)[:, None]
                batch = CloudBatch(
                    pos=torch.where(f[..., None], aug.pos, batch.pos),
                    feat=torch.where(f[..., None], aug.feat, batch.feat),
                    mask=torch.where(f, aug.mask, batch.mask),
                    y=batch.y,
                )
            yield batch
            i += 1
