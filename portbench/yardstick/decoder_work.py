"""The work of the per-point segmentor's step, counted as ``work.model_flops``
counts the encoder's: the matrix products of the reference's network, 2
operations a multiply-add, over the rows the reference computes (the valid
ones), a training step three times its forward.

* the encoder (SA1, SA2 and SA3): ``work.model_flops`` without the
  regressor's head;
* FP3 over SA2's valid centroids, FP2 over SA1's, FP1 and the per-point head
  over the valid points. The interpolations' weighted sums (k x C
  multiply-adds a target) and the dense distances are not products and are
  not counted.
"""

from __future__ import annotations

from portbench.yardstick import work


def decoder_flops(cfg: dict, sel, mask, train: bool) -> float:
    """FLOPs of FP3, FP2, FP1 and the head over the selection ``sel``
    (``reference.model.select_all``) of clouds of valid points ``mask``."""
    w = cfg["widths"]
    (_, cm1, _), (_, cm2, _) = sel.layers
    points = int(mask.sum())
    rows = {"fp3": int(cm2.sum()), "fp2": int(cm1.sum()), "fp1": points, "head": points}
    return float(sum(2 * n * work._linear_macs(w[k]) for k, n in rows.items())
                 * (3 if train else 1))


def model_flops(cfg: dict, sel, mask, train: bool) -> float:
    """FLOPs of the whole segmentor: the encoder and the decoder."""
    encoder = {**cfg, "widths": {**cfg["widths"], "head": []}}
    return work.model_flops(encoder, sel, mask.shape[0], train) + decoder_flops(cfg, sel, mask,
                                                                                train)
