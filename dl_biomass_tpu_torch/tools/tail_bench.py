"""Kernel 7 (``ops/tail_kernel.fused_tail``) against the unfused Linear +
``masked_max`` at SA-layer shapes (port of the JAX package's
``tools/tail_bench.py``).

"Unfused" is the bf16 product with a float32 sum (``models/layers.dot_f32``)
plus b3, rounded to bf16, then ``ops/pooling.masked_max``, its backward by
autograd; "fused" is ``fused_tail``. For SA1 (36, 2048, 64, 64 -> 128) and
SA2 (36, 512, 64, 128 -> 256) it prints the forward and the forward+backward
time of each, in ms per call: a chain of ``LOOPS`` calls with one
synchronisation, best of ``WINDOWS``, each call's whole output summed so that
no work can be skipped.

    python -m dl_biomass_tpu_torch.tools.tail_bench
"""

from __future__ import annotations

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.models.layers import dot_f32
from dl_biomass_tpu_torch.ops.pooling import masked_max
from dl_biomass_tpu_torch.ops.tail_kernel import fused_tail
from dl_biomass_tpu_torch.tools._timing import best_chain_s

LOOPS = 10  # calls per timed chain
WINDOWS = 3  # timed chains, best taken
SHAPES = (("SA1", (36, 2048, 64, 64, 128)), ("SA2", (36, 512, 64, 128, 256)))


def unfused(a2, mask, w3, b3):
    y = dot_f32(a2.to(torch.bfloat16), w3.to(torch.bfloat16))
    return masked_max((y + b3).to(torch.bfloat16), mask, dim=2)


def timed_ms(fn, a2, mask, w3, b3, grad: bool = False) -> float:
    acc = torch.zeros((), dtype=torch.float32, device=a2.device)

    def forward():
        nonlocal acc
        with torch.no_grad():
            acc = acc + fn(a2, mask, w3, b3).float().sum()

    def forward_backward():
        nonlocal acc
        leaves = [t.detach().requires_grad_() for t in (a2, w3, b3)]
        loss = fn(leaves[0], mask, leaves[1], leaves[2]).float().sum()
        _, _, db = torch.autograd.grad(loss, leaves)
        acc = acc + db.sum()

    return best_chain_s(forward_backward if grad else forward, a2.device, LOOPS, WINDOWS) * 1e3


def inputs(shape, rng: np.random.Generator, device):
    """a2, mask, w3, b3 of one shape, drawn from ``rng`` as the JAX tool draws them."""
    b, m, k, c2, c3 = shape
    a2 = torch.from_numpy(rng.normal(size=(b, m, k, c2)).astype(np.float32)).to(device)
    a2 = a2.to(torch.bfloat16)
    mask = torch.from_numpy(rng.random(size=(b, m, k)) > 0.1).to(device)
    w3 = torch.from_numpy((rng.normal(size=(c2, c3)) * 0.1).astype(np.float32)).to(device)
    b3 = torch.from_numpy((rng.normal(size=(c3,)) * 0.1).astype(np.float32)).to(device)
    return a2, mask, w3, b3


def main(device=None) -> list:
    """Time both forms at each shape of ``SHAPES``; prints a line each and
    returns them as dicts."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for name, shape in SHAPES:
        args = inputs(shape, rng, dev)
        for label, fn in (("unfused", unfused), ("fused", fused_tail)):
            fwd = timed_ms(fn, *args)
            fb = timed_ms(fn, *args, grad=True)
            print(f"{name} {label:7s}: fwd {fwd:7.3f} ms   fwd+bwd {fb:7.3f} ms", flush=True)
            rows.append(dict(shape=name, label=label, fwd_ms=fwd, fwd_bwd_ms=fb))
        del args
    return rows


if __name__ == "__main__":
    main()
