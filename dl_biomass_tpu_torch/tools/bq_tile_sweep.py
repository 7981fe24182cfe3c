"""Kernel 3's launch choices at SA2's scale (port of the JAX package's
``tools/bq_tile_sweep.py``, which sweeps ``ball_query_pallas``'s centroid
tile ``cm``; kernel 3 has no such tile).

B=16 clouds of N=2048 points (N(0, 5) positions, every point valid), their
first M=512 points as centroids, r=8, K=64: each launch that
``ball_query_kernel.plan`` could name for the whole cloud staged in shared
memory (warps a block, centroids a block, chunks of 32 points tested ahead)
runs with ``plan`` patched to it, as ``chip_compare.py querytune`` does; each
must give the plan's indices and mask exactly, and is timed: on the card
``steps`` launches replayed from a CUDA graph (median of ``repeats``
replays; a launch takes less than the host's time to issue it), on the CPU
``steps`` chained calls, best of ``repeats`` (every choice then runs the
plain version). Prints the plan's time, each choice's, and the fastest, with
the card and its power limit.

    python -m dl_biomass_tpu_torch.tools.bq_tile_sweep [M] [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
from unittest import mock

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device, round_up
from dl_biomass_tpu_torch.ops import ball_query_kernel as k3
from dl_biomass_tpu_torch.tools._timing import best_chain_s, card, graph_ms

B, K, RADIUS = 16, 64, 8.0
STEPS = 8
REPEATS = 3
WARPS = (8, 16, 32)
CENTROIDS_PER_WARP = (1, 2, 4, 8)


def plans(n: int, m: int, k: int) -> list:
    """The plan's launch first, then every whole-cloud launch that fits a
    block's shared memory."""
    base = k3.plan(n, m, k)
    swept = [k3.Plan(min(w * r, round_up(m, w)), w, round_up(n, 32 * a), True, a)
             for w, r, a in itertools.product(WARPS, CENTROIDS_PER_WARP, k3.AHEADS)]
    return list(dict.fromkeys([base] + [p for p in swept
                                        if k3.smem_bytes(p, k) <= k3.SMEM_PER_BLOCK]))


def main(m: int = 512, n: int = 2048, device=None, b: int = B, steps: int = STEPS,
         repeats: int = REPEATS) -> list:
    """The sweep; prints a line a launch and the fastest, returns the rows."""
    dev = resolve_device(device)
    where = card(dev)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy((rng.normal(size=(b, n, 3)) * 5).astype(np.float32)).to(dev)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    centers, cmask = pos[:, :m].contiguous(), mask[:, :m].contiguous()
    args, kwargs = (centers, cmask, pos, mask), dict(radius=RADIUS, k=K)
    ref = None
    rows = []
    for p in plans(n, m, K):
        with mock.patch.object(k3, "plan", lambda *_, p=p: p):
            idx, nbr = k3.ball_query_first_k(*args, **kwargs)
            if ref is None:
                ref = (idx, nbr)
            same = torch.equal(idx, ref[0]) and torch.equal(nbr, ref[1])
            if not same:
                raise RuntimeError(f"bq_tile_sweep: launch {tuple(p)} gives other neighbours "
                                   f"than the plan's")
            call = lambda: k3.ball_query_first_k(*args, **kwargs)  # noqa: E731
            ms = (graph_ms(call, steps, repeats) if dev.type == "cuda"
                  else best_chain_s(call, dev, steps, repeats) * 1e3)
        rows.append(dict(plan=tuple(p), ms=ms, same=same, card=where))
        print(f"bq_tile_sweep B={b} M={m} N={n} K={K}: launch {tuple(p)} "
              f"(centroids, warps, points, whole, ahead) {ms:.4f} ms, the plan's neighbours "
              f"[{where}]", flush=True)
    best = min(rows, key=lambda r: r["ms"])
    print(f"bq_tile_sweep: the plan's launch {rows[0]['plan']} {rows[0]['ms']:.4f} ms; fastest "
          f"{best['plan']} {best['ms']:.4f} ms, {len(rows)} launches [{where}]", flush=True)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="bq_tile_sweep")
    p.add_argument("m", nargs="?", type=int, default=512)
    p.add_argument("n", nargs="?", type=int, default=2048)
    p.add_argument("--device", default=None, help="cpu: the kernel's plain version")
    a = p.parse_args()
    main(a.m, a.n, a.device)
