"""Roofline of the production train and eval steps on an H100 (port of the JAX
package's ``tools/roofline.py``, which asks XLA's cost analysis and holds it
to a TPU's peaks).

Each step's operations and bytes are counted from shapes: the GEMMs' by
``torch.utils.flop_counter.FlopCounterMode`` (at the compute dtype's tensor
core peak), and kernels 1, 2, 3, 4a, 4b and 4c by the counts ``chip_smoke.py``
bounds them with (each input read once, each output written once; FPS's
9 operations a point a step; the distance tests the data needs, 8 operations
each, at the float32 peak), from the arguments each kernel's wrapper is
given in the step. The step's time is measured (host clock to a
synchronisation, best of ``repeats``). Prints each count beside the H100
peaks (989 TFLOP/s bf16 dense, 67 TFLOP/s float32, 3.35 TB/s), the bound they
give, which of the two bounds the step, and the card and its power limit.
The bytes of the operations outside the kernels and GEMMs (BatchNorm, casts,
the masked max) are not counted, so the bound is a floor.

    python -m dl_biomass_tpu_torch.tools.roofline [B] [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from contextlib import ExitStack
from unittest import mock

import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import card, flagship, sync

# H100 SXM peaks (NVIDIA data sheet), as PERF.md section 6 uses them
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
FPS_FLOPS_PER_POINT_STEP = 9  # t: 3 mul + 2 add; d: mul, sub, add; running min
DIST_TEST_FLOPS = 8  # 3 sub, 3 mul, 2 add
REPEATS = 3


def fps_counts(pos, mask, starts, k):
    """Kernel 1: (bytes, operations) of one launch."""
    rows, n = pos.shape[0], pos.shape[1]
    return (rows * n * 13 + rows * 4 + rows * k * 4,
            rows * n * 5 + rows * (k - 1) * n * FPS_FLOPS_PER_POINT_STEP)


def bucket_scan_lengths(centers, cmask, pos, mask, r2, chunk=128):
    """Distance tests kernel 2's data needs: per valid centroid and residue g,
    the points g, g+128, ... up to the first in-radius one."""
    from dl_biomass_tpu_torch.ops.grouping import in_radius

    b, m, _ = centers.shape
    n = pos.shape[1]
    n_pad = -(-n // 128) * 128
    order = torch.arange(n, device=pos.device)
    g = torch.arange(128, device=pos.device)
    full = (n - g + 127) // 128  # points in residue g
    total = 0
    for s in range(0, m, chunk):
        ok = in_radius(centers[:, s:s + chunk], cmask[:, s:s + chunk], pos, mask, r2)
        keys = torch.nn.functional.pad(torch.where(ok, order, n), (0, n_pad - n), value=n)
        first = keys.view(b, ok.shape[1], -1, 128).amin(2)  # (B, mc, 128)
        scanned = torch.where(first < n, (first - g) // 128 + 1, full)
        total += int((scanned * cmask[:, s:s + chunk, None]).sum())
    return total


def group_counts(centers, cmask, pos, mask, feat, radius, out_dtype):
    """Kernel 2: (bytes, operations) of one launch."""
    from dl_biomass_tpu_torch.ops import ball_group_kernel

    b, m, _ = centers.shape
    n, f = pos.shape[1], (0 if feat is None else feat.shape[-1])
    tests = bucket_scan_lengths(centers, cmask, pos, mask, ball_group_kernel._radius2(radius))
    esize = torch.empty((), dtype=out_dtype).element_size()
    return (b * n * (12 + 4 * f + 1) + b * m * 13 + b * m * 64 * ((f + 3) * esize + 1),
            tests * DIST_TEST_FLOPS)


def query_counts(centers, cmask, pos, mask, k, idx, nbr):
    """Kernel 3: (bytes, operations) of one launch, from its output (idx,
    nbr): a valid centroid's exact scan tests its points up to its k-th
    hit, else all of them."""
    b, m, _ = centers.shape
    n = pos.shape[1]
    scan = torch.where(nbr[..., k - 1], idx[..., k - 1].long() + 1,
                       torch.full_like(idx[..., k - 1], n, dtype=torch.long))[cmask]
    return b * n * 13 + b * m * 13 + b * m * k * 5, int(scan.sum()) * DIST_TEST_FLOPS


def gather_counts(values, idx):
    """Kernel 4a: (bytes, operations) of one launch."""
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    return b * m * k * c * es + b * m * k * 4 + b * n * c * es, 0


def gather_aux_counts(values, idx, aux):
    """Kernel 4c: (bytes, operations) of one launch."""
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    return b * m * k * (c * es + aux.shape[-1] * 4 + 4) + b * n * (c * es + aux.shape[-1] * 4), 0


def scatter_counts(ct, idx, n, valid: int):
    """Kernel 4b: (bytes, operations) of one launch, ``valid`` rows added."""
    b, c = ct.shape[0], ct.shape[-1]
    return (ct.numel() * ct.element_size() + idx.numel() * 4 + b * n * c * ct.element_size(),
            valid * c)


def _sites():
    from dl_biomass_tpu_torch.ops import (ball_group_kernel, ball_query_kernel, fps_kernel,
                                          gather_kernel)

    return {"1": (fps_kernel, "fps_rows"), "2": (ball_group_kernel, "ball_group"),
            "3": (ball_query_kernel, "ball_query_first_k"),
            "4a": (gather_kernel, "gather_rows_forward"),
            "4c": (gather_kernel, "gather_rows_aux"), "4b": (gather_kernel, "scatter_rows")}


def kernel_counts(calls: dict) -> dict:
    """{kernel: (bytes, operations)} summed over the recorded calls (each
    (args, kwargs, output))."""
    out = {}
    for name, recs in calls.items():
        nbytes = ops = 0
        for args, kwargs, res in recs:
            if name == "1":
                c = fps_counts(*args, **kwargs)
            elif name == "2":
                c = group_counts(*args, kwargs["radius"], kwargs.get("out_dtype", torch.float32))
            elif name == "3":
                c = query_counts(*args, kwargs["k"], *res)
            elif name == "4a":
                c = gather_counts(*args)
            elif name == "4c":
                c = gather_aux_counts(*args)
            else:
                ct, idx, n = args
                c = scatter_counts(ct, idx, n, int(((idx >= 0) & (idx < n)).sum()))
            nbytes, ops = nbytes + c[0], ops + c[1]
        out[name] = (nbytes, ops)
    return out


def record(fn) -> dict:
    """``fn()`` with kernels 1-4c's wrappers recording (args, kwargs,
    output) of every call, by kernel."""
    calls = {name: [] for name in _sites()}

    def recorder(name, real):
        def rec(*args, **kwargs):
            res = real(*args, **kwargs)
            calls[name].append((args, kwargs, res))
            return res
        return rec

    with ExitStack() as stack:
        for name, (module, attr) in _sites().items():
            stack.enter_context(mock.patch.object(module, attr,
                                                  recorder(name, getattr(module, attr))))
        fn()
    return calls


def count_step(fn):
    """(GEMM FLOPs, {kernel: (bytes, operations)}) of one call of ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        calls = record(fn)
    return counter.get_total_flops(), kernel_counts(calls)


def main(b: int = 16, n: int = 10240, device=None, repeats: int = REPEATS) -> list:
    """Count and time the production train and eval steps at ``b`` x ``n``;
    prints a line each and returns them as dicts."""
    dev = resolve_device(device)
    trainer, batch = flagship(b, n, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = trainer.model.compute_dtype == torch.bfloat16
    gemm_peak = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S
    where = card(dev)
    rows = []
    for name, fn in (("train", lambda: trainer.step(batch, gen)),
                     ("eval", lambda: trainer._eval_batch(batch))):
        flops, kernels = count_step(fn)
        best = float("inf")
        for _ in range(repeats):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best = min(best, time.perf_counter() - t0)
        k_bytes = sum(c[0] for c in kernels.values())
        k_ops = sum(c[1] for c in kernels.values())
        t_ops = flops / gemm_peak + k_ops / PEAK_F32_FLOP_PER_S
        t_bytes = k_bytes / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        row = dict(step=name, b=b, n=n, gemm_flops=flops, kernels=kernels, kernel_bytes=k_bytes,
                   kernel_ops=k_ops, ms=best * 1e3, bound_ms=bound_ms, bound_by=by,
                   card=where)
        rows.append(row)
        print(f"roofline {name} B={b} x {n}: GEMMs {flops / 1e9:.2f} GFLOP "
              f"({'bf16' if bf16 else 'f32'} peak {gemm_peak / 1e12:.0f} TFLOP/s: "
              f"{flops / gemm_peak * 1e3:.4f} ms); kernels 1-4c "
              + ", ".join(f"{k} {c[0] / 1e6:.2f} MB {c[1] / 1e9:.3f} GOP"
                          for k, c in kernels.items() if c != (0, 0))
              + f" ({k_bytes / 1e9:.3f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s: "
              f"{t_bytes * 1e3:.4f} ms; {k_ops / 1e9:.3f} GOP at f32 "
              f"{PEAK_F32_FLOP_PER_S / 1e12:.0f} TFLOP/s: {k_ops / PEAK_F32_FLOP_PER_S * 1e3:.4f} "
              f"ms); bound {bound_ms:.4f} ms by {by}; measured {best * 1e3:.3f} ms a step "
              f"(best of {repeats}), {bound_ms / (best * 1e3):.2%} of it [{where}]", flush=True)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="roofline")
    p.add_argument("b", nargs="?", type=int, default=16)
    p.add_argument("n", nargs="?", type=int, default=10240)
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main(a.b, a.n, a.device)
