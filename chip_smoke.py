#!/usr/bin/env python3
"""Drive the PyTorch port (``dl_biomass_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. card    — the card's name and power limit; build of ``csrc/*.cu`` (timed).
2. kernels — each CUDA kernel at the inputs one serving forward of a
             16 x 10240-point request gives it, held against its plain PyTorch
             version on the card (index-exact selection, bit-identical
             captured planes and gather) and timed with CUDA events (median
             of 25 launches), beside its bound and, where one PyTorch call
             computes the same function, that call's time.
3. serve   — the full-width production ``PointNet2Regressor`` (bf16,
             fast_group, fast_fps, split_first_layer; seeded random weights
             and non-trivial BatchNorm statistics) behind ``compile_inference``
             answers 16 x 10240, 36 x 10240, a partial request of 5 clouds of
             7000-10240 points, the first request again, the partial one
             with garbage in its pad rows, and 24 and 28 x 7168. The launch counts of that run, the
             repeat and pad invariance, agreement with the same forward on the
             plain versions and with the unfolded module, and ms per batch.
4. summary — one JSON line of the kernels, the card line, and as the last
             line ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without a card, or when the package is
not beside this script.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory rate and float32 outside
# the tensor cores — the type of every kernel's arithmetic here
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
FPS_FLOPS_PER_POINT_STEP = 9  # t: 3 mul + 2 add; d: mul, sub, add; running min
DIST_TEST_FLOPS = 8  # 3 sub, 3 mul, 2 add
BF16_SERVE_RTOL = 1e-2  # kernel vs plain forward: max |diff| / max |y|
FOLDED_VS_MODULE_RTOL = 5e-2  # folded serving vs unfolded module, both bf16
REPS = 25
SERVE_REPS = 10
# requests: B=SMALL and B=LARGE clouds of N_POINTS, and PARTIAL clouds of
# PARTIAL_LO..N_POINTS points padded to N_POINTS
N_POINTS, SMALL, LARGE, PARTIAL, PARTIAL_LO = 10240, 16, 36, 5, 7000
# and the batches that faulted the JAX package's eval graph on a TPU
# (docs/DESIGN.md section 9): B=24 and B=28 of SHORT_POINTS; their centroid
# counts (1434 and 359) are no multiple of any kernel's tile
SHORT_POINTS, FAULT_BATCHES = 7168, (24, 28)
EXPECTED_PER_FORWARD = {"dlbt_fps": 2, "dlbt_ball_group": 1, "dlbt_ball_query": 1,
                        "dlbt_gather": 1}  # launches of each kernel per serving forward


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls of ``fn``."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def synthetic_batch(num: int, n_points: int, seed: int, device, sizes=None):
    """Requests from the synthetic generator, padded to ``n_points``; ``sizes``
    cuts cloud i to its first sizes[i] points (a random subset: the generator
    permutes points)."""
    from dl_biomass_tpu_torch.core.cloud import CloudBatch
    from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset

    pos, feat, y, _ = synthetic_dataset(num, n_points, seed=seed)
    if sizes is not None:
        pos = [p[:s] for p, s in zip(pos, sizes)]
        feat = [f[:s] for f, s in zip(feat, sizes)]
    return CloudBatch.from_numpy(pos, feat, y, capacity=n_points, device=device)


def seeded_model(device, seed: int = 0):
    """The production model with weights from a seeded ``torch.Generator``:
    torch-default Linear ranges and BatchNorm affine + running statistics away
    from identity, so that folding does real work."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.layers import Dense, MaskedBatchNorm
    from dl_biomass_tpu_torch.models.pointnet2 import build_model

    model = build_model(TrainConfig(), num_features=1)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                bnd = 1.0 / math.sqrt(mod.in_features)
                mod.weight.uniform_(-bnd, bnd, generator=g)
                mod.bias.uniform_(-bnd, bnd, generator=g)
            elif isinstance(mod, MaskedBatchNorm):
                c = mod.weight.numel()
                mod.weight.copy_(0.5 + torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return model.to(device)


def kernel_sites():
    """(module, wrapper name, plain version name) of each kernel of the path."""
    from dl_biomass_tpu_torch.ops import (ball_group_kernel, ball_query_kernel, fps_kernel,
                                          gather_kernel)

    return [(fps_kernel, "fps_rows", "fps_rows_plain"),
            (ball_group_kernel, "ball_group", "ball_group_plain"),
            (ball_query_kernel, "ball_query_first_k", "ball_query_plain"),
            (gather_kernel, "gather_rows", "gather_rows_plain")]


def record_kernel_inputs(serve, batch):
    """Run one forward with recording wrappers: each kernel's arguments as the
    main path gives them."""
    calls = {name: [] for _, name, _ in kernel_sites()}

    def recorder(module, name):
        real = getattr(module, name)

        def rec(*args, **kwargs):
            calls[name].append((args, kwargs))
            return real(*args, **kwargs)
        return rec

    with ExitStack() as stack:
        for module, name, _ in kernel_sites():
            stack.enter_context(mock.patch.object(module, name, recorder(module, name)))
        serve(batch)
    return calls


def plain_versions():
    """Patches that put each kernel's plain version in its wrapper's place."""
    return [mock.patch.object(module, name, getattr(module, plain))
            for module, name, plain in kernel_sites()]


def bucket_scan_lengths(centers, cmask, pos, mask, r2, chunk=128):
    """Distance tests the ball-group kernel's data needs: per valid centroid
    and residue g, the points g, g+128, ... up to the first in-radius one."""
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


def check_kernels(calls, device):
    """Phase 2: each kernel against its plain version, timed, with its bound."""
    from dl_biomass_tpu_torch.ops import (ball_group_kernel, ball_query_kernel, fps_kernel,
                                          gather_kernel)

    rows = []

    # kernel 1: FPS, two launches per forward (SA1, SA2); its row sums both
    fps_calls = calls["fps_rows"]
    require(len(fps_calls) == 2, f"expected 2 FPS launches per forward, saw {len(fps_calls)}")
    ms = plain_ms = nbytes = flops = err = 0.0
    for (args, kwargs) in fps_calls:
        pos, mask, starts, k = args
        got = fps_kernel.fps_rows(pos, mask, starts, k)
        want = fps_kernel.fps_rows_plain(pos, mask, starts, k)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"FPS kernel differs from plain at {tuple(pos.shape)}")
        err = max(err, max_abs_err(got, want))
        r, n, _ = pos.shape
        t = time_ms(lambda: fps_kernel.fps_rows(pos, mask, starts, k))
        tp = time_ms(lambda: fps_kernel.fps_rows_plain(pos, mask, starts, k))
        cb = r * n * 13 + r * 4 + r * k * 4
        cf = r * n * 5 + r * (k - 1) * n * FPS_FLOPS_PER_POINT_STEP
        print(f"kernel fps rows={r} n={n} k={k}: {t:.4f} ms, plain {tp:.4f} ms, "
              f"bound {bound(cb, cf)[0]:.6f} ms, index-exact", flush=True)
        ms, plain_ms, nbytes, flops = ms + t, plain_ms + tp, nbytes + cb, flops + cf
    bms, by = bound(nbytes, flops)
    rows.append(dict(name="fps", source="dl_biomass_tpu_torch/csrc/fps.cu",
                     replaces="dl_biomass_tpu/ops/pallas_fps.py:127", entry="dlbt_fps",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                     bound_by=by, library_ms=None))

    # kernel 2: stratified ball group
    (args, kwargs), = calls["ball_group"]
    centers, cmask, pos, mask, feat = args
    radius, out_dtype = kwargs["radius"], kwargs["out_dtype"]
    err = 0.0
    for dt in (out_dtype, torch.float32):
        for need_idx in (False, True):
            got = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, radius=radius,
                                               out_dtype=dt, need_idx=need_idx)
            want = ball_group_kernel.ball_group_plain(centers, cmask, pos, mask, feat,
                                                      radius=radius, out_dtype=dt,
                                                      need_idx=need_idx)
            torch.cuda.synchronize()
            require(torch.equal(got[1], want[1]), "ball group: selection masks differ")
            if need_idx:
                require(torch.equal(got[0], want[0]), "ball group: indices differ")
            require(same_bits(got[2], want[2]), f"ball group: {dt} planes differ in bits")
            err = max(err, max_abs_err(got[2], want[2]))

    def bg():
        return ball_group_kernel.ball_group(*args, **kwargs)

    def bg_plain():
        return ball_group_kernel.ball_group_plain(*args, **kwargs)

    t, tp = time_ms(bg), time_ms(bg_plain)
    b, m, _ = centers.shape
    n, f = pos.shape[1], feat.shape[-1]
    tests = bucket_scan_lengths(centers, cmask, pos, mask, ball_group_kernel._radius2(radius))
    esize = torch.empty((), dtype=out_dtype).element_size()
    bms, by = bound(b * n * (12 + 4 * f + 1) + b * m * 13 + b * m * 64 * ((f + 3) * esize + 1),
                    tests * DIST_TEST_FLOPS)
    print(f"kernel ball_group B={b} M={m} N={n} F={f} {out_dtype}: {t:.4f} ms, plain "
          f"{tp:.4f} ms, bound {bms:.6f} ms ({tests} distance tests), selection index-exact, "
          f"planes bit-identical (bf16 and f32)", flush=True)
    rows.append(dict(name="ball_group", source="dl_biomass_tpu_torch/csrc/ball_group.cu",
                     replaces="dl_biomass_tpu/ops/pallas_group.py:139", entry="dlbt_ball_group",
                     max_abs_err=err, ms=t, plain_ms=tp, bound_ms=bms, bound_by=by,
                     library_ms=None))

    # kernel 3: exact ball query
    (args, kwargs), = calls["ball_query_first_k"]
    got = ball_query_kernel.ball_query_first_k(*args, **kwargs)
    want = ball_query_kernel.ball_query_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "ball query kernel differs from plain")
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    t = time_ms(lambda: ball_query_kernel.ball_query_first_k(*args, **kwargs))
    tp = time_ms(lambda: ball_query_kernel.ball_query_plain(*args, **kwargs))
    centers, cmask, pos, mask = args
    k = kwargs["k"]
    b, m, _ = centers.shape
    n = pos.shape[1]
    idx, nbr = want
    scan = torch.where(nbr[..., k - 1], idx[..., k - 1].long() + 1, torch.full_like(
        idx[..., k - 1], n, dtype=torch.long))
    tests = int((scan * cmask).sum())
    bms, by = bound(b * n * 13 + b * m * 13 + b * m * k * 5, tests * DIST_TEST_FLOPS)
    print(f"kernel ball_query B={b} M={m} N={n} K={k}: {t:.4f} ms, plain {tp:.4f} ms, "
          f"bound {bms:.6f} ms ({tests} distance tests), index-exact", flush=True)
    rows.append(dict(name="ball_query", source="dl_biomass_tpu_torch/csrc/ball_query.cu",
                     replaces="dl_biomass_tpu/ops/pallas_ballquery.py:142",
                     entry="dlbt_ball_query", max_abs_err=err, ms=t, plain_ms=tp,
                     bound_ms=bms, bound_by=by, library_ms=None))

    # kernel 4: row gather
    (args, kwargs), = calls["gather_rows"]
    values, idx = args
    got = gather_kernel.gather_rows(values, idx)
    want = gather_kernel.gather_rows_plain(values, idx)
    b_ar = torch.arange(values.shape[0], device=device)[:, None, None]
    lib = values[b_ar, idx.long()]
    torch.cuda.synchronize()
    require(same_bits(got, want), "gather kernel differs from plain in bits")
    require(same_bits(got, lib), "gather kernel differs from advanced indexing in bits")
    idx_l = idx.long()
    t = time_ms(lambda: gather_kernel.gather_rows(values, idx))
    tp = time_ms(lambda: gather_kernel.gather_rows_plain(values, idx))
    tl = time_ms(lambda: values[b_ar, idx_l])
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    bms, by = bound(b * m * k * c * es + b * m * k * 4 + b * n * c * es, 0)
    print(f"kernel gather B={b} N={n} C={c} M={m} K={k} {values.dtype}: {t:.4f} ms, plain "
          f"{tp:.4f} ms, library (values[b, idx]) {tl:.4f} ms, bound {bms:.6f} ms, "
          f"bit-identical", flush=True)
    rows.append(dict(name="gather", source="dl_biomass_tpu_torch/csrc/gather.cu",
                     replaces="dl_biomass_tpu/ops/pallas_mxu_gather.py:191",
                     entry="dlbt_gather", max_abs_err=max_abs_err(got, want), ms=t,
                     plain_ms=tp, bound_ms=bms, bound_by=by, library_ms=tl))
    return rows


def serve_timing(serve, batch, reps: int = SERVE_REPS) -> float:
    """Median ms per batch: host clock around a forward ending in a synchronize."""
    for _ in range(2):
        serve(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        serve(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_serve(serve, batch, forwards: int = 3):
    """Device time per forward over a short window of forwards (torch.profiler):
    the wall time, the device's busy time, and the busy time by kernel and by
    the PyTorch operator that launched it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        serve(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            serve(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def table(device_type):
        rows = [(e.key, e.self_device_time_total / 1e3 / forwards, e.count // forwards)
                for e in events if e.device_type == device_type and e.self_device_time_total > 0]
        return sorted(rows, key=lambda r: r[1], reverse=True)

    kernels = table(torch.autograd.DeviceType.CUDA)
    busy_ms = sum(ms for _, ms, _ in kernels)
    return wall_ms / forwards, busy_ms, kernels, table(torch.autograd.DeviceType.CPU)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import dl_biomass_tpu_torch
    except ImportError:
        print("chip_smoke: the package dl_biomass_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    if Path(dl_biomass_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: dl_biomass_tpu_torch was imported from elsewhere", file=sys.stderr)
        return 1
    from dl_biomass_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # phase 1: card and build
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {len(list(_build.CSRC_DIR.glob('*.cu')))} sources -> {so.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kernels = run(torch.device("cuda"), card)

    # phase 4: summary
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(device, card: str) -> list:
    """Phases 2 and 3; returns the kernels' summary rows."""
    n_points, small, large, partial, partial_lo = N_POINTS, SMALL, LARGE, PARTIAL, PARTIAL_LO
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import _build

    # phase 2: kernels at the inputs of one serving forward (B=16 x 10240)
    model = seeded_model(device)
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == 953_732, f"model has {n_params} parameters, not 953,732")
    serve = compile_inference(model, device)
    req16 = synthetic_batch(small, n_points, seed=1, device=device)
    calls = record_kernel_inputs(serve, req16)
    rows = check_kernels(calls, device)

    # phase 3: serve, with every launch of the main path counted
    req36 = synthetic_batch(large, n_points, seed=2, device=device)
    sizes = np.random.default_rng(3).integers(partial_lo, n_points + 1, size=partial)
    part = synthetic_batch(partial, n_points, seed=3, device=device, sizes=sizes)
    pad = ~part.mask
    garbage = synthetic_batch(partial, n_points, seed=3, device=device, sizes=sizes)
    noise = torch.Generator(device=device).manual_seed(7)
    garbage.pos[pad] = 1e4 * torch.rand(int(pad.sum()), 3, device=device, generator=noise)
    garbage.feat[pad] = -1e4 * torch.rand(int(pad.sum()), 1, device=device, generator=noise)

    faults = [synthetic_batch(b, SHORT_POINTS, seed=4 + i, device=device)
              for i, b in enumerate(FAULT_BATCHES)]
    requests = [req16, req36, part, req16, garbage] + faults

    _build.launch_counts.clear()
    outs = [serve(r) for r in requests]
    torch.cuda.synchronize()
    launches = {name: _build.launch_counts[name] for name in EXPECTED_PER_FORWARD}
    forwards = len(outs)
    for name, per in EXPECTED_PER_FORWARD.items():
        require(launches[name] == per * forwards,
                f"{name}: {launches[name]} launches in {forwards} forwards, "
                f"expected {per * forwards}")
    print(f"serve launches over {forwards} forwards: {launches}", flush=True)
    for out, req in zip(outs, requests):
        b = req.pos.shape[0]
        require(tuple(out.shape) == (b, 4), f"output shape {tuple(out.shape)} != ({b}, 4)")
        require(bool(torch.isfinite(out).all()), "non-finite prediction")
    require(torch.equal(outs[0], outs[3]), "a repeated request gave another answer")
    require(torch.equal(outs[2], outs[4]), "garbage in pad rows changed the predictions")
    print(f"serve: shapes (B, 4), finite, also at B={FAULT_BATCHES} x {SHORT_POINTS}; "
          "repeated request identical; pad garbage leaves predictions identical", flush=True)

    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        plain = [serve(req16), serve(faults[0])]
    rel_plain = max(float((p - o).abs().max()) / float(o.abs().max())
                    for p, o in zip(plain, (outs[0], outs[5])))
    require(rel_plain <= BF16_SERVE_RTOL,
            f"kernel vs plain forward: rel {rel_plain} > {BF16_SERVE_RTOL}")
    scale = float(outs[0].abs().max())
    with torch.inference_mode():
        module16 = model(req16)
    rel_module = float((module16 - outs[0]).abs().max()) / scale
    require(rel_module <= FOLDED_VS_MODULE_RTOL,
            f"folded serving vs module forward: rel {rel_module} > {FOLDED_VS_MODULE_RTOL}")
    print(f"serve vs plain-version forward on the card (B={small} x {n_points} and "
          f"B={FAULT_BATCHES[0]} x {SHORT_POINTS}): max|diff|/max|y| = {rel_plain:.3e} "
          f"(bound {BF16_SERVE_RTOL}); vs unfolded module forward: {rel_module:.3e} "
          f"(bound {FOLDED_VS_MODULE_RTOL})", flush=True)

    wall, busy, by_kernel, by_op = profile_serve(serve, req16)
    if busy > 0:
        print(f"profile B={small}: {busy:.3f} ms of device time in {wall:.3f} ms per forward "
              f"under the profiler (device idle {1 - busy / wall:.1%})", flush=True)
        for title, table in (("by kernel", by_kernel[:10]), ("by operator", by_op[:12])):
            print(f"profile {title}:", flush=True)
            for name, ms, count in table:
                print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{count:<3d} {name[:100]}", flush=True)
    else:
        print("profile: the profiler recorded no device time (not measured)", flush=True)

    for req in [req16, req36] + faults:
        b, n = req.pos.shape[:2]
        torch.cuda.reset_peak_memory_stats()
        ms = serve_timing(serve, req)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serve B={b} x {n}: {ms:.3f} ms/batch, {b / ms * 1e3:.1f} clouds/s, "
              f"peak {peak:.2f} GiB [{card}]", flush=True)

    kernels = []
    for r in rows:
        w = r.pop("entry")
        kernels.append(dict(name=r["name"], route="cuda", source=r["source"],
                            replaces=r["replaces"], launches=launches[w],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
