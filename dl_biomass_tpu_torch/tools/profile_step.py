"""Per-operator device profile of the production train, eval and engine steps
(port of the JAX package's ``tools/profile_step.py``).

A ``torch.profiler`` window (``utils/profiling.trace``, which also writes the
Chrome trace) of ``steps`` steps, each ended by a synchronisation, after one
warm-up step; the device's kernels are summed by name and the operators by
the device time their own kernels take. Prints ms a step of wall (host
clock) and of device time busy, the kernels and the top operators, with the
card and its power limit. On the CPU the operators' own CPU time stands in
for the device's.

    python -m dl_biomass_tpu_torch.tools.profile_step [train|eval|engine] [B] [N]
        [--fused-sa] [--logdir DIR] [--device cpu]

``--fused-sa`` profiles the ``fused_sa`` model (kernel 6), as the JAX tool's
``PROFILE_FUSED_SA=1`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from collections import defaultdict

import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import card, flagship, sync
from dl_biomass_tpu_torch.utils.profiling import trace

STEPS = 6
MODES = ("train", "eval", "engine")
TOP = 12


def step_fn(which: str, trainer, batch):
    """One step of ``which``: a training step, the module's eval forward, or
    the default serving engine's forward."""
    if which == "train":
        gen = torch.Generator(device=batch.pos.device).manual_seed(1)
        return lambda: trainer.step(batch, gen)
    if which == "eval":
        return lambda: trainer._eval_batch(batch)
    if which == "engine":
        from dl_biomass_tpu_torch.models.inference import compile_inference

        serve = compile_inference(trainer.model, batch.pos.device)
        return lambda: serve(batch)
    raise ValueError(f"unknown step {which!r}; options: {MODES}")


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def aggregate(prof, steps: int, on_device: bool):
    """(busy ms a step, kernels [(name, ms a step, calls a step)], operators
    [(name, ms a step)]): the device's kernels by name, and each operator's
    own device time (its own CPU time on the CPU)."""
    from torch.autograd import DeviceType

    kernels, calls = defaultdict(float), defaultdict(int)
    if on_device:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels[e.name] += e.time_range.end - e.time_range.start
                calls[e.name] += 1
    ops = {}
    for e in prof.key_averages():
        us = _device_us(e) if on_device else e.self_cpu_time_total
        if us and e.device_type == DeviceType.CPU:
            ops[e.key] = ops.get(e.key, 0.0) + us
    busy = sum(kernels.values()) if on_device else sum(ops.values())
    by_kernel = sorted(((k, us / steps / 1e3, calls[k] // steps) for k, us in kernels.items()),
                       key=lambda r: -r[1])
    by_op = sorted(((k, us / steps / 1e3) for k, us in ops.items()), key=lambda r: -r[1])
    return busy / steps / 1e3, by_kernel, by_op


def main(which: str = "train", b: int = 16, n: int = 10240, fused_sa: bool = False,
         device=None, steps: int = STEPS, logdir=None) -> dict:
    """Profile ``steps`` steps of ``which`` at ``b`` x ``n``; prints the
    profile and returns it."""
    dev = resolve_device(device)
    trainer, batch = flagship(b, n, dev, fused_sa=fused_sa)
    step = step_fn(which, trainer, batch)
    step()
    sync(dev)
    with contextlib.ExitStack() as stack:
        out_dir = logdir or stack.enter_context(tempfile.TemporaryDirectory())
        with trace(out_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
                sync(dev)
            wall = (time.perf_counter() - t0) / steps * 1e3
    on_device = dev.type == "cuda"
    busy, kernels, ops = aggregate(prof, steps, on_device)
    where = card(dev)
    what = "device" if on_device else "CPU (the operators' own time)"
    print(f"profile_step {which}{' fused_sa' if fused_sa else ''} B={b} x {n}: {wall:.3f} ms a "
          f"step of wall, {busy:.3f} ms a step busy on the {what} over {steps} steps "
          f"[{where}]", flush=True)
    for name, ms, k in kernels[:TOP]:
        print(f"  kernel {ms:9.4f} ms/step  x{k:<4d} {name[:100]}", flush=True)
    for name, ms in ops[:TOP]:
        print(f"  op     {ms:9.4f} ms/step  {name[:100]}", flush=True)
    return dict(step=which, b=b, n=n, fused_sa=fused_sa, wall_ms=wall, busy_ms=busy,
                kernels=kernels, ops=ops, card=where)


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="profile_step")
    p.add_argument("which", nargs="?", default="train", choices=MODES)
    p.add_argument("b", nargs="?", type=int, default=16)
    p.add_argument("n", nargs="?", type=int, default=10240)
    p.add_argument("--fused-sa", action="store_true", help="the fused_sa model (kernel 6)")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--logdir", default=None, help="keep the Chrome trace here")
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main(a.which, a.b, a.n, a.fused_sa, a.device, a.steps, a.logdir)
