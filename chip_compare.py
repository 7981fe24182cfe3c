#!/usr/bin/env python3
"""Comparisons of kernels 6 (the fused SA MLP), 5, 1 (FPS), 2 (ball group),
4b (the gather's scatter-add backward) and 3 (exact ball query) on one NVIDIA
card, beside
``chip_smoke.py``, whose helpers it uses:

    python3 chip_compare.py time TAG      # one line: the CUDA-core forward passes
                                          # F1-F3 (bf16 and f32) at the inputs of one
                                          # 16 x 10240 train-mode forward and the bf16
                                          # passes as the tree routes them, the f32
                                          # backward passes (ELU) at one step's, kernel
                                          # 5 at one fused_eval forward's (wrapper,
                                          # kernel alone, and where the tree has them
                                          # its occupancy and selection-only time), that
                                          # engine's ms per batch, and the fused_sa
                                          # step's ms at B=16 and 36
    python3 chip_compare.py outputs FILE  # the f32 passes' outputs at the inputs of
                                          # one f32 step (B=4 x 10240), saved
    python3 chip_compare.py same A B      # two such files, bit for bit
    python3 chip_compare.py steps         # the fused_sa step on the kernels against
                                          # the plain versions, bf16 and f32, by
                                          # neuron_multiplier and batch (no bounds)
    python3 chip_compare.py acts          # the bf16 backward passes at SA2 of a step
                                          # at neuron_multiplier 2 and 3 against their
                                          # plain versions, with ReLU and with ELU
    python3 chip_compare.py fps TAG       # kernel 1 (FPS) at every shape of
                                          # chip_smoke.FPS_SHAPES: its registers and
                                          # spills (nvcc -Xptxas -v), blocks per SM,
                                          # and chip_smoke.time_fps's times
    python3 chip_compare.py paths TAG     # device time per call (and kernels 1's, 2's, 3's
                                          # and 4b's part) of serve, serve_fused_eval and
                                          # eval_fused_sa at B=16 x 10240, train and
                                          # train_fused_sa steps at 16 x 10240 and a train
                                          # step at 36 x 7168, beside each one's wall time
    python3 chip_compare.py fpstune TAG   # kernel 1 at the sectored shapes under other
                                          # plans: P_MAX (block rows) and
                                          # ROWS_PER_WARP_BLOCK (one-warp rows) swept
    python3 chip_compare.py group TAG     # kernel 2 (ball group) at every shape the
                                          # paths give it (chip_smoke.GROUP_SHAPES), bf16
                                          # and f32 out: its ptxas report, blocks per SM,
                                          # events, CUDA-graph and profiler times, the
                                          # lane-tests issued beside the tests the data
                                          # needs, and its scan-only and full-scan
                                          # instantiations where the tree has them
    python3 chip_compare.py grouptune TAG # kernel 2 at those shapes (bf16 out) under
                                          # every plan its instantiations take:
                                          # centroids a block, points a thread a chunk
    python3 chip_compare.py scatter TAG   # kernel 4b (the gather's scatter-add
                                          # backward) at the inputs a training step
                                          # gives it at 16 and 36 x 10240, and the
                                          # unsplit model's at 16 x 10240: its ptxas
                                          # report, bit-exactness, events and CUDA-graph
                                          # times beside index_add_, each of its
                                          # launches alone and with the pad slots
                                          # taken out where the tree has its probe, the
                                          # segment lengths; then kernels 3, 4a and 4c
                                          # by graph at one 16 x 10240 forward's inputs
    python3 chip_compare.py eval5 TAG     # kernel 5 at every width the fused_eval
                                          # engine serves (neuron_multiplier 1, 2, 3;
                                          # bf16 and f32) at one 16 x 10240 forward's
                                          # inputs: against its plain version, by CUDA
                                          # graph, with its launch (blocks per SM)
    python3 chip_compare.py query TAG     # kernel 3 (exact ball query) at every shape of
                                          # chip_smoke.QUERY_SHAPES: its ptxas report, then
                                          # chip_smoke.time_query's events, CUDA-graph and
                                          # profiler times, the transpose copy alone, the
                                          # full-scan instantiation, the scan lengths the
                                          # data needs and the bound
    python3 chip_compare.py querytune TAG # kernel 3 at those shapes under other plans:
                                          # warps and centroids a block and chunks
                                          # tested ahead (whole clouds), warps, points
                                          # a chunk and chunks ahead (chunked), by
                                          # CUDA graph
    python3 chip_compare.py querylat TAG  # kernel 3's scan latency: one block of
                                          # 32 warps, one cloud of 2048 or 10240
                                          # points, every centroid scanning all of
                                          # it with no hit, or with a hit in every
                                          # lane (full scan), beside the staging alone

To compare two commits on one card, unpack the other commit (``git archive``)
into a directory, copy this script beside its ``chip_smoke.py`` (for ``fps``
and ``paths``, this ``chip_smoke.py`` too: ``fps`` reads its FPS_SHAPES), and
run the command from each root in turns (other, this, this, other).
It needs a card and fails without one.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent


def _setup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from dl_biomass_tpu_torch.ops import _build

    _build.build()
    return chip_smoke, torch.device("cuda")


def time_passes(tag: str) -> None:
    """CUDA-core F1-F3 at SA1 and SA2 (``mma_takes`` patched to refuse where
    the tree has it) and B1-B3 in f32 with ELU, CUDA events, median of 20; the
    step, host clock, median of 10 after 2."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6
    from dl_biomass_tpu_torch.train.trainer import Trainer

    model = cs.seeded_model(dev, fused_sa=True)
    batch = cs.synthetic_batch(16, 10240, seed=1, device=dev)
    with torch.no_grad():
        calls = cs.record_kernel_inputs(
            lambda b: model(b, train=True, generator=cs.train_gen(dev, 0)), batch)["fused_sa_stage"]
    cores = (mock.patch.object(k6, "mma_takes", lambda *widths: False)
             if hasattr(k6, "mma_takes") else mock.MagicMock())
    out = []
    with cores:
        for i, ((stage, *args), kw) in enumerate(calls):
            kw = {k: v for k, v in kw.items() if k != "packed"}
            for bf16 in (True, False):
                a = list(args)
                if not bf16 and a[0] is not None:
                    a[0] = a[0].float()
                kwb = dict(kw, bf16=bf16)
                ms = cs.time_ms(lambda: k6.fused_sa_stage(stage, *a, **kwb), reps=20, warmup=3)
                out.append(f"F{stage} {'SA1' if i < 3 else 'SA2'} {'bf16' if bf16 else 'f32'} "
                           f"{ms:.4f}")
    for i, ((stage, *args), kw) in enumerate(calls):  # bf16 as routed, the forward's block
        source = (k6.pass_source(stage, False, 0 if args[0] is None else args[0].shape[-1],
                                 args[1].shape[-1], args[3], True)
                  if hasattr(k6, "pass_source") else "csrc/fused_sa_fwd.cu")
        ms = cs.time_ms(lambda: k6.fused_sa_stage(stage, *args, **kw), reps=20, warmup=3)
        out.append(f"F{stage} {'SA1' if i < 3 else 'SA2'} bf16 routed ({source}) {ms:.4f}")
    trainer = Trainer(cs.seeded_model(dev, fused_sa=True), TrainConfig(), dev)
    bwd = cs.record_kernel_inputs(lambda b: trainer.step(b, cs.train_gen(dev, 0)),
                                  batch)["fused_sa_bwd_stage"]
    for i, ((stage, dense, *args), kw) in enumerate(bwd):  # SA2's backward first
        kw = dict({k: v for k, v in kw.items() if k != "packed"}, bf16=False, act="ELU")
        dense = None if dense is None else dense.float()
        ms = cs.time_ms(lambda: k6.fused_sa_bwd_stage(stage, dense, *args, **kw), reps=20,
                        warmup=3)
        out.append(f"B{stage} {'SA2' if i < 3 else 'SA1'} f32 {ms:.4f}")
    out += kernel5(cs, dev)
    for b in (16, 36):
        steps_batch = cs.synthetic_batch(b, 10240, seed=20, device=dev)
        gen = cs.train_gen(dev, 5)
        times = []
        for _ in range(12):
            t0 = time.perf_counter()
            trainer.step(steps_batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(f"step B={b} {statistics.median(times[2:]):.3f}")
    print(f"{tag} [{cs.card_line()}]: " + " | ".join(out), flush=True)


def kernel5(cs, dev) -> list:
    """Kernel 5 at the inputs one fused_eval forward at 16 x 10240 gives it: the
    wrapper as the engine calls it (CUDA events, median of 20), the kernel alone
    (torch.profiler), and where the tree has them the wrapper packing for
    itself, the occupancy and the selection-only instantiation; then the
    engine's ms per batch (host clock, median of 10)."""
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import sa_eval_kernel as k5

    serve = compile_inference(cs.seeded_model(dev), dev, fused_eval=True)
    req = cs.synthetic_batch(16, 10240, seed=1, device=dev)
    (args, kw), = cs.record_kernel_inputs(serve, req)["sa1_fused_eval"]
    out = [f"K5 {cs.time_ms(lambda: k5.sa1_fused_eval(*args, **kw), reps=20):.4f}",
           f"K5 alone {cs.kernel_alone_ms(lambda: k5.sa1_fused_eval(*args, **kw), 'sa1_'):.4f}"]
    if "packed" in kw:
        unpacked = {k: v for k, v in kw.items() if k != "packed"}
        out.append(f"K5 packing per call "
                   f"{cs.time_ms(lambda: k5.sa1_fused_eval(*args, **unpacked), reps=20):.4f}")
    if hasattr(k5, "occupancy"):
        widths = [w.shape[1] for w in args[5][0::2]]
        occ = k5.occupancy(kw["bf16"], *(-(-w // 64) * 64 for w in widths))
        out.append(f"K5 occupancy {occ}")
    if hasattr(k5, "selection_only"):
        sel = {k: v for k, v in kw.items() if k != "out_dtype"}
        out.append(f"K5 selection only "
                   f"{cs.time_ms(lambda: k5.selection_only(*args, **sel), reps=20):.4f}")
    out.append(f"serve_fused_eval B=16 {cs.serve_timing(serve, req):.3f}")
    return out


def save_outputs(path: str) -> None:
    """Every f32 pass of one f32 step (ELU), at the inputs it recorded, with
    the sum of those inputs beside each, saved with torch.save."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6
    from dl_biomass_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cs.seeded_model(dev, fused_sa=True, compute_dtype="float32",
                                      activation="ELU"), TrainConfig(), dev)
    batch = cs.synthetic_batch(4, 10240, seed=40, device=dev)
    calls = cs.record_kernel_inputs(lambda b: trainer.step(b, cs.train_gen(dev, 1)), batch)
    out = {}
    for name, fn in (("fused_sa_stage", k6.fused_sa_stage),
                     ("fused_sa_bwd_stage", k6.fused_sa_bwd_stage)):
        for i, (args, kw) in enumerate(calls[name]):
            got = fn(*args, **{k: v for k, v in kw.items() if k != "packed"})
            out[f"{name} {i}"] = (
                sum(float(a.detach().double().sum()) for a in args if isinstance(a, torch.Tensor)),
                [None if x is None else x.detach().cpu() for x in got])
    torch.save(out, path)
    print(f"saved {len(out)} passes to {path}", flush=True)


def same(path_a: str, path_b: str) -> None:
    """Raise unless the two files hold the same inputs and bit-identical outputs."""
    a, b = torch.load(path_a), torch.load(path_b)
    if sorted(a) != sorted(b):
        raise SystemExit(f"chip_compare: the files hold other passes: {sorted(a)} {sorted(b)}")
    for key in sorted(a):
        (in_a, out_a), (in_b, out_b) = a[key], b[key]
        if in_a != in_b:
            raise SystemExit(f"chip_compare: {key}: the inputs differ ({in_a} vs {in_b})")
        for j, (x, y) in enumerate(zip(out_a, out_b)):
            if x is None:
                continue
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise SystemExit(f"chip_compare: {key} output {j}: max|diff| "
                                 f"{float((x.double() - y.double()).abs().max())}")
        print(f"{key}: inputs equal, {sum(x is not None for x in out_a)} outputs bit-identical",
              flush=True)
    print("all passes bit-identical", flush=True)


def steps() -> None:
    """A fused_sa step on the kernels and on the plain versions from one state
    and seed: loss and per-gradient relative L2 (the biases whose true
    gradient is 0 left out), by neuron_multiplier, batch and type."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    for nm, b, bf16, seed in ((1, 4, True, 7), (1, 16, True, 7), (2, 4, True, 7), (2, 16, True, 7),
                              (3, 4, True, 7), (3, 16, True, 7), (2, 4, False, 7),
                              (3, 4, False, 7), (2, 16, False, 7), (3, 16, False, 7),
                              (1, 4, True, 8), (2, 4, True, 8)):
        kw = {} if bf16 else dict(compute_dtype="float32", activation="ELU")
        trainer = Trainer(cs.seeded_model(dev, fused_sa=True, neuron_multiplier=nm, **kw),
                          TrainConfig(), dev)
        batch = cs.synthetic_batch(b, 10240, seed=30 + nm, device=dev)
        (loss_k, g_k), (loss_p, g_p) = cs.kernel_and_plain_steps(trainer, batch, seed,
                                                                 restore=True)
        l2 = {k: float((g_k[k].double() - g_p[k].double()).norm()
                       / max(float(g_p[k].double().norm()), 1e-30))
              for k in g_p if not cs.zero_gradient(k)}
        worst = max(l2, key=l2.get)
        top = max(float(g.abs().max()) for g in g_p.values())
        moved = max(float((g_k[k].double() - g_p[k].double()).abs().max()) for k in g_p) / top
        print(f"x{nm} B={b} {'bf16' if bf16 else 'f32 (ELU)'} seed {seed}: loss rel "
              f"{abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)):.3e}, gradients rel L2 "
              f"at most {l2[worst]:.3e} ({worst}), median {statistics.median(l2.values()):.3e}; "
              f"max|diff| over the largest |g| {moved:.3e} [{cs.card_line()}]", flush=True)
        del trainer
        torch.cuda.empty_cache()


def acts() -> None:
    """SA2's bf16 backward passes at the inputs of one step of the fused_sa
    model at neuron_multiplier 2 and 3 (B=16 x 10240, the inputs of
    chip_smoke.py's phase 12), replayed with ReLU and with ELU: each output's
    max|diff| over the plain version's max|.|."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6
    from dl_biomass_tpu_torch.train.trainer import Trainer

    for nm in (2, 3):
        trainer = Trainer(cs.seeded_model(dev, fused_sa=True, neuron_multiplier=nm),
                          TrainConfig(), dev)
        batch = cs.synthetic_batch(16, 10240, seed=30 + nm, device=dev)
        calls = cs.record_kernel_inputs(lambda b: trainer.step(b, cs.train_gen(dev, 5)),
                                        batch)["fused_sa_bwd_stage"]
        for act in ("ReLU", "ELU"):
            for args, kw in calls[:3]:  # autograd runs SA2's backward first
                kw = dict({k: v for k, v in kw.items() if k != "packed"}, act=act)
                with torch.no_grad():
                    got = k6.fused_sa_bwd_stage(*args, **kw)
                    want = k6.fused_sa_bwd_stage_plain(*args, **kw)
                rel = [cs.rel_diff(g.float(), w.float()) for g, w in zip(got, want)
                       if w is not None]
                print(f"x{nm} SA2 B{args[0]} bf16 {act} on "
                      f"{k6.pass_source(args[0], True, args[1].shape[-1], args[2].shape[-1], args[4], True)}: "
                      f"max|diff| / max|plain| per output {', '.join(f'{r:.3e}' for r in rel)} "
                      f"[{cs.card_line()}]", flush=True)
        del trainer, calls
        torch.cuda.empty_cache()


def ptxas_lines(source: str) -> list:
    """What ``nvcc -Xptxas -v`` says of each kernel of one source: registers,
    shared memory, spills."""
    import subprocess
    import tempfile

    from dl_biomass_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              str(_build.CSRC_DIR / source), "-o", str(Path(tmp) / "k.o")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return [line.strip() for line in out.stdout.splitlines()
            if "Compiling entry" in line or "registers" in line or "spill" in line]


def fps(tag: str) -> None:
    """Kernel 1 at every shape of chip_smoke.FPS_SHAPES (chip_smoke.time_fps),
    with its blocks per SM at each, after its ptxas report."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import fps_kernel

    card = cs.card_line()
    for line in ptxas_lines("fps.cu"):
        print(f"{tag} ptxas: {line}", flush=True)
    serve = compile_inference(cs.seeded_model(dev), dev)
    for label, args in cs.fps_inputs(serve, dev):
        res = cs.time_fps(label, args, card)
        occ = fps_kernel.occupancy(res["n"]) if hasattr(fps_kernel, "occupancy") else None
        print(f"{tag} fps {label}: " + " ".join(f"{key}={val}" for key, val in res.items()
                                                if key != "label")
              + f" occupancy={occ} [{card}]", flush=True)


def fps_tune(tag: str) -> None:
    """Kernel 1 at the sectored shapes of chip_smoke.FPS_SHAPES under other
    values of ``fps_kernel.P_MAX`` (rows of more than one warp) and
    ``ROWS_PER_WARP_BLOCK`` (rows of one warp): index-exact against the plain
    version, then the graph replay's ms (chip_smoke.graph_ms)."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import fps_kernel

    card = cs.card_line()
    serve = compile_inference(cs.seeded_model(dev), dev)
    cases = [(label, args, fps_kernel.fps_rows_plain(*args))
             for label, args in cs.fps_inputs(serve, dev) if "SA" in label]
    for name, values in (("P_MAX", (4, 6, 8, 10, 12)), ("ROWS_PER_WARP_BLOCK", (1, 2, 4, 8))):
        for value in values:
            out = []
            with mock.patch.object(fps_kernel, name, value):
                for label, args, want in cases:
                    n = args[0].shape[1]
                    if (name == "P_MAX") == (fps_kernel.plan(n).path == "warp"):
                        continue
                    cs.require(torch.equal(fps_kernel.fps_rows(*args), want),
                               f"{name}={value}: kernel differs from plain at {label}")
                    ms = cs.graph_ms(lambda: fps_kernel.fps_rows(*args))
                    out.append(f"{label} {tuple(fps_kernel.plan(n))} {ms:.4f}")
            print(f"{tag} {name}={value}: " + " | ".join(out) + f" [{card}]", flush=True)


def group(tag: str) -> None:
    """Kernel 2 at every shape of chip_smoke.GROUP_SHAPES in bf16 and f32 out
    (chip_smoke.time_group), after its ptxas report."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference

    card = cs.card_line()
    for line in ptxas_lines("ball_group.cu"):
        print(f"{tag} ptxas: {line}", flush=True)
    serve = compile_inference(cs.seeded_model(dev), dev)
    for label, args, kwargs in cs.group_inputs(serve, dev):
        for out_dtype in (torch.bfloat16, torch.float32):
            res = cs.time_group(label, args, dict(kwargs, out_dtype=out_dtype), card)
            print(f"{tag} group {label} {res.pop('dtype')}: "
                  + " ".join(f"{key}={val}" for key, val in res.items() if key != "label")
                  + f" [{card}]", flush=True)


def group_tune(tag: str) -> None:
    """Kernel 2 at every shape of chip_smoke.GROUP_SHAPES (bf16 out, as the
    default engine runs it) under every plan of ``ball_group_kernel``'s
    instantiations: index-exact and bit-identical against the plain version,
    then the graph replay's ms (chip_smoke.graph_ms), with blocks per SM."""
    import itertools

    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import ball_group_kernel as k2

    card = cs.card_line()
    serve = compile_inference(cs.seeded_model(dev), dev)
    cases = [(label, args, kwargs, k2.ball_group_plain(*args, **kwargs))
             for label, args, kwargs in cs.group_inputs(serve, dev)]
    for values in itertools.product(k2.CENTROIDS, k2.CHUNK_POINTS):
        p = k2.Plan(*values)
        out = []
        with mock.patch.object(k2, "plan", lambda n, m: p):
            for label, args, kwargs, want in cases:
                got = k2.ball_group(*args, **kwargs)
                cs.require(torch.equal(got[1], want[1]) and cs.same_bits(got[2], want[2]),
                           f"plan {tuple(p)}: kernel differs from plain at {label}")
                out.append(f"{label} {cs.graph_ms(lambda: k2.ball_group(*args, **kwargs)):.4f}")
            occ = k2.occupancy(args[2].shape[1], args[0].shape[1])
        print(f"{tag} plan {tuple(p)} blocks/SM {occ['blocks_per_sm']}: " + " | ".join(out)
              + f" [{card}]", flush=True)


# the kernels of kernel 4b (csrc/gather_bwd.cu; csr_kernel before its redesign)
SCATTER_KERNELS = ("csr_kernel", "count_kernel", "scan_kernel", "place_kernel",
                   "segment_sum_kernel")


def paths(tag: str) -> None:
    """Device time per call of the paths kernels 1, 2, 3 and 4b run on (a
    torch.profiler window of 3 calls, chip_smoke.profile_calls) and those
    kernels' part of it: the default and the fused_eval engines and the
    fused_sa model's predict at 16 x 10240, the train and train_fused_sa steps
    at 16 x 10240 (the batch of chip_smoke.py's phases 7 and 11) and a
    training step at 36 x 7168; beside each, its wall time by host clock
    (median of 10 after 2, each ending in a synchronize)."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.train.trainer import Trainer

    card = cs.card_line()
    req = cs.synthetic_batch(16, 10240, seed=1, device=dev)
    batch = cs.synthetic_batch(36, 7168, seed=12, device=dev)
    batch16 = cs.synthetic_batch(16, 10240, seed=10, device=dev)
    serve = compile_inference(cs.seeded_model(dev), dev)
    fused = compile_inference(cs.seeded_model(dev), dev, fused_eval=True)
    fused_sa = Trainer(cs.seeded_model(dev, fused_sa=True), TrainConfig(), dev)
    trainer = Trainer(cs.seeded_model(dev), TrainConfig(), dev)
    gen = cs.train_gen(dev, 3)
    for name, fn in (("serve B=16", lambda: serve(req)),
                     ("serve_fused_eval B=16", lambda: fused(req)),
                     ("eval_fused_sa B=16", lambda: fused_sa.predict([req])),
                     ("train B=16", lambda: trainer.step(batch16, gen)),
                     ("train_fused_sa B=16", lambda: fused_sa.step(batch16, gen)),
                     ("train 36 x 7168", lambda: trainer.step(batch, gen))):
        _, busy, kernels, _ = cs.profile_calls(fn, 3)
        k1 = sum(ms for key, ms, _ in kernels if "fps" in key)
        k2 = sum(ms for key, ms, _ in kernels if "ball_group" in key)
        k3 = sum(ms for key, ms, _ in kernels if "ball_query" in key)
        k4b = sum(ms for key, ms, _ in kernels if any(k in key for k in SCATTER_KERNELS))
        wall = cs.serve_timing(lambda _: fn(), None)
        print(f"{tag} {name}: {busy:.3f} ms of device time per call, kernel 1 {k1:.4f} ms, "
              f"kernel 2 {k2:.4f} ms, kernel 3 {k3:.4f} ms, kernel 4b {k4b:.4f} ms; wall "
              f"{wall:.3f} ms [{card}]", flush=True)


def scatter(tag: str) -> None:
    """Kernel 4b (chip_smoke.time_scatter) at the inputs one training step
    gives it at 16 and 36 x 10240 (the batches of chip_smoke.py's phase 7) and
    one step of the unsplit model at 16 x 10240 (kernel 4c's backward, phase
    8), after its ptxas report; then kernels 3, 4a and 4c by CUDA graph
    (chip_smoke.graph_ms) at one 16 x 10240 serving forward's inputs."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3
    from dl_biomass_tpu_torch.ops import gather_kernel as k4
    from dl_biomass_tpu_torch.train.trainer import Trainer

    card = cs.card_line()
    for line in ptxas_lines("gather_bwd.cu"):
        print(f"{tag} ptxas: {line}", flush=True)
    for label, b, seed, split in (("train 16 x 10240", 16, 10, True),
                                  ("train 36 x 10240", 36, 11, True),
                                  ("train_unsplit 16 x 10240", 16, 10, False)):
        trainer = Trainer(cs.seeded_model(dev, split_first_layer=split), TrainConfig(), dev)
        batch = cs.synthetic_batch(b, 10240, seed=seed, device=dev)
        calls = cs.record_kernel_inputs(lambda x: trainer.step(x, cs.train_gen(dev, 0)), batch)
        res = cs.time_scatter(*cs.scatter_case(calls))
        print(f"{tag} scatter {label}: " + " ".join(f"{key}={val}" for key, val in res.items())
              + f" [{card}]", flush=True)
        del trainer, calls
        torch.cuda.empty_cache()
    req = cs.synthetic_batch(16, 10240, seed=1, device=dev)
    calls = cs.record_kernel_inputs(compile_inference(cs.seeded_model(dev), dev), req)
    unsplit = cs.record_kernel_inputs(
        compile_inference(cs.seeded_model(dev, split_first_layer=False), dev), req)
    (a3, kw3), = calls["ball_query_first_k"]
    a4, = [a for a, _ in calls["gather_rows_forward"]]
    a4c, = [a for a, _ in unsplit["gather_rows_aux"]]
    out = [f"kernel 3 {cs.graph_ms(lambda: k3.ball_query_first_k(*a3, **kw3)):.4f}",
           f"kernel 4a {cs.graph_ms(lambda: k4.gather_rows_forward(*a4)):.4f}",
           f"kernel 4c {cs.graph_ms(lambda: k4.gather_rows_aux(*a4c)):.4f}"]
    print(f"{tag} graph ms at one 16 x 10240 forward's inputs: " + " | ".join(out)
          + f" [{card}]", flush=True)


def eval5(tag: str) -> None:
    """Kernel 5 at the inputs one fused_eval forward at 16 x 10240 gives it, for
    the seeded model at neuron_multiplier 1, 2 and 3 in bf16 and in f32 (the
    inputs recorded with the plain version in the kernel's place): held
    against the plain version (max|diff| / max|y|), then the wrapper as the
    engine calls it replayed from a CUDA graph, with its blocks per SM; a
    width the tree refuses is printed as such."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import sa_eval_kernel as k5

    card = cs.card_line()
    for line in ptxas_lines("sa1_fused_eval.cu"):
        print(f"{tag} ptxas: {line}", flush=True)
    req = cs.synthetic_batch(16, 10240, seed=1, device=dev)
    for nm in (1, 2, 3):
        for dtype in ("bfloat16", "float32"):
            label = f"x{nm} {dtype}"
            try:
                serve = compile_inference(cs.seeded_model(dev, neuron_multiplier=nm,
                                                          compute_dtype=dtype),
                                          dev, fused_eval=True)
            except NotImplementedError as e:
                print(f"{tag} eval5 {label}: the engine refuses: {e} [{card}]", flush=True)
                continue
            with mock.patch.object(k5, "sa1_fused_eval", k5.sa1_fused_eval_plain):
                (args, kw), = cs.record_kernel_inputs(serve, req)["sa1_fused_eval"]
            widths = [-(-w.shape[1] // 64) * 64 for w in args[5][0::2]]
            try:
                got = k5.sa1_fused_eval(*args, **kw)
            except RuntimeError as e:
                print(f"{tag} eval5 {label} widths {widths}: the kernel refuses: {e} [{card}]",
                      flush=True)
                continue
            want = k5.sa1_fused_eval_plain(*args, **kw)
            again = k5.sa1_fused_eval(*args, **kw)
            torch.cuda.synchronize()
            ms = cs.graph_ms(lambda: k5.sa1_fused_eval(*args, **kw))
            occ = k5.occupancy(kw["bf16"], *widths)
            print(f"{tag} eval5 {label} widths {widths}: graph {ms:.4f} ms, vs plain "
                  f"{cs.rel_diff(got.float(), want.float()):.3e}, repeat bit-identical "
                  f"{cs.same_bits(got, again)}, zero rows equal "
                  f"{bool(torch.equal((got == 0).all(-1), (want == 0).all(-1)))}, launch {occ} "
                  f"[{card}]", flush=True)
            del serve, args, kw, got, want, again
            torch.cuda.empty_cache()


def query(tag: str) -> None:
    """Kernel 3 at every shape of chip_smoke.QUERY_SHAPES (chip_smoke.time_query),
    after its ptxas report."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.models.inference import compile_inference

    card = cs.card_line()
    for line in ptxas_lines("ball_query.cu"):
        print(f"{tag} ptxas: {line}", flush=True)
    serve = compile_inference(cs.seeded_model(dev), dev)
    for label, args, kwargs in cs.query_inputs(serve, dev):
        res = cs.time_query(label, args, kwargs, card)
        print(f"{tag} query {label}: graph {res['graph_ms']:.4f} ms, alone {res['alone_ms']:.4f} "
              f"ms, events {res['ms']:.4f} ms [{card}]", flush=True)


def query_tune(tag: str) -> None:
    """Kernel 3 at every shape of chip_smoke.QUERY_SHAPES under other plans
    (``ball_query_kernel.plan`` patched): index-exact against the plain
    version, then the graph replay's ms (chip_smoke.graph_ms)."""
    import itertools

    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.cloud import round_up
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3

    card = cs.card_line()
    serve = compile_inference(cs.seeded_model(dev), dev)
    for label, args, kwargs in cs.query_inputs(serve, dev):
        want = k3.ball_query_plain(*args, **kwargs)
        n, m, k = args[2].shape[1], args[0].shape[1], kwargs["k"]
        base = k3.plan(n, m, k)
        if base.whole:
            plans = [k3.Plan(min(w * r, round_up(m, w)), w, round_up(n, 32 * a), True, a)
                     for w, r, a in itertools.product((8, 16, 32), (1, 2, 4, 8), k3.AHEADS)]
        else:
            plans = [k3.Plan(w, w, pts, False, a) for w, pts, a in
                     itertools.product((16, 32), (2048, 4096, 8192), k3.AHEADS)]
        plans = [p for p in plans if k3.smem_bytes(p, k) <= k3.SMEM_PER_BLOCK]
        out = {}
        for p in dict.fromkeys([base] + plans):
            with mock.patch.object(k3, "plan", lambda *_: p):
                got = k3.ball_query_first_k(*args, **kwargs)
                cs.require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                           f"plan {tuple(p)}: kernel differs from plain at {label}")
                out[p] = cs.graph_ms(lambda: k3.ball_query_first_k(*args, **kwargs))
        best = sorted(out, key=out.get)
        print(f"{tag} querytune {label}: plan {tuple(base)} {out.get(base, float('nan')):.4f} ms; "
              f"fastest " + ", ".join(f"{tuple(p)} {out[p]:.4f}" for p in best[:6])
              + f"; slowest {tuple(best[-1])} {out[best[-1]]:.4f} [{card}]", flush=True)


def query_latency(tag: str) -> None:
    """Kernel 3 on one block (32 warps, one centroid each) over one cloud of
    uniform points, by CUDA graph: every centroid far from the cloud (no hit:
    each warp tests every chunk and places nothing), inside it with a radius
    that takes every point (every chunk placed, full-scan mode), and the
    staging alone; the difference over the groups of 32 * ahead points a
    warp scans is one group's time on a warp."""
    cs, dev = _setup()
    from dl_biomass_tpu_torch.core.cloud import round_up
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3

    card = cs.card_line()
    gen = torch.Generator(device=dev).manual_seed(5)
    for n in (2048, 10240):
        pos = torch.rand((1, n, 3), device=dev, generator=gen) * 10
        mask = torch.ones((1, n), dtype=torch.bool, device=dev)
        cmask = torch.ones((1, 32), dtype=torch.bool, device=dev)
        far, inside = torch.full((1, 32, 3), 100.0, device=dev), pos[:, :32].contiguous()
        for a in k3.AHEADS:
            p = k3.Plan(32, 32, round_up(n, 32 * a), True, a)
            groups = p.points // (32 * a)
            with mock.patch.object(k3, "plan", lambda *_: p):
                none = cs.graph_ms(lambda: k3.ball_query_first_k(far, cmask, pos, mask,
                                                                 radius=1.0, k=64))
                every = cs.graph_ms(lambda: k3.probe(inside, cmask, pos, mask, radius=100.0,
                                                     k=64, mode="full_scan"))
                staged = cs.graph_ms(lambda: k3.probe(far, cmask, pos, mask, radius=1.0, k=64,
                                                      mode="stage_only"))
            print(f"{tag} querylat n={n} ahead={a}: no hit {none:.4f} ms, every lane a hit "
                  f"{every:.4f} ms, staging alone {staged:.4f} ms; a group of {32 * a} points "
                  f"{(none - staged) * 1e6 / groups:.1f} ns with no hit, "
                  f"{(every - staged) * 1e6 / groups:.1f} ns placed [{card}]", flush=True)


def main(argv) -> int:
    commands = {"time": (time_passes, 1), "outputs": (save_outputs, 1), "same": (same, 2),
                "steps": (steps, 0), "acts": (acts, 0), "fps": (fps, 1),
                "fpstune": (fps_tune, 1), "paths": (paths, 1), "group": (group, 1),
                "grouptune": (group_tune, 1), "scatter": (scatter, 1), "eval5": (eval5, 1),
                "query": (query, 1), "querytune": (query_tune, 1),
                "querylat": (query_latency, 1)}
    if not argv or argv[0] not in commands or len(argv) - 1 != commands[argv[0]][1]:
        print(__doc__, file=sys.stderr)
        return 2
    fn, _ = commands[argv[0]]
    fn(*argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
