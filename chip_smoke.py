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
             computes the same function, that call's time; kernels 2, 3 and
             4a also replayed from a CUDA graph, kernel 2 with
             ``ball_group_kernel.plan``'s choice and its CUDA-core floor. Then
             kernel 3 at every shape the paths give it (QUERY_SHAPES: SA2 of
             16 and 36 x 10240, of 24, 28 and 36 x 7168 and of 2 x 20608,
             the parity preset's SA1 of 16 and 2 x 20608): index-exact against
             its plain version, two launches identical,
             ``ball_query_kernel.plan``'s choice and blocks per SM, timed by
             events, from a CUDA graph and alone (``torch.profiler``) beside
             its measurement modes (no early exit, the staging alone, no
             writing), the transpose copy its parent's wrapper made, the scan
             lengths the data needs, its CUDA-core floor and both parts of its
             bound. Then kernel 1 at
             every shape the paths give it (FPS_SHAPES: SA1 and SA2 of 16 and
             36 x 10240 and 36 x 7168, exact FPS on 16 x 10240 and 2 x
             16384): index-exact, two launches identical, ``fps_kernel.plan``'s
             choice, and its time by events, from a CUDA-graph replay and
             alone (``torch.profiler``), per step, and its chain-only loop's.
3. serve   — the full-width production ``PointNet2Regressor`` (bf16,
             fast_group, fast_fps, split_first_layer; seeded random weights
             and non-trivial BatchNorm statistics) behind ``compile_inference``
             answers 16 x 10240, 36 x 10240, a partial request of 5 clouds of
             7000-10240 points, the first request again, the partial one
             with garbage in its pad rows, and 24 and 28 x 7168. The launch counts of that run, the
             repeat and pad invariance, agreement with the same forward on the
             plain versions and with the unfolded module, and ms per batch.
4. kernels 4c and 5 — the two-table gather (``split_first_layer=False``) and
             the fused SA1 layer (``fused_eval=True``) at the inputs one
             16 x 10240 forward of their configuration gives them: 4c
             bit-identical to its plain version, 5 within 1e-2 of max|y| (bf16;
             1e-5 in a small f32 case) with identical zero rows, on the
             engine's packed block bit-identical to a repeat and to the
             wrapper packing for itself; timed beside their bounds, plain
             versions and yardsticks (two ``values[b, idx]`` ops; the default
             engine's unfused SA1 segment), 5 also by its kernel alone
             (``torch.profiler``), packing per call, and its selection and
             capture alone, with its blocks per SM; 4c also from a CUDA
             graph.
5. serve_fused_eval and serve_unsplit — the same requests through
             ``compile_inference(fused_eval=True)`` and through the engine of
             the same weights with ``split_first_layer=False``: launches per
             forward, repeat and pad invariance, agreement with the
             plain-version forward, the unfolded module and (fused_eval) the
             default engine, a profile (fused_eval: its launches per forward
             and the device's idle share), and ms per batch beside the default
             engine's.
6. kernel 4b — the scatter-add backward of the gather at the inputs one
             training step at 16 x 10240 gives it, held bit for bit against
             its plain version and a second launch, timed (median of 100
             launches, and replayed from a CUDA graph) beside its bound and one
             ``index_add_`` as the library yardstick, each of its four launches
             alone from a graph (``gather_kernel.probe``), also with the pad
             slots taken out, and the lengths of its segments. Then kernel
             11 (the train-mode BatchNorm of the SA layers' hidden layers) at
             the inputs one training step of the SSG benchmark cell's shape
             (36 clouds of 7168 points in 7936 slots: SA1 36 x 1588 x 64 x 64,
             SA2 36 x 397 x 64 x 128, bf16, ReLU) gives it: each of F1, F2, B1,
             B2 and the float32-to-float64 slice sum of their partials at
             each of its launches held against its plain version
             (``bn_train_kernel.f1_plain`` ...; y, the output and dy equal,
             the partials within 2^-16 of their rows' sum of |term|, the
             float64 sums within 1e-9 of theirs) and against a second launch
             bit for bit, timed from a CUDA graph beside its bound and its
             plain version.
7. train   — ``Trainer`` on the same production model (Adam, lr, weight decay,
             head dropout 0.5; FPS starts and dropout from a seeded
             ``torch.Generator``) takes 12 steps on each fixed batch of
             16 x 10240, 36 x 10240 and 36 x 7168: finite and falling loss,
             every parameter with a gradient moved, BatchNorm statistics
             moved, launches per step, ms/step (median of the last 10),
             clouds/s and peak memory; one step on the plain versions from the
             same state and seed against the kernel step; ``evaluate`` and
             ``predict`` at 24 and 28 x 7168; a profile of a 16 x 10240 step.
8. train_unsplit — the same checks for 12 steps of the model with
             ``split_first_layer=False`` at 16 x 10240 (kernels 4c and 4b).
9. fps scratch — kernel 1's global-scratch variant (rows beyond the
             registers, more than 10240 points): exact FPS on 2 rows of
             16384, index-exact, timed.
10. kernel 6 — the three passes of the fused SA MLP (F1, F2, F3) at the
             inputs one train-mode and one eval forward of the ``fused_sa``
             model at 16 x 10240 give them, SA1 and SA2, in bf16 and in f32
             (in bf16 F1, F2 and F3 on the tensor cores, ``csrc/fused_sa_f1.cu``,
             ``_f2.cu``, ``_f3.cu``, on one ``pack_fwd`` block per layer, also
             timed alone and beside the CUDA-core kernel of
             ``csrc/fused_sa_fwd.cu`` on the same inputs): statistics and
             outputs against the plain version
             (1e-2 of max|y| in bf16, 1e-5 in f32), the argmax equal wherever
             the winner leads by more, zero rows identical, two launches
             bit-identical; timed beside their bounds, plain versions and the
             unfused layer (``MLP`` + ``masked_max``) in train and eval mode.
             Each pass names the source whose kernel ran it. Then its three backward
             passes (B1, B2, B3; in bf16 on the tensor cores,
             ``csrc/fused_sa_b1.cu``, ``_b2.cu``, ``_b3.cu``) at the inputs one
             training step of that model gives them, SA1 and SA2, bf16, and f32
             with ELU (no branch to flip): the weight and bias gradients and the
             four sums within 1e-2 (bf16) or 1e-5 (f32) of the pass's largest,
             d(dense) of its own max|.|, from the plain backward, d(dense) rows 0
             where a centroid has no valid slot, two launches bit-identical;
             timed beside their bounds, plain versions and the autograd
             backward of the unfused layer, bf16 also by its kernel alone
             (``torch.profiler``).
11. eval_fused_sa, train_forward_fused_sa and train_fused_sa —
             ``Trainer.evaluate`` and ``predict`` on the ``fused_sa`` model at
             16 and 36 x 10240, held against the plain-version forward and the
             unfused model of the same weights, ms per batch beside the
             unfused model's; its train-mode forward at 16 x 10240 under
             ``torch.no_grad()`` against the plain version (output and moved
             running statistics); then ``Trainer.step``, 12 steps on each fixed
             batch of 16 and 36 x 10240 with the checks of phase 7, ms/step,
             clouds/s and peak memory beside the unfused model's steps on the
             same batches, one step on the kernels against one on the plain
             versions from one state and seed (float32 with ELU: loss 1e-5
             relative, gradients 1e-2 in relative L2 norm and 2e-3 of the
             largest |g|; bf16: loss 1e-2, gradients 0.35 in relative L2 norm)
             and a profile of a 16 x 10240 step.
12. fused_sa_x2 and fused_sa_x3 — the ``fused_sa`` model at
             ``neuron_multiplier`` 2 and 3 (SA1 [4, 128, 128, 256] and
             [4, 192, 192, 384], SA2 [259, 256, 256, 512] and [387, 384, 384,
             768]) in bf16 at B=16 x 10240: one train-mode forward (no_grad),
             one eval forward and one ``Trainer.step``, launches counted, each
             against the same on the plain versions under phase 11's bounds;
             then every pass of each layer at the inputs that run gave it, in
             bf16, and SA2's passes in f32 (ELU), against the plain version as
             in phase 10, each printed with the kernel that ran it (the
             routing rule ``sa_train_kernel.mma_takes``: SA1 at 2 on the
             tensor cores, the rest on the CUDA cores) and its time. Then
             ``serve_fused_eval_wide``: ``compile_inference(fused_eval=True)``
             for the seeded model at neuron_multiplier 2, 3, 4 and 8 in bf16
             and in float32 but at 3 (kernel 5 as ``sa_eval_kernel.plan``
             names it: the resident kernels at 2 and 3, the wide kernel at 4
             and 8) answers 16 x 10240 and the partial request, launches
             counted, against the same engine on the plain versions (1e-2 of
             max|y|, and 1e-4 in float32) and the unfolded module, timed
             beside the default engine of that model. Then kernel 5 alone
             against its plain version under the same bounds, in bf16 and in
             float32, at the inputs the x4 and x8 engines gave it at 16 x
             10240, at x16 on 2 of those clouds, and at 6 point features at
             x1 (16 x 10240), each with its plan, registers and spill as
             built, blocks per SM, and its time from CUDA-graph replays
             beside its bound and its plain version.
13. tail_bench, bn_stats_bench, dma_probe and bq_phase_bench — each tool's
             ``main()`` on the card (``dl_biomass_tpu_torch.tools``) with its
             launches counted;
             then kernel 7 (``fused_tail``) forward and backward at SA1
             (36 x 2048 x 64, 64 -> 128) and SA2 (36 x 512 x 64, 128 -> 256):
             output within 1e-2 of max|y| (bf16) of its plain version, the
             argmax equal where the winner leads by more than one bf16 step,
             empty rows 0 with argmax 64, NaN, Inf and 1e4 junk at invalid
             slots changing no bit; da2 and dW3 within 1e-2 of their largest,
             exactly 0 at every slot no column routes to (invalid slots
             among them), the autograd op's da2, dW3 and db3 likewise; two
             launches bit-identical; with NaN and Inf in a2, the cotangent
             and W3, da2 and dW3 NaN and +-Inf exactly where the plain
             (dense) version's are; the backward's launch the one
             ``tail_kernel.bwd_plan`` names; timed beside the bound, the plain version
             and the unfused pair (forward, autograd backward). Kernel 8
             (``stats_kernel``) at (36, 2048, 64, 64) and (36, 512, 64, 128):
             s1 and s2 within 1e-5 of the plain version's largest, two
             launches bit-identical, timed. The slice sum that ends kernels
             7-B and 8 (``sum_slices``) against its plain version on both
             kernels' slices (within 1e-6, a repeat bit-identical), with the
             launch ``sum_slices_kernel.plan`` names, timed beside one
             ``torch.sum`` in f64, both by events and replayed from a CUDA
             graph. Kernel 10
             (``block_copy``) at 128 blocks of 256 KB, 1 MB and 4 MB:
             bit-identical to x + 1.0, timed beside ``torch.add`` likewise. Kernel 9
             (``bq``) at the tool's 36 x 512 x 2048, K=64, r=8, every one of
             its eleven variants: bit-exact against its plain version on the
             tool's data and on a case whose bucket caps drop points, two
             launches identical, ``dyn`` equal to kernel 3 with masked slots
             n, the capped variants equal to it wherever they keep a point,
             ``rank`` and ``extract`` equal to its first slot; timed (CUDA
             events around the call, and its launches replayed from a CUDA
             graph, free of host time) beside the bound, the plain version
             and kernel 3 on the same input; its launch the one
             ``bq_phase_bench.plan`` names.
14. device_dataset — training and serving over a ``DeviceDataset`` of 72
             seeded synthetic plots of 7168 points (capacity
             ``aug_capacity(7168)`` = 7936): ``Trainer.fit`` for 2 epochs at
             B=36 with 2 augmented copies of each plot (``train_epoch_scan``,
             ``evaluate_scan`` on 36 more plots), every launch counted; then
             one epoch each through ``train_epoch_scan``, ``train_epoch_fused``
             and ``ds.batches`` + ``train_epoch`` from one state and seed,
             their losses and parameters bit-identical; ``evaluate_scan``
             equal to ``evaluate_fused``; ``compile_dataset_inference`` with
             the default and the ``fused_eval`` engines, its rows bit-identical
             to each engine's ``serve`` over ``ds.batches``. Ms per epoch,
             clouds/s, peak memory and launches per epoch by kernel.
15. disk_pipeline — the port's normal entry point on files on disk,
             ``python -m dl_biomass_tpu_torch`` (``__main__.main``) as a user
             runs it, at the full-width defaults: ``make_corpus`` writes 72
             train, 36 val and 36 test raw plots of 12,288 points; ``resample
             --engine cuda --format las`` takes each to 7168 points by exact
             FPS on kernel 1 (one launch a plot, its global-scratch launch);
             for 4 plots the picks index-equal to ``fps_rows_plain`` on a CPU
             copy, the files the plots at those picks, the picks that differ
             from the ``native`` engine's counted, and the launch timed beside
             its bound, its plain version and the native engine; ``train`` for
             2 epochs at B=36 with 2 augmented copies (a finite log of 2 rows,
             the checkpoint and its sidecar); ``evaluate`` (finite metrics,
             its predictions bit-identical to ``predict_dataset``);
             ``predict`` (rows bit-identical to ``compile_dataset_inference``),
             ``--no-engine`` (within the folded-vs-module bound) and
             ``--watch --max-polls 2`` (a plot added between the polls gets
             its row). Each stage's launches counted, its wall, the share of
             it spent decoding LAS files, s/epoch, clouds/s.
16. research — the rest of the research workload through ``python -m
             dl_biomass_tpu_torch`` at the production defaults (bf16,
             fast_fps, fast_group, split_first_layer) on a raw corpus of 72
             train and 36 val plots of 12,288 points (``make_corpus``), loaded
             at 7168 points a plot: ``sweep`` (lrs 1e-4, 1e-3 x wds 0,
             8.025e-5 at B=36, 2 augmented copies, 2 epochs: 4 trials in turn
             on each batch; the study JSON and its CSV); a library sweep of 2
             trials, 3 epochs, patience 1 with a scripted rise for trial 1 at
             epoch 1 (trial 1 frozen there bit for bit: parameters, Adam
             moments, BatchNorm running statistics; trial 0 bit-identical to a
             ``Trainer`` run of the same initial weights, lr, weight decay,
             batches and generators); ``tune`` (2 trials of 2 epochs, saved,
             then 1 more with ``--continue-study``); ``density`` (2048 and 7168
             points, 1 epoch each); ``seed-study`` (2 seeds of the production
             and parity modes, 48 plots of 4096 points, 1 epoch);
             ``parity-record --device cpu`` on ``tests/data/parity_fixture``
             then ``parity-check`` on the card within ``DEFAULT_RTOL`` (exact
             FPS on kernel 1 and SA1's ball query on kernel 3 against their
             plain versions through the path from LAS bytes to predictions),
             the max relative delta printed; ``visualize-aug`` on one plot;
             ``lr_range_test`` for 20 iterations at B=36 (finite losses, a
             suggestion inside the range). Every stage's launches counted by
             kernel and held to what its steps and forwards need; its wall,
             s/epoch and clouds/s on the host clock up to a ``hard_sync``.
17. mesh_export — the serving export and data parallelism. ``export_serving``
             of the seeded production model at 16 x 10240 on the card
             (``torch.export`` of the flat serving function, kernels 1, 2, 3
             and 4a as the registered ops ``torch.ops.dlbt.*``), then
             ``load_serving``: the strict call against ``compile_inference``
             (bit-identical, or within 1e-2 of max|y| with the difference
             printed) and ``predict`` on the partial request of 5 clouds; the
             same for the unsplit model (kernel 4c); launches counted by
             kernel; export and load seconds; the artifact's and the engine's
             ms per batch (host clock after a synchronize). Then 2 ranks
             spawned on the card (``parallel/mesh.spawn``: a card each, nccl,
             where there are two; else both on cuda:0, gloo), each rank's
             launches counted by path: the float32 (ELU) model's step at 16 x
             10240 held against the one-process step on the same global batch
             and draws (loss rtol 1e-5, gradients and running statistics over
             their largest atol 1e-4, every rank's gradients bit-identical);
             5 production bf16 steps at 36 x 10240 (the first loss within 2^-8
             of one process's, ms/step beside one process's); a ``fit`` of 2
             epochs over phase 14's ``DeviceDataset`` (the same MSEs on every
             rank); both serving engines (default and ``fused_eval``) at 16 x
             10240, every answer on every rank, against one process; a sweep
             of 4 trials split over the ranks, its results equal to the
             one-process sweep's. Then ``torchrun --standalone
             --nproc-per-node 2 -m dl_biomass_tpu_torch train`` on a raw corpus
             of 36 plots of 12,288 points, its log against the same command in
             one process (within 2^-8). A rank that fails ends the run with a
             non-zero exit.
18. variants — the model variants and the other families at full width, 16
             x 10240 (remat 36 x 10240), production preset, seeded weights:
             ``msg`` and ``msg`` + ``doubled_radius`` (two radii a layer, one
             FPS: kernel 2 at both SA1 radii, kernels 3, 4a and 4b at both SA2
             radii) 12 steps each with launches per step, one step against the
             plain-version step, the eval forward against the plain forward, and
             kernel 2 at r=4 and kernel 3 at r=16 timed beside their bounds;
             ``msg`` + ``fused_sa`` (kernel 6 at both scales, SA2's
             [256+3, 128, 128, 256] per scale) one step against the plain step
             in phase 11's bf16 bounds; ``analytic_bn`` with head dropout 0.5
             (SA2 through 4c) 12 steps and a step against plain, its engine
             bit-identical to the standard model's on the same weights;
             ``remat`` one step bit-identical to the plain step (loss,
             gradients, running statistics), then 12 steps each with ms/step
             and peak memory; ``pointnet2_v2`` through ``compile_inference``
             and the ``torch.export`` artifact; the voxel family
             (``voxelize`` on the card against a CPU copy, then the probe's
             configuration, ``voxelnet_deep`` and ``voxelnet_wide48``, 12
             steps each, kernel 11 at their 64-cell BatchNorms); the
             per-point segmentor (exact FPS, kernel 3, 4a, 4b, 11) forward and
             one step against the plain versions, in float32 and, through
             ``build_model`` with the benchmark cell's configuration
             (``portbench/configs/pn2_seg_biomass.json``: bf16, sectored FPS,
             kernel 2, head dropout 0.5) at the cell's 36 clouds of 7168
             points in 7936 slots, a forward and a ``Trainer.step`` on
             per-point targets, each leaf's gradient against the plain
             versions';
             ``voxel_select_first`` on 16 plots of 50,000 raw points at 0.35 m,
             10240 kept, index-equal to the host path.
19. mp_tools — ROADMAP C.4, the point axis over ``mp`` and the tools
             without kernels of their own. 2 ranks spawned on the card (as
             phase 17's) take phase 17's float32 (ELU) step at 16 x 10240 on a
             dp=2 mesh under whole-batch float32 BatchNorm sums (the port's
             until ROADMAP C.4) and under the port's (float64 over float32
             chunk partials): against one
             process, each gradient over its own largest within 1e-4
             (tests/test_parallel.py's bound; the port's must hold it),
             printed with (a) the masked max's argmax slots that differ by SA
             layer, (b) each train-mode BatchNorm's largest E[x^2]/var, (c)
             the one-process step with its statistics summed from two
             half-batch partials against the mesh's. Then on an mp=2 mesh
             (dp=1) the production model in bf16, then float32 with ELU, at 4
             x 16384: ``Trainer.predict`` and 2 ``Trainer.step`` on each
             rank's half of every cloud against one process's (eval within
             2e-4, float32 loss 1e-5 and gradients 1e-4, every loss within
             2^-8), kernel 2's share of the SA1 centroids a rank (half),
             ms/step and step peak memory a rank beside one process's,
             launches a rank. Then each tool's ``main()`` on the card, its
             repeats cut: ``profile_step`` (train, eval, engine),
             ``roofline``, ``batch_sweep``, ``serving_matrix`` (and
             ``--cold``: 36 plots from the artifact in a subprocess),
             ``dispatch_probe``, ``bq_tile_sweep``, ``fps_divergence_probe``
             (with and without ``--old-keys``), ``torch_cpu_anchor``, each
             with its launches counted.
20. summary — one JSON line of the kernels with their launches by path, the
             card line, and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without a card, or when the package is
not beside this script.
"""

from __future__ import annotations

import copy
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

# H100 SXM peaks (NVIDIA data sheet): device memory rate, float32 outside the
# tensor cores (the type of the selection kernels' arithmetic) and dense bf16
# on the tensor cores (the type of kernel 5's MLP at the least)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
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
ENTRIES = ("dlbt_fps", "dlbt_ball_group", "dlbt_ball_query", "dlbt_gather", "dlbt_gather_aux",
           "dlbt_sa1_fused_eval", "dlbt_scatter_rows", "dlbt_fused_sa_f1", "dlbt_fused_sa_f2",
           "dlbt_fused_sa_f3", "dlbt_fused_sa_b1", "dlbt_fused_sa_b2", "dlbt_fused_sa_b3",
           "dlbt_fused_tail_fwd", "dlbt_fused_tail_bwd", "dlbt_masked_stats", "dlbt_sum_slices",
           "dlbt_bq_phase", "dlbt_block_copy", "dlbt_bn_stats", "dlbt_bn_apply",
           "dlbt_bn_grad_sums", "dlbt_bn_grad", "dlbt_sum_slices_f64")


ENTRIES_6 = tuple(e for e in ENTRIES if e.startswith("dlbt_fused_sa_"))
ENTRIES_11 = ENTRIES[-5:]  # kernel 11's four passes and Σ's float64 sum of its partials


def per_run(**launches):
    """Launches of every kernel in one forward or step of a path (0 unless given)."""
    return {e: launches.get(e, 0) for e in ENTRIES}


def add_launches(*runs: dict) -> dict:
    """The launches of ``runs`` added, by the entries they name."""
    return {e: sum(r.get(e, 0) for r in runs) for e in dict.fromkeys(e for r in runs for e in r)}


def bn_train_launches(layers: int, biases: int, recomputed: int = 0, steps: int = 1,
                      backward: bool = True) -> dict:
    """Kernel 11's launches in ``steps`` training steps (``backward`` False:
    train-mode forwards) with ``layers`` train-mode BatchNorms on it,
    ``biases`` of them after a Dense (B2 then also writes the bias's
    partials) and ``recomputed`` run forward again by remat: F1 and F2 a
    forward, B1 and B2 once, and Σ's float64 sum after each F1, each B1 and
    each B2 with a bias."""
    fwd, bwd = layers + recomputed, layers if backward else 0
    sums = fwd + (layers + biases if backward else 0)
    return {e: n * steps for e, n in zip(ENTRIES_11, (fwd, fwd, bwd, bwd, sums))}


def without_bn_train(launches: dict) -> dict:
    """``launches`` with kernel 11's taken out: a path whose BatchNorms keep
    the PyTorch chain (a mesh, ``analytic_bn``)."""
    return {e: 0 if e in ENTRIES_11 else n for e, n in launches.items()}


# kernel 11 a training step of the SSG model: the hidden BatchNorms of SA1 and
# SA2, the first of each on the given z0 of the split first layer (SA1) or of
# SA2's gathered rows, the second after its Dense (unsplit: both after one);
# at N_POINTS slots SA2 keeps 512 centroids a cloud, SA3's rows, so SA3's two
# hidden BatchNorms (256 and 512 wide, after their Dense) take it too, where
# at SHORT_POINTS or the cell's 7936 slots (359 and 397 centroids) they keep
# the chain; so does the head (no mask)
SA3_BN = bn_train_launches(2, 2)
BN_STEP_SHORT = bn_train_launches(4, 3)
BN_STEP = add_launches(BN_STEP_SHORT, SA3_BN)
BN_STEP_UNSPLIT = add_launches(bn_train_launches(4, 4), SA3_BN)


# phase 14: a DeviceDataset of DD_PLOTS synthetic plots of DD_POINTS (seed
# DD_SEED), validation on DD_VAL_PLOTS more, fit for DD_EPOCHS epochs at B=DD_BATCH
# with DD_AUGS augmented copies of each plot
DD_PLOTS, DD_VAL_PLOTS, DD_POINTS, DD_BATCH, DD_AUGS, DD_EPOCHS, DD_SEED = (
    72, 36, 7168, 36, 2, 2, 40)
DD_STEPS = -(-DD_PLOTS * (1 + DD_AUGS) // DD_BATCH)
DD_VAL_BATCHES = -(-DD_VAL_PLOTS // DD_BATCH)
DD_FORWARDS = DD_EPOCHS * (DD_STEPS + DD_VAL_BATCHES)

# phase 15: a raw corpus of DISK_TRAIN, DISK_VAL and DISK_TEST plots of DISK_RAW
# points (make_corpus, seed DISK_SEED), resampled to DISK_POINTS by exact FPS;
# fit for DISK_EPOCHS epochs at B=DISK_BATCH with DISK_AUGS augmented copies a
# plot; evaluate and predict at the CLI's batch DISK_SERVE_BATCH, predict
# padding the plot count to DISK_BUCKET; kernel 1's picks held against its plain
# version on the CPU for DISK_CHECKED plots
DISK_TRAIN, DISK_VAL, DISK_TEST, DISK_RAW, DISK_POINTS, DISK_SEED = 72, 36, 36, 12288, 7168, 50
DISK_BATCH, DISK_AUGS, DISK_EPOCHS, DISK_SERVE_BATCH, DISK_BUCKET = 36, 2, 2, 32, 64
DISK_CHECKED = 4
DISK_STEPS = -(-DISK_TRAIN * (1 + DISK_AUGS) // DISK_BATCH)


# the tools' timings in one main(), each a warm-up chain and timed chains:
# (calls per chain, timed chains, shapes or block sizes), as the tools' own
# constants give them (tool_paths holds the tools to these)
TOOL_CHAINS = {"tail_bench": (10, 3, 2), "bn_stats_bench": (10, 3, 2), "dma_probe": (16, 5, 3),
               "bq_phase_bench": (20, 3, 3)}


def chained_calls(tool: str) -> int:
    calls, windows, shapes = TOOL_CHAINS[tool]
    return calls * (1 + windows) * shapes


# launches of each kernel per serving forward or training step, by path
EXPECTED = {
    "serve": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1, dlbt_gather=1),
    "serve_fused_eval": per_run(dlbt_fps=2, dlbt_sa1_fused_eval=1, dlbt_ball_query=1,
                                dlbt_gather=1),
    "serve_unsplit": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1,
                             dlbt_gather_aux=1),
    "train": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1, dlbt_gather=1,
                     dlbt_scatter_rows=1, **BN_STEP),
    "train_unsplit": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1,
                             dlbt_gather_aux=1, dlbt_scatter_rows=1, **BN_STEP_UNSPLIT),
    # a step at SHORT_POINTS (phase 7's third batch)
    "train_short": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1, dlbt_gather=1,
                           dlbt_scatter_rows=1, **BN_STEP_SHORT),
    # fused_sa: kernel 6 at SA1 (kernel 2's planes) and SA2 (kernel 4c's rows);
    # in training kernel 11 at SA3's (N_POINTS)
    "eval_fused_sa": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1,
                             dlbt_gather_aux=1, dlbt_fused_sa_f3=2),
    "train_forward_fused_sa": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1,
                                      dlbt_gather_aux=1, dlbt_fused_sa_f1=2,
                                      dlbt_fused_sa_f2=2, dlbt_fused_sa_f3=2,
                                      **bn_train_launches(2, 2, backward=False)),
    # and its step: B1-B3 at both layers, kernel 4b for SA2's d(dense)
    "train_fused_sa": per_run(dlbt_fps=2, dlbt_ball_group=1, dlbt_ball_query=1,
                              dlbt_gather_aux=1, dlbt_scatter_rows=1, dlbt_fused_sa_f1=2,
                              dlbt_fused_sa_f2=2, dlbt_fused_sa_f3=2, dlbt_fused_sa_b1=2,
                              dlbt_fused_sa_b2=2, dlbt_fused_sa_b3=2, **SA3_BN),
    # the fused_sa model at neuron_multiplier 2 and 3 (phase 12), per run of one
    # train-mode forward, one eval forward and one step
    # the fused_eval engine at the wider widths (phase 12), per forward
    "serve_fused_eval_wide": per_run(dlbt_fps=2, dlbt_sa1_fused_eval=1, dlbt_ball_query=1,
                                     dlbt_gather=1),
    # fit over a DeviceDataset (phase 14), per run: DD_EPOCHS epochs of DD_STEPS
    # training steps and DD_VAL_BATCHES evaluation forwards each
    "device_dataset": per_run(dlbt_fps=2 * DD_FORWARDS, dlbt_ball_group=DD_FORWARDS,
                              dlbt_ball_query=DD_FORWARDS, dlbt_gather=DD_FORWARDS,
                              dlbt_scatter_rows=DD_EPOCHS * DD_STEPS,
                              **bn_train_launches(4, 3, steps=DD_EPOCHS * DD_STEPS)),
    # kernel 11 at SA3's first hidden BatchNorm at 2 (512 wide; its second,
    # 1024, and both at 3, 768 and 1536, are no width it takes)
    **{f"fused_sa_x{nm}": per_run(dlbt_fps=6, dlbt_ball_group=3, dlbt_ball_query=3,
                                  dlbt_gather_aux=3, dlbt_scatter_rows=1, dlbt_fused_sa_f1=4,
                                  dlbt_fused_sa_f2=4, dlbt_fused_sa_f3=6, dlbt_fused_sa_b1=2,
                                  dlbt_fused_sa_b2=2, dlbt_fused_sa_b3=2,
                                  **(add_launches(bn_train_launches(1, 1, backward=False),
                                                  bn_train_launches(1, 1)) if nm == 2 else {}))
       for nm in (2, 3)},
    # the tools, per main(): tail_bench times the forward and the forward +
    # backward; bn_stats_bench calls kernel 8 once more per shape for max_rel_s1
    "tail_bench": per_run(dlbt_fused_tail_fwd=2 * chained_calls("tail_bench"),
                          dlbt_fused_tail_bwd=chained_calls("tail_bench"),
                          dlbt_sum_slices=chained_calls("tail_bench")),
    "bn_stats_bench": per_run(
        dlbt_masked_stats=chained_calls("bn_stats_bench") + TOOL_CHAINS["bn_stats_bench"][2],
        dlbt_sum_slices=chained_calls("bn_stats_bench") + TOOL_CHAINS["bn_stats_bench"][2]),
    "dma_probe": per_run(dlbt_block_copy=chained_calls("dma_probe")),
    "bq_phase_bench": per_run(dlbt_bq_phase=chained_calls("bq_phase_bench")),
}
# phase 17: the serving export at B=SMALL x N_POINTS; MESH_RANKS ranks: the f32 step
# at B=SMALL, MESH_STEPS bf16 steps at B=LARGE, a fit over phase 14's DeviceDataset,
# both engines at B=SMALL, and a sweep of the MS_LRS x MS_WDS trials over MS_PLOTS
# plots (validation MS_VAL_PLOTS) of DD_POINTS at B=MS_BATCH for MS_EPOCHS epochs
MESH_RANKS, MESH_STEPS, MESH_SEED = 2, 5, 60
MS_LRS, MS_WDS = (1e-4, 1e-4, 1e-3, 1e-3), (0.0, 8.025e-5, 0.0, 8.025e-5)
MS_PLOTS, MS_VAL_PLOTS, MS_BATCH, MS_EPOCHS = 24, 12, 12, 2
# and train under torchrun on a raw corpus of MC_PLOTS plots (make_corpus's
# splits) at B=MC_BATCH for MC_EPOCHS epochs
MC_PLOTS, MC_BATCH, MC_EPOCHS = 36, 12, 2
MS_STEPS = len(MS_LRS) // MESH_RANKS * MS_EPOCHS * -(-MS_PLOTS // MS_BATCH)
MS_FORWARDS = len(MS_LRS) // MESH_RANKS * MS_EPOCHS * -(-MS_VAL_PLOTS // MS_BATCH)
# a mesh step vs one process's on the same global batch and draws: the float32
# loss relative, each gradient and the running statistics over their largest in
# tests/test_parallel.py's bounds (ROADMAP C.4, closed: the statistics' sums in
# float64 over float32 chunk partials, layers.chunk_sums); bf16 within one
# bf16 step of the loss
MESH_LOSS_RTOL, MESH_GRAD_ATOL, MESH_BF16_RTOL = 1e-5, 1e-4, 2.0**-8
# launches per forward, step or run of each rank (mesh paths: no kernel 11
# under data_parallel, whose statistics would be this rank's) or of the artifact
EXPECTED.update({
    "export": EXPECTED["serve"],
    "export_unsplit": EXPECTED["serve_unsplit"],
    "mesh_train": without_bn_train(EXPECTED["train"]),
    "mesh_fit": without_bn_train(EXPECTED["device_dataset"]),
    "mesh_serve": EXPECTED["serve"],
    "mesh_serve_fused_eval": EXPECTED["serve_fused_eval"],
    # the sweep splits its trials over the ranks, each a Trainer of its own
    # outside data_parallel: kernel 11 takes their steps' BatchNorms
    "mesh_sweep": per_run(dlbt_fps=2 * (MS_STEPS + MS_FORWARDS),
                          dlbt_ball_group=MS_STEPS + MS_FORWARDS,
                          dlbt_ball_query=MS_STEPS + MS_FORWARDS,
                          dlbt_gather=MS_STEPS + MS_FORWARDS, dlbt_scatter_rows=MS_STEPS,
                          **bn_train_launches(4, 3, steps=MS_STEPS)),
})
FUSED_VS_DEFAULT_RTOL = 1e-2  # fused_eval vs default engine, both bf16
SA1_F32_RTOL = 1e-5  # kernel 5 vs its plain version in float32
SCATTER_REPS = 100
# training: fixed batches of (clouds, points); 2 warm-up steps, then 10 timed
TRAIN_SHAPES = ((16, N_POINTS), (36, N_POINTS), (36, SHORT_POINTS))
# kernel 1's global-scratch variant: rows of more than 10240 points
SCRATCH_ROWS, SCRATCH_POINTS = 2, 16384
# kernel 1 at every shape the paths give it, phase 2: (label, clouds, points,
# seed, selection); "sectored" records both FPS launches of one serving forward
# (SA1, SA2), "exact" is one exact FPS over whole clouds at SA1's ratio, as
# exact_selection and phase 9 run it
FPS_SHAPES = (("16 x 10240", SMALL, N_POINTS, 1, "sectored"),
              ("36 x 10240", LARGE, N_POINTS, 2, "sectored"),
              ("36 x 7168", LARGE, SHORT_POINTS, 12, "sectored"),
              ("exact 16 x 10240", SMALL, N_POINTS, 1, "exact"),
              ("phase 9", SCRATCH_ROWS, SCRATCH_POINTS, 30, "exact"))
# kernel 2 at every shape the paths give it (chip_compare.py group): (label,
# clouds, points, seed) of the serving requests and the 36 x 7168 training batch
GROUP_SHAPES = (("16 x 10240", SMALL, N_POINTS, 1), ("36 x 10240", LARGE, N_POINTS, 2),
                ("24 x 7168", FAULT_BATCHES[0], SHORT_POINTS, 4),
                ("28 x 7168", FAULT_BATCHES[1], SHORT_POINTS, 5),
                ("36 x 7168", LARGE, SHORT_POINTS, 12))
# kernel 3 at every shape the paths give it (phase 2, chip_compare.py query):
# (label, clouds, points, seed, path). "SA2" records the default engine's
# query (sectored FPS, r=8); "parity SA1" the SA1 query of the parity preset's
# engine (TrainConfig.apply_parity: exact FPS, no fast_group, r=2); 2 x 20608
# is SA2 beyond 4096 SA1 centroids (M=1031 of N=4122) and, under the parity
# preset, SA1 on clouds too large for one block's shared memory
QUERY_SHAPES = (("SA2 16 x 10240", SMALL, N_POINTS, 1, "SA2"),
                ("SA2 36 x 10240", LARGE, N_POINTS, 2, "SA2"),
                ("SA2 24 x 7168", FAULT_BATCHES[0], SHORT_POINTS, 4, "SA2"),
                ("SA2 28 x 7168", FAULT_BATCHES[1], SHORT_POINTS, 5, "SA2"),
                ("SA2 36 x 7168", LARGE, SHORT_POINTS, 12, "SA2"),
                ("parity SA1 16 x 10240", SMALL, N_POINTS, 1, "parity SA1"),
                ("SA2 2 x 20608", 2, 20608, 31, "SA2"),
                ("parity SA1 2 x 20608", 2, 20608, 31, "parity SA1"))
# kernel 2's CUDA-core floor: a distance test is 9 instructions with no FMA (3
# sub, 3 mul, 2 add, a compare: csrc/stratified_select.cuh), at 128 FP32 lanes
# an SM a cycle
TEST_INSTRUCTIONS, FP32_LANES_PER_SM = 9, 128
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# kernel step vs plain-version step from one state and seed: every kernel is
# exact against its plain version, so the two steps should be identical; the
# bound allows one bf16 rounding step (2^-8) if a GEMM took another algorithm
PLAIN_STEP_RTOL = 2.0**-8
# kernel 6 vs its plain version, max|diff| / max|y|, by bf16: the two sum in
# another order; in bf16 an activation at a rounding boundary may then round
# one step the other way
FUSED_SA_RTOL = {True: BF16_SERVE_RTOL, False: 1e-5}
# the fused_sa model's eval forward on the kernels vs on the plain versions:
# kernel 6 sums in another order than its plain version, so an SA1 output
# near a bf16 rounding boundary rounds the other way in SA2's dense block,
# and that step travels through SA2, SA3 and the head (8.0e-3 on an H100)
FUSED_VS_PLAIN_RTOL = 2.5e-2
# the fused_sa model's forward vs the unfused model on the same weights (bf16):
# the fused layers keep h1, a1, h2 and a2 in float32 where the unfused MLP
# rounds each to bf16
FUSED_VS_UNFUSED_RTOL = 5e-2
# the fused_sa model's train-mode forward on the kernels vs on the plain
# versions: kernel 6 is not bit-exact (its sums run in another order), and the
# head's train-mode BatchNorm over the batch's 16 rows amplifies what differs
# (on an H100: output 2.5e-2, statistics 3.4e-3; SA1's and SA2's 8.2e-7,
# which are held at BF16_SERVE_RTOL)
FUSED_TRAIN_FORWARD_RTOL = 5e-2
FUSED_SA_REPS = 10
# a fused_sa step on the kernels vs on the plain versions, from one state and
# seed, by dtype: the loss (relative), each gradient in relative L2 norm and by
# max|diff| over the step's largest |g|, and the biases whose true gradient is
# 0 by the latter. Kernel 6 sums in another order than its plain version, so a
# max near a tie takes another slot and moves one centroid's share of a
# gradient whole (float32 with ELU on an H100: 9.1e-4 of the largest |g|,
# relative L2 2.2e-3); in bf16 a ReLU flip does too, so bf16 takes the
# cross-package bound of tests/test_torch_step.py.
FUSED_STEP_RTOL = {False: dict(loss=1e-5, grad_l2=1e-2, grad_top=2e-3, zero=1e-3),
                   True: dict(loss=1e-2, grad_l2=0.35, grad_top=None, zero=2e-2)}

# phase 13: the tools' paths, each its tool's main() once on the card; kernel 7's
# shapes (tail_bench's); kernel 8 vs its f32 plain version, of the plain
# version's largest s1 or s2; CUDA-event timings of the tools' kernels
TOOL_PATHS = ("tail_bench", "bn_stats_bench", "dma_probe", "bq_phase_bench")
TAIL_SHAPES = {"SA1": (36, 2048, 64, 64, 128), "SA2": (36, 512, 64, 128, 256)}
STATS_RTOL = 1e-5  # kernel 8 vs its f32 plain version, of the plain version's largest
TOOL_REPS = 10
# kernel 9 at the JAX tool's shape: (B, M, N), K; the cap case's far cluster
BQ_SHAPE, BQ_K, BQ_FAR = (36, 512, 2048), 64, 100.0


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


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
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


def seeded_model(device, seed: int = 0, split_first_layer: bool = True, fused_sa: bool = False,
                 compute_dtype: str = "bfloat16", activation: str = "ReLU",
                 neuron_multiplier: int = 0, **model_fields):
    """The production model with weights from a seeded ``torch.Generator``:
    torch-default Linear ranges and BatchNorm affine + running statistics away
    from identity, so that folding does real work. ``split_first_layer``,
    ``fused_sa``, ``compute_dtype`` and ``activation`` change the path, not
    the weights; ``neuron_multiplier`` (0 or 1: the production widths) scales
    every width, as the reference's constructor knob does; ``model_fields``
    (``msg``, ``doubled_radius``, ``analytic_bn``, ``remat``) set more of the
    config's model section."""
    import dataclasses

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.pointnet2 import build_model

    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, split_first_layer=split_first_layer, fused_sa=fused_sa,
        compute_dtype=compute_dtype, **model_fields), hp=dataclasses.replace(
            cfg.hp, activation_function=activation, neuron_multiplier=neuron_multiplier))
    return seed_weights(build_model(cfg, num_features=1), seed).to(device)


def seed_weights(model, seed: int):
    """``model`` with its Linear and BatchNorm weights and statistics drawn
    from ``seed`` (``seeded_model``'s draws, module by module)."""
    from dl_biomass_tpu_torch.models.layers import Dense, MaskedBatchNorm

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
    return model


def kernel_sites():
    """(module, wrapper name, plain version name) of each kernel of the paths."""
    from dl_biomass_tpu_torch.ops import (ball_group_kernel, ball_query_kernel, fps_kernel,
                                          gather_kernel, sa_eval_kernel, sa_train_kernel,
                                          sum_slices_kernel, tail_kernel)
    from dl_biomass_tpu_torch.tools import bn_stats_bench, bq_phase_bench, dma_probe

    return [(fps_kernel, "fps_rows", "fps_rows_plain"),
            (ball_group_kernel, "ball_group", "ball_group_plain"),
            (ball_query_kernel, "ball_query_first_k", "ball_query_plain"),
            (gather_kernel, "gather_rows_forward", "gather_rows_plain"),
            (gather_kernel, "gather_rows_aux", "gather_rows_aux_plain"),
            (sa_eval_kernel, "sa1_fused_eval", "sa1_fused_eval_plain"),
            (gather_kernel, "scatter_rows", "scatter_rows_plain"),
            (sa_train_kernel, "fused_sa_stage", "fused_sa_stage_plain"),
            (sa_train_kernel, "fused_sa_bwd_stage", "fused_sa_bwd_stage_plain"),
            (tail_kernel, "fused_tail_fwd", "fused_tail_fwd_plain"),
            (tail_kernel, "fused_tail_bwd", "fused_tail_bwd_plain"),
            (bn_stats_bench, "stats_kernel", "stats_current"),
            (sum_slices_kernel, "sum_slices", "sum_slices_plain"),
            (dma_probe, "block_copy", "block_copy_plain"),
            (bq_phase_bench, "bq", "bq_plain")]


def bn_train_sites():
    """(module, wrapper name, plain version name) of kernel 11's passes; not
    among ``kernel_sites``, so that a plain-version step keeps kernel 11 (its
    gradients differ from its plain version's by the order of the sums,
    which the zero-gradient biases before a BatchNorm show whole)."""
    from dl_biomass_tpu_torch.ops import bn_train_kernel

    return [(bn_train_kernel, name, f"{name}_plain") for name in ("f1", "f2", "b1", "b2")]


def record_kernel_inputs(serve, batch, sites=None):
    """Run ``serve(batch)`` (a forward or a training step) with recording
    wrappers: each kernel's arguments as the main path gives them (the
    kernels of ``sites``, by default ``kernel_sites()``)."""
    sites = kernel_sites() if sites is None else sites
    calls = {name: [] for _, name, _ in sites}

    def recorder(module, name):
        real = getattr(module, name)

        def rec(*args, **kwargs):
            calls[name].append((args, kwargs))
            return real(*args, **kwargs)
        return rec

    with ExitStack() as stack:
        for module, name, _ in sites:
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


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_floor_ms(tests: int) -> float:
    """Kernel 2's CUDA-core floor for ``tests`` distance tests: TEST_INSTRUCTIONS
    each at FP32_LANES_PER_SM lanes on every SM at the highest clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tests * TEST_INSTRUCTIONS / (FP32_LANES_PER_SM * sms * sm_clock_hz()) * 1e3


def group_bound(centers, cmask, pos, mask, feat, radius: float, out_dtype):
    """Kernel 2's bound (bytes: the inputs read once, the outputs written once;
    operations: the distance tests the data needs), with those tests."""
    from dl_biomass_tpu_torch.ops import ball_group_kernel

    b, m, _ = centers.shape
    n, f = pos.shape[1], (0 if feat is None else feat.shape[-1])
    tests = bucket_scan_lengths(centers, cmask, pos, mask, ball_group_kernel._radius2(radius))
    esize = torch.empty((), dtype=out_dtype).element_size()
    bms, by = bound(b * n * (12 + 4 * f + 1) + b * m * 13 + b * m * 64 * ((f + 3) * esize + 1),
                    tests * DIST_TEST_FLOPS)
    return bms, by, tests


def group_inputs(serve, device) -> list:
    """(label, args, kwargs) of kernel 2 in one forward of ``serve`` at each
    of GROUP_SHAPES."""
    out = []
    for label, b, n, seed in GROUP_SHAPES:
        batch = synthetic_batch(b, n, seed=seed, device=device)
        (args, kwargs), = record_kernel_inputs(serve, batch)["ball_group"]
        out.append((label, args, kwargs))
    return out


def time_group(label: str, args, kwargs, card: str) -> dict:
    """Kernel 2 at one shape: index-exact and bit-identical against its plain
    version and across two launches, then timed by CUDA events around the
    wrapper (median of 25), replayed from a CUDA graph and alone from a
    torch.profiler window; the lane-tests a full scan issues (B*M*N) beside
    the tests the data needs, the CUDA-core floor of each, the bound, and
    where the tree has them the plan, blocks per SM and the graph times of
    the scan-only and full-scan instantiations."""
    from dl_biomass_tpu_torch.ops import ball_group_kernel as k2

    centers, cmask, pos, mask, feat = args
    b, m, _ = centers.shape
    n = pos.shape[1]
    out_dtype = kwargs["out_dtype"]
    got = k2.ball_group(*args, **kwargs)
    again = k2.ball_group(*args, **kwargs)
    want = k2.ball_group_plain(*args, **kwargs)
    torch.cuda.synchronize()
    for x, y, what in ((got, want, "plain"), (got, again, "a second launch")):
        require(torch.equal(x[1], y[1]) and same_bits(x[2], y[2])
                and (x[0] is None or torch.equal(x[0], y[0])),
                f"ball group differs from {what} at {label} {out_dtype}")
    res = dict(label=label, dtype=str(out_dtype).replace("torch.", ""), b=b, m=m, n=n,
               plan=(tuple(k2.plan(n, m)) if hasattr(k2, "plan")
                     else "parent: one 128-thread block per centroid"))

    def fn():
        return k2.ball_group(*args, **kwargs)

    res.update(ms=time_ms(fn), graph_ms=graph_ms(fn), alone_ms=kernel_alone_ms(fn, "ball_group"))
    if hasattr(k2, "probe"):
        for mode in ("scan_only", "full_scan"):
            res[f"{mode}_graph_ms"] = graph_ms(lambda: k2.probe(
                *args, radius=kwargs["radius"], mode=mode, out_dtype=out_dtype))
    if hasattr(k2, "occupancy"):
        res["occupancy"] = k2.occupancy(n, m)
    res["bound_ms"], res["bound_by"], res["tests"] = group_bound(*args, kwargs["radius"],
                                                                 out_dtype)
    res["lane_tests"] = b * m * n
    res["floor_tests_ms"] = scan_floor_ms(res["tests"])
    res["floor_full_ms"] = scan_floor_ms(res["lane_tests"])
    return res


def query_inputs(serve, device) -> list:
    """(label, args, kwargs) of kernel 3 at each of QUERY_SHAPES: the call one
    forward of ``serve`` (the default engine) makes, or of the parity preset's
    engine (its first call, SA1's)."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.models.pointnet2 import build_model

    engines = {"SA2": serve}
    if any(path == "parity SA1" for *_, path in QUERY_SHAPES):
        parity = build_model(TrainConfig().apply_parity(), num_features=1).to(device)
        engines["parity SA1"] = compile_inference(parity, device)
    out = []
    for label, b, n, seed, path in QUERY_SHAPES:
        batch = synthetic_batch(b, n, seed=seed, device=device)
        args, kwargs = record_kernel_inputs(engines[path], batch)["ball_query_first_k"][0]
        out.append((label, args, kwargs))
    return out


def query_scan(args, kwargs, want) -> dict:
    """The points each valid centroid's exact scan tests (up to its K-th hit,
    else all N), from the plain version's output ``want``: their sum (the
    distance tests the data needs), mean, p99 and longest, in points and in
    passes of 32, and the centroids that scan all N."""
    centers, cmask, pos, mask = args
    k, n = kwargs["k"], pos.shape[1]
    idx, nbr = want
    scan = torch.where(nbr[..., k - 1], idx[..., k - 1].long() + 1,
                       torch.full_like(idx[..., k - 1], n, dtype=torch.long))[cmask]
    if scan.numel() == 0:
        return dict(tests=0)
    passes = (scan + 31) // 32
    return dict(tests=int(scan.sum()), scan_mean=float(scan.double().mean()),
                scan_p99=float(torch.quantile(scan.double(), 0.99)), scan_max=int(scan.max()),
                passes_mean=float(passes.double().mean()),
                passes_p99=float(torch.quantile(passes.double(), 0.99)),
                passes_max=int(passes.max()), full_scans=int((scan >= n).sum()),
                centroids=int(scan.numel()))


def query_bound(args, kwargs, tests: int):
    """Kernel 3's bound in both parts: bytes (points and centroids read once,
    the (B, M, K) int32 and bool outputs written once) and operations (the
    distance tests the data needs)."""
    centers, _, pos, _ = args
    b, m, _ = centers.shape
    nbytes = b * pos.shape[1] * 13 + b * m * 13 + b * m * kwargs["k"] * 5
    return bound(nbytes, tests * DIST_TEST_FLOPS), bound(nbytes, 0)[0], bound(0, tests *
                                                                              DIST_TEST_FLOPS)[0]


def time_query(label: str, args, kwargs, card: str, plain: bool = False) -> dict:
    """Kernel 3 at one shape: index-exact against its plain version and
    identical across two launches, then timed by CUDA events around the
    wrapper (median of 25), replayed from a CUDA graph and alone from a
    torch.profiler window, beside the bound in both its parts, the scan the
    data needs and its CUDA-core floor, the transpose copy the parent's
    wrapper made alone (by graph), and where the tree has them the plan, the
    launch's blocks per SM and the graph time of each measurement mode (no
    early exit; the staging alone; no writing);
    ``plain`` adds the plain version's time by events."""
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3

    centers, cmask, pos, mask = args
    b, m, _ = centers.shape
    n = pos.shape[1]
    got = k3.ball_query_first_k(*args, **kwargs)
    again = k3.ball_query_first_k(*args, **kwargs)
    want = k3.ball_query_plain(*args, **kwargs)
    torch.cuda.synchronize()
    for x, what in ((want, "plain"), (again, "a second launch")):
        require(torch.equal(got[0], x[0]) and torch.equal(got[1], x[1]),
                f"ball query differs from {what} at {label}")

    def fn():
        return k3.ball_query_first_k(*args, **kwargs)

    res = dict(label=label, b=b, m=m, n=n, k=kwargs["k"], radius=kwargs["radius"],
               plan=(k3.plan(n, m, kwargs["k"])._asdict() if hasattr(k3, "plan")
                     else "parent: one warp a centroid, four a block, planes from L2"))
    res.update(ms=time_ms(fn), graph_ms=graph_ms(fn), alone_ms=kernel_alone_ms(fn, "ball_query"))
    if plain:
        res["plain_ms"] = time_ms(lambda: k3.ball_query_plain(*args, **kwargs))
    res["transpose_graph_ms"] = graph_ms(lambda: pos.transpose(1, 2).contiguous())
    for mode in getattr(k3, "MODES", ()):
        if mode != "kernel":
            res[f"{mode}_graph_ms"] = graph_ms(lambda: k3.probe(*args, **kwargs, mode=mode))
    if hasattr(k3, "occupancy"):
        res["occupancy"] = k3.occupancy(n, m, kwargs["k"])
    res.update(query_scan(args, kwargs, want))
    (res["bound_ms"], res["bound_by"]), res["bytes_ms"], res["operations_ms"] = query_bound(
        args, kwargs, res["tests"])
    res["floor_tests_ms"] = scan_floor_ms(res["tests"])
    res["floor_full_ms"] = scan_floor_ms(res.get("centroids", 0) * n)
    print(f"kernel ball_query {label}: " + " ".join(
        f"{key}={round(val, 6) if isinstance(val, float) else val}" for key, val in res.items()
        if key != "label") + f"; index-exact, repeats identical [{card}]", flush=True)
    return res


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
              f"bound {fps_bound(r, n, k)[0]:.6f} ms, index-exact", flush=True)
        ms, plain_ms, nbytes, flops = ms + t, plain_ms + tp, nbytes + cb, flops + cf
    bms, by = bound(nbytes, flops)
    rows.append(dict(name="fps_rows", source="dl_biomass_tpu_torch/csrc/fps.cu",
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
    bms, by, tests = group_bound(*args, radius, out_dtype)
    print(f"kernel ball_group B={b} M={m} N={n} F={f} {out_dtype} plan "
          f"{tuple(ball_group_kernel.plan(n, m))}: {t:.4f} ms, CUDA graph {graph_ms(bg):.4f} ms, "
          f"plain {tp:.4f} ms, bound {bms:.6f} ms ({tests} distance tests; CUDA-core floor "
          f"{scan_floor_ms(tests):.4f} ms, full scan {scan_floor_ms(b * m * n):.4f}), "
          f"selection index-exact, planes bit-identical (bf16 and f32)", flush=True)
    rows.append(dict(name="ball_group", source="dl_biomass_tpu_torch/csrc/ball_group.cu",
                     replaces="dl_biomass_tpu/ops/pallas_group.py:139", entry="dlbt_ball_group",
                     max_abs_err=err, ms=t, plain_ms=tp, bound_ms=bms, bound_by=by,
                     library_ms=None))

    # kernel 3: exact ball query (every shape of QUERY_SHAPES follows in run)
    (args, kwargs), = calls["ball_query_first_k"]
    res = time_query("serve 16 x 10240", args, kwargs, card_line(), plain=True)
    rows.append(dict(name="ball_query_first_k", source="dl_biomass_tpu_torch/csrc/ball_query.cu",
                     replaces="dl_biomass_tpu/ops/pallas_ballquery.py:142",
                     entry="dlbt_ball_query", max_abs_err=0.0, ms=res["ms"],
                     plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                     bound_by=res["bound_by"], library_ms=None, graph_ms=res["graph_ms"],
                     alone_ms=res["alone_ms"]))

    # kernel 4: row gather
    (args, kwargs), = calls["gather_rows_forward"]
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
    tg = graph_ms(lambda: gather_kernel.gather_rows(values, idx))
    tp = time_ms(lambda: gather_kernel.gather_rows_plain(values, idx))
    tl = time_ms(lambda: values[b_ar, idx_l])
    tlg = graph_ms(lambda: values[b_ar, idx_l])
    b, n, c = values.shape
    _, m, k = idx.shape
    es = values.element_size()
    bms, by = bound(b * m * k * c * es + b * m * k * 4 + b * n * c * es, 0)
    print(f"kernel gather B={b} N={n} C={c} M={m} K={k} {values.dtype}: {t:.4f} ms, CUDA "
          f"graph {tg:.4f} ms, plain {tp:.4f} ms, library (values[b, idx]) {tl:.4f} ms (graph "
          f"{tlg:.4f}), bound {bms:.6f} ms, bit-identical", flush=True)
    rows.append(dict(name="gather_rows_forward", source="dl_biomass_tpu_torch/csrc/gather.cu",
                     replaces="dl_biomass_tpu/ops/pallas_mxu_gather.py:191",
                     entry="dlbt_gather", max_abs_err=max_abs_err(got, want), ms=t,
                     plain_ms=tp, bound_ms=bms, bound_by=by, library_ms=tl, graph_ms=tg,
                     library_graph_ms=tlg))
    return rows


def fps_inputs(serve, device) -> list:
    """(label, (pos, mask, starts, k)) of kernel 1 at each of FPS_SHAPES."""
    out = []
    for label, b, n, seed, how in FPS_SHAPES:
        batch = synthetic_batch(b, n, seed=seed, device=device)
        if how == "sectored":
            sa1, sa2 = [args for args, _ in record_kernel_inputs(serve, batch)["fps_rows"]]
            out += [(f"{label} SA1", sa1), (f"{label} SA2", sa2)]
        else:
            starts = torch.zeros(b, dtype=torch.int32, device=device)
            out.append((label, (batch.pos, batch.mask, starts, math.ceil(0.2 * n))))
    return out


def fps_bound(rows: int, n: int, k: int):
    """Kernel 1's bound: each point read once (xyz and mask), the picks written
    once, and FPS_FLOPS_PER_POINT_STEP on every point at every step."""
    return bound(rows * n * 13 + rows * 4 + rows * k * 4,
                 rows * n * 5 + rows * (k - 1) * n * FPS_FLOPS_PER_POINT_STEP)


def time_fps(label: str, args, card: str) -> dict:
    """Kernel 1 at one shape: index-exact against its plain version and
    bit-identical across two launches, then timed by CUDA events around the
    wrapper (median of 25), replayed from a CUDA graph (free of host time) and
    alone from a torch.profiler window, with the time per step, the chain-only
    instantiation's graph time where the tree has it, and the bound."""
    from dl_biomass_tpu_torch.ops import fps_kernel

    pos, mask, starts, k = args
    r, n, _ = pos.shape
    got = fps_kernel.fps_rows(pos, mask, starts, k)
    again = fps_kernel.fps_rows(pos, mask, starts, k)
    want = fps_kernel.fps_rows_plain(pos, mask, starts, k)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"FPS kernel differs from plain at {label} ({r} x {n}, k={k})")
    require(torch.equal(got, again), f"FPS kernel: two launches differ at {label}")
    res = dict(label=label, rows=r, n=n, k=k,
               plan=(fps_kernel.plan(n)._asdict() if hasattr(fps_kernel, "plan")
                     else "parent: one block per row, planes in shared memory or scratch"),
               ms=time_ms(lambda: fps_kernel.fps_rows(pos, mask, starts, k)),
               graph_ms=graph_ms(lambda: fps_kernel.fps_rows(pos, mask, starts, k)),
               alone_ms=kernel_alone_ms(lambda: fps_kernel.fps_rows(pos, mask, starts, k), "fps"))
    res["us_per_step"] = res["graph_ms"] * 1e3 / max(k - 1, 1)
    if hasattr(fps_kernel, "chain_only"):
        res["chain_graph_ms"] = graph_ms(lambda: fps_kernel.chain_only(pos, mask, starts, k))
        res["chain_us_per_step"] = res["chain_graph_ms"] * 1e3 / max(k - 1, 1)
    res["bound_ms"], res["bound_by"] = fps_bound(r, n, k)
    print(f"kernel fps {label} rows={r} n={n} k={k} plan {res['plan']}: events "
          f"{res['ms']:.4f} ms, graph {res['graph_ms']:.4f} ms, alone {res['alone_ms']:.4f} ms, "
          f"{res['us_per_step']:.4f} us/step (graph)"
          + (f", chain only {res['chain_graph_ms']:.4f} ms ({res['chain_us_per_step']:.4f} "
             "us/step)" if "chain_graph_ms" in res else "")
          + f", bound {res['bound_ms']:.6f} ms ({res['bound_by']}); index-exact, repeats "
          f"identical [{card}]", flush=True)
    return res


def check_gather_aux(calls, device):
    """Phase 4: kernel 4c against its plain version, timed, with its bound."""
    from dl_biomass_tpu_torch.ops import gather_kernel

    (args, kwargs), = calls["gather_rows_aux"]
    values, idx, aux = args
    got = gather_kernel.gather_rows_aux(values, idx, aux)
    want = gather_kernel.gather_rows_aux_plain(values, idx, aux)
    b_ar = torch.arange(values.shape[0], device=device)[:, None, None]
    idx_l = idx.long()
    torch.cuda.synchronize()
    require(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
            "aux gather kernel differs from plain in bits")
    require(same_bits(got[0], values[b_ar, idx_l]) and same_bits(got[1], aux[b_ar, idx_l]),
            "aux gather kernel differs from advanced indexing in bits")
    t = time_ms(lambda: gather_kernel.gather_rows_aux(values, idx, aux))
    tg = graph_ms(lambda: gather_kernel.gather_rows_aux(values, idx, aux))
    tp = time_ms(lambda: gather_kernel.gather_rows_aux_plain(values, idx, aux))
    tl = time_ms(lambda: (values[b_ar, idx_l], aux[b_ar, idx_l]))
    tlg = graph_ms(lambda: (values[b_ar, idx_l], aux[b_ar, idx_l]))
    b, n, c = values.shape
    _, m, k = idx.shape
    c2 = aux.shape[-1]
    es = values.element_size()
    bms, by = bound(b * m * k * (c * es + c2 * 4 + 4) + b * n * (c * es + c2 * 4), 0)
    print(f"kernel gather_rows_aux B={b} N={n} C={c} {values.dtype} + aux C2={c2} f32, M={m} "
          f"K={k}: {t:.4f} ms, CUDA graph {tg:.4f} ms, plain {tp:.4f} ms, yardstick "
          f"(values[b, idx] and aux[b, idx]) {tl:.4f} ms (graph {tlg:.4f}), bound {bms:.6f} ms, "
          f"bit-identical", flush=True)
    return dict(name="gather_rows_aux", source="dl_biomass_tpu_torch/csrc/gather.cu",
                replaces="dl_biomass_tpu/ops/pallas_mxu_gather.py:263", entry="dlbt_gather_aux",
                max_abs_err=max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])),
                ms=t, plain_ms=tp, bound_ms=bms, bound_by=by, library_ms=tl, graph_ms=tg,
                library_graph_ms=tlg)


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return max_abs_err(got, want) / max(float(want.double().abs().max()), 1e-30)


def check_sa1_fused_eval(calls, device):
    """Phase 4: kernel 5 against its plain version (bf16 at the path's inputs,
    and a small float32 case), timed beside its bound, its plain version and
    the default engine's unfused SA1 segment."""
    from dl_biomass_tpu_torch.models.inference import _run_folded
    from dl_biomass_tpu_torch.ops import ball_group_kernel, sa_eval_kernel
    from dl_biomass_tpu_torch.ops.pooling import masked_max

    (args, kwargs), = calls["sa1_fused_eval"]
    centers, cmask, pos, mask, feat, weights = args
    radius, bf16, out_dtype = kwargs["radius"], kwargs["bf16"], kwargs["out_dtype"]
    require(bf16 and out_dtype == torch.bfloat16, "the production path runs kernel 5 in bf16")
    require(kwargs.get("packed") is not None, "the fused_eval engine passed kernel 5 no block")
    unpacked = {k: v for k, v in kwargs.items() if k != "packed"}  # the wrapper packs
    got = sa_eval_kernel.sa1_fused_eval(*args, **kwargs)
    again = sa_eval_kernel.sa1_fused_eval(*args, **kwargs)
    alone = sa_eval_kernel.sa1_fused_eval(*args, **unpacked)
    want = sa_eval_kernel.sa1_fused_eval_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(same_bits(got, again) and same_bits(got, alone),
            "sa1_fused_eval: a repeat, or the wrapper packing for itself, changed bits")
    rel = rel_diff(got, want)
    require(rel <= BF16_SERVE_RTOL, f"sa1_fused_eval vs plain: rel {rel} > {BF16_SERVE_RTOL}")
    zero_got, zero_want = (got == 0).all(-1), (want == 0).all(-1)
    require(torch.equal(zero_got, zero_want), "sa1_fused_eval: zero rows differ from plain")
    require(bool(zero_got[~cmask].all()), "sa1_fused_eval: a masked centroid's row is not 0")
    # a small float32 case: 2 clouds, 256 centroids, the weights in float32
    small = (centers[:2, :256], cmask[:2, :256], pos[:2], mask[:2], feat[:2],
             [w.float() for w in weights])
    got32 = sa_eval_kernel.sa1_fused_eval(*small, radius=radius)
    want32 = sa_eval_kernel.sa1_fused_eval_plain(*small, radius=radius)
    torch.cuda.synchronize()
    rel32 = rel_diff(got32, want32)
    require(rel32 <= SA1_F32_RTOL, f"sa1_fused_eval f32 vs plain: rel {rel32} > {SA1_F32_RTOL}")

    ct = torch.bfloat16
    layers = [(weights[i].to(ct), weights[i + 1].float()) for i in range(0, 6, 2)]

    def unfused():  # the default engine's SA1 segment at the same inputs
        _, nm, e = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, radius=radius,
                                                out_dtype=ct, need_idx=False)
        return masked_max(_run_folded(e, layers, compute_dtype=ct), nm, dim=2)

    rel_unfused = rel_diff(got, unfused())
    require(rel_unfused <= BF16_SERVE_RTOL,
            f"sa1_fused_eval vs the unfused segment: rel {rel_unfused} > {BF16_SERVE_RTOL}")
    t = time_ms(lambda: sa_eval_kernel.sa1_fused_eval(*args, **kwargs))
    t_self = time_ms(lambda: sa_eval_kernel.sa1_fused_eval(*args, **unpacked))
    t_alone = kernel_alone_ms(lambda: sa_eval_kernel.sa1_fused_eval(*args, **kwargs),
                              "sa1_eval_mma_kernel")
    sel_kw = {k: v for k, v in kwargs.items() if k != "out_dtype"}
    t_sel = time_ms(lambda: sa_eval_kernel.selection_only(*args, **sel_kw))
    tp = time_ms(lambda: sa_eval_kernel.sa1_fused_eval_plain(*args, **kwargs), reps=5, warmup=1)
    tu = time_ms(unfused)

    b, m, _ = centers.shape
    n, f = pos.shape[1], feat.shape[-1]
    h1, h2, c = (weights[i].shape[1] for i in (0, 2, 4))
    _, nbr_mask, _ = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat, radius=radius,
                                                  out_dtype=ct, need_idx=False)
    edges = int(nbr_mask.sum())  # the valid slots: the MLP rows the data needs
    mlp_flops = edges * 2 * ((f + 3) * h1 + h1 * h2 + h2 * c)
    tests = bucket_scan_lengths(centers, cmask, pos, mask, ball_group_kernel._radius2(radius))
    nbytes = (b * n * (12 + 4 * f + 1) + b * m * 13 + sum(w.numel() * 4 for w in weights)
              + b * m * c * got.element_size())
    t_ops = mlp_flops / PEAK_BF16_FLOP_PER_S + tests * DIST_TEST_FLOPS / PEAK_F32_FLOP_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    floor = (mlp_flops + tests * DIST_TEST_FLOPS) / PEAK_F32_FLOP_PER_S * 1e3
    occ = sa_eval_kernel.occupancy(True, *(-(-w // 64) * 64 for w in (h1, h2, c)))
    print(f"kernel sa1_fused_eval B={b} M={m} N={n} F={f} widths {h1},{h2},{c} bf16: {t:.4f} ms "
          f"on the engine's packed block (packing per call {t_self:.4f} ms), the kernel alone "
          f"{t_alone:.4f} ms, its selection and capture alone {t_sel:.4f} ms; "
          f"{occ['blocks_per_sm']} block(s) of {occ['threads']} threads per SM, "
          f"{occ['smem_bytes']} bytes of shared memory each; "
          f"plain {tp:.4f} ms, yardstick (default engine's unfused SA1 segment: ball_group, "
          f"3 folded layers, masked_max) {tu:.4f} ms, bound {bms:.6f} ms ({by}: {edges} valid "
          f"edges x {mlp_flops // max(edges, 1)} flop on the bf16 tensor cores, {tests} distance "
          f"tests), CUDA-core f32 floor {floor:.4f} ms; vs plain max|diff|/max|y| {rel:.3e} "
          f"(bound {BF16_SERVE_RTOL}), f32 case {rel32:.3e} (bound {SA1_F32_RTOL}), vs unfused "
          f"segment {rel_unfused:.3e}; zero rows identical "
          f"({int(zero_want.sum())} of {zero_want.numel()}); a repeat and the wrapper packing "
          f"for itself bit-identical", flush=True)
    return dict(name="sa1_fused_eval", source="dl_biomass_tpu_torch/csrc/sa1_fused_eval.cu",
                replaces="dl_biomass_tpu/ops/pallas_sa_eval.py:176", entry="dlbt_sa1_fused_eval",
                max_abs_err=max_abs_err(got, want), ms=t, plain_ms=tp, bound_ms=bms, bound_by=by,
                library_ms=None, yardstick_ms=tu, packing_per_call_ms=t_self,
                kernel_alone_ms=t_alone, selection_only_ms=t_sel,
                blocks_per_sm=occ["blocks_per_sm"], threads_per_block=occ["threads"])


def scatter_case(calls):
    """(ct, idx, n, nbr) of kernel 4b in a recorded step: its inputs, and the
    ball query's mask of the same index (False at the pad slots, which point
    at row 0)."""
    from dl_biomass_tpu_torch.ops import ball_query_kernel

    (args, _), = calls["scatter_rows"]
    ct, idx, n = args
    (bq_args, bq_kwargs), = calls["ball_query_first_k"]
    bq_idx, nbr = ball_query_kernel.ball_query_first_k(*bq_args, **bq_kwargs)
    require(torch.equal(bq_idx.to(idx.dtype), idx), "the gather's index is not the ball query's")
    return ct, idx, n, nbr


def scatter_segments(idx, n: int, nbr) -> dict:
    """Members of each output row of kernel 4b (its segment): mean, 99th
    percentile and longest over the rows, the longest row 0 (which also takes
    a cloud's pad slots) and the longest over true neighbours alone."""
    b = idx.shape[0]

    def counts(ok):
        keys = (idx.long() + torch.arange(b, device=idx.device).view(b, 1, 1) * n)[ok]
        return torch.bincount(keys, minlength=b * n).view(b, n).float()

    ok = (idx >= 0) & (idx < n)
    cnt, true = counts(ok), counts(ok & nbr)
    return dict(mean=round(float(cnt.mean()), 2), p99=float(torch.quantile(cnt.flatten(), 0.99)),
                longest=int(cnt.max()), longest_row0=int(cnt[:, 0].max()),
                longest_true=int(true.max()), pads=int((ok & ~nbr).sum()))


def time_scatter(ct, idx, n: int, nbr) -> dict:
    """Kernel 4b at one input: bit-identical against its plain version and
    across two launches, then timed by CUDA events (median of SCATTER_REPS)
    and replayed from a CUDA graph beside one ``index_add_`` (float atomics:
    a yardstick only), with its bound; where the tree has them, each of its
    launches alone (``gather_kernel.probe``) from a graph, also on the
    index with the pad slots taken out (-1: they then add nothing)."""
    from dl_biomass_tpu_torch.ops import gather_kernel as k4

    got = k4.scatter_rows(ct, idx, n)
    again = k4.scatter_rows(ct, idx, n)
    want = k4.scatter_rows_plain(ct, idx, n)
    torch.cuda.synchronize()
    require(same_bits(got, want), "scatter kernel differs from plain in bits")
    require(same_bits(got, again), "scatter kernel: a second launch changed bits")
    b, m, k, c = ct.shape
    ok = (idx >= 0) & (idx < n)
    keys = (idx.long() + torch.arange(b, device=ct.device).view(b, 1, 1) * n)[ok]
    src = ct.reshape(b, m, k, c)[ok].float()  # the f32 image of the rows that count
    buf = torch.empty((b * n, c), dtype=torch.float32, device=ct.device)

    def library():  # float atomics: a yardstick only, not deterministic
        buf.zero_()
        return buf.index_add_(0, keys, src).to(ct.dtype)

    lib = library().view(b, n, c)
    torch.cuda.synchronize()

    def kernel():
        return k4.scatter_rows(ct, idx, n)

    valid = int(ok.sum())
    bms, by = bound(ct.numel() * ct.element_size() + idx.numel() * 4
                    + b * n * c * ct.element_size(), valid * c)
    res = dict(b=b, m=m, k=k, c=c, n=n, dtype=str(ct.dtype).replace("torch.", ""),
               ms=time_ms(kernel, reps=SCATTER_REPS), graph_ms=graph_ms(kernel),
               library_ms=time_ms(library, reps=SCATTER_REPS), library_graph_ms=graph_ms(library),
               library_max_abs_diff=max_abs_err(lib, want), bound_ms=bms, bound_by=by,
               rows=valid, err=max_abs_err(got, want), segments=scatter_segments(idx, n, nbr))
    if hasattr(k4, "probe"):
        no_pads = torch.where(nbr, idx, torch.full_like(idx, -1))
        for tag, index in (("", idx), ("no_pads_", no_pads)):
            scratch = k4.probe_scratch(ct, index, n)
            for mode in k4.PROBE_MODES:
                res[f"{tag}{mode}_graph_ms"] = graph_ms(
                    lambda: k4.probe(ct, index, n, mode, scratch))
            res[f"{tag}kernel_graph_ms"] = graph_ms(lambda: k4.scatter_rows(ct, index, n))
    return res


def check_scatter(calls, device):
    """Phase 6: kernel 4b against its plain version, timed, with its bound."""
    from dl_biomass_tpu_torch.ops import gather_kernel

    ct, idx, n, nbr = scatter_case(calls)
    res = time_scatter(ct, idx, n, nbr)
    tp = time_ms(lambda: gather_kernel.scatter_rows_plain(ct, idx, n), reps=3, warmup=1)
    print(f"kernel scatter_rows B={res['b']} M={res['m']} K={res['k']} C={res['c']} N={n} "
          f"{ct.dtype}: {res['ms']:.4f} ms (median of {SCATTER_REPS}), CUDA graph "
          f"{res['graph_ms']:.4f} ms, plain {tp:.4f} ms, library (index_add_ of the f32 rows, "
          f"float atomics) {res['library_ms']:.4f} ms (graph {res['library_graph_ms']:.4f}), "
          f"bound {res['bound_ms']:.6f} ms ({res['rows']} rows), bit-identical to plain and "
          f"across two launches; library max|diff| {res['library_max_abs_diff']:.3e}; segments "
          f"{res['segments']}", flush=True)
    return dict(name="scatter_rows", source="dl_biomass_tpu_torch/csrc/gather_bwd.cu",
                replaces="dl_biomass_tpu/ops/pallas_mxu_gather.py:164", entry="dlbt_scatter_rows",
                max_abs_err=res["err"], ms=res["ms"], plain_ms=tp, bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=res["library_ms"],
                graph_ms=res["graph_ms"], library_graph_ms=res["library_graph_ms"])


# kernel 11, phase 6: one step at the SSG cell's shape, 36 clouds of
# BN_POINTS points in BN_SLOTS slots; each pass's partials against its plain
# version's: two float32 sums of a chunk's 64 terms, in two orders, differ by
# at most 2 x 63 units of float32's last place of the sum of |term|
BN_POINTS, BN_SLOTS, BN_SEED = SHORT_POINTS, 7936, 13
BN_PART_RTOL, BN_SUM_RTOL = 2.0**-16, 1e-9


def bn_part_check(label: str, got: torch.Tensor, want: torch.Tensor,
                  size: torch.Tensor) -> float:
    """``got`` and ``want`` (chunk partials) within BN_PART_RTOL of ``size``
    (the chunks' sums of |term|, float64); returns the largest ratio."""
    err = (got.double() - want.double()).abs()
    worst = float((err / (size * BN_PART_RTOL + 1e-30)).max()) if err.numel() else 0.0
    require(bool(torch.isfinite(got).all()) and worst <= 1.0,
            f"kernel 11 {label}: partials off their plain version's by {worst:.3f} of the bound")
    return worst


def bn_train_calls(trainer, device) -> dict:
    """Kernel 11's calls in one training step at the SSG cell's shape."""
    batch = synthetic_batch(LARGE, BN_SLOTS, seed=BN_SEED, device=device,
                            sizes=[BN_POINTS] * LARGE)
    return record_kernel_inputs(lambda b: trainer.step(b, train_gen(device, 3)), batch,
                                bn_train_sites())


@torch.no_grad()
def check_bn_train(calls, card: str) -> dict:
    """Phase 6, kernel 11: each pass at each of its ``calls`` (``bn_train_calls``),
    against its plain version and a second launch, timed from a CUDA graph
    beside its bound and its plain version."""
    from dl_biomass_tpu_torch.ops import bn_train_kernel as bk
    from dl_biomass_tpu_torch.ops.sum_slices_kernel import sum_slices

    require([len(calls[n]) for n in ("f1", "f2", "b1", "b2")] == [BN_STEP_SHORT[e] for e in
                                                                  ENTRIES_11[:4]],
            f"kernel 11: a step made {[len(v) for v in calls.values()]} calls of F1, F2, B1, B2")
    chunk = bk.CHUNK

    def chunks(t):
        return t.reshape(-1, chunk, t.shape[-1]).sum(1)

    rows, total, bound_total, plain_total, worst = [], 0.0, 0.0, 0.0, 0.0
    for name in ("f1", "f2", "b1", "b2"):
        for i, (args, kwargs) in enumerate(calls[name]):
            kern = getattr(bk, name)
            plain = getattr(bk, f"{name}_plain")
            got, again, want = kern(*args, **kwargs), kern(*args, **kwargs), plain(*args, **kwargs)
            torch.cuda.synchronize()
            if name == "f1":
                x, bias, mask, dtype = args
                y = want[0] if bias is not None else x
                if bias is not None:
                    require(torch.equal(got[0], want[0]), f"kernel 11 F1 #{i}: y differs")
                ya, m = y.double().abs(), mask.view(-1, 1).double()
                worst = max(worst, bn_part_check(
                    f"F1 #{i}", got[1], want[1], torch.cat([chunks(ya * m), chunks(ya * ya * m)],
                                                           1)))
                parts = [got[1]]
                label = f"F1{'' if bias is not None else ' from y'}"
                es = y.element_size()
                nbytes = (x.numel() * 4 + y.numel() * es if bias is not None else y.numel() * es)
                nbytes += mask.numel() + got[1].numel() * 4
            elif name == "f2":
                y, scale, shift, act = args
                require(torch.equal(got, want), f"kernel 11 F2 #{i}: the output differs")
                parts, label, nbytes = [], "F2", 2 * y.numel() * y.element_size()
            elif name == "b1":
                dout, y, scale, shift, mean, act = args
                g = bk._act_grad(bk._normalized(y, scale, shift), dout, act).double()
                size = torch.cat([chunks(g.abs()), chunks((g * (y.double() - mean)).abs())], 1)
                worst = max(worst, bn_part_check(f"B1 #{i}", got, want, size))
                parts, label = [got], "B1"
                nbytes = 2 * y.numel() * y.element_size() + got.numel() * 4
            else:
                dout, y, mask = args[:3]
                bias_sums = kwargs.get("bias_sums", args[8] if len(args) > 8 else False)
                require(torch.equal(got[0], want[0]), f"kernel 11 B2 #{i}: dy differs")
                parts, label = [], "B2" + (" with the bias's partials" if bias_sums else "")
                if bias_sums:
                    worst = max(worst, bn_part_check(f"B2 #{i}", got[1], want[1],
                                                     chunks(want[0].double().abs())))
                    parts = [got[1]]
                nbytes = 3 * y.numel() * y.element_size() + mask.numel() + (
                    got[1].numel() * 4 if bias_sums else 0)
            require(all(same_bits(a, b) for a, b in zip(
                [t for t in (got if isinstance(got, tuple) else (got,)) if t is not None],
                [t for t in (again if isinstance(again, tuple) else (again,)) if t is not None])),
                f"kernel 11 {label} #{i}: a second launch changed bits")
            n, c = y.shape
            kms = graph_ms(lambda: kern(*args, **kwargs))
            pms = graph_ms(lambda: plain(*args, **kwargs), calls=3, replays=3)
            bms, by = bound(nbytes, 10 * n * c)
            total, bound_total, plain_total = total + kms, bound_total + bms, plain_total + pms
            rows.append(dict(call=f"{name} #{i}", rows=n, c=c, ms=kms, bound_ms=bms,
                             plain_ms=pms))
            print(f"kernel bn_train {label} #{i} ({n} rows x {c}, {y.dtype}): {kms:.4f} ms by "
                  f"graph, bound {bms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB), "
                  f"{100 * bms / kms:.1f}% of it; plain {pms:.4f} ms; equal to plain, "
                  f"bit-identical across two launches [{card}]", flush=True)
            for part in parts:  # Σ's float64 sum of this pass's partials
                got64, want64 = sum_slices(part, torch.float64), part.double().sum(0)
                err = float(((got64 - want64).abs() / (part.double().abs().sum(0) + 1e-300))
                            .max())
                require(err <= BN_SUM_RTOL and torch.equal(got64, sum_slices(
                    part, torch.float64)), f"kernel 11 Σ f64 after {label} #{i}: rel {err}")
                sms = graph_ms(lambda: sum_slices(part, torch.float64))
                sbms, _ = bound(part.numel() * 4 + part.shape[1] * 8, part.numel())
                total, bound_total = total + sms, bound_total + sbms
                rows.append(dict(call=f"sum_f64 after {name} #{i}", slices=part.shape[0],
                                 n=part.shape[1], ms=sms, bound_ms=sbms, rel=err))
                print(f"kernel bn_train Σ f64 of {label} #{i}'s partials ({part.shape[0]} x "
                      f"{part.shape[1]}): {sms:.4f} ms by graph, bound {sbms:.4f} ms, within "
                      f"{err:.2e} of the float64 sum's |terms| (bound {BN_SUM_RTOL:g}) [{card}]",
                      flush=True)
    sums = sum(1 for r in rows if r["call"].startswith("sum_f64"))
    require(sums == BN_STEP_SHORT["dlbt_sum_slices_f64"],
            f"kernel 11: {sums} float64 sums a step")
    print(f"kernel bn_train: a step at {LARGE} x {BN_POINTS} ({BN_SLOTS} slots): "
          f"{len(rows) - sums} passes and {sums} float64 sums {total:.4f} ms by graph, bound "
          f"{bound_total:.4f} ms ({100 * bound_total / total:.1f}% of it), their plain versions "
          f"{plain_total:.4f} ms; partials within {worst:.3f} of their bound [{card}]",
          flush=True)
    return dict(name="bn_train", source="dl_biomass_tpu_torch/csrc/bn_train.cu",
                replaces="none: the train-mode MaskedBatchNorm chain of an SA MLP's hidden "
                         "layer, left to XLA's fusion (dl_biomass_tpu/models/layers.py)",
                entry="dlbt_bn_stats", ms=total, bound_ms=bound_total, plain_ms=plain_total,
                worst_part=worst, calls=rows)


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


def profile_calls(fn, calls: int = 3):
    """Device time per call of ``fn`` over a short window (torch.profiler): the
    wall time, the device's busy time, and the busy time by kernel and by the
    PyTorch operator that launched it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def table(device_type):
        rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count // calls)
                for e in events if e.device_type == device_type and e.self_device_time_total > 0]
        return sorted(rows, key=lambda r: r[1], reverse=True)

    kernels = table(torch.autograd.DeviceType.CUDA)
    busy_ms = sum(ms for _, ms, _ in kernels)
    return wall_ms / calls, busy_ms, kernels, table(torch.autograd.DeviceType.CPU)


def kernel_alone_ms(fn, name: str, calls: int = 5, windows: int = 8) -> float:
    """Device time per launch of the kernels whose name holds ``name``, over
    ``calls`` calls of ``fn`` under torch.profiler: their time over the
    launches it recorded, since a window can miss its first launch (and has
    recorded none of five on an H100, once in three windows running: another
    window is then opened, up to ``windows``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        if hits:
            return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3
    raise PhaseError(f"the profiler recorded no launch of {name} in {windows} windows")


def graph_ms(fn, calls: int = TOOL_REPS, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the median of ``replays`` replays between two events, so that no
    host work (which CUDA events around ``fn`` also hold once the host is
    slower than the device) stands between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del graph
    return statistics.median(times)


def sum_slices_graph_ms(slices: torch.Tensor):
    """Σ and its library call, ``torch.sum(slices, 0, dtype=torch.float64)``,
    each replayed from a CUDA graph (``graph_ms``)."""
    from dl_biomass_tpu_torch.ops import sum_slices_kernel as ss

    return (graph_ms(lambda: ss.sum_slices(slices)),
            graph_ms(lambda: torch.sum(slices, 0, dtype=torch.float64)))


def print_profile(what: str, fn, calls: int, n_kernels: int = 10, n_ops: int = 12):
    """Prints the profile of ``fn``; returns (device ms, wall ms) per call, or
    None where the profiler recorded no device time."""
    wall, busy, by_kernel, by_op = profile_calls(fn, calls)
    if busy <= 0:
        print(f"profile {what}: the profiler recorded no device time (not measured)", flush=True)
        return None
    print(f"profile {what}: {busy:.3f} ms of device time in {wall:.3f} ms per call under the "
          f"profiler (device idle {1 - busy / wall:.1%})", flush=True)
    for title, table in (("by kernel", by_kernel[:n_kernels]), ("by operator", by_op[:n_ops])):
        print(f"profile {what} {title}:", flush=True)
        for name, ms, count in table:
            print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{count:<3d} {name[:100]}", flush=True)
    return busy, wall


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

    kernels = drive(torch.device("cuda"), card)

    # phase 20: summary
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


WIDE_MULTIPLIERS = (2, 3)
PATHS = ("serve", "serve_fused_eval", "serve_unsplit", "train", "train_unsplit", "eval_fused_sa",
         "train_forward_fused_sa", "train_fused_sa") + tuple(
             f"fused_sa_x{nm}" for nm in WIDE_MULTIPLIERS) + (
                 "serve_fused_eval_wide",) + TOOL_PATHS + (
                     "device_dataset", "disk_pipeline", "research", "export", "export_unsplit",
                     "mesh_train", "mesh_fit", "mesh_serve", "mesh_serve_fused_eval",
                     "mesh_sweep")


def drive(device, card: str) -> list:
    """Phases 2-19; returns the kernels' summary rows, with each kernel's
    launches in the run of each path."""
    launches = {}  # path -> {entry: launches in that path's run}
    rows, ctx = run(device, card, launches)
    rows += serve_configs(device, card, ctx, launches)
    rows += train_phases(device, card, launches)
    train_unsplit(device, card, launches)
    check_fps_scratch(device, card)
    rows += check_fused_sa(device, card)
    fused_sa_paths(device, card, launches)
    wide_fused_sa(device, card, launches)
    by_width = wide_fused_eval(device, card, launches)
    rows += tool_paths(device, card, launches)
    device_dataset(device, card, launches)
    resample = disk_pipeline(device, card, launches)
    research(device, card, launches)
    mesh_export(device, card, launches)
    msg_radii = variants(device, card, launches)
    mp_tools(device, card, launches)
    next(r for r in rows if r["entry"] == "dlbt_sa1_fused_eval")["by_width"] = by_width
    next(r for r in rows if r["entry"] == "dlbt_fps")["resample"] = resample
    for entry, t in (("dlbt_ball_group", msg_radii["group"]),
                     ("dlbt_ball_query", msg_radii["query"])):  # at msg's second radius
        next(r for r in rows if r["entry"] == entry)[f"msg_r{t['radius']:g}"] = {
            k: t[k] for k in ("label", "ms", "graph_ms", "alone_ms", "bound_ms", "bound_by",
                              "tests")}
    kernels = []
    for r in sorted(rows, key=lambda r: ENTRIES.index(r["entry"])):
        w = r.pop("entry")
        by_path = {path: launches[path][w]
                   for path in PATHS + VARIANT_PATHS + MP_PATHS + REST_TOOLS}
        if not r["source"].endswith((FWD_SOURCE, BWD_SOURCE)) and w in ENTRIES_6:
            # kernel 6's entries also run the CUDA-core kernel where mma_takes refuses
            r["cuda_core_launches_by_path"] = {p: c.get(w, 0) for p, c in
                                               launches.get("cuda_core", {}).items()}
        kernels.append(dict(name=r.pop("name"), route="cuda", source=r.pop("source"),
                            replaces=r.pop("replaces"), launches=sum(by_path.values()),
                            launches_by_path=by_path, **r))
    return kernels


def serving_requests(device):
    """16 x 10240, 36 x 10240, a partial request, the first again, the partial
    one with garbage in its pad rows, and 24 and 28 x 7168."""
    n_points = N_POINTS
    req16 = synthetic_batch(SMALL, n_points, seed=1, device=device)
    req36 = synthetic_batch(LARGE, n_points, seed=2, device=device)
    sizes = np.random.default_rng(3).integers(PARTIAL_LO, n_points + 1, size=PARTIAL)
    part = synthetic_batch(PARTIAL, n_points, seed=3, device=device, sizes=sizes)
    pad = ~part.mask
    garbage = synthetic_batch(PARTIAL, n_points, seed=3, device=device, sizes=sizes)
    noise = torch.Generator(device=device).manual_seed(7)
    garbage.pos[pad] = 1e4 * torch.rand(int(pad.sum()), 3, device=device, generator=noise)
    garbage.feat[pad] = -1e4 * torch.rand(int(pad.sum()), 1, device=device, generator=noise)
    faults = [synthetic_batch(b, SHORT_POINTS, seed=4 + i, device=device)
              for i, b in enumerate(FAULT_BATCHES)]
    return [req16, req36, part, req16, garbage] + faults


# the requests of serving_requests held against the plain versions and the
# module: 16 and 36 x 10240, 24 and 28 x 7168
MAIN_REQUESTS = (0, 1, 5, 6)


def counted_run(path: str, fn, launches: dict, runs: int, total=None):
    """``fn()`` with every launch count set to 0 just before it and read just
    after; checks the counts against ``runs`` forwards or steps of ``path``
    (or against ``total``, launches by entry, where the runs differ)."""
    from dl_biomass_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.launch_counts.clear()
    out = fn()
    torch.cuda.synchronize()
    launches[path] = {e: _build.launch_counts[e] for e in ENTRIES}
    if total is None:
        check_launches(path, launches[path], runs)
    for e, want in (total or {}).items():
        require(launches[path][e] == want,
                f"{path}: {e} launched {launches[path][e]} times in {runs} runs, expected {want}")
    return out


def check_serving(path: str, serve, model, requests, launches: dict):
    """One path's serving run: launches, shapes, repeat and pad invariance,
    the plain-version forward and the unfolded module; returns the outputs."""
    outs = counted_run(path, lambda: [serve(r) for r in requests], launches, len(requests))
    print(f"{path} launches over {len(requests)} forwards: {launches[path]}", flush=True)
    for out, req in zip(outs, requests):
        b = req.pos.shape[0]
        require(tuple(out.shape) == (b, 4), f"{path}: output shape {tuple(out.shape)} != ({b}, 4)")
        require(bool(torch.isfinite(out).all()), f"{path}: non-finite prediction")
    require(torch.equal(outs[0], outs[3]), f"{path}: a repeated request gave another answer")
    require(torch.equal(outs[2], outs[4]), f"{path}: garbage in pad rows changed the predictions")
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        plain = [serve(requests[i]) for i in MAIN_REQUESTS]
    rel_plain = max(rel_diff(outs[i], p) for i, p in zip(MAIN_REQUESTS, plain))
    require(rel_plain <= BF16_SERVE_RTOL,
            f"{path}: kernel vs plain forward: rel {rel_plain} > {BF16_SERVE_RTOL}")
    with torch.inference_mode():
        rel_module = max(rel_diff(outs[i], model(requests[i])) for i in MAIN_REQUESTS)
    require(rel_module <= FOLDED_VS_MODULE_RTOL,
            f"{path}: folded serving vs module forward: rel {rel_module} > "
            f"{FOLDED_VS_MODULE_RTOL}")
    print(f"{path}: shapes (B, 4), finite; repeated request identical; pad garbage leaves "
          f"predictions identical; vs plain-version forward (B={SMALL}, {LARGE} x {N_POINTS}, "
          f"B={FAULT_BATCHES} x {SHORT_POINTS}) max|diff|/max|y| = {rel_plain:.3e} (bound "
          f"{BF16_SERVE_RTOL}); vs unfolded module: {rel_module:.3e} (bound "
          f"{FOLDED_VS_MODULE_RTOL})", flush=True)
    return outs


def run(device, card: str, launches: dict):
    """Phases 2 and 3; returns the serving kernels' rows and what phase 5
    reuses: the model, the requests, the default engine and its outputs."""
    from dl_biomass_tpu_torch.models.inference import compile_inference

    # phase 2: kernels at the inputs of one serving forward (B=16 x 10240)
    model = seeded_model(device)
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == 953_732, f"model has {n_params} parameters, not 953,732")
    serve = compile_inference(model, device)
    requests = serving_requests(device)
    calls = record_kernel_inputs(serve, requests[0])
    rows = check_kernels(calls, device)
    for label, args, kwargs in query_inputs(serve, device):
        time_query(label, args, kwargs, card)
    for label, args in fps_inputs(serve, device):
        time_fps(label, args, card)

    # phase 3: serve, with every launch of the main path counted
    outs = check_serving("serve", serve, model, requests, launches)
    print_profile(f"serve B={SMALL}", lambda: serve(requests[0]), calls=3)
    for i in MAIN_REQUESTS:
        req = requests[i]
        b, n = req.pos.shape[:2]
        torch.cuda.reset_peak_memory_stats()
        ms = serve_timing(serve, req)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serve B={b} x {n}: {ms:.3f} ms/batch, {b / ms * 1e3:.1f} clouds/s, "
              f"peak {peak:.2f} GiB [{card}]", flush=True)
    return rows, dict(model=model, requests=requests, serve=serve, outs=outs)


def serve_configs(device, card: str, ctx: dict, launches: dict) -> list:
    """Phases 4 and 5: kernels 4c and 5 at their configurations' inputs, then
    serving with fused_eval and with split_first_layer=False; returns the two
    kernels' rows."""
    from dl_biomass_tpu_torch.models.inference import compile_inference

    model, requests, serve, default_outs = ctx["model"], ctx["requests"], ctx["serve"], ctx["outs"]
    unsplit_model = seeded_model(device, split_first_layer=False)
    configs = {"serve_fused_eval": (compile_inference(model, device, fused_eval=True), model),
               "serve_unsplit": (compile_inference(unsplit_model, device), unsplit_model)}

    # phase 4: kernels 4c and 5 at the inputs of one B=16 x 10240 forward
    rows = [check_sa1_fused_eval(record_kernel_inputs(configs["serve_fused_eval"][0],
                                                      requests[0]), device),
            check_gather_aux(record_kernel_inputs(configs["serve_unsplit"][0], requests[0]),
                             device)]

    # phase 5: serve in each configuration, every launch counted
    for path, (fn, mod) in configs.items():
        outs = check_serving(path, fn, mod, requests, launches)
        if path == "serve_fused_eval":
            rel = max(rel_diff(outs[i], default_outs[i]) for i in MAIN_REQUESTS)
            require(rel <= FUSED_VS_DEFAULT_RTOL,
                    f"fused_eval vs the default engine: rel {rel} > {FUSED_VS_DEFAULT_RTOL}")
            print(f"serve_fused_eval vs the default engine: max|diff|/max|y| = {rel:.3e} "
                  f"(bound {FUSED_VS_DEFAULT_RTOL})", flush=True)
        prof = print_profile(f"{path} B={SMALL}", lambda: fn(requests[0]), calls=3)
        if path == "serve_fused_eval":
            idle = "not measured" if prof is None else f"{1 - prof[0] / prof[1]:.1%}"
            print(f"serve_fused_eval: {sum(launches[path].values()) / len(requests):g} kernel "
                  f"launches per forward; B={SMALL} device idle {idle} [{card}]", flush=True)
    for i in MAIN_REQUESTS:  # the three engines in turns, one request at a time
        req = requests[i]
        b, n = req.pos.shape[:2]
        times = {"serve": serve_timing(serve, req)}
        for path, (fn, _) in configs.items():
            torch.cuda.reset_peak_memory_stats()
            times[path] = serve_timing(fn, req)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{path} B={b} x {n}: {times[path]:.3f} ms/batch, "
                  f"{b / times[path] * 1e3:.1f} clouds/s, peak {peak:.2f} GiB; default engine "
                  f"in the same turn {times['serve']:.3f} ms/batch, "
                  f"{b / times['serve'] * 1e3:.1f} clouds/s [{card}]", flush=True)
    return rows


def train_timing(trainer, batch, generator, name: str, card: str, expected: dict) -> None:
    """TRAIN_WARMUP + TRAIN_TIMED steps on one fixed batch, each ending in a
    synchronize; checks loss, moved parameters and statistics, and launches
    per step against ``expected``."""
    from dl_biomass_tpu_torch.ops import _build

    b = batch.pos.shape[0]
    steps = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    counts0 = dict(_build.launch_counts)
    losses, times = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.step(batch, generator))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if s == 0:  # one step moved every parameter that has a gradient
            after = trainer.model.state_dict()
            for k, p in trainer.model.named_parameters():
                if p.grad is not None and bool(p.grad.abs().max() > 0):
                    require(not torch.equal(after[k], before[k]), f"{name}: {k} did not move")
            stats = [k for k in before if "running_" in k]
            require(all(not torch.equal(after[k], before[k]) for k in stats),
                    f"{name}: a BatchNorm running statistic did not move")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).float().cpu()
    require(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss {losses.tolist()}")
    require(float(losses[TRAIN_TIMED]) < float(losses[0]),
            f"{name}: loss after {TRAIN_TIMED} steps {float(losses[TRAIN_TIMED])} is not "
            f"below the first step's {float(losses[0])}")
    per_step = {}
    for k, per in expected.items():
        got = _build.launch_counts[k] - counts0.get(k, 0)
        require(got == per * steps, f"{name}: {k} launched {got} times in {steps} steps, "
                                    f"expected {per * steps}")
        per_step[k] = got / steps
    ms = statistics.median(times[TRAIN_WARMUP:])
    print(f"train {name}: {ms:.3f} ms/step (median of {TRAIN_TIMED} after {TRAIN_WARMUP}), "
          f"{b / ms * 1e3:.1f} clouds/s, peak {peak:.2f} GiB, loss {float(losses[0]):.4f} -> "
          f"{float(losses[TRAIN_TIMED]):.4f} after {TRAIN_TIMED} steps; launches per step "
          f"{per_step} [{card}]", flush=True)
    return ms, peak


def kernel_and_plain_steps(trainer, batch, seed: int, restore: bool = False):
    """One step on the kernels and one on their plain versions, from one state
    and one generator seed: (loss, gradients) of each; ``restore`` puts the
    state back after them."""
    device = batch.pos.device
    model_state = copy.deepcopy(trainer.model.state_dict())
    opt_state = copy.deepcopy(trainer.optimizer.state_dict())

    def one_step():
        loss = trainer.step(batch, torch.Generator(device=device).manual_seed(seed))
        return loss, {k: p.grad.clone() for k, p in trainer.model.named_parameters()}

    kernel = one_step()
    trainer.model.load_state_dict(model_state)
    trainer.optimizer.load_state_dict(opt_state)
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        plain = one_step()
    if restore:
        trainer.model.load_state_dict(model_state)
        trainer.optimizer.load_state_dict(opt_state)
    torch.cuda.synchronize()
    return kernel, plain


def compare_plain_step(trainer, batch, seed: int) -> None:
    """One step on the kernels and one on their plain versions, from one state
    and one generator seed: the same loss and gradients."""
    (loss_k, grads_k), (loss_p, grads_p) = kernel_and_plain_steps(trainer, batch, seed)
    identical = bool(torch.equal(loss_k, loss_p)) and all(
        torch.equal(grads_k[k], grads_p[k]) for k in grads_k)
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_k))
    rel_grad = max(float((grads_k[k] - grads_p[k]).abs().max())
                   / max(float(grads_k[k].abs().max()), 1e-30) for k in grads_k)
    require(rel_loss <= PLAIN_STEP_RTOL and rel_grad <= PLAIN_STEP_RTOL,
            f"kernel vs plain step: loss rel {rel_loss}, gradient rel {rel_grad} > "
            f"{PLAIN_STEP_RTOL}")
    print(f"train step on the kernels vs on the plain versions (B={batch.pos.shape[0]} x "
          f"{batch.pos.shape[1]}, one state and seed): loss rel {rel_loss:.3e}, max gradient "
          f"rel {rel_grad:.3e} (bound {PLAIN_STEP_RTOL:.3e}); bit-identical: {identical}",
          flush=True)


def train_gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def running_stats(model) -> dict:
    """Copies of the model's BatchNorm running statistics."""
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def train_phases(device, card: str, launches: dict) -> dict:
    """Phases 6 and 7; returns kernel 4b's and kernel 11's rows and records
    the launches of the training run."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    trainer = Trainer(seeded_model(device), TrainConfig(), device)
    batches = [synthetic_batch(b, n, seed=10 + i, device=device)
               for i, (b, n) in enumerate(TRAIN_SHAPES)]

    # phase 6: kernel 4b at the inputs of one training step (B=16 x 10240)
    calls = record_kernel_inputs(lambda b: trainer.step(b, train_gen(device, 0)), batches[0])
    require(len(calls["scatter_rows"]) == 1, "a training step launched the gather backward "
                                             f"{len(calls['scatter_rows'])} times, not once")
    row = check_scatter(calls, device)
    del calls
    bn_row = check_bn_train(bn_train_calls(trainer, device), card)

    # phase 7: train, every launch of the main path counted
    per_step = [EXPECTED["train"] if n == N_POINTS else EXPECTED["train_short"]
                for _, n in TRAIN_SHAPES]

    def steps():
        for i, ((b, n), batch) in enumerate(zip(TRAIN_SHAPES, batches)):
            train_timing(trainer, batch, train_gen(device, 100 + i), f"B={b} x {n}", card,
                         per_step[i])

    steps_each = TRAIN_WARMUP + TRAIN_TIMED
    counted_run("train", steps, launches, steps_each * len(TRAIN_SHAPES),
                total={e: steps_each * sum(t[e] for t in per_step) for e in ENTRIES})
    compare_plain_step(trainer, batches[0], seed=7)
    for i, b in enumerate(FAULT_BATCHES):
        batch = synthetic_batch(b, SHORT_POINTS, seed=4 + i, device=device)
        val = trainer.evaluate([batch])
        pred = trainer.predict([batch])
        require(np.isfinite(val) and pred.shape == (b, 4) and np.isfinite(pred).all(),
                f"evaluate/predict at B={b} x {SHORT_POINTS}: loss {val}, {pred.shape}")
    print(f"train: evaluate and predict at B={FAULT_BATCHES} x {SHORT_POINTS}: finite loss, "
          "predictions (B, 4) finite", flush=True)
    print_profile(f"train step B={TRAIN_SHAPES[0][0]}",
                  lambda: trainer.step(batches[0], train_gen(device, 9)), calls=2, n_kernels=14,
                  n_ops=16)
    return [row, bn_row]


def train_unsplit(device, card: str, launches: dict) -> None:
    """Phase 8: the model with split_first_layer=False takes 12 steps on the
    16 x 10240 batch of phase 7 (kernels 4c and 4b at SA2), and one step on
    the plain versions from the same state and seed."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    trainer = Trainer(seeded_model(device, split_first_layer=False), TrainConfig(), device)
    (b, n), = TRAIN_SHAPES[:1]
    batch = synthetic_batch(b, n, seed=10, device=device)
    counted_run("train_unsplit",
                lambda: train_timing(trainer, batch, train_gen(device, 100),
                                     f"unsplit B={b} x {n}", card, EXPECTED["train_unsplit"]),
                launches, TRAIN_WARMUP + TRAIN_TIMED)
    compare_plain_step(trainer, batch, seed=7)


def check_fps_scratch(device, card: str) -> None:
    """Phase 9: kernel 1's global-scratch variant, exact FPS (SA1's ratio) on
    rows beyond the registers, index-exact against its plain version."""
    from dl_biomass_tpu_torch.ops import fps_kernel

    r, n = SCRATCH_ROWS, SCRATCH_POINTS
    require(fps_kernel.plan(n).path == "planes", f"rows of {n} points fit the registers")
    batch = synthetic_batch(r, n, seed=30, device=device)
    pos, mask = batch.pos, batch.mask
    k = math.ceil(0.2 * n)
    starts = torch.zeros(r, dtype=torch.int32, device=device)
    got = fps_kernel.fps_rows(pos, mask, starts, k)
    want = fps_kernel.fps_rows_plain(pos, mask, starts, k)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"FPS scratch variant differs from plain at {r} x {n}")
    t = time_ms(lambda: fps_kernel.fps_rows(pos, mask, starts, k), reps=5, warmup=1)
    tp = time_ms(lambda: fps_kernel.fps_rows_plain(pos, mask, starts, k), reps=1, warmup=0)
    bms, by = fps_bound(r, n, k)
    print(f"kernel fps rows={r} n={n} k={k} (global-scratch variant): {t:.4f} ms (median of 5), "
          f"plain {tp:.4f} ms, bound {bms:.6f} ms ({by}), index-exact [{card}]", flush=True)


# kernel 6's passes: (row name, the Pallas kernel it replaces); the CUDA-core
# kernels' sources
FWD_SOURCE, BWD_SOURCE = "csrc/fused_sa_fwd.cu", "csrc/fused_sa_bwd.cu"
FUSED_SA_STAGES = {1: ("fused_sa_f1", "dl_biomass_tpu/ops/pallas_sa_train.py:245"),
                   2: ("fused_sa_f2", "dl_biomass_tpu/ops/pallas_sa_train.py:266"),
                   3: ("fused_sa_f3", "dl_biomass_tpu/ops/pallas_sa_train.py:289")}


def fused_sa_stage_flops(stage: int, params: dict) -> int:
    """flop per edge row of pass ``stage``: the products it recomputes."""
    w = [params[f"w{i}"].shape for i in (1, 2, 3)]
    return sum(2 * r * c for r, c in w[:stage])


def check_fused_sa_call(label: str, call, bf16: bool, ctx: dict):
    """One kernel 6 pass at recorded inputs: kernel vs plain (statistics or
    output, argmax, zero rows), two launches bit-identical, timings, bound."""
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6

    (stage, dense, planes, nbr_mask, params, folds), kwargs = call
    if not bf16 and dense is not None:
        dense = dense.float()
    # the forward hands F2 and F3 one block packed per layer (none in f32 or
    # where the layer runs on the CUDA cores): the replay packs it as the
    # forward does
    kwargs = dict(kwargs, bf16=bf16,
                  packed=k6.pack_fwd(dense, planes, nbr_mask, params) if bf16 else None)
    args = (stage, dense, planes, nbr_mask, params, folds)
    cd = 0 if dense is None else dense.shape[-1]
    cp = 0 if planes is None else planes.shape[-1]
    source = k6.pass_source(stage, False, cd, cp, params, bf16)
    got = k6.fused_sa_stage(*args, **kwargs)
    again = k6.fused_sa_stage(*args, **kwargs)
    want = k6.fused_sa_stage_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(all(same_bits(a, b) for a, b in zip(got, again)),
            f"kernel 6 {label}: two launches differ in bits")
    tol = FUSED_SA_RTOL[bf16]
    b, m, k = nbr_mask.shape
    note = ""
    if stage < 3:
        cnt = torch.clamp_min(nbr_mask.sum().float(), 1.0)
        g, w = k6._stats(*got, cnt), k6._stats(*want, cnt)
        rel = max(rel_diff(g[0], w[0]), rel_diff(g[1], w[1]))
        err = max(max_abs_err(g[0], w[0]), max_abs_err(g[1], w[1]))
        require(rel <= tol, f"kernel 6 {label}: statistics vs plain rel {rel} > {tol}")
    else:
        out, am = got
        w_out, w_am = want
        rel, err = rel_diff(out, w_out), max_abs_err(out, w_out)
        require(rel <= tol, f"kernel 6 {label}: output vs plain rel {rel} > {tol}")
        require(torch.equal((out == 0).all(-1), (w_out == 0).all(-1))
                and torch.equal(am == -1, w_am == -1), f"kernel 6 {label}: zero rows differ")
        h3 = k6.hidden_plain(3, *args[1:], act=kwargs.get("act", "ReLU"), bf16=bf16).view(
            b, m, k, -1)
        top2 = torch.where(nbr_mask[..., None], h3, float("-inf")).topk(2, dim=2).values
        lead = (top2[:, :, 0] - top2[:, :, 1]) > tol * float(w_out.abs().max())
        require(torch.equal(am[lead], w_am[lead]),
                f"kernel 6 {label}: argmax differs where the winner leads")
        note = f"; argmax equal where the winner leads ({int(lead.sum())} of {lead.numel()})"
        del h3, top2
    t = time_ms(lambda: k6.fused_sa_stage(*args, **kwargs), reps=FUSED_SA_REPS, warmup=2)
    tp = time_ms(lambda: k6.fused_sa_stage_plain(*args, **kwargs), reps=3, warmup=1)
    alone = fma = fma_alone = None
    if source != FWD_SOURCE:  # on the tensor cores: the kernel alone, and the CUDA-core
        alone = kernel_alone_ms(lambda: k6.fused_sa_stage(*args, **kwargs),  # kernel beside it
                                f"fused_sa_f{stage}_kernel")
        with mock.patch.object(k6, "mma_takes", lambda *widths: False):
            fma_kw = dict(kwargs, packed=None)
            other = k6.fused_sa_stage(*args, **fma_kw)
            rel_fma = max(rel_diff(a, b) for a, b in (zip(other, want) if stage < 3
                                                      else [(other[0], want[0])]))
            require(rel_fma <= tol, f"kernel 6 {label}: the CUDA-core F{stage} vs plain rel "
                                    f"{rel_fma} > {tol}")
            fma = time_ms(lambda: k6.fused_sa_stage(*args, **fma_kw), reps=FUSED_SA_REPS,
                          warmup=2)
            fma_alone = kernel_alone_ms(lambda: k6.fused_sa_stage(*args, **fma_kw),
                                        "fused_sa_fwd_kernel")
        note += (f"; kernel alone {alone:.4f} ms; the CUDA-core kernel ({FWD_SOURCE}) on the "
                 f"same inputs {fma:.4f} ms, alone {fma_alone:.4f} ms")
    edges = int(nbr_mask.sum())
    per_edge = fused_sa_stage_flops(stage, params)
    flops = edges * per_edge
    c_out = params[f"w{stage}"].shape[1]
    nbytes = (nbr_mask.numel() + sum(x.numel() * x.element_size() for x in (dense, planes)
                                     if x is not None)
              + sum(v.numel() * 4 for v in params.values())
              + (2 * c_out * 4 if stage < 3 else b * m * c_out * 8))
    peak = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    floor = flops / PEAK_F32_FLOP_PER_S * 1e3
    print(f"kernel fused_sa F{stage} {label} on {source} (B={b} M={m} CD={cd} CP={cp} widths "
          f"{','.join(str(params[f'w{i}'].shape[1]) for i in (1, 2, 3))}): {t:.4f} ms (median of "
          f"{FUSED_SA_REPS}), plain {tp:.4f} ms, bound {bms:.6f} ms ({by}: {edges} valid edges x "
          f"{per_edge} flop at {peak / 1e12:.0f} TFLOP/s, {nbytes} bytes), CUDA-core f32 floor "
          f"{floor:.4f} ms; vs plain max|diff|/max|y| {rel:.3e} (bound {tol}){note}; two "
          f"launches bit-identical", flush=True)
    ctx.setdefault(stage, []).append(dict(bf16=bf16, ms=t, plain_ms=tp, bound_ms=bms,
                                          bound_by=by, err=err, label=label, source=source,
                                          alone_ms=alone, fma_ms=fma, fma_alone_ms=fma_alone))
    return t


def unfused_layer_ms(mlp, call, bf16: bool, train: bool) -> float:
    """The yardstick: the unfused ``MLP`` and ``masked_max`` of the same layer
    on the same edges (the unfused path's edge tensor in the compute type)."""
    from dl_biomass_tpu_torch.models.layers import MLP
    from dl_biomass_tpu_torch.ops.pooling import masked_max

    (_, dense, planes, nbr_mask, _, _), _ = call
    ct = torch.bfloat16 if bf16 else torch.float32
    parts = ([] if dense is None else [dense.to(ct)]) + ([] if planes is None else [planes.to(ct)])
    edges = torch.where(nbr_mask[..., None], torch.cat(parts, dim=-1),
                        torch.zeros((), dtype=ct, device=nbr_mask.device))
    mlp = copy.deepcopy(mlp)  # train mode moves the copy's running statistics
    for lin in mlp.linears():
        lin.compute_dtype = ct

    def run():
        with torch.no_grad():
            return masked_max(MLP.forward(mlp, edges, nbr_mask, train), nbr_mask, dim=2)

    return time_ms(run, reps=FUSED_SA_REPS, warmup=2)


def layer_checks(model, train_calls, eval_calls, card: str, ctx: dict) -> None:
    """Each pass of each layer in bf16 and f32, train and eval; the yardsticks."""
    for li, (layer, mlp) in enumerate((("SA1", model.sa1.mlp), ("SA2", model.sa2.mlp))):
        for bf16 in (True, False):
            dt = "bf16" if bf16 else "f32"
            train_ms = sum(check_fused_sa_call(f"{layer} {dt} train", call, bf16, ctx)
                           for call in train_calls[3 * li:3 * li + 3])
            eval_ms = check_fused_sa_call(f"{layer} {dt} eval", eval_calls[li], bf16, ctx)
            yt = unfused_layer_ms(mlp, train_calls[3 * li + 2], bf16, train=True)
            ye = unfused_layer_ms(mlp, eval_calls[li], bf16, train=False)
            ctx.setdefault("yardstick", []).append(dict(bf16=bf16, train=yt, eval=ye))
            print(f"kernel fused_sa {layer} {dt}: F1+F2+F3 (train mode) {train_ms:.4f} ms against "
                  f"the unfused layer (MLP + masked_max, train mode) {yt:.4f} ms; F3 (eval) "
                  f"{eval_ms:.4f} ms against the unfused layer in eval mode {ye:.4f} ms "
                  f"[{card}]", flush=True)


def check_fused_sa(device, card: str) -> list:
    """Phase 10: kernel 6's passes at the inputs of one train-mode and one eval
    forward of the fused_sa model (B=16 x 10240), SA1 and SA2, bf16 and f32,
    against the plain version, timed; returns the three passes' rows."""
    model = seeded_model(device, fused_sa=True)
    batch = synthetic_batch(SMALL, N_POINTS, seed=1, device=device)
    rec = copy.deepcopy(model)  # the train-mode forward moves running statistics
    with torch.no_grad():
        train_calls = record_kernel_inputs(
            lambda b: rec(b, train=True, generator=train_gen(device, 0)), batch)["fused_sa_stage"]
        eval_calls = record_kernel_inputs(lambda b: model(b), batch)["fused_sa_stage"]
    del rec
    require([c[0][0] for c in train_calls] == [1, 2, 3, 1, 2, 3],
            f"a train-mode forward ran passes {[c[0][0] for c in train_calls]}")
    require([c[0][0] for c in eval_calls] == [3, 3],
            f"an eval forward ran passes {[c[0][0] for c in eval_calls]}")
    ctx = {}
    with torch.no_grad():
        layer_checks(model, train_calls, eval_calls, card, ctx)
    rows = []
    yard = [y for y in ctx["yardstick"] if y["bf16"]]  # the production type, both layers
    for stage, (name, replaces) in FUSED_SA_STAGES.items():
        runs = [r for r in ctx[stage] if r["bf16"] and r["label"].endswith("train")]
        require(len({r["source"] for r in runs}) == 1,
                f"kernel 6 F{stage}: SA1 and SA2 ran {[r['source'] for r in runs]}")
        row = dict(name=name, source=f"dl_biomass_tpu_torch/{runs[0]['source']}",
                   replaces=replaces, entry=f"dlbt_{name}",
                   max_abs_err=max(r["err"] for r in ctx[stage]),
                   ms=sum(r["ms"] for r in runs), plain_ms=sum(r["plain_ms"] for r in runs),
                   bound_ms=sum(r["bound_ms"] for r in runs),
                   bound_by=max(runs, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
                   yardstick_train_ms=sum(y["train"] for y in yard))
        if runs[0]["alone_ms"] is not None:  # on the tensor cores, beside the CUDA-core kernel
            row.update(kernel_alone_ms=sum(r["alone_ms"] for r in runs),
                       cuda_core_ms=sum(r["fma_ms"] for r in runs),
                       cuda_core_kernel_alone_ms=sum(r["fma_alone_ms"] for r in runs))
        if stage == 3:
            row["yardstick_eval_ms"] = sum(y["eval"] for y in yard)
            evals = [r for r in ctx[stage] if r["bf16"] and r["label"].endswith("eval")]
            row["eval_ms"] = sum(r["ms"] for r in evals)
        rows.append(row)
    return rows + check_fused_sa_bwd(device, card)


# kernel 6's backward passes: (row name, the Pallas kernel it replaces)
FUSED_SA_BWD_STAGES = {1: ("fused_sa_b1", "dl_biomass_tpu/ops/pallas_sa_train.py:331"),
                       2: ("fused_sa_b2", "dl_biomass_tpu/ops/pallas_sa_train.py:365"),
                       3: ("fused_sa_b3", "dl_biomass_tpu/ops/pallas_sa_train.py:404")}


def fused_sa_bwd_flops(stage: int, cd: int, params: dict, edges: int, centroids: int) -> int:
    """flop of backward pass ``stage`` that this run's data needs: the
    recompute of h1 and h2 and the layer products over the valid edges, and
    the routed products (one row per column) over the centroids with a valid
    slot."""
    (k0, c1), (_, c2), (_, c3) = (params[f"w{i}"].shape for i in (1, 2, 3))
    per_edge = 2 * (k0 * c1 + c1 * c2) + {1: 0, 2: 4 * c1 * c2,
                                          3: 2 * c1 * c2 + 2 * k0 * c1 + 2 * cd * c1}[stage]
    per_centroid = 2 * c2 * c3 * (2 if stage == 1 else 1)
    return edges * per_edge + centroids * per_centroid


def check_fused_sa_bwd_call(label: str, call, bf16: bool, ctx: dict, elu=None):
    """One backward pass at recorded inputs: kernel vs plain (the weight and
    bias gradients and the sums within the bound of the largest of them:
    some, such as SA1's db3, are 0 but for rounding, since a BatchNorm
    follows; d(dense) within the bound of its own max|.|; zero d(dense) rows
    where a centroid has no valid slot), two launches bit-identical,
    timings, bound; bf16 on one ``pack_bwd`` block, as the step runs it.
    ``elu`` (by default in f32): the pass with ELU in place of the recorded
    activation."""
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6

    args, kwargs = call
    stage, dense, planes, nbr_mask, params, folds, stats = args[:7]
    if not bf16 and dense is not None:
        dense = dense.float()
    args = (stage, dense, planes, nbr_mask) + tuple(args[4:])
    cd = 0 if dense is None else dense.shape[-1]
    cp = 0 if planes is None else planes.shape[-1]
    source = k6.pass_source(stage, True, cd, cp, params, bf16)
    # the step hands bf16 passes a block packed once per layer, from the
    # parameters before the optimizer moved them: the replay packs one as the
    # step does, from the recorded ones, and runs the step's route on it; an
    # f32 pass, or one at widths the tensor-core kernels do not take, none
    packed = k6.pack_bwd(dense, planes, nbr_mask, params, folds, stats) if bf16 else None
    # float32 runs with ELU, whose derivative is continuous: at a million rows
    # some ReLU inputs lie within rounding of 0, and the kernel's and the plain
    # version's sums of h2 put them on other sides, moving whole elements
    elu = not bf16 if elu is None else elu
    kwargs = dict(kwargs, bf16=bf16, packed=packed, **({"act": "ELU"} if elu else {}))
    got = k6.fused_sa_bwd_stage(*args, **kwargs)
    again = k6.fused_sa_bwd_stage(*args, **kwargs)
    want = k6.fused_sa_bwd_stage_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(all(a is None or same_bits(a, b) for a, b in zip(got, again)),
            f"kernel 6 B{stage} {label}: two launches differ in bits")
    tol = FUSED_SA_RTOL[bf16]
    sums = list(zip(got, want))[:2] if stage == 3 else list(zip(got, want))
    scale = max(float(b.abs().max()) for _, b in sums)
    rels = [max_abs_err(a, b) / scale for a, b in sums]
    if stage == 3 and want[2] is not None:
        rels.append(rel_diff(got[2], want[2]))
    err = max(max_abs_err(a, b) for a, b in zip(got, want) if b is not None)
    require(max(rels) <= tol, f"kernel 6 B{stage} {label}: outputs vs plain rel {rels} > {tol}")
    empty = ~nbr_mask.any(-1)
    if stage == 3 and cd:
        require(bool((got[2][empty] == 0).all()) and bool((want[2][empty] == 0).all()),
                f"kernel 6 B3 {label}: d(dense) rows of centroids without a valid slot are not 0")
    t = time_ms(lambda: k6.fused_sa_bwd_stage(*args, **kwargs), reps=FUSED_SA_REPS, warmup=2)
    tp = time_ms(lambda: k6.fused_sa_bwd_stage_plain(*args, **kwargs), reps=3, warmup=1)
    alone = None  # the kernel alone, without the vectors' copy and the slice sum
    if bf16:
        alone = kernel_alone_ms(lambda: k6.fused_sa_bwd_stage(*args, **kwargs),
                                f"{Path(source).stem}_kernel")
    b, m, _ = nbr_mask.shape
    edges, centroids = int(nbr_mask.sum()), int((~empty).sum())
    flops = fused_sa_bwd_flops(stage, cd, params, edges, centroids)
    c3 = params["w3"].shape[1]
    nbytes = (nbr_mask.numel() + sum(x.numel() * x.element_size() for x in (dense, planes)
                                     if x is not None)
              + sum(v.numel() * 4 for v in params.values()) + b * m * c3 * 8
              + sum(x.numel() * x.element_size() for x in got if x is not None))
    peak = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    bms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    floor = flops / PEAK_F32_FLOP_PER_S * 1e3
    print(f"kernel fused_sa B{stage} {label} on {source} (B={b} M={m} CD={cd} "
          f"CP={0 if planes is None else planes.shape[-1]} widths "
          f"{','.join(str(params[f'w{i}'].shape[1]) for i in (1, 2, 3))}): {t:.4f} ms (median of "
          f"{FUSED_SA_REPS}){'' if alone is None else f', kernel alone {alone:.4f} ms'}, plain "
          f"{tp:.4f} ms, bound {bms:.6f} ms ({by}: {flops} flop for "
          f"{edges} valid edges and {centroids} centroids at {peak / 1e12:.0f} TFLOP/s, {nbytes} "
          f"bytes), CUDA-core f32 floor {floor:.4f} ms ({floor / t:.1%} reached); vs plain "
          f"max|diff| per output over the pass's largest gradient or sum (d(dense): its own "
          f"max) {', '.join(f'{r:.3e}' for r in rels)} (bound {tol}); two launches "
          f"bit-identical", flush=True)
    ctx.setdefault(stage, []).append(dict(bf16=bf16, ms=t, plain_ms=tp, bound_ms=bms,
                                          bound_by=by, err=err, label=label, alone_ms=alone,
                                          source=source))
    return t


def unfused_backward_ms(mlp, call, bf16: bool) -> float:
    """The yardstick: the autograd backward of the unfused ``MLP`` and
    ``masked_max`` of the same layer in train mode, on the same edges (the
    dense block's gradient where it has one) under the same cotangent."""
    from dl_biomass_tpu_torch.models.layers import MLP
    from dl_biomass_tpu_torch.ops.pooling import masked_max

    (_, dense, planes, nbr_mask, _, _, _, _, g, _), _ = call
    ct = torch.bfloat16 if bf16 else torch.float32
    x = None if dense is None else dense.detach().to(ct).requires_grad_()
    parts = ([] if x is None else [x]) + ([] if planes is None else [planes.to(ct)])
    mlp = copy.deepcopy(mlp)
    for lin in mlp.linears():
        lin.compute_dtype = ct
    edges = torch.where(nbr_mask[..., None], torch.cat(parts, dim=-1),
                        torch.zeros((), dtype=ct, device=nbr_mask.device))
    with torch.enable_grad():
        out = masked_max(MLP.forward(mlp, edges, nbr_mask, True), nbr_mask, dim=2)
        wrt = list(mlp.parameters()) + ([] if x is None else [x])

        def run():
            return torch.autograd.grad(out, wrt, g.to(out.dtype), retain_graph=True)

        return time_ms(run, reps=FUSED_SA_REPS, warmup=2)


def check_fused_sa_bwd(device, card: str) -> list:
    """Phase 10, backward: B1-B3 at the inputs of one training step of the
    fused_sa model (B=16 x 10240) with every BatchNorm on the PyTorch chain,
    SA1 and SA2, bf16 and f32, against the plain backward, timed beside the
    unfused layer's autograd backward; then SA2's in bf16 with ELU at the
    inputs of the step as the model runs it, SA3's BatchNorms on kernel 11;
    returns the three passes' rows."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import bn_train_kernel
    from dl_biomass_tpu_torch.train.trainer import Trainer

    batch = synthetic_batch(SMALL, N_POINTS, seed=1, device=device)

    def step_calls(chain: bool):
        trainer = Trainer(seeded_model(device, fused_sa=True), TrainConfig(), device)
        with ExitStack() as stack:
            if chain:
                stack.enter_context(mock.patch.object(bn_train_kernel, "takes",
                                                      lambda *a, **kw: False))
            calls = record_kernel_inputs(lambda b: trainer.step(b, train_gen(device, 0)),
                                         batch)["fused_sa_bwd_stage"]
        # autograd runs SA2's backward first
        require([(c[0][0], c[0][1] is None) for c in calls]
                == [(1, False), (2, False), (3, False), (1, True), (2, True), (3, True)],
                f"a fused_sa step ran backward passes {[c[0][0] for c in calls]}")
        return trainer, calls

    # the step's inputs with SA3's BatchNorms on the chain, as this check's
    # bounds were set: on kernel 11 (SA2's 512 centroids a cloud at 16 x
    # 10240) its rounding moves 4 of SA2's 520,406 edges across a ReLU branch,
    # where the kernel's and the plain version's sums fall on either side,
    # and their d(dense) rows differ whole (2.0e-2 of its max on an H100; 1.2e-3
    # with ELU), as phase 12 found at x2: those inputs are held with ELU below
    trainer, calls = step_calls(chain=True)
    ctx = {}
    mlps = {"SA1": trainer.model.sa1.mlp, "SA2": trainer.model.sa2.mlp}
    for layer, at in (("SA1", 3), ("SA2", 0)):
        for bf16 in (True, False):
            dt = "bf16" if bf16 else "f32 (ELU)"
            with torch.no_grad():
                ms = sum(check_fused_sa_bwd_call(f"{layer} {dt}", call, bf16, ctx)
                         for call in calls[at:at + 3])
            yard = unfused_backward_ms(mlps[layer], calls[at], bf16)
            ctx.setdefault("yardstick", []).append(dict(bf16=bf16, ms=yard))
            print(f"kernel fused_sa {layer} {dt}: B1+B2+B3 {ms:.4f} ms against the unfused "
                  f"layer's autograd backward (MLP + masked_max, train mode) {yard:.4f} ms "
                  f"[{card}]", flush=True)
    del calls, trainer
    trainer, calls = step_calls(chain=False)
    with torch.no_grad():
        for call in calls[0:3]:
            check_fused_sa_bwd_call("SA2 bf16 (ELU; SA3 on kernel 11)", call, True, {}, elu=True)
    del calls, trainer
    rows = []
    yard = sum(y["ms"] for y in ctx["yardstick"] if y["bf16"])
    for stage, (name, replaces) in FUSED_SA_BWD_STAGES.items():
        runs = [r for r in ctx[stage] if r["bf16"]]
        rows.append(dict(name=name, source=f"dl_biomass_tpu_torch/csrc/fused_sa_b{stage}.cu",
                         replaces=replaces, entry=f"dlbt_{name}",
                         max_abs_err=max(r["err"] for r in ctx[stage]),
                         ms=sum(r["ms"] for r in runs), plain_ms=sum(r["plain_ms"] for r in runs),
                         bound_ms=sum(r["bound_ms"] for r in runs),
                         bound_by=max(runs, key=lambda r: r["bound_ms"])["bound_by"],
                         library_ms=None, yardstick_backward_ms=yard,
                         kernel_alone_ms=sum(r["alone_ms"] for r in runs)))
    return rows


def fused_sa_paths(device, card: str, launches: dict) -> None:
    """Phase 11: the fused_sa model's evaluation (eval_fused_sa) and its
    train-mode forward (train_forward_fused_sa), every launch counted."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    fused = Trainer(seeded_model(device, fused_sa=True), TrainConfig(), device)
    unfused = Trainer(seeded_model(device), TrainConfig(), device)  # the same weights
    reqs = [synthetic_batch(b, N_POINTS, seed=20 + i, device=device)
            for i, b in enumerate((SMALL, LARGE))]

    def evaluation():
        return [(fused.evaluate([r]), fused.predict([r])) for r in reqs]

    outs = counted_run("eval_fused_sa", evaluation, launches, 2 * len(reqs))
    print(f"eval_fused_sa launches over {2 * len(reqs)} forwards: {launches['eval_fused_sa']}",
          flush=True)
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        plain = [fused.predict([r]) for r in reqs]
    rel_plain = rel_unfused = 0.0
    for (val, pred), p, r in zip(outs, plain, reqs):
        b = r.pos.shape[0]
        require(np.isfinite(val) and pred.shape == (b, 4) and np.isfinite(pred).all(),
                f"eval_fused_sa at B={b}: loss {val}, predictions {pred.shape}")
        require(np.array_equal(pred, fused.predict([r])), "eval_fused_sa: a repeat differs")
        scale = max(float(np.abs(p).max()), 1e-30)
        rel_plain = max(rel_plain, float(np.abs(pred - p).max()) / scale)
        u = unfused.predict([r])
        rel_unfused = max(rel_unfused, float(np.abs(pred - u).max()) / max(float(np.abs(u).max()),
                                                                           1e-30))
    require(rel_plain <= FUSED_VS_PLAIN_RTOL,
            f"eval_fused_sa vs plain-version forward: rel {rel_plain} > {FUSED_VS_PLAIN_RTOL}")
    require(rel_unfused <= FUSED_VS_UNFUSED_RTOL,
            f"eval_fused_sa vs the unfused model: rel {rel_unfused} > {FUSED_VS_UNFUSED_RTOL}")
    print(f"eval_fused_sa: evaluate and predict at B={SMALL}, {LARGE} x {N_POINTS}: finite, "
          f"(B, 4), repeat identical; vs plain-version forward max|diff|/max|y| {rel_plain:.3e} "
          f"(bound {FUSED_VS_PLAIN_RTOL}); vs the unfused model on the same weights "
          f"{rel_unfused:.3e} (bound {FUSED_VS_UNFUSED_RTOL})", flush=True)
    print_profile(f"eval_fused_sa B={SMALL}", lambda: fused.predict([reqs[0]]), calls=3)
    for r in reqs:  # the two models in turns
        b = r.pos.shape[0]
        tu = serve_timing(lambda x: unfused.predict([x]), r)
        tf = serve_timing(lambda x: fused.predict([x]), r)
        print(f"eval_fused_sa B={b} x {N_POINTS}: {tf:.3f} ms/batch, {b / tf * 1e3:.1f} clouds/s; "
              f"unfused model's predict in the same turn {tu:.3f} ms/batch, "
              f"{b / tu * 1e3:.1f} clouds/s [{card}]", flush=True)

    # train_forward_fused_sa: the train-mode forward, no gradient
    model, batch = fused.model, reqs[0]
    state = copy.deepcopy(model.state_dict())

    def forward(m=model):
        with torch.no_grad():
            return m(batch, train=True, generator=train_gen(device, 3))

    out = counted_run("train_forward_fused_sa", forward, launches, 1)
    print(f"train_forward_fused_sa launches in one forward: {launches['train_forward_fused_sa']}",
          flush=True)
    stats = running_stats(model)
    model.load_state_dict(state)
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        out_p = forward()
    stats_p = running_stats(model)
    model.load_state_dict(state)
    require(bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(v).all())
                                                    for v in stats.values()),
            "train_forward_fused_sa: non-finite output or statistics")
    require(all(not torch.equal(stats[k], state[k]) for k in stats),
            "train_forward_fused_sa: a running statistic did not move")
    rel_out = rel_diff(out, out_p)
    rel_stats = {k: rel_diff(stats[k], stats_p[k]) for k in stats}
    rel_fused = max(v for k, v in rel_stats.items() if k.startswith(("sa1.", "sa2.")))
    require(rel_fused <= BF16_SERVE_RTOL,
            f"train_forward_fused_sa: SA1/SA2 statistics vs plain rel {rel_fused}")
    require(rel_out <= FUSED_TRAIN_FORWARD_RTOL and max(rel_stats.values()) <= FUSED_TRAIN_FORWARD_RTOL,
            f"train_forward_fused_sa vs plain: output rel {rel_out}, statistics "
            f"{max(rel_stats.values())} > {FUSED_TRAIN_FORWARD_RTOL}")
    tf = serve_timing(lambda x: forward(), batch)
    model.load_state_dict(state)
    tu = serve_timing(lambda x: forward(unfused.model), batch)
    print(f"train_forward_fused_sa B={SMALL} x {N_POINTS}: output finite, every running statistic "
          f"moved; vs plain versions: output max|diff|/max|y| {rel_out:.3e}, SA1/SA2 statistics "
          f"{rel_fused:.3e}, all statistics {max(rel_stats.values()):.3e} (bounds "
          f"{BF16_SERVE_RTOL}, {FUSED_TRAIN_FORWARD_RTOL}); train-mode forward (no gradient) "
          f"{tf:.3f} ms against the unfused model's {tu:.3f} ms in the same turn [{card}]",
          flush=True)
    train_fused_sa(device, card, launches, fused, unfused, reqs)


def zero_gradient(name: str) -> bool:
    """Biases whose true gradient is 0: each hidden layer's (a BatchNorm
    follows), each SA MLP's last layer's (the max passes a shift on to the
    next BatchNorm) and the head's first BatchNorm's."""
    parts = name.split(".")
    if name == "head.bn0.bias":
        return True
    return (len(parts) >= 2 and parts[-1] == "bias" and parts[-2].startswith("lin")
            and (parts[0] != "head" or int(parts[-2][3:]) < 2))


def compare_fused_plain_step(trainer, batch, seed: int, bf16: bool) -> str:
    """One fused_sa step on the kernels and one on their plain versions, from
    one state and generator seed, within FUSED_STEP_RTOL; the state is put
    back."""
    (loss_k, grads_k), (loss_p, grads_p) = kernel_and_plain_steps(trainer, batch, seed,
                                                                  restore=True)
    grads_k = {k: g.double() for k, g in grads_k.items()}
    grads_p = {k: g.double() for k, g in grads_p.items()}
    bnd = FUSED_STEP_RTOL[bf16]
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    top = max(float(g.abs().max()) for g in grads_p.values())
    zero = max((float((grads_k[k] - grads_p[k]).abs().max()) / top
                for k in grads_p if zero_gradient(k)), default=0.0)
    l2 = {k: float((grads_k[k] - grads_p[k]).norm() / max(float(grads_p[k].norm()), 1e-30))
          for k in grads_p if not zero_gradient(k)}
    by_top = {k: float((grads_k[k] - grads_p[k]).abs().max()) / top for k in grads_p}
    worst, worst_top = max(l2, key=l2.get), max(by_top, key=by_top.get)
    dt = "bf16" if bf16 else "f32"
    require(rel_loss <= bnd["loss"] and l2[worst] <= bnd["grad_l2"] and zero <= bnd["zero"]
            and (bnd["grad_top"] is None or by_top[worst_top] <= bnd["grad_top"]),
            f"fused_sa {dt} step, kernels vs plain: loss rel {rel_loss}, gradient {worst} rel L2 "
            f"{l2[worst]}, {worst_top} max|diff| {by_top[worst_top]} of the largest |g|, "
            f"zero-gradient biases {zero}")
    return (f"{dt}: loss rel {rel_loss:.3e} (bound {bnd['loss']}), gradients rel L2 at most "
            f"{l2[worst]:.3e} ({worst}; median {statistics.median(l2.values()):.3e}; bound "
            f"{bnd['grad_l2']}), zero-gradient biases {zero:.3e} of the largest |g| (bound "
            f"{bnd['zero']}); max|diff| over the largest |g| at most {by_top[worst_top]:.3e} "
            f"({worst_top}; median {statistics.median(by_top.values()):.3e}; bound "
            f"{bnd['grad_top']})")


def train_fused_sa(device, card: str, launches: dict, fused, unfused, reqs) -> None:
    """Phase 11, training: the fused_sa model's Trainer.step, 12 steps on each
    fixed batch of 16 and 36 x 10240 (every launch counted), then the
    unfused model's steps on the same batches, a kernel-vs-plain step in
    float32 and in bf16, and a profile of one 16 x 10240 step."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    state = copy.deepcopy(fused.model.state_dict())

    def steps():
        return [train_timing(fused, r, train_gen(device, 200 + i),
                             f"fused_sa B={r.pos.shape[0]} x {N_POINTS}", card,
                             EXPECTED["train_fused_sa"]) for i, r in enumerate(reqs)]

    timed = counted_run("train_fused_sa", steps, launches,
                        (TRAIN_WARMUP + TRAIN_TIMED) * len(reqs))
    print(f"train_fused_sa launches over {(TRAIN_WARMUP + TRAIN_TIMED) * len(reqs)} steps: "
          f"{launches['train_fused_sa']}", flush=True)
    for i, (r, (ms, peak)) in enumerate(zip(reqs, timed)):
        b = r.pos.shape[0]
        ms_u, peak_u = train_timing(unfused, r, train_gen(device, 200 + i),
                                    f"unfused B={b} x {N_POINTS}", card, EXPECTED["train"])
        print(f"train_fused_sa B={b} x {N_POINTS}: {ms:.3f} ms/step, {b / ms * 1e3:.1f} clouds/s, "
              f"peak {peak:.2f} GiB; the unfused model's step on the same batch {ms_u:.3f} "
              f"ms/step, {b / ms_u * 1e3:.1f} clouds/s, peak {peak_u:.2f} GiB [{card}]",
              flush=True)
    fused.model.load_state_dict(state)
    # float32 with ELU, as tests/test_torch_step.py: no ReLU branch to flip
    f32 = Trainer(seeded_model(device, fused_sa=True, compute_dtype="float32", activation="ELU"),
                  TrainConfig(), device)
    notes = [compare_fused_plain_step(f32, reqs[0], 7, bf16=False),
             compare_fused_plain_step(fused, reqs[0], 7, bf16=True)]
    del f32
    print(f"train_fused_sa step on the kernels vs on the plain versions (B={SMALL} x {N_POINTS}, "
          f"one state and seed): {'; '.join(notes)}", flush=True)
    print_profile(f"train_fused_sa step B={SMALL}", lambda: fused.step(reqs[0], train_gen(device, 9)),
                  calls=2, n_kernels=14, n_ops=16)




# phase 12: the fused_sa model at the wider widths neuron_multiplier gives it,
# at the batch of phases 10 and 11, whose bf16 step bound was set there: at
# B=4 the bf16 step's gradients differ from the plain step's by up to 0.48 in
# relative L2 norm at neuron_multiplier 2 (0.31 at 1), as rounding order alone
# moves more of fewer centroids' terms, while in f32 they agree to 1.3e-3
# (chip_compare.py steps)
WIDE_BATCH = SMALL


def wide_fused_sa(device, card: str, launches: dict) -> None:
    """Phase 12: the fused_sa model at neuron_multiplier 2 and 3 in bf16, full
    width, B=16 x 10240 (paths fused_sa_x2, fused_sa_x3: one train-mode
    forward under no_grad, one eval forward and one Trainer.step, every launch
    counted): each against the same on the plain versions (the forwards'
    bounds of phase 11 and its bf16 step bound), then every pass of each layer
    it ran against its plain version at the inputs it gave it, with the kernel
    that ran it and its time; and the f32 passes at SA2's widths, likewise."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6
    from dl_biomass_tpu_torch.train.trainer import Trainer

    for nm in WIDE_MULTIPLIERS:
        path = f"fused_sa_x{nm}"
        trainer = Trainer(seeded_model(device, fused_sa=True, neuron_multiplier=nm),
                          TrainConfig(), device)
        model = trainer.model
        widths = [tuple(m.mlp.linears()[i].out_features for i in range(3))
                  for m in (model.sa1, model.sa2)]
        batch = synthetic_batch(WIDE_BATCH, N_POINTS, seed=30 + nm, device=device)
        state = copy.deepcopy(model.state_dict())

        def forward(train: bool):
            with torch.no_grad():
                return model(batch, train=train, generator=train_gen(device, 3))

        def bundle():
            model.load_state_dict(state)
            out_t = forward(True)
            stats_t = running_stats(model)
            model.load_state_dict(state)
            return out_t, stats_t, forward(False), trainer.step(batch, train_gen(device, 5))

        outs = []
        calls = counted_run(path, lambda: record_kernel_inputs(lambda _: outs.append(bundle()),
                                                               batch), launches, 1)
        (out_t, stats_t, out_e, loss), = outs
        require(bool(torch.isfinite(out_t).all()) and bool(torch.isfinite(out_e).all())
                and bool(torch.isfinite(loss)), f"{path}: non-finite output or loss")
        model.load_state_dict(state)
        with ExitStack() as stack:
            for p in plain_versions():
                stack.enter_context(p)
            out_tp = forward(True)
            stats_tp = running_stats(model)
            model.load_state_dict(state)
            out_ep = forward(False)
        rel_t, rel_e = rel_diff(out_t, out_tp), rel_diff(out_e, out_ep)
        rel_stats = {k: rel_diff(stats_t[k], stats_tp[k]) for k in stats_t}
        rel_sa = max(v for k, v in rel_stats.items() if k.startswith(("sa1.", "sa2.")))
        require(rel_sa <= BF16_SERVE_RTOL, f"{path}: SA1/SA2 statistics vs plain rel {rel_sa}")
        require(rel_t <= FUSED_TRAIN_FORWARD_RTOL
                and max(rel_stats.values()) <= FUSED_TRAIN_FORWARD_RTOL,
                f"{path}: train-mode forward vs plain: output rel {rel_t}, statistics "
                f"{max(rel_stats.values())} > {FUSED_TRAIN_FORWARD_RTOL}")
        require(rel_e <= FUSED_VS_PLAIN_RTOL,
                f"{path}: eval forward vs plain rel {rel_e} > {FUSED_VS_PLAIN_RTOL}")
        step_note = compare_fused_plain_step(trainer, batch, 7, bf16=True)
        print(f"{path} (widths SA1 {widths[0]}, SA2 {widths[1]}; B={WIDE_BATCH} x {N_POINTS}) "
              f"launches in one train-mode forward, one eval forward and one step: "
              f"{launches[path]}; vs plain versions: train-mode forward output {rel_t:.3e}, "
              f"SA1/SA2 statistics {rel_sa:.3e}, all statistics {max(rel_stats.values()):.3e} "
              f"(bounds {BF16_SERVE_RTOL}, {FUSED_TRAIN_FORWARD_RTOL}); eval forward "
              f"{rel_e:.3e} (bound {FUSED_VS_PLAIN_RTOL}); step {step_note} [{card}]",
              flush=True)

        # the passes at the inputs the run gave them: the step's forward and backward
        # (autograd runs SA2's backward first), the eval forward's F3
        fwd, bwd = calls["fused_sa_stage"], calls["fused_sa_bwd_stage"]
        require([c[0][0] for c in fwd] == [1, 2, 3, 1, 2, 3, 3, 3, 1, 2, 3, 1, 2, 3]
                and [c[0][0] for c in bwd] == [1, 2, 3, 1, 2, 3],
                f"{path}: passes {[c[0][0] for c in fwd]} and {[c[0][0] for c in bwd]}")
        # which kernel each launch of the run went to: the entries count both
        cores = {}
        for calls_of, entries, backward in ((fwd, k6.ENTRIES, False), (bwd, k6.BWD_ENTRIES, True)):
            for (stage, dense, planes, _, params, *_), kw in calls_of:
                source = k6.pass_source(stage, backward, 0 if dense is None else dense.shape[-1],
                                        0 if planes is None else planes.shape[-1], params,
                                        kw.get("bf16", False))
                if source == (BWD_SOURCE if backward else FWD_SOURCE):
                    cores[entries[stage]] = cores.get(entries[stage], 0) + 1
        launches.setdefault("cuda_core", {})[path] = cores
        print(f"{path}: launches of kernel 6 that ran the CUDA-core kernel ({FWD_SOURCE}, "
              f"{BWD_SOURCE}): {cores}; the rest ran the tensor-core kernels", flush=True)
        del calls, outs
        fctx, bctx = {}, {}
        with torch.no_grad():
            for li, layer in enumerate(("SA1", "SA2")):
                for call in fwd[8 + 3 * li:11 + 3 * li]:
                    check_fused_sa_call(f"{path} {layer} bf16 train", call, True, fctx)
                check_fused_sa_call(f"{path} {layer} bf16 eval", fwd[6 + li], True, fctx)
                # with ELU, as f32 in phase 10: at these widths some ReLU inputs lie
                # within rounding of 0, where the kernel's and the plain version's
                # sums fall on either side and move a whole term of d(dense) (2.9e-2
                # of its max at SA2 x2 on an H100, 2.1e-3 with ELU: chip_compare.py acts)
                for call in bwd[3 - 3 * li:6 - 3 * li]:
                    check_fused_sa_bwd_call(f"{path} {layer} bf16 (ELU)", call, True, bctx,
                                            elu=True)
            for call in fwd[11:14]:  # f32 at SA2's widths
                check_fused_sa_call(f"{path} SA2 f32 train", call, False, fctx)
            for call in bwd[0:3]:
                check_fused_sa_bwd_call(f"{path} SA2 f32 (ELU)", call, False, bctx)
        for kind, ctx in (("F", fctx), ("B", bctx)):
            for stage in (1, 2, 3):
                for r in ctx[stage]:
                    print(f"{kind}{stage} {r['label']}: {r['source']}, {r['ms']:.4f} ms, "
                          f"max|diff| {r['err']:.3e} [{card}]", flush=True)
        del fwd, bwd, trainer, model
        torch.cuda.empty_cache()


# the fused_eval engine at the wider widths (phase 12): (neuron_multiplier,
# compute dtype) of each model, and the bound of its float32 engine against
# the plain versions (kernel 5 sums each dot product in another order: 1e-7 of
# max|y| at SA1 on an H100, chip_compare.py eval5)
WIDE_FUSED_EVAL = ((2, "bfloat16"), (3, "bfloat16"), (2, "float32"), (4, "bfloat16"),
                   (4, "float32"), (8, "bfloat16"), (8, "float32"))
F32_SERVE_RTOL = 1e-4
# kernel 5 alone beyond the engines' inputs: (label, neuron_multiplier, clouds of
# the x1 engine's 16 x 10240 inputs, point features)
WIDE_KERNEL_POINTS = (("x16 B=2", 16, 2, 1), ("x1 F=6", 1, SMALL, 6))
WIDE_GRAPH_CALLS = 3  # the wide points by graph: 3 calls a graph, the median of 3 replays


def seeded_sa1_weights(nm: int, f: int, seed: int, device):
    """Folded SA1 weights [w1 (F+3, 64 nm), b1, w2, b2, w3 (64 nm, 128 nm), b3]
    in torch-default Linear ranges, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    dims = (f + 3, 64 * nm, 64 * nm, 128 * nm)
    out = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        bnd = 1.0 / math.sqrt(cin)
        out += [(torch.rand(cin, cout, generator=g) * 2 - 1) * bnd,
                (torch.rand(cout, generator=g) * 2 - 1) * bnd]
    return [w.to(device) for w in out]


def check_sa1_wide(label: str, args, weights, radius: float, bf16: bool, card: str) -> dict:
    """Kernel 5 against its plain version at one point (phase 12), under the
    bound of the engines' bf16 (float32) forwards: identical zero rows, a
    repeat bit-identical; its plan as built, graph time, bound and plain time."""
    from dl_biomass_tpu_torch.ops import ball_group_kernel, sa_eval_kernel

    centers, cmask, pos, mask, feat = args
    kw = dict(radius=radius, bf16=bf16, out_dtype=torch.bfloat16 if bf16 else torch.float32,
              packed=sa_eval_kernel.pack_sa1_eval(weights, bf16, pos.device))
    got = sa_eval_kernel.sa1_fused_eval(*args, weights, **kw)
    again = sa_eval_kernel.sa1_fused_eval(*args, weights, **kw)
    want = sa_eval_kernel.sa1_fused_eval_plain(*args, weights, **kw)
    torch.cuda.synchronize()
    bnd = BF16_SERVE_RTOL if bf16 else F32_SERVE_RTOL
    rel = rel_diff(got, want)
    dtype = "bf16" if bf16 else "f32"
    require(rel <= bnd, f"sa1_fused_eval {label} {dtype} vs plain: rel {rel} > {bnd}")
    require(same_bits(got, again), f"sa1_fused_eval {label} {dtype}: a repeat changed bits")
    require(torch.equal((got == 0).all(-1), (want == 0).all(-1)),
            f"sa1_fused_eval {label} {dtype}: zero rows differ from plain")
    err = max_abs_err(got, want)
    del want
    ms = graph_ms(lambda: sa_eval_kernel.sa1_fused_eval(*args, weights, **kw),
                  calls=WIDE_GRAPH_CALLS, replays=WIDE_GRAPH_CALLS)
    plain_ms = time_ms(lambda: sa_eval_kernel.sa1_fused_eval_plain(*args, weights, **kw),
                       reps=3, warmup=1)
    b, m, _ = centers.shape
    n, f = pos.shape[1], feat.shape[-1]
    h1, h2, c = (weights[i].shape[1] for i in (0, 2, 4))
    # the valid slots (the selection reads no feature, and kernel 2 captures at most 4)
    _, nbr, _ = ball_group_kernel.ball_group(centers, cmask, pos, mask, feat[..., :1],
                                             radius=radius, need_idx=False)
    edges = int(nbr.sum())
    flops = edges * 2 * ((f + 3) * h1 + h1 * h2 + h2 * c)
    tests = bucket_scan_lengths(centers, cmask, pos, mask, ball_group_kernel._radius2(radius))
    nbytes = (b * n * (12 + 4 * f + 1) + b * m * 13 + sum(w.numel() * 4 for w in weights)
              + b * m * c * got.element_size())
    t_ops = (flops / (PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S)
             + tests * DIST_TEST_FLOPS / PEAK_F32_FLOP_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_ms, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    occ = sa_eval_kernel.occupancy(bf16, *(-(-w // 64) * 64 for w in (h1, h2, c)), f=f)
    print(f"kernel sa1_fused_eval {label} {dtype} B={b} M={m} N={n} F={f} widths {h1},{h2},{c}: "
          f"plan {occ['kernel']} ({occ['threads']} threads, {occ['smem_bytes']} B shared, "
          f"{occ['scratch_bytes']} B scratch a block, {occ['blocks_per_sm']} block(s) per SM, "
          f"{occ['registers']} registers, {occ['local_bytes']} B local a thread); "
          f"{ms:.4f} ms by graph, bound {bound_ms:.4f} ms ({by}: {edges} valid edges x "
          f"{flops // max(edges, 1)} flop on the {'bf16 tensor' if bf16 else 'f32 CUDA'} cores, "
          f"{tests} distance tests), plain {plain_ms:.4f} ms; vs plain max|diff|/max|y| "
          f"{rel:.3e} (bound {bnd}); zero rows identical, a repeat bit-identical [{card}]",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, max_abs_err=err,
                plan=occ["kernel"], registers=occ["registers"], local_bytes=occ["local_bytes"],
                blocks_per_sm=occ["blocks_per_sm"])


def wide_fused_eval(device, card: str, launches: dict) -> dict:
    """Phase 12, path serve_fused_eval_wide: the fused_eval engine of the seeded
    model at each of WIDE_FUSED_EVAL answers the 16 x 10240 and the partial
    request (every launch counted), held against the same engine on the plain
    versions and the unfolded module, and timed beside the default engine;
    then kernel 5 alone at the x4 and x8 engines' inputs and at
    WIDE_KERNEL_POINTS (``check_sa1_wide``). Returns those points' rows."""
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import sa_eval_kernel

    requests = serving_requests(device)
    reqs = [requests[0], requests[2]]  # 16 x 10240, and 5 clouds of 7000-10240 points
    engines = []
    for nm, dtype in WIDE_FUSED_EVAL:
        model = seeded_model(device, neuron_multiplier=nm, compute_dtype=dtype)
        widths = [model.sa1.mlp.linears()[i].out_features for i in range(3)]
        engines.append((nm, dtype, widths, model, compile_inference(model, device,
                                                                    fused_eval=True)))
    outs = counted_run("serve_fused_eval_wide",
                       lambda: [[fn(r) for r in reqs] for *_, fn in engines], launches,
                       len(reqs) * len(engines))
    by_width = {}
    for (nm, dtype, widths, model, fn), got in zip(engines, outs):
        bound = BF16_SERVE_RTOL if dtype == "bfloat16" else F32_SERVE_RTOL
        for out, req in zip(got, reqs):
            require(tuple(out.shape) == (req.pos.shape[0], 4) and bool(torch.isfinite(out).all()),
                    f"fused_eval x{nm} {dtype}: output {tuple(out.shape)} or not finite")
        with ExitStack() as stack:
            for p in plain_versions():
                stack.enter_context(p)
            plain = [fn(r) for r in reqs]
        rel = max(rel_diff(g, p) for g, p in zip(got, plain))
        require(rel <= bound, f"fused_eval x{nm} {dtype} vs plain: rel {rel} > {bound}")
        with torch.inference_mode():
            rel_module = max(rel_diff(g, model(r)) for g, r in zip(got, reqs))
        require(rel_module <= FOLDED_VS_MODULE_RTOL,
                f"fused_eval x{nm} {dtype} vs the module: rel {rel_module}")
        default = compile_inference(model, device)
        ms, ms_default = serve_timing(fn, reqs[0]), serve_timing(default, reqs[0])
        plan = sa_eval_kernel.plan(*(-(-w // 64) * 64 for w in widths), dtype == "bfloat16")
        print(f"serve_fused_eval_wide x{nm} {dtype} (SA1 widths {tuple(widths)}, kernel 5 plan "
              f"{tuple(plan)}): vs plain-version engine max|diff|/max|y| {rel:.3e} (bound "
              f"{bound}), vs unfolded module {rel_module:.3e} (bound {FOLDED_VS_MODULE_RTOL}); "
              f"B={SMALL} x {N_POINTS} {ms:.3f} ms/batch, default engine {ms_default:.3f} "
              f"[{card}]", flush=True)
        if nm >= 4:  # kernel 5 alone at the inputs this engine gave it
            (args, kwargs), = record_kernel_inputs(fn, reqs[0])["sa1_fused_eval"]
            by_width[f"x{nm} {dtype}"] = check_sa1_wide(
                f"x{nm}", args[:5], list(args[5]), kwargs["radius"], dtype == "bfloat16", card)
        del default, got, plain
        torch.cuda.empty_cache()
    print(f"serve_fused_eval_wide launches over {len(reqs) * len(engines)} forwards: "
          f"{launches['serve_fused_eval_wide']}", flush=True)
    (args, kwargs), = record_kernel_inputs(engines[0][4], reqs[0])["sa1_fused_eval"]
    del engines, outs
    torch.cuda.empty_cache()
    centers, cmask, pos, mask, feat = args[:5]
    for label, nm, b, f in WIDE_KERNEL_POINTS:
        extra = torch.randn(*feat.shape[:2], f - 1, device=device,
                            generator=torch.Generator(device=device).manual_seed(f))
        point = (centers[:b], cmask[:b], pos[:b], mask[:b], torch.cat([feat, extra], -1)[:b])
        weights = seeded_sa1_weights(nm, f, seed=50 + nm, device=device)
        for bf16 in (True, False):
            by_width[f"{label} {'bfloat16' if bf16 else 'float32'}"] = check_sa1_wide(
                label, point, weights, kwargs["radius"], bf16, card)
        torch.cuda.empty_cache()
    return by_width


def device_dataset(device, card: str, launches: dict) -> None:
    """Phase 14, path device_dataset: fit over a DeviceDataset (every launch
    counted), the three epoch paths from one state bit-identical, the two
    evaluation paths equal, and compile_dataset_inference in both engines
    bit-identical to serve over ds.batches."""
    import dataclasses

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.io.device_data import DeviceDataset
    from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
    from dl_biomass_tpu_torch.models.inference import (compile_dataset_inference,
                                                       compile_inference)
    from dl_biomass_tpu_torch.train.trainer import Trainer
    from dl_biomass_tpu_torch.transforms.augment import aug_capacity

    ds = DeviceDataset.from_clouds(*synthetic_dataset(DD_PLOTS, DD_POINTS, seed=DD_SEED),
                                   device=device)
    val = DeviceDataset.from_clouds(*synthetic_dataset(DD_VAL_PLOTS, DD_POINTS,
                                                       seed=DD_SEED + 1), device=device)
    require(tuple(ds.pos.shape) == (DD_PLOTS, aug_capacity(DD_POINTS), 3),
            f"device_dataset: tensors {tuple(ds.pos.shape)}")
    nbytes = sum(t.numel() * t.element_size() for t in (ds.pos, ds.feat, ds.mask, ds.y))
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, scan_epochs=True, hp=dataclasses.replace(
        cfg.hp, batch_size=DD_BATCH, num_augs=DD_AUGS))
    trainer = Trainer(seeded_model(device), cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = counted_run("device_dataset",
                       lambda: trainer.fit(ds, val, num_epochs=DD_EPOCHS, log_fn=lambda _: None),
                       launches, runs=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(np.isfinite(hist["train_mse"])) and all(np.isfinite(hist["val_mse"])),
            f"device_dataset: non-finite loss {hist['train_mse']}, {hist['val_mse']}")
    per_epoch = {e: n / DD_EPOCHS for e, n in launches["device_dataset"].items() if n}
    print(f"device_dataset: {DD_PLOTS} plots x {DD_POINTS} points, capacity "
          f"{aug_capacity(DD_POINTS)}, {nbytes / 1e6:.2f} MB on the device; fit {DD_EPOCHS} "
          f"epochs at B={DD_BATCH}, {DD_AUGS} augmented copies ({DD_STEPS} steps and "
          f"{DD_VAL_BATCHES} validation batch(es) an epoch): train MSE {hist['train_mse']}, val "
          f"{hist['val_mse']}; ms/epoch {[round(t * 1e3, 3) for t in hist['epoch_seconds']]}, "
          f"clouds/s {[round(c, 1) for c in hist['clouds_per_sec']]}, peak {peak:.2f} GiB; "
          f"launches per epoch {per_epoch} [{card}]", flush=True)

    # one epoch through each path from one state and seed
    model_state = copy.deepcopy(trainer.model.state_dict())
    opt_state = copy.deepcopy(trainer.optimizer.state_dict())
    seed = trainer.epoch_seed(DD_EPOCHS)
    runs = {}
    for name in ("scan", "fused", "batches"):
        trainer.model.load_state_dict(model_state)
        # a copy: load_state_dict keeps the tensors it is given, which Adam updates in place
        trainer.optimizer.load_state_dict(copy.deepcopy(opt_state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "scan":
            out = trainer.train_epoch_scan(ds, seed, batch_size=DD_BATCH, num_augs=DD_AUGS)
        elif name == "fused":
            out = trainer.train_epoch_fused(ds, seed, batch_size=DD_BATCH, num_augs=DD_AUGS)
        else:
            out = trainer.train_epoch(ds.batches(DD_BATCH, seed=seed, num_augs=DD_AUGS,
                                                 shuffle=True), trainer.step_generator(seed))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[name] = out, {k: v.clone() for k, v in trainer.model.state_dict().items()}, ms
    for name in ("fused", "batches"):
        require(runs[name][0] == runs["scan"][0],
                f"device_dataset: {name} epoch loss {runs[name][0]} != scan {runs['scan'][0]}")
        differ = [k for k, v in runs["scan"][1].items() if not same_bits(v, runs[name][1][k])]
        require(not differ, f"device_dataset: {name} epoch left other parameters: {differ[:5]}")
    ev_scan = trainer.evaluate_scan(val, batch_size=DD_BATCH)
    ev_fused = trainer.evaluate_fused(val, batch_size=DD_BATCH)
    require(ev_scan == ev_fused, f"device_dataset: evaluate_scan {ev_scan} != fused {ev_fused}")
    print(f"device_dataset: one epoch from one state and seed through train_epoch_scan, "
          f"train_epoch_fused and ds.batches + train_epoch: loss {runs['scan'][0][0]:.6f} and "
          f"every parameter bit-identical; "
          f"{', '.join(f'{k} {v[2]:.1f} ms' for k, v in runs.items())} "
          f"({runs['scan'][0][1]} clouds); evaluate_scan = evaluate_fused = {ev_scan:.6f} "
          f"[{card}]", flush=True)

    # serving the dataset through each engine
    model = trainer.model.eval()
    for fused_eval in (False, True):
        serve_ds = compile_dataset_inference(model, device, fused_eval=fused_eval)
        serve = compile_inference(model, device, fused_eval=fused_eval)
        serve_ds(ds, DD_BATCH)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = serve_ds(ds, DD_BATCH)
        ms = (time.perf_counter() - t0) * 1e3
        want = torch.cat([serve(b) for b in ds.batches(DD_BATCH)]).cpu().numpy()[:DD_PLOTS]
        require(rows.shape == (DD_PLOTS, 4) and np.isfinite(rows).all(),
                f"compile_dataset_inference: rows {rows.shape}")
        require(np.array_equal(rows.view(np.int32), want.view(np.int32)),
                f"compile_dataset_inference (fused_eval={fused_eval}) differs from serve over "
                f"ds.batches")
        print(f"device_dataset: compile_dataset_inference (fused_eval={fused_eval}) served "
              f"{DD_PLOTS} plots in {ms:.1f} ms ({DD_PLOTS / ms * 1e3:.1f} clouds/s after a "
              f"warm-up call), rows bit-identical to serve over ds.batches [{card}]", flush=True)


def disk_forwards(plots: int, batch: int) -> int:
    """Eval forwards over ``plots`` plots at ``batch`` a batch."""
    return -(-plots // batch)


def disk_launches(resampled: int = 0, steps: int = 0, forwards: int = 0) -> dict:
    """Launches of one stage of phase 15: one exact FPS a resampled plot, then
    the main path's per step and per eval forward."""
    return per_run(dlbt_fps=resampled + 2 * (steps + forwards), dlbt_ball_group=steps + forwards,
                   dlbt_ball_query=steps + forwards, dlbt_gather=steps + forwards,
                   dlbt_scatter_rows=steps, **bn_train_launches(4, 3, steps=steps))


# what each stage of phase 15 launches: the resample of every plot, fit
# (DISK_EPOCHS epochs of steps and validation forwards), evaluate (the module over
# the test plots at DISK_SERVE_BATCH), predict with the engine and without it
# (the test plots padded to DISK_BUCKET), and two polls of --watch (one bucket each)
DISK_STAGES = {
    "resample": disk_launches(resampled=DISK_TRAIN + DISK_VAL + DISK_TEST),
    "train": disk_launches(steps=DISK_EPOCHS * DISK_STEPS,
                           forwards=DISK_EPOCHS * disk_forwards(DISK_VAL, DISK_BATCH)),
    "evaluate": disk_launches(forwards=disk_forwards(DISK_TEST, DISK_SERVE_BATCH)),
    "predict": disk_launches(forwards=disk_forwards(DISK_BUCKET, DISK_SERVE_BATCH)),
    "predict --no-engine": disk_launches(forwards=disk_forwards(DISK_BUCKET, DISK_SERVE_BATCH)),
    "predict --watch": disk_launches(forwards=2 * disk_forwards(DISK_BUCKET, DISK_SERVE_BATCH)),
}
EXPECTED["disk_pipeline"] = {e: sum(s[e] for s in DISK_STAGES.values()) for e in ENTRIES}


class DecodeClock:
    """Seconds spent in ``read_las`` by the dataset and resample modules, as
    a share of a stage's wall: the file decoding."""

    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        from dl_biomass_tpu_torch.io import dataset, reader, resample

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return reader.read_las(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0

        self._stack = ExitStack()
        for mod in (dataset, resample):
            self._stack.enter_context(mock.patch.object(mod, "read_las", timed))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def run_cli(argv, device) -> str:
    """``python -m dl_biomass_tpu_torch`` as a user runs it (``main(argv)``;
    ``--device cpu`` only off the card); its standard output. Fails on a
    non-zero return."""
    import contextlib
    import io

    from dl_biomass_tpu_torch.__main__ import main as cli

    argv = list(argv) + ([] if device.type == "cuda" else ["--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    require(rc == 0, f"{argv[0]} exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def disk_stage(name: str, argv, device, counts: dict, card: str, expected=None):
    """One CLI command (``run_cli``) with every launch count set to 0 just
    before it and read just after, held to ``expected`` (default
    ``DISK_STAGES[name]``); returns (its standard output, wall seconds, decode
    seconds)."""
    from dl_biomass_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.launch_counts.clear()
    with DecodeClock() as clock:
        t0 = time.perf_counter()
        out = run_cli(argv, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = {e: _build.launch_counts[e] for e in ENTRIES}
    for e, want in (expected or DISK_STAGES[name]).items():
        require(got[e] == want, f"disk_pipeline: {name} launched {e} {got[e]} times, "
                                f"expected {want}")
    counts[name] = got
    print(f"disk_pipeline {name}: {wall:.3f} s of wall, {clock.seconds:.3f} s decoding LAS "
          f"files ({clock.seconds / wall:.1%}); launches "
          f"{ {e: n for e, n in got.items() if n} } [{card}]", flush=True)
    return out, wall, clock.seconds


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """``same_bits`` of two host arrays as float32."""
    return same_bits(*(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (a, b)))


def check_resample_kernel(raw_dir: Path, out_dir: Path, device, card: str) -> dict:
    """Kernel 1 at a raw plot's row (1 x DISK_RAW, k=DISK_POINTS, its
    global-scratch launch): for DISK_CHECKED plots, the ``cuda`` engine's picks
    index-equal to ``fps_rows_plain`` on a CPU copy of the engine's input, the
    resampled file the CLI wrote equal byte for byte to one written from those
    picks, and the picks that differ from the ``native`` engine's (float64,
    uncentred) counted; then the launch timed beside its bound and its plain
    version on the card, and the native engine's time on the host."""
    import filecmp
    import tempfile

    from dl_biomass_tpu_torch.io.reader import normalize_intensity, read_las, write_las
    from dl_biomass_tpu_torch.io.resample import centred_f32, farthest_point_sampling
    from dl_biomass_tpu_torch.native import pointops
    from dl_biomass_tpu_torch.ops import fps_kernel

    require(fps_kernel.plan(DISK_RAW).path == "planes",
            f"rows of {DISK_RAW} points do not take kernel 1's scratch launch")
    k = DISK_POINTS
    native_differ, native_s = [], []
    for path in sorted(raw_dir.glob("*.las"))[:DISK_CHECKED]:
        coords, attrs = read_las(str(path), get_attributes=True, filter_height=0)
        picks = farthest_point_sampling(coords, k, engine="cuda", device=device)
        pos = centred_f32(coords, "cpu")
        plain = fps_kernel.fps_rows_plain(pos, torch.ones(pos.shape[:2], dtype=torch.bool),
                                          torch.zeros(1, dtype=torch.int32), k)[0].numpy()
        require(np.array_equal(picks, plain),
                f"disk_pipeline: kernel 1 picks of {path.name} differ from fps_rows_plain")
        sel = coords[picks]
        with tempfile.TemporaryDirectory() as tmp:
            mine = Path(tmp) / "picks.las"
            write_las(sel - sel.mean(axis=0), mine, {
                "intensity_normalized": normalize_intensity(attrs["intensity"])[picks]})
            wrote = out_dir / f"{path.stem}_fps_{k}.las"
            require(filecmp.cmp(mine, wrote, shallow=False),
                    f"disk_pipeline: {wrote.name} is not the plot at kernel 1's picks")
        if pointops.available():
            t0 = time.perf_counter()
            native = pointops.fps(coords, k, start=0)
            native_s.append(time.perf_counter() - t0)
            native_differ.append(int((native != picks).sum()))
    print(f"disk_pipeline: kernel 1 at 1 x {DISK_RAW}, k={k} (the cuda engine, centred float32) "
          f"index-equal to fps_rows_plain on a CPU copy for {DISK_CHECKED} plots, and the CLI's "
          f"files are those plots at those picks; picks that differ from the native engine's "
          f"(float64, uncentred): {native_differ if native_s else 'native library unavailable'}"
          + (f", native {statistics.mean(native_s) * 1e3:.1f} ms a plot on the host"
             if native_s else ""), flush=True)
    pos = centred_f32(coords, device)
    mask = torch.ones(pos.shape[:2], dtype=torch.bool, device=device)
    starts = torch.zeros(1, dtype=torch.int32, device=device)
    res = time_fps(f"resample 1 x {DISK_RAW}", (pos, mask, starts, k), card)
    res["plain_ms"] = time_ms(lambda: fps_kernel.fps_rows_plain(pos, mask, starts, k), reps=1,
                              warmup=0)
    res["max_abs_err"] = 0.0
    res["native_ms"] = statistics.mean(native_s) * 1e3 if native_s else None
    res["native_differ"] = native_differ
    print(f"kernel fps resample 1 x {DISK_RAW} k={k}: plain version on the card "
          f"{res['plain_ms']:.2f} ms [{card}]", flush=True)
    return res


def check_loader(raw: Path, device, card: str) -> None:
    """``io/pipeline.PrefetchingLoader`` over the raw test plots (a producer
    thread decoding into pinned buffers, non-blocking copies): without
    augmentation its batches on the card equal the CPU loader's bit for bit;
    with DISK_AUGS copies a plot every augmented cloud keeps 90-100% of its
    points and appends at most 10%; batches/s of each epoch."""
    from dl_biomass_tpu_torch.io.dataset import PointCloudsInFiles
    from dl_biomass_tpu_torch.io.pipeline import PrefetchingLoader

    fileset = PointCloudsInFiles(str(raw / "test"), "*.las", max_points=DISK_POINTS,
                                 use_columns=["intensity_normalized"], filter_height=0.2,
                                 dataset=("BC", "RM", "PF"), biomass_csv=str(raw / "biomass.csv"))
    cpu = list(PrefetchingLoader(fileset, DISK_BATCH, DISK_POINTS, device="cpu").epoch(DISK_SEED))
    t0 = time.perf_counter()
    card_batches = list(PrefetchingLoader(fileset, DISK_BATCH, DISK_POINTS,
                                          device=device).epoch(DISK_SEED))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(len(card_batches) == len(cpu) and all(
        torch.equal(getattr(g, f).cpu(), getattr(w, f)) for g, w in zip(card_batches, cpu)
        for f in ("pos", "feat", "mask", "y")), "PrefetchingLoader: card batches differ from CPU's")
    loader = PrefetchingLoader(fileset, DISK_BATCH, DISK_POINTS, num_augs=DISK_AUGS, device=device)
    t0 = time.perf_counter()
    augmented = list(loader.epoch(DISK_SEED))
    torch.cuda.synchronize()
    aug_s = time.perf_counter() - t0
    for b in augmented:
        real = b.mask.any(1)  # the partial last batch's pad samples hold no point
        kept = b.mask[real, :DISK_POINTS].sum(1)
        extra = b.mask[real, DISK_POINTS:].sum(1)
        require(bool(torch.isfinite(b.pos).all()) and b.pos.device.type == device.type
                and bool((kept >= 0.9 * DISK_POINTS - 1).all())
                and bool((extra <= 0.1 * DISK_POINTS + 1).all()),
                "PrefetchingLoader: an augmented batch out of its bounds")
    print(f"disk_pipeline PrefetchingLoader: {len(fileset)} raw plots at B={DISK_BATCH}: "
          f"{len(card_batches)} batches bit-identical to the CPU loader's in {plain_s:.3f} s; "
          f"with {DISK_AUGS} augmented copies {len(augmented)} batches "
          f"({len(augmented) / aug_s:.1f} batches/s, capacity {loader.capacity}) [{card}]",
          flush=True)


def disk_pipeline(device, card: str, launches: dict) -> dict:
    """Phase 15, path disk_pipeline: the port's normal entry point on LAS files
    on disk, ``python -m dl_biomass_tpu_torch`` (``__main__.main``) as a user
    runs it: ``resample --engine cuda`` of a raw corpus, ``train`` at the
    full-width defaults, ``evaluate``, ``predict`` with and without the
    engine, and ``predict --watch``; every launch counted by stage. Returns
    kernel 1's row at the resampler's shape."""
    import tempfile

    import pandas as pd

    from dl_biomass_tpu_torch.eval import testing
    from dl_biomass_tpu_torch.io.dataset import PointCloudsInFilesPreSampled
    from dl_biomass_tpu_torch.models.inference import compile_dataset_inference
    from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
    from dl_biomass_tpu_torch.train.trainer import Trainer

    counts = {}
    k, suffix = DISK_POINTS, f"_fps_{DISK_POINTS}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_") as tmp:
        root = Path(tmp)
        total = DISK_TRAIN + DISK_VAL + DISK_TEST
        t0 = time.perf_counter()
        make_corpus(str(root / "raw"), total, DISK_RAW, seed=DISK_SEED, splits=(
            ("train", DISK_TRAIN / total), ("val", DISK_VAL / total), ("test", DISK_TEST / total)))
        print(f"disk_pipeline: make_corpus wrote {total} plots of {DISK_RAW} raw points in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        # resample: exact FPS on kernel 1, one launch a plot
        walls, decodes = [], []
        for split, plots in (("train", DISK_TRAIN), ("val", DISK_VAL), ("test", DISK_TEST)):
            argv = ["resample", "--in-dir", str(root / "raw" / split), "--out-dir",
                    str(root / "fps" / split), "--num-points", str(k), "--method", "fps",
                    "--format", "las", "--engine", "cuda"]
            _, wall, dec = disk_stage(f"resample {split}", argv, device, counts, card,
                                      expected=disk_launches(resampled=plots))
            walls.append(wall)
            decodes.append(dec)
        splits = [counts.pop(f"resample {s}") for s in ("train", "val", "test")]
        counts["resample"] = {e: sum(c[e] for c in splits) for e in ENTRIES}
        require(counts["resample"] == DISK_STAGES["resample"], "disk_pipeline: resample launches")
        print(f"disk_pipeline resample --engine cuda: {total} plots in {sum(walls):.3f} s, "
              f"{sum(walls) / total * 1e3:.2f} ms a plot (decode, FPS, write), decoding "
              f"{sum(decodes) / sum(walls):.1%} [{card}]", flush=True)
        fps_row = check_resample_kernel(root / "raw" / "test", root / "fps" / "test", device,
                                        card)
        fps_row["resample_ms_per_plot"] = sum(walls) / total * 1e3

        # train at the full-width defaults
        cfg = {"hp": {"batch_size": DISK_BATCH, "num_augs": DISK_AUGS},
               "data": {"train_dir": str(root / "fps" / "train"),
                        "val_dir": str(root / "fps" / "val"),
                        "biomass_csv": str(root / "raw" / "biomass.csv"),
                        "presampled_suffix": suffix},
               "model_dir": str(root / "models"), "seed": DISK_SEED}
        cfg_path = root / "cfg.json"
        cfg_path.write_text(json.dumps(cfg))
        fit = Trainer.fit
        hist = {}

        def recorded_fit(self, *args, **kwargs):
            hist.update(fit(self, *args, **kwargs))
            return hist

        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(Trainer, "fit", recorded_fit):
            _, wall, dec = disk_stage("train", ["train", "--config", str(cfg_path),
                                                "--num_epochs", str(DISK_EPOCHS)],
                                      device, counts, card)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log = pd.read_csv(root / "models" / "training_log.csv", header=None)
        require(log.shape == (DISK_EPOCHS, 3) and np.isfinite(log.to_numpy()).all(),
                f"disk_pipeline: training log {log.to_numpy().tolist()}")
        require(bool(sorted((root / "models").glob("epoch_*.pt")))
                and (root / "models" / "model_config.json").exists(),
                "disk_pipeline: no checkpoint or no model_config.json sidecar")
        fit_s = sum(hist["epoch_seconds"])
        print(f"disk_pipeline train: {DISK_TRAIN} train and {DISK_VAL} val plots of {k} points, "
              f"B={DISK_BATCH}, {DISK_AUGS} augmented copies, {DISK_EPOCHS} epochs: train MSE "
              f"{hist['train_mse']}, val {hist['val_mse']}; s/epoch "
              f"{[round(t, 4) for t in hist['epoch_seconds']]}, clouds/s "
              f"{[round(c, 1) for c in hist['clouds_per_sec']]}; fit {fit_s:.3f} s of the "
              f"command's {wall:.3f} s, decoding {dec / wall:.1%}; peak {peak:.2f} GiB [{card}]",
              flush=True)

        # evaluate: its predictions bit-identical to predict_dataset on the same test set
        evaluated = {}
        test_model = testing.test_model

        def recorded_test_model(*args, **kwargs):
            evaluated["metrics"], evaluated["frame"] = test_model(*args, **kwargs)
            return evaluated["metrics"], evaluated["frame"]

        test_dir = root / "fps" / "test"
        with mock.patch.object(testing, "test_model", recorded_test_model):
            out, wall, dec = disk_stage("evaluate", [
                "evaluate", "--config", str(cfg_path), "--model-dir", str(root / "models"),
                "--fig-out-dir", str(root / "figs"), "--data.test_dir", str(test_dir)],
                device, counts, card)
        metrics = evaluated["metrics"].to_numpy(np.float64)
        require(np.isfinite(metrics).all(), f"disk_pipeline: evaluate metrics {metrics}")
        if testing.figure_module() is None:
            figures = "no figures (matplotlib is not installed on this machine)"
            require("matplotlib is not installed" in out, "disk_pipeline: evaluate figures")
        else:
            figures = "the 4 figures written"
            require(len(list((root / "figs").glob("*.png"))) == 4,
                    "disk_pipeline: evaluate figures")
        model, _ = testing.load_model_for_eval(str(root / "models"), device=device)
        ds = PointCloudsInFilesPreSampled(
            str(test_dir), "*.las", biomass_csv=str(root / "raw" / "biomass.csv"),
            presampled_suffix=suffix).load_all(for_augmentation=False, device=device)
        rows = testing.predict_dataset(model, ds, DISK_SERVE_BATCH)
        frame = evaluated["frame"]
        pred_cols = [f"{c}_pred" for c in ("bark_btphr", "branch_btphr", "foliage_btphr",
                                           "wood_btphr")]
        require(list(frame.index) == ds.plot_ids and bits_equal(frame[pred_cols].to_numpy(), rows),
                "disk_pipeline: evaluate's predictions differ from predict_dataset's")
        print(f"disk_pipeline evaluate: {DISK_TEST} plots, metrics finite (r2 tree "
              f"{evaluated['metrics'].loc['tree_btphr', 'r2']}), predictions bit-identical to "
              f"predict_dataset, {figures}; {DISK_TEST / wall:.1f} clouds/s over the command's "
              f"wall {wall:.3f} s [{card}]", flush=True)

        # predict: the engine's rows bit-identical to compile_dataset_inference; the
        # module's within the folded-vs-module bound
        csvs = {}
        for name, extra in (("predict", []), ("predict --no-engine", ["--no-engine"])):
            csvs[name] = root / f"{name.split()[-1].strip('-')}.csv"
            _, wall, dec = disk_stage(name, ["predict", "--model-dir", str(root / "models"),
                                             "--in-dir", str(test_dir), "--out", str(csvs[name]),
                                             "--presampled-suffix", suffix, *extra],
                                      device, counts, card)
            print(f"disk_pipeline {name}: {DISK_TEST} plots, {DISK_TEST / wall:.1f} clouds/s over "
                  f"the command's wall {wall:.3f} s, decoding {dec / wall:.1%} [{card}]",
                  flush=True)

        def read(path):
            df = pd.read_csv(path, index_col="PlotID", float_precision="round_trip")
            return df, df.to_numpy(np.float32)[:, :4]

        engine_df, engine_rows = read(csvs["predict"])
        want = compile_dataset_inference(model, device)(ds, DISK_SERVE_BATCH)
        require(list(engine_df.index) == ds.plot_ids and bits_equal(engine_rows, want),
                "disk_pipeline: predict's rows differ from compile_dataset_inference's")
        _, module_rows = read(csvs["predict --no-engine"])
        rel = rel_diff(torch.from_numpy(module_rows), torch.from_numpy(engine_rows))
        require(rel <= FOLDED_VS_MODULE_RTOL,
                f"disk_pipeline: --no-engine vs engine rel {rel} > {FOLDED_VS_MODULE_RTOL}")
        print(f"disk_pipeline predict: rows bit-identical to compile_dataset_inference(model)(ds, "
              f"{DISK_SERVE_BATCH}); --no-engine (the module) max|diff|/max|y| {rel:.3e} (bound "
              f"{FOLDED_VS_MODULE_RTOL}) [{card}]", flush=True)

        # predict --watch: a plot added between two polls gets its row appended
        arrivals = root / "arrivals"
        arrivals.mkdir()
        files = sorted(test_dir.glob("*.las"))
        for f in files[:-1]:
            (arrivals / f.name).write_bytes(f.read_bytes())

        def arrive(_seconds):
            (arrivals / files[-1].name).write_bytes(files[-1].read_bytes())

        watch_csv = root / "watch.csv"
        with mock.patch.object(time, "sleep", side_effect=arrive):
            disk_stage("predict --watch", [
                "predict", "--model-dir", str(root / "models"), "--in-dir", str(arrivals),
                "--out", str(watch_csv), "--presampled-suffix", suffix, "--watch",
                "--max-polls", "2", "--poll-seconds", "0"],
                device, counts, card)
        watch_df, _ = read(watch_csv)
        last = ds.plot_ids[-1]
        require(len(watch_df) == DISK_TEST and list(watch_df.index)[-1] == last,
                f"disk_pipeline: --watch rows {list(watch_df.index)[-3:]}")
        require(bits_equal(watch_df.loc[ds.plot_ids].to_numpy(np.float32)[:, :4], engine_rows),
                "disk_pipeline: --watch rows differ from predict's")
        print(f"disk_pipeline predict --watch: {DISK_TEST - 1} plots at the first poll, {last} "
              f"appended at the second, every row bit-identical to predict's [{card}]",
              flush=True)
        check_loader(root / "raw", device, card)

    launches["disk_pipeline"] = {e: sum(c[e] for c in counts.values()) for e in ENTRIES}
    require(launches["disk_pipeline"] == EXPECTED["disk_pipeline"],
            f"disk_pipeline: launches {launches['disk_pipeline']}")
    return fps_row


# phase 16: a raw corpus of RS_TRAIN train and RS_VAL val plots of DISK_RAW points
# (make_corpus, seed RS_SEED), loaded at RS_POINTS points a plot by the raw loader;
# the research commands at B=RS_BATCH with RS_AUGS augmented copies a plot, their
# config seeded RS_CONFIG_SEED (the sweep's and tune's TPE draws)
RS_TRAIN, RS_VAL, RS_POINTS, RS_SEED, RS_CONFIG_SEED = 72, 36, 7168, 60, 0
RS_BATCH, RS_AUGS = 36, 2
RS_LRS, RS_WDS, RS_SWEEP_EPOCHS = (1e-4, 1e-3), (0.0, 8.025e-5), 2
RS_CHECK_EPOCHS = 3  # the library sweep whose trial 1 is stopped at epoch 1
RS_TUNE_TRIALS, RS_TUNE_EPOCHS = 2, 2
RS_DENSITY = (2048, 7169, 5120)  # --range: 2048 and 7168 points
# the ablation's own defaults (experiments/density.py): B=28, 1 augmented copy,
# a quarter of the plots for validation
RS_DENSITY_BATCH, RS_DENSITY_AUGS, RS_DENSITY_VAL = 28, 1, RS_TRAIN // 4
RS_STUDY_SEEDS, RS_STUDY_PLOTS, RS_STUDY_POINTS = 2, 48, 4096
# run_seed_study's defaults: B=32, 3 augmented copies; a sixth of the plots each
# for validation and test
RS_STUDY_BATCH, RS_STUDY_AUGS = 32, 3
RS_LR_ITERS, RS_LR_RANGE = 20, (1e-7, 1.0)
FIXTURE = ROOT / "tests" / "data" / "parity_fixture"


def batches_of(plots: int, batch: int, augs: int = 0) -> int:
    """Batches an epoch takes over ``plots`` plots with ``augs`` copies each."""
    return -(-plots * (1 + augs) // batch)


def parity_launches(steps: int = 0, forwards: int = 0) -> dict:
    """Launches of the parity preset's steps and forwards: exact FPS on kernel
    1 and the first-K ball query on kernel 3 at both SA layers, SA2's gather
    (kernel 4a) and, in a step, its scatter-add (kernel 4b) and kernel 11 as
    in the production step."""
    n = steps + forwards
    return per_run(dlbt_fps=2 * n, dlbt_ball_query=2 * n, dlbt_gather=n, dlbt_scatter_rows=steps,
                   **bn_train_launches(4, 3, steps=steps))


def research_stage(name: str, fn, device, card: str, counts: dict, expected=None,
                   epochs: int = 0, clouds: int = 0):
    """``fn()`` with every launch count set to 0 just before it and read just
    after, timed on the host clock up to a ``utils/profiling.hard_sync`` on
    the device; ``expected`` (a launch dict, or a function of ``fn``'s result
    giving (launches, epochs, clouds trained)) is held to the counts. Returns
    ``fn``'s result."""
    from dl_biomass_tpu_torch.ops import _build
    from dl_biomass_tpu_torch.utils.profiling import hard_sync

    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    out = fn()
    hard_sync(torch.zeros(1, device=device))
    wall = time.perf_counter() - t0
    got = {e: _build.launch_counts[e] for e in ENTRIES}
    if callable(expected):
        expected, epochs, clouds = expected(out)
    for e, want in (expected or per_run()).items():
        require(got[e] == want, f"research {name}: {e} launched {got[e]} times, expected {want}")
    counts[name] = got
    pace = (f"{epochs} epochs ({wall / epochs:.4f} s/epoch), {clouds} clouds trained "
            f"({clouds / wall:.1f} clouds/s); " if epochs else "")
    print(f"research {name}: {wall:.3f} s of wall; {pace}launches "
          f"{ {e: n for e, n in got.items() if n} } [{card}]", flush=True)
    return out


def trainer_state(trainer):
    """A trainer's module state and optimizer state, copied."""
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            copy.deepcopy(trainer.optimizer.state_dict()))


def same_trainer_state(a, b) -> bool:
    """Parameters, BatchNorm running statistics, Adam's step and moments, bit for bit."""
    (ma, oa), (mb, ob) = a, b
    sa, sb = oa["state"], ob["state"]
    return (ma.keys() == mb.keys() and all(same_bits(ma[k], mb[k]) for k in ma)
            and sa.keys() == sb.keys() and all(same_bits(sa[k][f], sb[k][f]) for k in sa
                                               for f in ("step", "exp_avg", "exp_avg_sq")))


def check_frozen_trial(cfg, device, card: str, counts: dict) -> None:
    """A library sweep of 2 trials over RS_CHECK_EPOCHS epochs, patience 1,
    the validation values scripted (trial 0 falling, trial 1 rising at epoch
    1) on top of the real validation: trial 1 stops at epoch 1 and keeps its
    state bit for bit; trial 0's state equals a ``Trainer`` run's of the same
    initial weights over the same batches with the same generators."""
    from dl_biomass_tpu_torch.__main__ import _load_train_val
    from dl_biomass_tpu_torch.io.device_data import derive_seed
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep
    from dl_biomass_tpu_torch.train.trainer import Trainer

    ds, val = _load_train_val(cfg, device)
    sweep = VmappedSweep(build_model(cfg, ds.num_features), RS_LRS, RS_WDS[::-1], patience=1,
                         device=device)
    init, snaps, epoch = {}, {}, iter(range(RS_CHECK_EPOCHS))
    init_states, validate = sweep.init_states, sweep._validate

    def recorded_init(seed):
        trials = init_states(seed)
        init.update({i: trainer_state(t) for i, t in enumerate(trials)})
        return trials

    def scripted_validate(val_ds, batch_size, active):
        e = next(epoch)
        vals = validate(val_ds, batch_size, active)
        snaps[e] = trainer_state(sweep.trials[1])
        require(np.isfinite(vals[active]).all(), f"research: non-finite validation {vals}")
        return np.where(active, [RS_CHECK_EPOCHS - e, 1.0 + e], np.nan)

    sweep.init_states, sweep._validate = recorded_init, scripted_validate
    steps, fwd = batches_of(RS_TRAIN, RS_BATCH, RS_AUGS), batches_of(RS_VAL, RS_BATCH)
    epochs = RS_CHECK_EPOCHS + 2  # trial 0 all of them, trial 1 until its stop
    res = research_stage(
        "sweep (library, trial 1 stopped)",
        lambda: sweep.run(ds, val, seed=RS_SEED, batch_size=RS_BATCH, num_augs=RS_AUGS,
                          num_epochs=RS_CHECK_EPOCHS, log_fn=lambda _: None),
        device, card, counts, disk_launches(steps=epochs * steps, forwards=epochs * fwd),
        epochs=epochs, clouds=epochs * RS_TRAIN * (1 + RS_AUGS))
    require([(r.epochs_run, r.stopped_early) for r in res] == [(RS_CHECK_EPOCHS, False),
                                                              (2, True)],
            f"research: library sweep stops {[(r.epochs_run, r.stopped_early) for r in res]}")
    require(same_trainer_state(trainer_state(sweep.trials[1]), snaps[1])
            and not same_trainer_state(snaps[0], snaps[1]),
            "research: the stopped trial's state moved after its stop")
    ref = Trainer(build_model(cfg, ds.num_features), sweep.trial_config(0), device)
    ref.model.load_state_dict(init[0][0])
    for e in range(RS_CHECK_EPOCHS):
        es = derive_seed(RS_SEED, e)
        ref.train_epoch(ds.batches(RS_BATCH, seed=es, num_augs=RS_AUGS, shuffle=True),
                        sweep.trial_generator(0, es))
    require(same_trainer_state(trainer_state(ref), trainer_state(sweep.trials[0])),
            "research: trial 0 differs from the Trainer run of its weights, batches and "
            "generators")
    print(f"research sweep (library): trial 1 stopped at epoch 1 by a scripted rise (patience "
          f"1) keeps its parameters, Adam moments and BatchNorm running statistics bit for bit "
          f"over epoch 2; trial 0 ({RS_CHECK_EPOCHS} epochs) bit-identical to a Trainer run of "
          f"the same initial weights, lr {sweep.lrs[0]}, weight decay {sweep.wds[0]}, batches and "
          f"generators [{card}]", flush=True)


def tune_launches(trials):
    """(launches, epochs, clouds trained) of tune's trials over the RS_TRAIN
    and RS_VAL plots, from their sampled batch sizes and copies and the epochs
    each reported."""
    steps = forwards = epochs = clouds = 0
    for t in trials:
        e, b, a = len(t["intermediate_values"]), t["params"]["batch_size"], t["params"]["num_augs"]
        steps += e * batches_of(RS_TRAIN, b, a)
        forwards += e * batches_of(RS_VAL, b)
        epochs += e
        clouds += e * RS_TRAIN * (1 + a)
    return disk_launches(steps=steps, forwards=forwards), epochs, clouds


def research(device, card: str, launches: dict) -> None:
    """Phase 16, path research: sweep, tune (and --continue-study), density,
    seed-study, parity-record / parity-check, visualize-aug and the LR range
    test at the production defaults, every stage's launches counted."""
    import tempfile

    import pandas as pd

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.eval.recorded import DEFAULT_RTOL
    from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
    from dl_biomass_tpu_torch.train import lr_finder

    counts = {}
    steps, fwd = batches_of(RS_TRAIN, RS_BATCH, RS_AUGS), batches_of(RS_VAL, RS_BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_research_") as tmp:
        root = Path(tmp)
        total = RS_TRAIN + RS_VAL
        t0 = time.perf_counter()
        make_corpus(str(root / "raw"), total, DISK_RAW, seed=RS_SEED,
                    splits=(("train", RS_TRAIN / total), ("val", RS_VAL / total)))
        print(f"research: make_corpus wrote {total} plots of {DISK_RAW} raw points in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        csv = str(root / "raw" / "biomass.csv")
        cfg_dict = {"hp": {"batch_size": RS_BATCH, "num_augs": RS_AUGS, "num_points": RS_POINTS},
                    "data": {"train_dir": str(root / "raw" / "train"),
                             "val_dir": str(root / "raw" / "val"), "biomass_csv": csv,
                             "use_presampled": False},
                    "seed": RS_CONFIG_SEED}
        cfg_path = root / "cfg.json"
        cfg_path.write_text(json.dumps(cfg_dict))
        cfg = TrainConfig.from_json(str(cfg_path))

        # sweep: the 4 trials of the (lr x wd) grid in turn on each batch
        n_trials = len(RS_LRS) * len(RS_WDS)
        study = root / "studies" / "sweep.json"
        research_stage("sweep", lambda: run_cli(
            ["sweep", "--config", str(cfg_path), "--lrs", ",".join(map(str, RS_LRS)),
             "--wds", ",".join(map(str, RS_WDS)), "--batch-sizes", str(RS_BATCH),
             "--num-epochs", str(RS_SWEEP_EPOCHS), "--study-out", str(study)], device),
            device, card, counts,
            disk_launches(steps=n_trials * RS_SWEEP_EPOCHS * steps,
                          forwards=n_trials * RS_SWEEP_EPOCHS * fwd),
            epochs=n_trials * RS_SWEEP_EPOCHS,
            clouds=n_trials * RS_SWEEP_EPOCHS * RS_TRAIN * (1 + RS_AUGS))
        trials = json.loads(study.read_text())["trials"]
        frame = pd.read_csv(root / "studies" / "sweep_trials.csv")
        require(len(trials) == n_trials and len(frame) == n_trials
                and all(np.isfinite(t["value"]) for t in trials),
                f"research: sweep study {trials}")
        print(f"research sweep: {n_trials} trials, best val MSE by (lr, wd): "
              f"{ {(t['params']['lr'], t['params']['weight_decay']): round(t['value'], 4) for t in trials} }",
              flush=True)
        check_frozen_trial(cfg, device, card, counts)

        # tune: 2 trials, saved; then one more from the saved study
        tune_json = root / "tune" / "tune.json"
        argv = ["tune", "--config", str(cfg_path), "--max-epochs", str(RS_TUNE_EPOCHS),
                "--study-out", str(tune_json)]
        out = research_stage(
            "tune", lambda: run_cli(argv + ["--n-trials", str(RS_TUNE_TRIALS)], device),
            device, card, counts,
            lambda _: tune_launches(json.loads(tune_json.read_text())["trials"]))
        trials = json.loads(tune_json.read_text())["trials"]
        require(len(trials) == RS_TUNE_TRIALS and all(np.isfinite(t["value"]) for t in trials),
                f"research: tune study {trials}")
        require("Param importances" in out or "scikit-learn is not installed" in out,
                "research: tune's importances")
        out = research_stage(
            "tune --continue-study",
            lambda: run_cli(argv + ["--n-trials", "1", "--continue-study"], device),
            device, card, counts,
            lambda _: tune_launches(json.loads(tune_json.read_text())["trials"][RS_TUNE_TRIALS:]))
        trials = json.loads(tune_json.read_text())["trials"]
        require(f"Continuing study: {tune_json} ({RS_TUNE_TRIALS} trials)" in out
                and len(trials) == RS_TUNE_TRIALS + 1
                and all(np.isfinite(t["value"]) for t in trials),
                f"research: tune --continue-study {trials}")
        print(f"research tune: trials (batch, copies, val MSE) "
              f"{[(t['params']['batch_size'], t['params']['num_augs'], round(t['value'], 4)) for t in trials]}; "
              f"{out.strip().splitlines()[-1]}", flush=True)

        # density: 2048 and 7168 points, 1 epoch each, the ablation's own defaults
        lo, hi, stride = RS_DENSITY
        points = list(range(lo, hi, stride))
        d_train = RS_TRAIN - RS_DENSITY_VAL
        d_steps = len(points) * batches_of(d_train, RS_DENSITY_BATCH, RS_DENSITY_AUGS)
        d_fwd = len(points) * batches_of(RS_DENSITY_VAL, RS_DENSITY_BATCH)
        density_csv = root / "density.csv"
        research_stage("density", lambda: run_cli(
            ["density", "--data.train_dir", str(root / "raw" / "train"), "--data.biomass_csv",
             csv, "--range", f"{lo}:{hi}:{stride}", "--num_epochs", "1", "--out-csv",
             str(density_csv)], device), device, card, counts,
            disk_launches(steps=d_steps, forwards=d_fwd), epochs=len(points),
            clouds=len(points) * d_train * (1 + RS_DENSITY_AUGS))
        df = pd.read_csv(density_csv)
        require(list(df["point_num"]) == points and list(df["epochs"]) == [1] * len(points)
                and np.isfinite(df[["val_mse", "runtime", "clouds_per_sec"]].to_numpy()).all(),
                f"research: density CSV {df.to_dict('records')}")
        print(f"research density: {df.to_dict('records')} [{card}]", flush=True)

        # seed-study: 2 seeds of the production and parity modes
        n_val = RS_STUDY_PLOTS // 6
        s_train = RS_STUDY_PLOTS - 2 * n_val
        per_run_steps = batches_of(s_train, RS_STUDY_BATCH, RS_STUDY_AUGS)
        per_run_fwd = batches_of(n_val, RS_STUDY_BATCH) + batches_of(n_val, RS_STUDY_BATCH)
        study_json = root / "seed_study.json"
        research_stage("seed-study", lambda: run_cli(
            ["seed-study", "--seeds", str(RS_STUDY_SEEDS), "--modes", "production,parity",
             "--num-plots", str(RS_STUDY_PLOTS), "--num-points", str(RS_STUDY_POINTS),
             "--max-epochs", "1", "--out", str(study_json)], device), device, card, counts,
            add_launches(disk_launches(steps=RS_STUDY_SEEDS * per_run_steps,
                                       forwards=RS_STUDY_SEEDS * per_run_fwd),
                         parity_launches(steps=RS_STUDY_SEEDS * per_run_steps,
                                         forwards=RS_STUDY_SEEDS * per_run_fwd)),
            epochs=2 * RS_STUDY_SEEDS,
            clouds=2 * RS_STUDY_SEEDS * s_train * (1 + RS_STUDY_AUGS))
        runs = json.loads(study_json.read_text())["runs"]
        require(len(runs) == 2 * RS_STUDY_SEEDS and all(
            np.isfinite(r["min_val_mse"]) and np.isfinite(r["r2_total"]) for r in runs),
            f"research: seed-study runs {runs}")
        print(f"research seed-study: (mode, seed, val MSE, r2 total, clouds/s) "
              f"{[(r['mode'], r['seed'], round(r['min_val_mse'], 4), round(r['r2_total'], 4), round(r['clouds_per_sec'], 1)) for r in runs]} "
              f"[{card}]", flush=True)

        # parity: recorded on the CPU (plain versions), replayed on the card (kernels)
        rec = root / "parity.json"
        fixture = ["--data-dir", str(FIXTURE), "--biomass-csv", str(FIXTURE / "biomass.csv")]
        t0 = time.perf_counter()
        run_cli(["parity-record", *fixture, "--out", str(rec), "--device", "cpu"], device)
        print(f"research parity-record --device cpu: {time.perf_counter() - t0:.3f} s of wall "
              f"on the host", flush=True)
        plots = len(json.loads(rec.read_text())["predictions"])
        out = research_stage("parity-check", lambda: run_cli(
            ["parity-check", *fixture, "--recorded", str(rec)], device), device, card, counts,
            parity_launches(forwards=batches_of(plots, 8)))
        delta = float(out.split("max relative delta")[1].split()[0])
        require(delta <= DEFAULT_RTOL, f"research: parity delta {delta}")
        print(f"research parity: {plots} fixture plots recorded on the CPU (plain versions) and "
              f"replayed on the card (kernels 1 and 3 exact, 4a): max relative delta {delta:.3e} "
              f"(bound DEFAULT_RTOL {DEFAULT_RTOL}) [{card}]", flush=True)

        # visualize-aug: one plot augmented on the device
        las = sorted((root / "raw" / "train").glob("*.las"))[0]
        vis = root / "vis.png"
        out = research_stage("visualize-aug", lambda: run_cli(
            ["visualize-aug", "--las", str(las), "--out", str(vis)], device), device, card, counts)
        require("augmented" in out and (vis.exists() or "matplotlib is not installed" in out),
                f"research: visualize-aug said {out}")
        print(f"research visualize-aug: {out.strip()}", flush=True)

        # the LR range test: RS_LR_ITERS SGD steps at B=RS_BATCH, cycling 2 batches
        from dl_biomass_tpu_torch.__main__ import _load_train_val
        from dl_biomass_tpu_torch.models.pointnet2 import build_model, seeded_init

        ds, _ = _load_train_val(cfg, device)
        model = seeded_init(RS_SEED, build_model, cfg, ds.num_features)
        sgd_steps, sgd_step = [], lr_finder._sgd_step

        def counted_sgd_step(*args):
            sgd_steps.append(1)
            return sgd_step(*args)

        lo, hi = RS_LR_RANGE
        with mock.patch.object(lr_finder, "_sgd_step", counted_sgd_step):
            res = research_stage(
                "lr_range_test", lambda: lr_finder.lr_range_test(
                    model, ds.batches(RS_BATCH), seed=RS_SEED, start_lr=lo, end_lr=hi,
                    num_iter=RS_LR_ITERS, device=device), device, card, counts,
                lambda _: (disk_launches(steps=len(sgd_steps)), 0, 0))
        require(len(res["loss"]) > 3 and np.isfinite(res["loss"]).all()
                and res["suggestion"] is not None and lo <= res["suggestion"] <= hi,
                f"research: lr_range_test {res}")
        print(f"research lr_range_test: {len(sgd_steps)} steps of {RS_LR_ITERS} at B={RS_BATCH} "
              f"(lr {res['lr'][0]:.1e} .. {res['lr'][-1]:.3e}), smoothed losses "
              f"{[round(v, 2) for v in res['loss']]}, suggestion {res['suggestion']:.3e} [{card}]",
              flush=True)

    launches["research"] = add_launches(*counts.values())
    print(f"research launches by stage: "
          f"{ {k: {e: n for e, n in c.items() if n} for k, c in counts.items()} }", flush=True)


# ---- phase 17: the serving export and the data-parallel mesh -----------------------


def check_launches(path: str, got: dict, runs: int) -> None:
    """``got`` (launches by entry in the run of ``path``) held to ``runs``
    forwards or steps of ``path``."""
    for e, per in EXPECTED[path].items():
        require(got[e] == per * runs,
                f"{path}: {e} launched {got[e]} times in {runs} runs, expected {per * runs}")


def dlbt_calls(loaded) -> dict:
    """The registered kernel ops an exported graph calls, with their counts."""
    calls = [str(n.target) for n in loaded._fn.graph.nodes if n.op == "call_function"]
    return {c.split(".")[1]: calls.count(c) for c in sorted(set(calls)) if c.startswith("dlbt.")}


def export_paths(device, card: str, launches: dict, root: Path) -> None:
    """Phase 17, paths export and export_unsplit: ``export_serving`` of the
    seeded production model (and of its unsplit twin, kernel 4c) at SMALL x
    N_POINTS, ``load_serving``, the strict call and ``predict`` on the partial
    request, launches counted, against ``compile_inference``; ms per batch of
    both."""
    from dl_biomass_tpu_torch.models.export import export_serving, load_serving
    from dl_biomass_tpu_torch.models.inference import compile_inference

    req = synthetic_batch(SMALL, N_POINTS, seed=1, device=device)
    sizes = np.random.default_rng(3).integers(PARTIAL_LO, N_POINTS + 1, size=PARTIAL)
    part = synthetic_batch(PARTIAL, N_POINTS, seed=3, device=device, sizes=sizes)
    for path, split in (("export", True), ("export_unsplit", False)):
        model = seeded_model(device, split_first_layer=split)
        engine = compile_inference(model, device)
        art = root / path
        t0 = time.perf_counter()
        meta = export_serving(model, batch_size=SMALL, num_points=N_POINTS, path=str(art),
                              device=device)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_serving(str(art), device)
        t_load = time.perf_counter() - t0
        require(meta["platforms"] == [device.type], f"{path}: platforms {meta['platforms']}")
        got, got_part = counted_run(path, lambda: (loaded(req.pos, req.feat, req.mask),
                                                   loaded.predict(part.pos, part.feat, part.mask)),
                                    launches, runs=1 + -(-PARTIAL // SMALL))
        want, want_part = engine(req), engine(part).cpu()
        identical = same_bits(got, want)
        err = rel_diff(got, want)
        require(identical or err <= BF16_SERVE_RTOL,
                f"{path}: artifact vs compile_inference rel {err} > {BF16_SERVE_RTOL}")
        part_err = rel_diff(torch.from_numpy(got_part), want_part)
        require(got_part.shape == (PARTIAL, 4) and np.isfinite(got_part).all()
                and part_err <= BF16_SERVE_RTOL,
                f"{path}: predict on {PARTIAL} clouds {got_part.shape}, rel {part_err}")
        ms_art = serve_timing(lambda b: loaded(b.pos, b.feat, b.mask), req)
        ms_eng = serve_timing(engine, req)
        size = sum(f.stat().st_size for f in art.iterdir())
        print(f"{path}: export_serving {t_export:.1f} s, load_serving {t_load:.1f} s, "
              f"{size / 1e6:.2f} MB on disk; the graph calls {dlbt_calls(loaded)}; launches over "
              f"the strict call and predict({PARTIAL}): "
              f"{ {e: n for e, n in launches[path].items() if n} }; B={SMALL} x {N_POINTS} vs "
              f"compile_inference: bit-identical {identical}, max|diff|/max|y| {err:.3e} (bound "
              f"{BF16_SERVE_RTOL}); predict on the partial request vs the engine: "
              f"{part_err:.3e}; ms per batch (host clock after a synchronize, median of "
              f"{SERVE_REPS}): artifact {ms_art:.3f}, engine {ms_eng:.3f} [{card}]", flush=True)


def mesh_rank(rank: int, world: int, device, tmp: str) -> None:
    """Phase 17's body in each rank of the group: every data-parallel path,
    its launches counted, what it gave saved to ``rank<r>.pt`` for the parent
    to hold against one process."""
    import dataclasses

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.io.device_data import DeviceDataset
    from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.ops import _build
    from dl_biomass_tpu_torch.parallel import mesh as dp
    from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep
    from dl_biomass_tpu_torch.train.trainer import Trainer

    mesh = dp.make_mesh(world, 1, device)
    out = dict(device=str(device), backend=torch.distributed.get_backend(), launches={})

    def counted(path, fn):
        torch.cuda.synchronize(device)
        _build.launch_counts.clear()
        res = fn()
        torch.cuda.synchronize(device)
        seen = out["launches"].setdefault(path, dict.fromkeys(ENTRIES, 0))
        for e in ENTRIES:
            seen[e] += _build.launch_counts[e]
        return res

    # the f32 step at SMALL (ELU: no ReLU branch to flip), the bf16 steps at LARGE
    model = seeded_model(device, compute_dtype="float32", activation="ELU")
    trainer = Trainer(model, TrainConfig(), device, mesh=mesh)
    batch = synthetic_batch(SMALL, N_POINTS, seed=MESH_SEED, device=device)
    loss = counted("mesh_train", lambda: trainer.step(batch, train_gen(device, MESH_SEED)))
    out["f32"] = dict(loss=float(loss), grads={k: p.grad.cpu() for k, p in
                                               model.named_parameters()},
                      stats={k: v.cpu() for k, v in running_stats(model).items()})
    del trainer, model, batch
    trainer = Trainer(seeded_model(device), TrainConfig(), device, mesh=mesh)
    batch = synthetic_batch(LARGE, N_POINTS, seed=MESH_SEED + 1, device=device)
    torch.cuda.reset_peak_memory_stats(device)

    def steps():
        losses, times = [], []
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            losses.append(float(trainer.step(batch, train_gen(device, MESH_SEED + i))))
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    losses, times = counted("mesh_train", steps)
    out["bf16"] = dict(losses=losses, ms=times,
                       peak=torch.cuda.max_memory_allocated(device) / 2**30)
    del trainer, batch

    # fit over phase 14's DeviceDataset
    ds = DeviceDataset.from_clouds(*synthetic_dataset(DD_PLOTS, DD_POINTS, seed=DD_SEED),
                                   device=device)
    val = DeviceDataset.from_clouds(*synthetic_dataset(DD_VAL_PLOTS, DD_POINTS,
                                                       seed=DD_SEED + 1), device=device)
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, scan_epochs=True, hp=dataclasses.replace(
        cfg.hp, batch_size=DD_BATCH, num_augs=DD_AUGS))
    trainer = Trainer(seeded_model(device), cfg, device, mesh=mesh)
    hist = counted("mesh_fit", lambda: trainer.fit(ds, val, num_epochs=DD_EPOCHS,
                                                   log_fn=lambda _: None))
    out["fit"] = {k: hist[k] for k in ("train_mse", "val_mse", "epoch_seconds",
                                       "clouds_per_sec")}
    del trainer, ds, val

    # both engines at SMALL
    model = seeded_model(device)
    req = synthetic_batch(SMALL, N_POINTS, seed=1, device=device)
    out["serve"] = {}
    for path, fused_eval in (("mesh_serve", False), ("mesh_serve_fused_eval", True)):
        serve = compile_inference(model, device, fused_eval=fused_eval, mesh=mesh)
        y = counted(path, lambda: serve(req))
        out["serve"][path] = dict(y=y.cpu(), ms=serve_timing(serve, req))

    # the sweep: MESH_TRIALS trials split over the ranks
    ds = DeviceDataset.from_clouds(*synthetic_dataset(MS_PLOTS, DD_POINTS, seed=MESH_SEED),
                                   device=device)
    val = DeviceDataset.from_clouds(*synthetic_dataset(MS_VAL_PLOTS, DD_POINTS,
                                                       seed=MESH_SEED + 1), device=device)
    sweep = VmappedSweep(model, MS_LRS, MS_WDS, mesh=mesh, device=device)
    t0 = time.perf_counter()
    res = counted("mesh_sweep", lambda: sweep.run(ds, val, seed=MESH_SEED, batch_size=MS_BATCH,
                                                  num_epochs=MS_EPOCHS, log_fn=lambda _: None))
    out["sweep"] = dict(results=[(r.lr, r.weight_decay, r.best_val_mse, r.epochs_run,
                                  r.stopped_early) for r in res],
                        local=list(sweep.local), s=time.perf_counter() - t0)
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def one_f32_step(device, chain: bool) -> dict:
    """Phase 17's f32 (ELU) step at SMALL x N_POINTS in one process, with
    every BatchNorm on the PyTorch chain (``chain``) or the SA layers' on
    kernel 11: loss, gradients, running statistics and each masked max's
    argmax, in forward order."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import bn_train_kernel, pooling
    from dl_biomass_tpu_torch.train.trainer import Trainer

    model = seeded_model(device, compute_dtype="float32", activation="ELU")
    trainer = Trainer(model, TrainConfig(), device)
    batch = synthetic_batch(SMALL, N_POINTS, seed=MESH_SEED, device=device)
    real, argmax = pooling.first_argmax, []

    def first_argmax(filled, out_max, dim):
        am = real(filled, out_max, dim)
        argmax.append(am.cpu())
        return am

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(pooling, "first_argmax", first_argmax))
        if chain:
            stack.enter_context(mock.patch.object(bn_train_kernel, "takes",
                                                  lambda *a, **kw: False))
        loss = trainer.step(batch, train_gen(device, MESH_SEED))
    return dict(loss=float(loss), grads={k: p.grad.cpu() for k, p in model.named_parameters()},
                stats={k: v.cpu() for k, v in running_stats(model).items()}, argmax=argmax)


def step_gap(got: dict, want: dict) -> dict:
    """``hold_step``'s measures of ``got`` against ``want``, unheld, and
    the argmaxes that differ where both recorded them."""
    m = grad_misses(got, want)
    worst = max(m["own"], key=m["own"].get)
    out = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]), own=m["own"][worst],
               own_name=worst, within=len(m["own"]) - len(m["miss"]), tensors=len(m["own"]),
               stat=max(float((got["stats"][k].double() - s.double()).abs().max())
                        / float(s.abs().max()) for k, s in want["stats"].items()))
    if "argmax" in got and "argmax" in want:
        out["flips"] = sum(int((a != b).sum()) for a, b in zip(got["argmax"], want["argmax"]))
        out["slots"] = sum(a.numel() for a in want["argmax"])
    return out


def hold_step(name: str, got: dict, want: dict) -> dict:
    """A mesh step's loss, gradients and running statistics against one
    process's: the loss within MESH_LOSS_RTOL; each gradient over its own
    largest within MESH_GRAD_ATOL (tests/test_parallel.py's measure and
    bound; the biases whose true gradient is 0 by size, within C4_ZERO of
    the step's largest |g|, as tests/test_torch_mesh.py holds them); the
    statistics over their largest within MESH_GRAD_ATOL. Returns the
    measures, the relative L2 and the largest difference over the step's
    largest |g| among them."""
    rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    require(rel_loss <= MESH_LOSS_RTOL, f"{name}: loss rel {rel_loss} > {MESH_LOSS_RTOL}")
    m = grad_misses(got, want)
    require(not m["miss"] and not m["zero_miss"],
            f"{name}: gradients past {MESH_GRAD_ATOL} of their largest {m['miss']} or zero "
            f"gradients past {C4_ZERO} of the step's {m['zero_miss']}: "
            f"{ {k: m['own'].get(k, m['zero'].get(k)) for k in m['miss'] + m['zero_miss']} }")
    top = max(float(g.abs().max()) for g in want["grads"].values())
    l2 = max(float((got["grads"][k].double() - g.double()).norm() / g.double().norm())
             for k, g in want["grads"].items() if k in m["own"])
    by_top = max(float((got["grads"][k].double() - g.double()).abs().max()) / top
                 for k, g in want["grads"].items())
    stat = max(float((got["stats"][k].double() - s.double()).abs().max()) / float(s.abs().max())
               for k, s in want["stats"].items())
    require(stat <= MESH_GRAD_ATOL, f"{name}: running statistics off by {stat}")
    worst = max(m["own"], key=m["own"].get)
    return dict(loss=rel_loss, l2=l2, top=by_top, stat=stat, own=m["own"][worst],
                own_name=worst, own_within=len(m["own"]) - len(m["miss"]),
                tensors=len(m["own"]), zero=max(m["zero"].values(), default=0.0))


def mesh_paths(device, card: str, launches: dict) -> None:
    """Phase 17, paths mesh_train, mesh_fit, mesh_serve, mesh_serve_fused_eval
    and mesh_sweep: MESH_RANKS ranks spawned on the card (a card each where
    there are enough, nccl; else both on cuda:0, gloo), every path's launches
    counted in each rank, then each held against one process here."""
    import tempfile

    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.io.device_data import DeviceDataset
    from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.parallel import mesh as dp
    from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep
    from dl_biomass_tpu_torch.train.trainer import Trainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dp.spawn(mesh_rank, MESH_RANKS, str(Path(tmp) / "store"), args=(tmp,), device=device)
        wall = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu", weights_only=False)
                 for r in range(MESH_RANKS)]
    print(f"mesh: {MESH_RANKS} ranks on {[r['device'] for r in ranks]} ({ranks[0]['backend']}), "
          f"{wall:.1f} s from spawn to the last rank's end [{card}]", flush=True)
    runs = {"mesh_train": 1 + MESH_STEPS, "mesh_fit": 1, "mesh_serve": 1,
            "mesh_serve_fused_eval": 1, "mesh_sweep": 1}
    for path, n in runs.items():
        launches[path] = {e: sum(r["launches"][path][e] for r in ranks) for e in ENTRIES}
        check_launches(path, launches[path], n * MESH_RANKS)
    print(f"mesh launches over both ranks by path: "
          f"{ {p: {e: n for e, n in launches[p].items() if n} for p in runs} }", flush=True)

    # the f32 step against one process on the same global batch and draws,
    # on the BatchNorm chain the mesh runs; then one process on kernel 11
    # against both, reported
    one, fused = (one_f32_step(device, chain) for chain in (True, False))
    m = hold_step("mesh f32 step", ranks[0]["f32"], one)
    same = all(torch.equal(ranks[0]["f32"]["grads"][k], r["f32"]["grads"][k])
               for r in ranks[1:] for k in one["grads"])
    require(same, "mesh f32 step: the ranks hold different gradients")
    print(f"mesh_train f32 (ELU) B={SMALL} x {N_POINTS}, {MESH_RANKS} ranks vs one process, one "
          f"state and generator: loss {ranks[0]['f32']['loss']:.6f} vs {one['loss']:.6f} (rel "
          f"{m['loss']:.3e}, bound {MESH_LOSS_RTOL}); gradients each over its own largest "
          f"(tests/test_parallel.py's measure): {m['own_within']} of {m['tensors']} within "
          f"{MESH_GRAD_ATOL}, the worst {m['own']:.3e} ({m['own_name']}); zero-gradient biases "
          f"{m['zero']:.3e} of the step's largest (bound {C4_ZERO}); rel L2 {m['l2']:.3e}, "
          f"max|diff| over the step's largest |g| {m['top']:.3e}; running statistics "
          f"{m['stat']:.3e} (bound {MESH_GRAD_ATOL}); every rank's gradients bit-identical "
          f"[{card}]", flush=True)
    for name, want in (("the mesh", ranks[0]["f32"]), ("one process on the chain", one)):
        k = step_gap(fused, want)
        print(f"mesh_train f32 (ELU) B={SMALL} x {N_POINTS}: one process on kernel 11 against "
              f"{name}: loss rel {k['loss']:.3e}; gradients over their own largest: "
              f"{k['within']} of {k['tensors']} within {MESH_GRAD_ATOL}, the worst "
              f"{k['own']:.3e} ({k['own_name']}); running statistics {k['stat']:.3e}"
              + (f"; masked-max argmaxes differing {k['flips']} of {k['slots']}"
                 if "argmax" in want else "") + f" (reported, not held) [{card}]", flush=True)

    trainer = Trainer(seeded_model(device), TrainConfig(), device)
    batch = synthetic_batch(LARGE, N_POINTS, seed=MESH_SEED + 1, device=device)
    losses, times = [], []
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        losses.append(float(trainer.step(batch, train_gen(device, MESH_SEED + i))))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    got = ranks[0]["bf16"]
    rel = abs(got["losses"][0] - losses[0]) / abs(losses[0])
    require(rel <= MESH_BF16_RTOL and all(r["bf16"]["losses"] == got["losses"] for r in ranks),
            f"mesh bf16 step: loss rel {rel} > {MESH_BF16_RTOL}, or the ranks disagree")
    ms_mesh = statistics.median(got["ms"][1:])
    ms_one = statistics.median(times[1:])
    print(f"mesh_train bf16 B={LARGE} x {N_POINTS}, {MESH_RANKS} ranks ({LARGE // MESH_RANKS} "
          f"clouds each): first loss {got['losses'][0]:.6f} vs one process {losses[0]:.6f} (rel "
          f"{rel:.3e}, bound {MESH_BF16_RTOL:.3e}); {MESH_STEPS} steps {got['losses']} vs "
          f"{losses}; ms/step (host clock, median of the last {MESH_STEPS - 1}) {ms_mesh:.3f} "
          f"({LARGE / ms_mesh * 1e3:.1f} clouds/s) vs one process {ms_one:.3f} "
          f"({LARGE / ms_one * 1e3:.1f} clouds/s); rank peaks "
          f"{[round(r['bf16']['peak'], 2) for r in ranks]} GiB [{card}]", flush=True)
    del trainer, batch

    fits = [r["fit"] for r in ranks]
    require(all(f["val_mse"] == fits[0]["val_mse"] and f["train_mse"] == fits[0]["train_mse"]
                for f in fits) and np.isfinite(fits[0]["val_mse"]).all(),
            f"mesh_fit: the ranks' MSEs differ or are not finite: {fits}")
    print(f"mesh_fit: {DD_EPOCHS} epochs over {DD_PLOTS} plots x {DD_POINTS} at B={DD_BATCH} "
          f"({DD_BATCH // MESH_RANKS} a rank), {DD_AUGS} augmented copies: train MSE "
          f"{fits[0]['train_mse']}, val MSE {fits[0]['val_mse']} on every rank; s/epoch "
          f"{[round(s, 3) for s in fits[0]['epoch_seconds']]}, clouds/s "
          f"{[round(c, 1) for c in fits[0]['clouds_per_sec']]} [{card}]", flush=True)

    model = seeded_model(device)
    req = synthetic_batch(SMALL, N_POINTS, seed=1, device=device)
    for path, fused_eval in (("mesh_serve", False), ("mesh_serve_fused_eval", True)):
        serve = compile_inference(model, device, fused_eval=fused_eval)
        want = serve(req).cpu()
        ms_one = serve_timing(serve, req)
        got = [r["serve"][path] for r in ranks]
        identical = all(same_bits(g["y"], want) for g in got)
        err = max(rel_diff(g["y"], want) for g in got)
        require(all(same_bits(g["y"], got[0]["y"]) for g in got) and err <= BF16_SERVE_RTOL,
                f"{path}: the ranks' answers differ, or rel {err} > {BF16_SERVE_RTOL}")
        print(f"{path}: B={SMALL} x {N_POINTS}, {SMALL // MESH_RANKS} clouds a rank, every "
              f"answer on every rank in batch order: vs one process bit-identical {identical}, "
              f"max|diff|/max|y| {err:.3e} (bound {BF16_SERVE_RTOL}); ms per batch {got[0]['ms']:.3f}"
              f" vs one process {ms_one:.3f} [{card}]", flush=True)

    ds = DeviceDataset.from_clouds(*synthetic_dataset(MS_PLOTS, DD_POINTS, seed=MESH_SEED),
                                   device=device)
    val = DeviceDataset.from_clouds(*synthetic_dataset(MS_VAL_PLOTS, DD_POINTS,
                                                       seed=MESH_SEED + 1), device=device)
    t0 = time.perf_counter()
    res = VmappedSweep(model, MS_LRS, MS_WDS, device=device).run(
        ds, val, seed=MESH_SEED, batch_size=MS_BATCH, num_epochs=MS_EPOCHS,
        log_fn=lambda _: None)
    s_one = time.perf_counter() - t0
    want = [(r.lr, r.weight_decay, r.best_val_mse, r.epochs_run, r.stopped_early) for r in res]
    require(all(r["sweep"]["results"] == want for r in ranks),
            f"mesh_sweep: {ranks[0]['sweep']['results']} != one process {want}")
    print(f"mesh_sweep: {len(MS_LRS)} trials ({[r['sweep']['local'] for r in ranks]} by rank), "
          f"{MS_EPOCHS} epochs over {MS_PLOTS} plots x {DD_POINTS} at B={MS_BATCH}: results equal "
          f"to one process's, bit for bit ({[round(w[2], 4) for w in want]}); "
          f"{ranks[0]['sweep']['s']:.1f} s vs one process {s_one:.1f} s [{card}]", flush=True)


def mesh_cli(device, card: str, root: Path) -> None:
    """Phase 17: ``torchrun --standalone --nproc-per-node MESH_RANKS -m
    dl_biomass_tpu_torch train`` as a user runs it, on a raw corpus of
    MC_PLOTS plots of DISK_RAW points loaded at DISK_POINTS, against the same
    command in one process: the logs within MESH_BF16_RTOL, one printer."""
    import contextlib
    import io
    import os

    from dl_biomass_tpu_torch.tools.make_corpus import make_corpus

    with contextlib.redirect_stdout(io.StringIO()):
        make_corpus(str(root / "raw"), MC_PLOTS, DISK_RAW, seed=MESH_SEED)
    cfg = {"hp": {"batch_size": MC_BATCH, "num_augs": 0, "num_points": DISK_POINTS},
           "data": {"train_dir": str(root / "raw" / "train"), "val_dir": str(root / "raw" / "val"),
                    "biomass_csv": str(root / "raw" / "biomass.csv"), "use_presampled": False},
           "num_epochs": MC_EPOCHS}
    (root / "cfg.json").write_text(json.dumps(cfg))
    argv = ["train", "--config", str(root / "cfg.json")]
    cpu = [] if device.type == "cuda" else ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc-per-node={MESH_RANKS}", "-m", "dl_biomass_tpu_torch", *argv,
                          "--model_dir", str(root / "mesh"), *cpu], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"torchrun train exited {out.returncode}: "
                                 f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
    t0 = time.perf_counter()
    run_cli(argv + ["--model_dir", str(root / "one")], device)
    wall_one = time.perf_counter() - t0
    mesh_log = np.loadtxt(root / "mesh" / "training_log.csv", delimiter=",", ndmin=2)
    one_log = np.loadtxt(root / "one" / "training_log.csv", delimiter=",", ndmin=2)
    rel = float(np.abs(mesh_log[:, 1:] - one_log[:, 1:]).max() / np.abs(one_log[:, 1:]).max())
    printed = out.stdout.count(f"mesh {{'dp': {MESH_RANKS}, 'mp': 1}}")
    require(mesh_log.shape == one_log.shape == (MC_EPOCHS, 3) and rel <= MESH_BF16_RTOL
            and printed == 1 and sorted((root / "mesh").glob("epoch_*.pt")),
            f"torchrun train: logs {mesh_log} vs {one_log} (rel {rel}), printed {printed}")
    print(f"mesh_cli: torchrun --nproc-per-node {MESH_RANKS} train, {MC_EPOCHS} epochs over "
          f"{MC_PLOTS} raw plots' train split at {DISK_POINTS} points, B={MC_BATCH}: "
          f"{wall:.1f} s (one process in this one: {wall_one:.1f} s); (train, val) MSE by "
          f"epoch {mesh_log[:, 1:].tolist()} vs one process {one_log[:, 1:].tolist()}, max rel "
          f"{rel:.3e} (bound {MESH_BF16_RTOL:.3e}); rank 0 alone printed and wrote [{card}]",
          flush=True)


def mesh_export(device, card: str, launches: dict) -> None:
    """Phase 17: the serving export, the data-parallel mesh, then training
    under torchrun."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        export_paths(device, card, launches, Path(tmp))
    mesh_paths(device, card, launches)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_cli(device, card, Path(tmp))


# phase 18: the model variants and the other families at full width, B=VAR_BATCH x
# N_POINTS (remat at REMAT_BATCH), production preset, seeded weights; VAR_STEPS
# steps a timed run; voxel_select_first on SELECT_PLOTS raw plots of SELECT_RAW
# points at SELECT_VOXEL m voxels, SELECT_KEEP kept
VAR_BATCH, REMAT_BATCH, VAR_SEED = SMALL, LARGE, 70
VAR_STEPS = TRAIN_WARMUP + TRAIN_TIMED
SELECT_PLOTS, SELECT_RAW, SELECT_VOXEL, SELECT_KEEP = 16, 50_000, 0.35, N_POINTS
# the segmentor's forward and step on the kernels vs on the plain versions
# (float32, every kernel exact: only the order of cuBLAS sums could differ)
SEGMENTOR_RTOL = 1e-5
# the cell's bf16 segmentor step on the kernels vs on the plain versions, at
# the cell's 36 clouds of 7168 points in 7936 slots: each leaf's gradient
# gap, ||g - g_plain|| over the larger of ||g_plain|| and the median leaf's
# (the measure of tests/test_torch_segmentor.py); the forward is the same bit
# for bit, and kernel 11's backward sums its partials in another order than
# the chain, so in bf16 an element at a rounding boundary of dy takes the
# other side (a Linear bias before a BatchNorm has a true gradient of 0, so
# its gradient is that rounding alone, held by the median leaf's norm)
SEGMENTOR_BF16_GRAD_RTOL = 2.0**-4
VARIANT_PATHS = ("msg", "msg_doubled", "msg_fused_sa", "analytic_bn", "remat", "v2_serve",
                 "voxelnet", "segmentor", "segmentor_bf16")
SEGMENTOR_CONFIG = ROOT / "portbench" / "configs" / "pn2_seg_biomass.json"
# launches per step (msg, msg_doubled, analytic_bn), per step of the remat
# model and one of the plain model (remat), per step of the kernels
# (msg_fused_sa), per forward (v2_serve: the engine and the artifact), per step
# of each of the three voxel configurations (voxelnet: kernel 11 at the
# 64-cell BatchNorms of the probe's (2) and voxelnet_deep (3), none at
# voxelnet_wide48's widths), per forward and step (segmentor)
EXPECTED.update({
    # two scales a layer: kernel 2 at both of SA1's radii, kernels 3, 4a and 4b
    # at both of SA2's; kernel 11 at both scales' hidden BatchNorms
    "msg": per_run(dlbt_fps=2, dlbt_ball_group=2, dlbt_ball_query=2, dlbt_gather=2,
                   dlbt_scatter_rows=2, **add_launches(bn_train_launches(8, 6), SA3_BN)),
    "msg_doubled": per_run(dlbt_fps=2, dlbt_ball_group=2, dlbt_ball_query=2, dlbt_gather=2,
                           dlbt_scatter_rows=2, **add_launches(bn_train_launches(8, 6), SA3_BN)),
    # kernel 6 at each scale (kernel 2's planes at SA1, 4c's rows at SA2)
    # (and kernel 11 at SA3 in the plain-version step too, which keeps it)
    "msg_fused_sa": per_run(dlbt_fps=2, dlbt_ball_group=2, dlbt_ball_query=2,
                            dlbt_gather_aux=2, dlbt_scatter_rows=2, dlbt_fused_sa_f1=4,
                            dlbt_fused_sa_f2=4, dlbt_fused_sa_f3=4, dlbt_fused_sa_b1=4,
                            dlbt_fused_sa_b2=4, dlbt_fused_sa_b3=4,
                            **bn_train_launches(2, 2, steps=2)),
    # the folded form turns the split first layer off: SA2 gathers through 4c;
    # its statistics come from the input moments, not from kernel 11
    "analytic_bn": without_bn_train(EXPECTED["train_unsplit"]),
    # the recompute runs F1 and F2 of SA1's and SA2's four BatchNorms again
    "remat_step": {**EXPECTED["train"], **bn_train_launches(6, 5, recomputed=4)},
    "v2_serve": EXPECTED["serve"],
    "voxelnet": per_run(**bn_train_launches(2 + 3, 0)),
    # exact FPS and kernel 3 at SA1 and SA2, SA2 split (4a); the step adds 4b
    # and kernel 11 at the eleven hidden BatchNorms of SA1, SA2 and the FP
    # decoder (10 after a Dense)
    "segmentor": per_run(dlbt_fps=4, dlbt_ball_query=4, dlbt_gather=2, dlbt_scatter_rows=1,
                         **bn_train_launches(11, 10)),
    # the cell's configuration at its 7936 slots: sectored FPS and kernel 2
    # at SA1, as the SSG model's; kernel 11 at the six hidden BatchNorms of
    # SA1, SA2 and FP1 (five after a Dense), whose rows a cloud are whole
    # 64-row chunks; SA3's, FP3's (397 rows a cloud), FP2's (1588) and the
    # head's (dropout 0.5) on the chain
    "segmentor_bf16": per_run(dlbt_fps=4, dlbt_ball_group=2, dlbt_ball_query=2, dlbt_gather=2,
                              dlbt_scatter_rows=1, **bn_train_launches(6, 5)),
})
EXPECTED["remat"] = {e: EXPECTED["remat_step"][e] + EXPECTED["train"][e] for e in ENTRIES}


def msg_radii_kernels(model, batch, card: str) -> dict:
    """Kernel 2 at SA1's second radius and kernel 3 at SA2's second (4 and 16
    under msg), at the inputs one eval forward of the msg model gives them:
    exact against their plain versions, timed beside their bounds."""
    with torch.no_grad():
        calls = record_kernel_inputs(lambda b: model(b), batch)
    (g_args, g_kw) = calls["ball_group"][1]
    (q_args, q_kw) = calls["ball_query_first_k"][1]
    group = time_group(f"msg SA1 r={g_kw['radius']} B={VAR_BATCH} x {N_POINTS}", g_args, g_kw,
                       card)
    group["radius"] = g_kw["radius"]
    print(f"kernel ball_group {group['label']}: " + " ".join(
        f"{k}={round(v, 6) if isinstance(v, float) else v}" for k, v in group.items()
        if k != "label") + f"; index-exact, repeats identical [{card}]", flush=True)
    query = time_query(f"msg SA2 r={q_kw['radius']} B={VAR_BATCH} x {N_POINTS}", q_args, q_kw,
                       card)
    return dict(group=group, query=query)


def msg_paths(device, card: str, launches: dict) -> dict:
    """Phase 18, msg: the msg model and msg + doubled_radius, VAR_STEPS steps
    each (launches per step counted), one step on the kernels against one on
    the plain versions, the eval forward against the plain forward; kernels 2
    and 3 at the second radii; msg + fused_sa, one step against the plain
    step in phase 11's bf16 bounds."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import sa_train_kernel as k6
    from dl_biomass_tpu_torch.train.trainer import Trainer

    batch = synthetic_batch(VAR_BATCH, N_POINTS, seed=VAR_SEED, device=device)
    timings = {}
    for path, fields in (("msg", dict(msg=True)),
                         ("msg_doubled", dict(msg=True, doubled_radius=True))):
        trainer = Trainer(seeded_model(device, **fields), TrainConfig(), device)
        model = trainer.model
        radii = (model.sa1.radii, model.sa2.radii)
        with torch.inference_mode():
            out = model(batch)
            with ExitStack() as stack:
                for p in plain_versions():
                    stack.enter_context(p)
                plain = model(batch)
        rel = rel_diff(out, plain)
        require(bool(torch.isfinite(out).all()) and rel <= BF16_SERVE_RTOL,
                f"{path}: eval forward vs plain rel {rel}")
        if path == "msg":
            timings = msg_radii_kernels(model, batch, card)
        ms, peak = counted_run(path, lambda: train_timing(
            trainer, batch, train_gen(device, 100), f"{path} B={VAR_BATCH} x {N_POINTS}",
            card, EXPECTED[path]), launches, VAR_STEPS)
        compare_plain_step(trainer, batch, seed=7)
        print(f"{path} (radii SA1 {radii[0]}, SA2 {radii[1]}): eval forward vs plain-version "
              f"forward max|diff|/max|y| {rel:.3e} (bound {BF16_SERVE_RTOL}); {ms:.3f} ms/step, "
              f"{VAR_BATCH / ms * 1e3:.1f} clouds/s, peak {peak:.2f} GiB; launches per step "
              f"{ {k: v // VAR_STEPS for k, v in launches[path].items() if v} } [{card}]",
              flush=True)
        del trainer, model
        torch.cuda.empty_cache()

    fused = Trainer(seeded_model(device, fused_sa=True, msg=True), TrainConfig(), device)
    calls = {}
    note = counted_run("msg_fused_sa", lambda: _recorded_step(fused, batch, calls), launches, 1)
    cores = {}
    for calls_of, entries, backward in ((calls["fused_sa_stage"], k6.ENTRIES, False),
                                        (calls["fused_sa_bwd_stage"], k6.BWD_ENTRIES, True)):
        for (stage, dense, planes, _, params, *_), kw in calls_of:
            source = k6.pass_source(stage, backward, 0 if dense is None else dense.shape[-1],
                                    0 if planes is None else planes.shape[-1], params,
                                    kw.get("bf16", False))
            if source == (BWD_SOURCE if backward else FWD_SOURCE):
                cores[entries[stage]] = cores.get(entries[stage], 0) + 1
    launches.setdefault("cuda_core", {})["msg_fused_sa"] = cores
    print(f"msg_fused_sa (SA2 per scale {[l.in_features for l in fused.model.sa2.mlp.linears()]}"
          f" -> {fused.model.sa2.mlp.lin2.out_features}) launches in one step: "
          f"{launches['msg_fused_sa']}; of kernel 6 on the CUDA-core kernel ({FWD_SOURCE}, "
          f"{BWD_SOURCE}): {cores}; step on the kernels vs on the plain versions: {note} "
          f"[{card}]", flush=True)
    del fused, calls
    torch.cuda.empty_cache()
    return timings


def _recorded_step(trainer, batch, calls: dict) -> str:
    """One fused_sa step on the kernels against one on the plain versions
    (``compare_fused_plain_step``), the kernels' calls recorded into ``calls``."""
    out = []
    calls.update(record_kernel_inputs(
        lambda b: out.append(compare_fused_plain_step(trainer, b, 7, bf16=True)), batch))
    return out[0]


def analytic_and_remat(device, card: str, launches: dict) -> None:
    """Phase 18, analytic_bn (head dropout 0.5): VAR_STEPS steps beside the
    standard model's, one step on the kernels against one on the plain
    versions, and its serving engine bit for bit the standard model's on the
    same weights; remat at REMAT_BATCH:
    VAR_STEPS steps beside the plain model's on the same batch (ms/step, peak
    memory), and one step of each from one state: the same loss, gradients and
    running statistics, bit for bit."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.train.trainer import Trainer

    batch = synthetic_batch(VAR_BATCH, N_POINTS, seed=VAR_SEED + 1, device=device)
    trainer = Trainer(seeded_model(device, analytic_bn=True), TrainConfig(), device)
    standard = seeded_model(device)  # the same draws: the same weights, unfolded
    require(trainer.model.head.dropout == 0.5, "analytic_bn: the head's dropout is not 0.5")
    with torch.inference_mode():
        served = compile_inference(trainer.model, device)(batch)
        std_served = compile_inference(standard, device)(batch)
    require(torch.equal(served, std_served),
            "analytic_bn: its engine differs from the standard model's on the same weights")
    ms, peak = counted_run("analytic_bn", lambda: train_timing(
        trainer, batch, train_gen(device, 100), f"analytic_bn B={VAR_BATCH} x {N_POINTS}", card,
        EXPECTED["analytic_bn"]), launches, VAR_STEPS)
    compare_plain_step(trainer, batch, seed=7)
    ms_s, peak_s = train_timing(Trainer(standard, TrainConfig(), device), batch,
                                train_gen(device, 100), f"standard B={VAR_BATCH} x {N_POINTS}",
                                card, EXPECTED["train"])
    print(f"analytic_bn (head dropout 0.5): {ms:.3f} ms/step, {VAR_BATCH / ms * 1e3:.1f} "
          f"clouds/s, peak {peak:.2f} GiB; the standard model's steps on the same batch "
          f"{ms_s:.3f} ms/step, peak {peak_s:.2f} GiB; its engine bit-identical to the standard "
          f"model's on the same weights [{card}]", flush=True)
    del trainer, standard
    torch.cuda.empty_cache()

    batch = synthetic_batch(REMAT_BATCH, N_POINTS, seed=VAR_SEED + 2, device=device)
    remat = Trainer(seeded_model(device, remat=True), TrainConfig(), device)
    plain = Trainer(seeded_model(device), TrainConfig(), device)
    state = copy.deepcopy(plain.model.state_dict())
    steps = {}
    for name, t in (("plain", plain), ("remat", remat)):
        loss = t.step(batch, train_gen(device, 5))
        steps[name] = (loss, {k: p.grad.clone() for k, p in t.model.named_parameters()},
                       copy.deepcopy(t.model.state_dict()))
    (lp, gp, sp), (lr, gr, sr) = steps["plain"], steps["remat"]
    same = (torch.equal(lp, lr) and all(torch.equal(gp[k], gr[k]) for k in gp)
            and all(torch.equal(sp[k], sr[k]) for k in sp))
    require(same, "remat: a step differs from the plain step's (loss, gradients, running "
                  "statistics or weights)")
    for t in (plain, remat):  # back to the common state, fresh Adam moments
        t.model.load_state_dict(state)
        t.optimizer.state.clear()

    def both():
        return [train_timing(t, batch, train_gen(device, 100),
                             f"{name} B={REMAT_BATCH} x {N_POINTS}", card, EXPECTED[path])
                for name, t, path in (("remat", remat, "remat_step"),
                                      ("plain", plain, "train"))]

    (ms_r, peak_r), (ms_p, peak_p) = counted_run("remat", both, launches, VAR_STEPS)
    print(f"remat B={REMAT_BATCH} x {N_POINTS}: one step from one state bit-identical to the "
          f"plain step (loss, gradients, running statistics, weights); {ms_r:.3f} ms/step, "
          f"{REMAT_BATCH / ms_r * 1e3:.1f} clouds/s, peak {peak_r:.2f} GiB; plain model in the "
          f"same run {ms_p:.3f} ms/step, {REMAT_BATCH / ms_p * 1e3:.1f} clouds/s, peak "
          f"{peak_p:.2f} GiB [{card}]", flush=True)
    del remat, plain, steps
    torch.cuda.empty_cache()


def v2_serving(device, card: str, launches: dict) -> None:
    """Phase 18, v2 (one output, SA3 and the head twice as wide):
    ``compile_inference`` and the ``torch.export`` artifact on a request of
    VAR_BATCH x N_POINTS: shape (B, 1), finite, the engine against the plain
    versions and the module, the artifact against the engine; both forwards'
    launches counted."""
    import tempfile

    from dl_biomass_tpu_torch.models.export import export_serving, load_serving
    from dl_biomass_tpu_torch.models.inference import compile_inference
    from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor

    model = seed_weights(PointNet2Regressor(
        num_features=1, fast_group=True, fast_fps=True, compute_dtype=torch.bfloat16,
        num_outputs=1, global_width_mult=2), VAR_SEED).to(device)
    batch = synthetic_batch(VAR_BATCH, N_POINTS, seed=VAR_SEED + 3, device=device)
    serve = compile_inference(model, device)
    with tempfile.TemporaryDirectory() as tmp:
        meta = export_serving(model, batch_size=VAR_BATCH, num_points=N_POINTS, path=tmp,
                              device=device)
        artifact = load_serving(tmp, device)
        out, art = counted_run("v2_serve", lambda: (serve(batch), artifact(
            batch.pos, batch.feat, batch.mask)), launches, 2)
    require(meta["num_outputs"] == 1 and tuple(out.shape) == (VAR_BATCH, 1)
            and bool(torch.isfinite(out).all()), f"v2: output {tuple(out.shape)}, meta {meta}")
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        plain = serve(batch)
    with torch.inference_mode():
        module = model(batch)
    rel_plain, rel_module, rel_art = rel_diff(out, plain), rel_diff(out, module), rel_diff(art,
                                                                                          out)
    require(rel_plain <= BF16_SERVE_RTOL and rel_module <= FOLDED_VS_MODULE_RTOL
            and rel_art <= BF16_SERVE_RTOL,
            f"v2: engine vs plain {rel_plain}, vs module {rel_module}, artifact {rel_art}")
    print(f"v2_serve B={VAR_BATCH} x {N_POINTS}: (B, 1) finite; engine vs plain versions "
          f"{rel_plain:.3e} (bound {BF16_SERVE_RTOL}), vs module {rel_module:.3e} (bound "
          f"{FOLDED_VS_MODULE_RTOL}); artifact (meta num_outputs {meta['num_outputs']}) vs engine "
          f"{rel_art:.3e}, bit-identical {torch.equal(art, out)}; launches over the two "
          f"forwards {launches['v2_serve']}; engine {serve_timing(serve, batch):.3f} ms/batch "
          f"[{card}]", flush=True)


def voxel_paths(device, card: str, launches: dict) -> None:
    """Phase 18, the voxel family: the card's ``voxelize`` against the same
    call on a CPU copy (counts exact), then the seed study's three voxel
    configurations (the probe's, ``voxelnet_deep``, ``voxelnet_wide48``; bf16)
    VAR_STEPS steps each at VAR_BATCH x N_POINTS: finite and falling loss,
    ms/step, clouds/s, peak memory; of the port's kernels only kernel 11
    launches, at the BatchNorms of 64 cells a cloud (launches counted)."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.experiments.seed_study import _mode_config
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.ops.voxelize import voxelize
    from dl_biomass_tpu_torch.train.trainer import Trainer

    batch = synthetic_batch(VAR_BATCH, N_POINTS, seed=VAR_SEED + 4, device=device)
    got = voxelize(batch.pos, batch.feat, batch.mask, grid=32)
    want = voxelize(batch.pos.cpu(), batch.feat.cpu(), batch.mask.cpu(), grid=32)
    require(torch.equal(got[0].cpu(), want[0]), "voxelize: card and CPU counts differ")
    errs = [max_abs_err(g.cpu(), w) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got[1:], want[1:])]
    require(max(errs) <= 1e-5, f"voxelize: card vs CPU sums rel {errs}")
    vox_ms = time_ms(lambda: voxelize(batch.pos, batch.feat, batch.mask, grid=32))
    print(f"voxelize B={VAR_BATCH} x {N_POINTS}, grid 32: counts equal to the CPU's, feature "
          f"and offset sums within {max(errs):.3e} of their largest; {vox_ms:.4f} ms [{card}]",
          flush=True)

    def runs():
        for mode in ("voxelnet", "voxelnet_deep", "voxelnet_wide48"):
            cfg = _mode_config(TrainConfig(), mode)
            torch.manual_seed(VAR_SEED)
            trainer = Trainer(build_model(cfg, num_features=1), cfg, device)
            ms, peak = train_timing(trainer, batch, train_gen(device, 100),
                                    f"{mode} B={VAR_BATCH} x {N_POINTS}", card, {})
            m = trainer.model
            print(f"{mode} (grid {m.grid}, channels {m.channels}, {m.param_count():,} "
                  f"parameters, bf16): {ms:.3f} ms/step, {VAR_BATCH / ms * 1e3:.1f} clouds/s, "
                  f"peak {peak:.2f} GiB [{card}]", flush=True)

    counted_run("voxelnet", runs, launches, VAR_STEPS)


def segmentor_path(device, card: str, launches: dict) -> None:
    """Phase 18, the per-point segmentor (float32) at VAR_BATCH x N_POINTS:
    one eval forward and one step (a masked per-point MSE, Adam) on the
    kernels, launches counted; each against the same on the plain versions
    from one state."""
    from dl_biomass_tpu_torch.models.decoder import PointNet2Segmentor

    batch = synthetic_batch(VAR_BATCH, N_POINTS, seed=VAR_SEED + 5, device=device)
    target = torch.where(batch.mask[..., None], batch.pos[..., 2:3] * 0.1, 0.0)
    torch.manual_seed(VAR_SEED)
    model = seed_weights(PointNet2Segmentor(num_features=1), VAR_SEED).to(device)
    state = copy.deepcopy(model.state_dict())
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def run():
        with torch.inference_mode():
            out = model(batch)
        opt.zero_grad(set_to_none=True)
        pred = model(batch, train=True, generator=train_gen(device, 5))
        loss = ((pred - target) ** 2).sum() / batch.mask.sum()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        opt.step()
        return out, loss.detach(), grads

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, loss, grads = counted_run("segmentor", run, launches, 1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model.load_state_dict(state)
    opt.state.clear()
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        out_p, loss_p, grads_p = run()
    require(tuple(out.shape) == (VAR_BATCH, N_POINTS, 1) and bool(torch.isfinite(out).all())
            and bool((out[~batch.mask] == 0).all()) and bool(torch.isfinite(loss)),
            "segmentor: output shape, finiteness or pad zeros")
    rel_out = rel_diff(out, out_p)
    top = max(float(g.abs().max()) for g in grads_p.values())
    rel_grad = max(max_abs_err(grads[k], grads_p[k]) for k in grads) / top
    rel_loss = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    require(max(rel_out, rel_loss) <= SEGMENTOR_RTOL and rel_grad <= PLAIN_STEP_RTOL,
            f"segmentor vs plain: output {rel_out}, loss {rel_loss}, gradients {rel_grad}")
    print(f"segmentor B={VAR_BATCH} x {N_POINTS} (float32): (B, N, 1) finite, 0 at pads; vs the "
          f"plain versions: output {rel_out:.3e}, loss {rel_loss:.3e} (bound {SEGMENTOR_RTOL}), "
          f"gradients {rel_grad:.3e} of their largest (bound {PLAIN_STEP_RTOL:.3e}); launches "
          f"in one forward and one step {launches['segmentor']}; the two in {wall:.3f} s, peak "
          f"{peak:.2f} GiB [{card}]", flush=True)
    del model, opt
    torch.cuda.empty_cache()


def segmentor_bf16_path(device, card: str, launches: dict) -> None:
    """Phase 18, the segmentor as the benchmark cell builds it
    (``build_model`` on ``SEGMENTOR_CONFIG``) at the cell's LARGE clouds of
    BN_POINTS points in BN_SLOTS slots: one eval forward and one
    ``Trainer.step`` on per-point targets (the per-point MSE, Adam) on the
    kernels, launches counted; each against the same on the plain versions
    from one state and one seed."""
    from dl_biomass_tpu_torch.core.cloud import CloudBatch
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.train.trainer import Trainer

    cfg = json.loads(SEGMENTOR_CONFIG.read_text())
    tc = TrainConfig.from_dict({"hp": cfg["hp"], "model": cfg["model"]})
    batch = synthetic_batch(LARGE, BN_SLOTS, seed=VAR_SEED + 7, device=device,
                            sizes=[BN_POINTS] * LARGE)
    batch = CloudBatch(pos=batch.pos, feat=batch.feat, mask=batch.mask,
                       y=torch.where(batch.mask[..., None], batch.pos[..., 2:3] * 0.1, 0.0))
    trainer = Trainer(seed_weights(build_model(tc, 1), VAR_SEED), tc, device=device)
    model = trainer.model
    require(model.compute_dtype == torch.bfloat16 and model.sa1.fast_group,
            "segmentor_bf16: build_model did not take the cell's configuration")
    state = copy.deepcopy(model.state_dict())

    def run():
        with torch.inference_mode():
            out = model(batch)
        loss = trainer.step(batch, train_gen(device, 7))
        return out, loss, {k: p.grad.clone() for k, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, loss, grads = counted_run("segmentor_bf16", run, launches, 1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model.load_state_dict(state)
    trainer.optimizer.state.clear()
    with ExitStack() as stack:
        for p in plain_versions():
            stack.enter_context(p)
        out_p, loss_p, grads_p = run()
    require(tuple(out.shape) == (LARGE, BN_SLOTS, 1) and bool(torch.isfinite(out).all())
            and bool((out[~batch.mask] == 0).all()) and bool(torch.isfinite(loss)),
            "segmentor_bf16: output shape, finiteness or pad zeros")
    rel_out = rel_diff(out, out_p)
    rel_loss = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    norms = {k: float(g.double().norm()) for k, g in grads_p.items()}
    med = statistics.median(norms.values())
    gaps = {k: float((grads[k].double() - grads_p[k].double()).norm()) / max(norms[k], med)
            for k in grads}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    require(rel_out <= BF16_SERVE_RTOL and rel_loss <= PLAIN_STEP_RTOL
            and gaps[worst[0]] <= SEGMENTOR_BF16_GRAD_RTOL,
            f"segmentor_bf16 vs plain: output {rel_out}, loss {rel_loss}, gradient gaps "
            f"{[(k, gaps[k]) for k in worst]}")
    print(f"segmentor_bf16 B={LARGE} x {BN_POINTS} in {BN_SLOTS} slots (the cell's "
          f"configuration): (B, N, 1) finite, 0 at pads; vs the plain versions: eval output "
          f"{rel_out:.3e} (bound {BF16_SERVE_RTOL}), step loss {rel_loss:.3e} (bound "
          f"{PLAIN_STEP_RTOL:.3e}), each leaf's gradient gap over the larger of its norm and "
          f"the median leaf's, worst {', '.join(f'{k} {gaps[k]:.3e}' for k in worst)} (bound "
          f"{SEGMENTOR_BF16_GRAD_RTOL:.3e}), median {statistics.median(gaps.values()):.3e}; "
          f"launches in one forward and one step {launches['segmentor_bf16']}; the two in "
          f"{wall:.3f} s, peak {peak:.2f} GiB [{card}]", flush=True)
    del model, trainer
    torch.cuda.empty_cache()


def voxel_selection(device, card: str) -> None:
    """Phase 18, ``voxel_select_first`` on SELECT_PLOTS raw plots of SELECT_RAW
    points: index-equal to the host path (``io/resample.voxel_downsample``,
    first SELECT_KEEP), timed."""
    from dl_biomass_tpu_torch.io.resample import voxel_downsample
    from dl_biomass_tpu_torch.ops.voxelize import voxel_select_first

    batch = synthetic_batch(SELECT_PLOTS, SELECT_RAW, seed=VAR_SEED + 6, device=device)
    idx, keep = voxel_select_first(batch.pos, batch.mask, voxel_size=SELECT_VOXEL,
                                   n_keep=SELECT_KEEP)
    pos, mask = batch.pos.cpu().numpy(), batch.mask.cpu().numpy()
    idx, keep = idx.cpu().numpy(), keep.cpu().numpy()
    kept = []
    for b in range(SELECT_PLOTS):
        valid = np.flatnonzero(mask[b])
        host = valid[voxel_downsample(pos[b][valid], SELECT_VOXEL)][:SELECT_KEEP]
        require(np.array_equal(idx[b][keep[b]], host), f"voxel_select_first: plot {b} differs "
                                                       "from the host path")
        kept.append(len(host))
    ms = time_ms(lambda: voxel_select_first(batch.pos, batch.mask, voxel_size=SELECT_VOXEL,
                                            n_keep=SELECT_KEEP))
    print(f"voxel_select_first {SELECT_PLOTS} x {SELECT_RAW} points, {SELECT_VOXEL} m voxels, "
          f"n_keep {SELECT_KEEP}: index-equal to the host path on every plot (kept "
          f"{min(kept)}-{max(kept)}); {ms:.4f} ms [{card}]", flush=True)


def variants(device, card: str, launches: dict) -> dict:
    """Phase 18; returns kernels 2's and 3's timings at msg's second radii."""
    t0 = time.perf_counter()
    timings = msg_paths(device, card, launches)
    analytic_and_remat(device, card, launches)
    v2_serving(device, card, launches)
    voxel_paths(device, card, launches)
    segmentor_path(device, card, launches)
    segmentor_bf16_path(device, card, launches)
    voxel_selection(device, card)
    print(f"variants: phase 18 in {time.perf_counter() - t0:.1f} s", flush=True)
    return timings


# ---- phase 19: C.4, the point axis over mp, and the tools without kernels ----------

# C.4: the f32 (ELU) 2-rank step at B=SMALL x N_POINTS (phase 17's batch and
# draws) against one process's, each gradient over its own largest within
# MESH_GRAD_ATOL (tests/test_parallel.py's bound), the biases whose true
# gradient is 0 by size as tests/test_torch_mesh.py holds them; printed with
# (a) the masked max's argmax slots that differ, by SA layer, (b) each
# train-mode BatchNorm's largest E[x^2]/var, (c) the one-process step with
# its statistics summed from two half-batch partials, in the mesh's order,
# held against the mesh's; each under whole-batch float32 sums (the statistics
# the repair replaced) and under the port's own
C4_ZERO = 1e-5
C4_SA = ("sa1", "sa2", "sa3")
C4_BN = ("sa1.bn0", "sa1.bn1", "sa2.bn0", "sa2.bn1", "sa3.bn0", "sa3.bn1", "head.bn0",
         "head.bn1")
C4_VARIANTS = ("float32", "port")


def float32_sums(xf, mask):
    """(2C,) float32 [sum x, sum x^2] over the valid slots, each one sum
    over the whole local batch: the sums the repair of C.4 replaced."""
    axes = tuple(range(xf.dim() - 1))
    xm = xf if mask is None else xf * mask.unsqueeze(-1).float()
    return torch.cat([xm.sum(dim=axes), (xm * xf).sum(dim=axes)])


def port_sums(xf, mask):
    """(2C,) float64 sums of the port's statistics (``layers.chunk_sums``)."""
    from dl_biomass_tpu_torch.models.layers import chunk_sums

    xm = xf if mask is None else xf * mask.unsqueeze(-1).float()
    return torch.cat([chunk_sums(xm), chunk_sums(xm * xf)])


class C4Probe:
    """Patches ``MaskedBatchNorm.batch_stats`` with the statistics of
    ``variant`` (summed from two half-batch partials with ``halves``) and
    ``pooling.first_argmax`` with a recorder: each BatchNorm's (mean, var)
    and each masked max's argmax of one step, in forward order. Every
    BatchNorm keeps the PyTorch chain (``bn_train_kernel.takes`` refuses),
    whose sums are what the variants change, in one process as over the
    mesh."""

    def __init__(self, variant: str, halves: bool = False):
        self.sums = {"float32": float32_sums, "port": port_sums}[variant]
        self.halves, self.stats, self.argmax = halves, [], []

    def batch_stats(self, xf, mask):
        from dl_biomass_tpu_torch.parallel import mesh as dp

        c, b = xf.shape[-1], xf.shape[0]
        parts = [(xf, mask)] if not self.halves else [
            (xf[:b // 2], None if mask is None else mask[:b // 2]),
            (xf[b // 2:], None if mask is None else mask[b // 2:])]
        sums = self.sums(*parts[0])
        for part in parts[1:]:
            sums = sums + self.sums(*part)
        cnt = (mask.sum().float() if mask is not None else
               torch.tensor(float(math.prod(xf.shape[:-1])), device=xf.device))
        sums = dp.sum_stats(sums, grad=True)
        cnt = torch.clamp_min(dp.sum_stats(cnt), 1.0)
        mean = sums[:c] / cnt
        var = torch.clamp_min(sums[c:] / cnt - mean * mean, 0.0)
        mean, var = mean.float(), var.float()
        self.stats.append((mean.detach().cpu(), var.detach().cpu()))
        return mean, var, cnt

    def __enter__(self):
        from dl_biomass_tpu_torch.models import layers
        from dl_biomass_tpu_torch.ops import bn_train_kernel, pooling

        real = pooling.first_argmax

        def first_argmax(filled, out_max, dim):
            am = real(filled, out_max, dim)
            self.argmax.append(am.cpu())
            return am

        self.patches = [mock.patch.object(layers.MaskedBatchNorm, "batch_stats",
                                          staticmethod(self.batch_stats)),
                        mock.patch.object(pooling, "first_argmax", first_argmax),
                        mock.patch.object(bn_train_kernel, "takes", lambda *a, **kw: False)]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def c4_step(device, variant: str, mesh=None, halves: bool = False) -> dict:
    """Phase 17's f32 (ELU) step at SMALL x N_POINTS (one process, or this
    rank's share under ``mesh``) under ``C4Probe(variant, halves)``: loss,
    gradients, running statistics, the statistics and argmaxes it used."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.train.trainer import Trainer

    model = seeded_model(device, compute_dtype="float32", activation="ELU")
    trainer = Trainer(model, TrainConfig(), device, mesh=mesh)
    batch = synthetic_batch(SMALL, N_POINTS, seed=MESH_SEED, device=device)
    with C4Probe(variant, halves) as probe:
        loss = trainer.step(batch, train_gen(device, MESH_SEED))
    return dict(loss=float(loss), grads={k: p.grad.cpu() for k, p in model.named_parameters()},
                stats={k: v.cpu() for k, v in running_stats(model).items()},
                used=probe.stats, argmax=probe.argmax)


def grad_misses(got: dict, want: dict) -> dict:
    """Each gradient of ``got`` against ``want``'s over ``want``'s largest
    entry (tests/test_parallel.py's measure); the biases whose true gradient
    is 0 over the step's largest |g|, as tests/test_torch_mesh.py holds them."""
    top = max(float(g.abs().max()) for g in want["grads"].values())
    own, zero = {}, {}
    for k, g in want["grads"].items():
        d = float((got["grads"][k].double() - g.double()).abs().max())
        if zero_gradient(k) and float(g.abs().max()) <= C4_ZERO * top:
            zero[k] = float(got["grads"][k].abs().max()) / top
        else:
            own[k] = d / float(g.abs().max())
    return dict(own=own, zero=zero, miss=sorted(k for k, v in own.items() if v > MESH_GRAD_ATOL),
                zero_miss=sorted(k for k, v in zero.items() if v > C4_ZERO))


def argmax_flips(ranks: list, one: dict) -> list:
    """Argmax slots of the masked maxes (SA1, SA2, SA3) that differ between
    the ranks' steps and one process's, by layer."""
    flips = []
    for i in range(len(C4_SA)):
        n = 0
        for r, rank in enumerate(ranks):
            mine = rank["argmax"][i]
            b = mine.shape[0]
            n += int((mine != one["argmax"][i][r * b:(r + 1) * b]).sum())
        flips.append(n)
    return flips


def stat_gap(a: dict, b: dict) -> tuple:
    """(largest |mean diff| / |mean|max, largest |var diff| / var max, bits
    equal) of the statistics two steps used."""
    dm = max(float((x[0] - y[0]).abs().max() / y[0].abs().max()) for x, y in zip(a["used"],
                                                                                 b["used"]))
    dv = max(float((x[1] - y[1]).abs().max() / y[1].abs().max()) for x, y in zip(a["used"],
                                                                                 b["used"]))
    same = all(same_bits(x[0], y[0]) and same_bits(x[1], y[1])
               for x, y in zip(a["used"], b["used"]))
    return dm, dv, same


def c4_report(device, card: str, ranks: list, wall: float) -> None:
    """Phase 19, C.4: each rank's step under each statistics variant against
    one process's, whole and with the statistics summed from two half-batch
    partials (c). Prints (a), (b) and (c) and the gradients' misses; the
    port's statistics must hold every gradient within MESH_GRAD_ATOL."""
    for variant in C4_VARIANTS:
        one, halves = c4_step(device, variant), c4_step(device, variant, halves=True)
        mesh = [r["c4"][variant] for r in ranks]
        got = mesh[0]
        vs_one, vs_halves = grad_misses(got, one), grad_misses(got, halves)
        ratio = [float(((m * m + v) / v.clamp_min(1e-30)).max()) for m, v in one["used"]]
        sm, sv, same = stat_gap(got, one)
        hm, hv, hsame = stat_gap(got, halves)
        rel = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        print(f"C.4 {variant} statistics, f32 (ELU) step B={SMALL} x {N_POINTS}, "
              f"{MESH_RANKS} ranks ({wall:.1f} s spawn to end) vs one process: loss rel "
              f"{rel:.3e}; gradients over their own largest: {len(vs_one['miss'])} of "
              f"{len(vs_one['own'])} past {MESH_GRAD_ATOL} {vs_one['miss']}, the worst "
              f"{max(vs_one['own'].values()):.3e} "
              f"({max(vs_one['own'], key=vs_one['own'].get)}); zero-gradient biases over the "
              f"step's largest {max(vs_one['zero'].values(), default=0.0):.3e} (bound "
              f"{C4_ZERO}); statistics mean {sm:.3e} var {sv:.3e} bit-identical {same}; (a) "
              f"argmax slots that differ {dict(zip(C4_SA, argmax_flips(mesh, one)))}; (b) "
              f"largest E[x^2]/var {dict(zip(C4_BN, (round(x, 1) for x in ratio)))}; (c) the "
              f"one-process step summed from two half-batch partials vs the mesh's: "
              f"{len(vs_halves['miss'])} past, the worst {max(vs_halves['own'].values()):.3e}, "
              f"statistics mean {hm:.3e} var {hv:.3e} bit-identical {hsame}, argmax slots that "
              f"differ {dict(zip(C4_SA, argmax_flips(mesh, halves)))} [{card}]", flush=True)
        if variant == "port":
            require(rel <= MESH_LOSS_RTOL and not vs_one["miss"] and not vs_one["zero_miss"],
                    f"C.4: the 2-rank f32 step: loss rel {rel}, gradients past "
                    f"{MESH_GRAD_ATOL} {vs_one['miss']}, zero gradients {vs_one['zero_miss']}")


# the point axis over mp: MP_RANKS ranks (mp = MP_RANKS, dp = 1) on the card,
# the production model at full width in bf16, then in float32 with ELU, on
# MP_BATCH clouds of MP_POINTS (__graft_entry__.py's eval cloud): the eval
# forward and MP_STEPS steps against one process's. The eval forward within
# tests/test_parallel.py's 2e-4 (TestModelParallel) in both dtypes (eval
# mode sums nothing across centroids: on an H100 both came out identical),
# the float32 first step's loss and each gradient in MESH_LOSS_RTOL and
# MESH_GRAD_ATOL, every loss within MESH_BF16_RTOL, as phase 17's
MP_RANKS, MP_BATCH, MP_POINTS, MP_SEED, MP_STEPS = 2, 4, 16384, 80, 2
MP_EVAL_RTOL = 2e-4
MP_DTYPES = (("bfloat16", "ReLU"), ("float32", "ELU"))
MP_PATHS = ("mp_eval", "mp_train")
EXPECTED.update({"mp_eval": EXPECTED["serve"], "mp_train": without_bn_train(EXPECTED["train"])})


def mp_run(device, mesh, dtype: str, act: str, counted=None) -> dict:
    """The mp check's model (``dtype``, ``act``) under ``mesh`` (None: one
    process): the eval forward, then MP_STEPS steps; their outputs, the first
    step's gradients, each step's ms (host clock to a synchronize), the
    steps' peak memory and kernel 2's centroids a call. ``counted(path,
    fn)`` counts the launches."""
    from dl_biomass_tpu_torch.core.config import TrainConfig
    from dl_biomass_tpu_torch.ops import ball_group_kernel
    from dl_biomass_tpu_torch.train.trainer import Trainer

    counted = counted or (lambda path, fn: fn())
    model = seeded_model(device, compute_dtype=dtype, activation=act, seed=MP_SEED)
    trainer = Trainer(model, TrainConfig(), device, mesh=mesh)
    batch = synthetic_batch(MP_BATCH, MP_POINTS, seed=MP_SEED, device=device)
    real, centroids = ball_group_kernel.ball_group, []

    def group(centers, *args, **kwargs):
        centroids.append(int(centers.shape[1]))
        return real(centers, *args, **kwargs)

    out = dict(losses=[], ms=[])
    with mock.patch.object(ball_group_kernel, "ball_group", group):
        out["y"] = counted("mp_eval", lambda: trainer.predict([batch]))
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(MP_STEPS):
            t0 = time.perf_counter()
            loss = counted("mp_train", lambda: trainer.step(batch, train_gen(device, MP_SEED + i)))
            out["losses"].append(float(loss))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                out["grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        out["peak"] = torch.cuda.max_memory_allocated(device) / 2**30
        out["peak_over_base"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    out["centroids"] = centroids
    return out


def phase19_rank(rank: int, world: int, device, tmp: str) -> None:
    """Phase 19's body in each rank: C.4's steps on a dp mesh, then the
    point-parallel paths on an mp mesh, launches counted; saved for the parent."""
    from dl_biomass_tpu_torch.ops import _build
    from dl_biomass_tpu_torch.parallel import mesh as dp

    mesh = dp.make_mesh(world, 1, device)
    out = dict(c4={v: c4_step(device, v, mesh) for v in C4_VARIANTS}, launches={},
               device=str(device), backend=torch.distributed.get_backend())
    del mesh
    torch.cuda.empty_cache()

    def counted(path, fn):
        torch.cuda.synchronize(device)
        _build.launch_counts.clear()
        res = fn()
        torch.cuda.synchronize(device)
        seen = out["launches"].setdefault(path, dict.fromkeys(ENTRIES, 0))
        for e in ENTRIES:
            seen[e] += _build.launch_counts[e]
        return res

    mesh = dp.make_mesh(1, world, device)
    out["coordinate"] = tuple(mesh.get_coordinate())
    out["mp"] = {dtype: mp_run(device, mesh, dtype, act, counted) for dtype, act in MP_DTYPES}
    torch.save(out, Path(tmp) / f"p19_rank{rank}.pt")


def mp_report(device, card: str, ranks: list, launches: dict) -> None:
    """Phase 19, paths mp_eval and mp_train: each rank's launches (per
    forward and step, held to one process's), kernel 2's share of the
    centroids, the forwards and ms against one process's, and the steps and
    their peak memory against one process's on the BatchNorm chain the mesh
    runs; the steps of one process on kernel 11 against the ranks',
    reported."""
    from dl_biomass_tpu_torch.ops import bn_train_kernel

    runs = {"mp_eval": len(MP_DTYPES), "mp_train": len(MP_DTYPES) * MP_STEPS}
    for path, n in runs.items():
        for r in ranks:
            check_launches(path, r["launches"][path], n)
        launches[path] = {e: sum(r["launches"][path][e] for r in ranks) for e in ENTRIES}
    m1 = math.ceil(0.2 * MP_POINTS)
    share = -(-m1 // MP_RANKS)
    for dtype, act in MP_DTYPES:
        one = mp_run(device, None, dtype, act)
        with mock.patch.object(bn_train_kernel, "takes", lambda *a, **kw: False):
            chain = mp_run(device, None, dtype, act)
        got = [r["mp"][dtype] for r in ranks]
        require(all(g["centroids"] == [share] * (1 + MP_STEPS) for g in got)
                and one["centroids"] == [m1] * (1 + MP_STEPS),
                f"mp {dtype}: kernel 2's centroids a call {[g['centroids'] for g in got]}, one "
                f"process {one['centroids']}; expected {share} of {m1}")
        want = torch.from_numpy(one["y"])
        err = max(rel_diff(torch.from_numpy(g["y"]), want) for g in got)
        f32 = dtype == "float32"
        eval_bound = MP_EVAL_RTOL
        require(all(np.array_equal(g["y"], got[0]["y"]) for g in got) and err <= eval_bound,
                f"mp {dtype}: eval forward rel {err} > {eval_bound}, or the ranks disagree")
        rels = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], chain["losses"])]
        require(all(g["losses"] == got[0]["losses"] for g in got)
                and all(r <= MESH_BF16_RTOL for r in rels)
                and (not f32 or rels[0] <= MESH_LOSS_RTOL),
                f"mp {dtype}: losses {got[0]['losses']} vs one process {chain['losses']} (rel "
                f"{rels}), or the ranks disagree")
        g = grad_misses(got[0], chain)
        k11 = grad_misses(got[0], one)
        k11_rels = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], one["losses"])]
        require(not f32 or (not g["miss"] and not g["zero_miss"]),
                f"mp {dtype}: gradients past {MESH_GRAD_ATOL} of their largest {g['miss']}, "
                f"zero gradients {g['zero_miss']}")
        require(all(x["peak_over_base"] < chain["peak_over_base"] for x in got),
                f"mp {dtype}: rank step peaks {[x['peak_over_base'] for x in got]} GiB not below "
                f"one process's on the chain {chain['peak_over_base']}")
        print(f"mp_train / mp_eval {dtype} ({act}) B={MP_BATCH} x {MP_POINTS}, mp={MP_RANKS} "
              f"ranks on {ranks[0]['device']} ({ranks[0]['backend']}), coordinates "
              f"{[r['coordinate'] for r in ranks]}: kernel 2 took {share} of the {m1} SA1 "
              f"centroids a rank (one process {m1}); eval forward vs one process max|diff|/max|y| "
              f"{err:.3e} (bound {eval_bound}); losses {got[0]['losses']} vs "
              f"{chain['losses']} on the chain (rel {[f'{r:.3e}' for r in rels]}); "
              + (f"first step's gradients over their own largest: "
                 f"{len(g['own']) - len(g['miss'])} of {len(g['own'])} within {MESH_GRAD_ATOL}, "
                 f"the worst {max(g['own'].values()):.3e}, zero-gradient biases "
                 f"{max(g['zero'].values(), default=0.0):.3e} of the step's largest; " if f32
                 else "") + f"one process on kernel 11 (reported, not held): losses rel "
              f"{[f'{r:.3e}' for r in k11_rels]}, gradients "
              f"{len(k11['own']) - len(k11['miss'])} of {len(k11['own'])} within "
              f"{MESH_GRAD_ATOL}, the worst {max(k11['own'].values()):.3e}; ms/step (host "
              f"clock, step {MP_STEPS}) {got[0]['ms'][-1]:.3f} / {got[1]['ms'][-1]:.3f} vs one "
              f"process {one['ms'][-1]:.3f}; step peak GiB a rank "
              f"{[round(x['peak'], 3) for x in got]} ({[round(x['peak_over_base'], 3) for x in got]}"
              f" above the memory held before the steps) vs one process on the chain "
              f"{chain['peak']:.3f} ({chain['peak_over_base']:.3f}), on kernel 11 "
              f"{one['peak']:.3f} ({one['peak_over_base']:.3f}); launches a rank over "
              f"{runs['mp_eval']} forwards "
              f"and {runs['mp_train']} steps "
              f"{ {p: {e: n for e, n in ranks[0]['launches'][p].items() if n} for p in MP_PATHS} }"
              f" [{card}]", flush=True)


# the tools without kernels of their own, each main() at its real shapes with
# its repeats cut (timed steps, windows, epochs), launches counted by tool
REST_TOOLS = ("profile_step", "roofline", "batch_sweep", "serving_matrix", "dispatch_probe",
              "bq_tile_sweep", "fps_divergence_probe", "torch_cpu_anchor")


def rest_calls(device) -> dict:
    """{tool: its main() calls}, each cut only in repeats."""
    from dl_biomass_tpu_torch.tools import (batch_sweep, bq_tile_sweep, dispatch_probe,
                                            fps_divergence_probe, profile_step, roofline,
                                            serving_matrix, torch_cpu_anchor)

    return {
        "profile_step": lambda: [profile_step.main(w, device=device, steps=2)
                                 for w in profile_step.MODES],
        "roofline": lambda: roofline.main(device=device, repeats=2),
        "batch_sweep": lambda: batch_sweep.main(device=device, steps=2, repeats=1),
        "serving_matrix": lambda: (serving_matrix.main(device=device, steps=4, repeats=1),
                                   serving_matrix.main(cold=True, device=device)),
        "dispatch_probe": lambda: dispatch_probe.main(device=device, steps=3, repeats=1),
        "bq_tile_sweep": lambda: bq_tile_sweep.main(device=device),
        "fps_divergence_probe": lambda: [fps_divergence_probe.main(old=old, device=device,
                                                                   max_epochs=1)
                                         for old in (False, True)],
        "torch_cpu_anchor": lambda: torch_cpu_anchor.main(steps=1, device=device),
    }


def rest_tools(device, card: str, launches: dict) -> None:
    """Phase 19: each tool's main() on the card, its launches counted; each
    must launch kernel 1 (all but bq_tile_sweep, whose sweep is kernel 3's)
    and the cold start must answer every plot."""
    from dl_biomass_tpu_torch.ops import _build

    for tool, call in rest_calls(device).items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        out = call()
        torch.cuda.synchronize()
        launches[tool] = {e: _build.launch_counts[e] for e in ENTRIES}
        must = "dlbt_ball_query" if tool == "bq_tile_sweep" else "dlbt_fps"
        require(launches[tool][must] > 0, f"{tool}: {must} never launched")
        if tool == "serving_matrix":
            require(out[1]["ok"] and out[1]["rows"] == 36, f"serving_matrix --cold: {out[1]}")
        print(f"{tool}: main() in {time.perf_counter() - t0:.1f} s, launches "
              f"{ {e: n for e, n in launches[tool].items() if n} } [{card}]", flush=True)
        torch.cuda.empty_cache()


def mp_tools(device, card: str, launches: dict) -> None:
    """Phase 19: C.4 and the point axis over mp (MP_RANKS ranks spawned on
    the card, a card each with nccl where there are enough, else sharing
    cuda:0 through gloo), then the tools without kernels of their own."""
    import tempfile

    from dl_biomass_tpu_torch.parallel import mesh as dp

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        dp.spawn(phase19_rank, MP_RANKS, str(Path(tmp) / "store"), args=(tmp,), device=device)
        wall = time.perf_counter() - t1
        ranks = [torch.load(Path(tmp) / f"p19_rank{r}.pt", map_location="cpu",
                            weights_only=False) for r in range(MP_RANKS)]
    c4_report(device, card, ranks, wall)
    mp_report(device, card, ranks, launches)
    rest_tools(device, card, launches)
    print(f"mp_tools: phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)


def tail_inputs(shape, device, seed: int):
    """a2, mask (with two all-invalid rows), w3, b3 and a cotangent g of one shape."""
    b, m, k, c2, c3 = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    a2 = torch.randn((b, m, k, c2), device=device, generator=gen).to(torch.bfloat16)
    mask = torch.rand((b, m, k), device=device, generator=gen) > 0.1
    mask[0, :2] = False
    w3 = 0.1 * torch.randn((c2, c3), device=device, generator=gen)
    b3 = 0.1 * torch.randn((c3,), device=device, generator=gen)
    g = torch.randn((b, m, c3), device=device, generator=gen)
    return a2, mask, w3, b3, g


def bf16_lead(a2, mask, w3, b3) -> torch.Tensor:
    """Where the masked max of z = bf16(a2 W3 + b3) leads the second value by
    more than one bf16 step of the max (B, M, C3): where the argmax is not a
    near tie."""
    from dl_biomass_tpu_torch.ops.sa_eval_kernel import _dot_f32

    b, m, k, c2 = a2.shape
    z = (_dot_f32(a2.reshape(-1, c2), w3.to(torch.bfloat16)) + b3).to(torch.bfloat16)
    z = torch.where(mask[..., None], z.view(b, m, k, -1), float("-inf"))
    top2 = z.topk(2, dim=2).values.float()
    del z
    _, e = torch.frexp(top2[:, :, 0])
    ulp = torch.ldexp(torch.ones_like(top2[:, :, 0]), e - 8)
    return (top2[:, :, 0] - top2[:, :, 1]) > ulp


def tail_fwd_bound(a2, mask, w3):
    """Kernel 7's forward bound: (ms, "bytes" or "operations", bytes, flop).
    It reads a2, the mask, W3 and b3 once and writes out (B, M, C3) bf16; its
    products are dense, 2 B M 64 C2 C3 flop at bf16's peak."""
    b, m, k, c2 = a2.shape
    c3 = w3.shape[1]
    flops = 2 * b * m * k * c2 * c3
    nbytes = a2.numel() * 2 + mask.numel() + w3.numel() * 4 + c3 * 4 + b * m * c3 * 2
    bms, by = bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)
    return bms, by, nbytes, flops


def check_tail_fwd(name: str, args, ctx: dict) -> None:
    """Kernel 7's forward at one shape: vs plain (output, argmax where the
    winner leads, zero rows), junk at invalid slots, NaN at valid slots, two
    launches, its plan and launch, timings (events and CUDA graph)."""
    from dl_biomass_tpu_torch.ops import tail_kernel as k7
    from dl_biomass_tpu_torch.tools.tail_bench import unfused

    a2, mask, w3, b3, _ = args
    out, am = k7.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    again = k7.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    alone = k7.fused_tail_fwd(a2, mask, w3, b3)[0]
    want, w_am = k7.fused_tail_fwd_plain(a2, mask, w3, b3, with_argmax=True)
    torch.cuda.synchronize()
    require(same_bits(out, again[0]) and torch.equal(am, again[1]) and same_bits(out, alone),
            f"kernel 7 {name}: two launches, or the launches with and without the argmax, "
            f"differ in bits")
    rel = rel_diff(out, want)
    require(rel <= BF16_SERVE_RTOL,
            f"kernel 7 {name}: output vs plain rel {rel} > {BF16_SERVE_RTOL}")
    empty = ~mask.any(-1)
    require(bool((out[empty] == 0).all()) and torch.equal(out[empty], want[empty])
            and bool((am[empty] == 64).all()) and bool((w_am[empty] == 64).all()),
            f"kernel 7 {name}: rows with no valid slot differ")
    lead = bf16_lead(a2, mask, w3, b3)
    require(torch.equal(am[lead], w_am[lead]), f"kernel 7 {name}: argmax differs where the "
                                               f"winner leads by more than one bf16 step")
    for junk in (float("nan"), float("inf"), 1e4):
        dirty = torch.where(mask[..., None], a2, torch.tensor(junk, dtype=a2.dtype,
                                                               device=a2.device))
        got = k7.fused_tail_fwd(dirty, mask, w3, b3, with_argmax=True)
        require(same_bits(got[0], out) and torch.equal(got[1], am),
                f"kernel 7 {name}: junk {junk} at invalid slots changed the output")
        del dirty, got
    nan_rows = check_tail_nan(name, a2, mask, w3, b3, out, am)
    b, m, k, c2 = a2.shape
    c3 = w3.shape[1]
    plan, launches = k7.plan(c2, c3), {}
    for argmax in (False, True):
        launch = k7.occupancy(c2, c3, argmax)
        require(launch["smem_bytes"] == plan.smem_bytes and launch["threads"] == 32 * plan.warps,
                f"kernel 7 {name}: launch {launch} is not the plan's {plan}")
        launches["with the argmax" if argmax else "max"] = launch
    t = time_ms(lambda: k7.fused_tail_fwd(a2, mask, w3, b3), reps=TOOL_REPS)
    t_am = time_ms(lambda: k7.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True), reps=TOOL_REPS)
    tg = graph_ms(lambda: k7.fused_tail_fwd(a2, mask, w3, b3))
    tg_am = graph_ms(lambda: k7.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True))
    tp = time_ms(lambda: k7.fused_tail_fwd_plain(a2, mask, w3, b3), reps=3, warmup=1)
    with torch.no_grad():
        tu = time_ms(lambda: unfused(a2, mask, w3, b3), reps=3, warmup=1)
    bms, by, nbytes, flops = tail_fwd_bound(a2, mask, w3)
    print(f"kernel fused_tail_fwd {name} (B={b} M={m} C2={c2} C3={c3}): {t:.4f} ms (median of "
          f"{TOOL_REPS}; {t_am:.4f} ms with the argmax), CUDA graph {tg:.4f} ms ({tg_am:.4f} "
          f"with the argmax), plain {tp:.4f} ms, unfused pair "
          f"(dot_f32 + masked_max) {tu:.4f} ms, bound {bms:.6f} ms ({by}: {nbytes} bytes, "
          f"{flops} flop at {PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s); vs plain max|diff|/max|y| "
          f"{rel:.3e} (bound {BF16_SERVE_RTOL}); argmax equal where the winner leads "
          f"({int(lead.sum())} of {lead.numel()}); {int(empty.sum())} empty rows 0 with argmax "
          f"64; NaN, Inf and 1e4 junk at invalid slots: same bits; NaN at valid slots of "
          f"{nan_rows} rows: NaN with argmax 64 as the plain version, the rest the same bits; "
          f"two launches bit-identical; plan {tuple(plan)}, launches {launches}", flush=True)
    ctx.setdefault("fused_tail_fwd", []).append(dict(
        err=max_abs_err(out, want), ms=t, plain_ms=tp, bound_ms=bms, bound_by=by, yard=tu,
        graph_ms=tg))
    ctx.setdefault("am", {})[name] = am


def check_tail_nan(name: str, a2, mask, w3, b3, out, am) -> int:
    """Kernel 7's forward with NaN at valid slots (one feature of one valid
    slot in every 97th row, every valid slot of every 101st) against its plain
    version: NaN and argmax 64 on exactly those rows, as the JAX kernel has
    it, and every other row the same bits as without the NaN. Returns the
    number of NaN rows."""
    from dl_biomass_tpu_torch.ops import tail_kernel as k7

    b, m = mask.shape[:2]
    rows = torch.zeros((b, m), dtype=torch.bool, device=a2.device)
    rows.view(-1)[::97] = True
    rows.view(-1)[::101] = True
    rows &= mask.any(-1)
    one = rows.clone()
    one.view(-1)[::101] = False
    first = mask.float().argmax(-1)  # a valid slot of each row that has one
    dirty = a2.clone()
    bi, mi = one.nonzero(as_tuple=True)
    dirty[bi, mi, first[bi, mi], 0] = float("nan")
    every = rows & ~one
    dirty[..., 1] = torch.where(every[..., None], torch.tensor(float("nan"), dtype=a2.dtype,
                                                               device=a2.device), dirty[..., 1])
    got, got_am = k7.fused_tail_fwd(dirty, mask, w3, b3, with_argmax=True)
    want, w_am = k7.fused_tail_fwd_plain(dirty, mask, w3, b3, with_argmax=True)
    torch.cuda.synchronize()
    nan = rows[..., None].expand_as(got)
    require(torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan),
            f"kernel 7 {name}: NaN at valid slots: NaN outputs differ from the NaN rows")
    require(bool((got_am[nan] == 64).all()) and bool((w_am[nan] == 64).all()),
            f"kernel 7 {name}: NaN at valid slots: argmax not 64 on the NaN rows")
    require(same_bits(got[~nan], out[~nan]) and torch.equal(got_am[~nan], am[~nan]),
            f"kernel 7 {name}: NaN at valid slots changed other rows")
    return int(rows.sum())


def check_tail_bwd(name: str, args, ctx: dict) -> None:
    """Kernel 7's backward at one shape: da2, dW3 and db3 vs plain, exact 0 at
    invalid slots, the autograd op, two launches, timings."""
    from dl_biomass_tpu_torch.ops import sum_slices_kernel as ss, tail_kernel as k7
    from dl_biomass_tpu_torch.tools.tail_bench import unfused

    a2, mask, w3, b3, g = args
    am = ctx["am"].pop(name)
    gb = g.to(torch.bfloat16)
    da2, slices = k7.fused_tail_bwd_slices(a2, gb, am, w3)
    dw3 = ss.sum_slices(slices).view(w3.shape)
    again = k7.fused_tail_bwd(a2, gb, am, w3)
    w_da2, w_dw3 = k7.fused_tail_bwd_plain(a2, gb, am, w3)
    w_sum = ss.sum_slices_plain(slices).view(w3.shape)
    torch.cuda.synchronize()
    require(same_bits(da2, again[0]) and same_bits(dw3, again[1]),
            f"kernel 7 backward {name}: two launches differ in bits")
    rels = (rel_diff(da2, w_da2), rel_diff(dw3, w_dw3))
    require(max(rels) <= BF16_SERVE_RTOL,
            f"kernel 7 backward {name}: da2, dW3 vs plain rel {rels} > {BF16_SERVE_RTOL}")
    rel_sum = rel_diff(dw3, w_sum)
    require(rel_sum <= 1e-6, f"kernel 7 slice sum {name}: vs plain rel {rel_sum} > 1e-6")
    require(same_bits(ss.sum_slices(slices).view(w3.shape), dw3),
            f"kernel 7 slice sum {name}: two launches differ in bits")
    b, m, k, c2 = a2.shape
    c3 = w3.shape[1]
    hit = torch.zeros((b, m, k + 1), dtype=torch.bool, device=a2.device)
    hit.scatter_(2, am.long(), True)  # the slots some column routes to (64: none)
    require(bool((da2[~hit[:, :, :k]] == 0).all()) and not bool(hit[:, :, :k][~mask].any()),
            f"kernel 7 backward {name}: gradient at a slot no column routes to")
    leaves = [t.detach().requires_grad_() for t in (a2, w3, b3)]
    with torch.enable_grad():
        out = k7.fused_tail(leaves[0], mask, leaves[1], leaves[2])
        grads = torch.autograd.grad(out, leaves, gb)
    _, w_am = k7.fused_tail_fwd_plain(a2, mask, w3, b3, with_argmax=True)
    w_db3 = torch.where(w_am < 64, g.to(torch.bfloat16).float(), 0.0).sum(dim=(0, 1))
    rel_auto = (rel_diff(grads[0], w_da2), rel_diff(grads[1], w_dw3), rel_diff(grads[2], w_db3))
    require(max(rel_auto) <= BF16_SERVE_RTOL,
            f"kernel 7 autograd {name}: da2, dW3, db3 vs plain rel {rel_auto} > {BF16_SERVE_RTOL}")
    err = max(max_abs_err(da2, w_da2), max_abs_err(dw3, w_dw3))
    del grads, out, leaves, w_da2, again
    plan, launch = k7.bwd_plan(c2, c3), k7.occupancy_bwd(c2, c3)
    require(launch["smem_bytes"] == plan.smem_bytes and launch["threads"] == plan.threads,
            f"kernel 7 backward {name}: launch {launch} is not the plan's {plan}")
    nonfinite = check_tail_bwd_nonfinite(name, args)
    t = time_ms(lambda: k7.fused_tail_bwd(a2, gb, am, w3), reps=TOOL_REPS)
    t_slices = time_ms(lambda: k7.fused_tail_bwd_slices(a2, gb, am, w3), reps=TOOL_REPS)
    t_sum = time_ms(lambda: ss.sum_slices(slices), reps=TOOL_REPS)
    tp = time_ms(lambda: k7.fused_tail_bwd_plain(a2, gb, am, w3), reps=3, warmup=1)
    tsp = time_ms(lambda: ss.sum_slices_plain(slices), reps=TOOL_REPS)
    tsl = time_ms(lambda: torch.sum(slices, 0, dtype=torch.float64), reps=TOOL_REPS)
    t_sum_g, tsl_g = sum_slices_graph_ms(slices)
    leaves = [t_.detach().requires_grad_() for t_ in (a2, w3, b3)]
    with torch.enable_grad():
        out = unfused(leaves[0], mask, leaves[1], leaves[2])
        tu = time_ms(lambda: torch.autograd.grad(out, leaves, gb, retain_graph=True), reps=3,
                     warmup=1)
    del out, leaves
    routed = int((am < 64).sum())
    flops = 4 * c2 * routed
    nbytes = 2 * a2.numel() * 2 + b * m * c3 * (2 + 4) + 2 * c2 * c3 * 4
    bms, by = bound(nbytes, flops)
    n_sum = slices.numel()
    bms_sum, by_sum = bound(n_sum * 4 + c2 * c3 * 4, n_sum)
    print(f"kernel fused_tail_bwd {name} (B={b} M={m} C2={c2} C3={c3}): {t_slices:.4f} ms "
          f"(median of {TOOL_REPS}; {t:.4f} ms with the slice sum; the sum of "
          f"{slices.shape[0]} slices alone {t_sum:.4f} ms (graph {t_sum_g:.4f}; plan "
          f"{tuple(ss.plan(*slices.shape))}, repeat bit-identical), its plain "
          f"version {tsp:.4f} ms, torch.sum in f64 {tsl:.4f} ms (graph {tsl_g:.4f}), bound "
          f"{bms_sum:.6f} ms), plain "
          f"{tp:.4f} ms, the unfused pair's autograd backward {tu:.4f} ms, bound {bms:.6f} ms "
          f"({by}: {nbytes} bytes, {flops} flop over {routed} routed columns at "
          f"{PEAK_F32_FLOP_PER_S / 1e12:.0f} TFLOP/s); vs plain max|diff| over the largest: "
          f"da2 {rels[0]:.3e}, dW3 {rels[1]:.3e} (bound {BF16_SERVE_RTOL}), slice sum "
          f"{rel_sum:.3e}; autograd op da2, dW3, db3 {', '.join(f'{r:.3e}' for r in rel_auto)};"
          f" slots no column routes to exactly 0; two launches bit-identical; NaN and Inf in "
          f"a2, the cotangent and W3: {nonfinite}; plan {tuple(plan)}, launch {launch}",
          flush=True)
    ctx.setdefault("fused_tail_bwd", []).append(dict(
        err=err, ms=t_slices, plain_ms=tp,
        bound_ms=bms, bound_by=by, yard=tu))
    ctx.setdefault("sum_slices", []).append(dict(
        err=max_abs_err(dw3, w_sum), ms=t_sum, plain_ms=tsp, bound_ms=bms_sum, bound_by=by_sum,
        yard=None, library=tsl, graph_ms=t_sum_g, library_graph_ms=tsl_g))


def check_tail_bwd_nonfinite(name: str, args) -> str:
    """Kernel 7's backward with NaN and Inf in its inputs against its plain
    (dense) version: NaN at an invalid slot of a row with no valid slot (its
    columns route nothing), +Inf at a valid slot (the columns it wins route
    there, the rest elsewhere), NaN and -Inf in the cotangent, then also +Inf
    in one W3 entry. da2 and dW3 must be NaN, +Inf and -Inf exactly where the
    plain version's are, the rest within BF16_SERVE_RTOL of the largest
    finite value, da2 exactly 0 at every slot no column routes to where W3 is
    finite, and two launches the same bits. Returns what it saw."""
    from dl_biomass_tpu_torch.ops import tail_kernel as k7

    a2, mask, w3, b3, g = args
    a2 = a2.clone()
    a2[0, 0, 10, 3] = float("nan")  # mask[0, :2] is all False
    valid = int(mask[1, 7].float().argmax())
    a2[1, 7, valid, 5] = float("inf")
    gb = g.to(torch.bfloat16)
    gb[2, 9, 17], gb[3, 11, 40] = float("nan"), float("-inf")
    seen = []
    for w_bad in (False, True):
        w = w3.clone()
        if w_bad:
            w[7, 33] = float("inf")
        with torch.no_grad():
            _, am = k7.fused_tail_fwd(a2, mask, w, b3, with_argmax=True)
        got, again = k7.fused_tail_bwd(a2, gb, am, w), k7.fused_tail_bwd(a2, gb, am, w)
        want = k7.fused_tail_bwd_plain(a2, gb, am, w)
        torch.cuda.synchronize()
        require(all(same_bits(x, y) for x, y in zip(got, again)),
                f"kernel 7 backward {name}, non-finite inputs: two launches differ in bits")
        counts = []
        for label, x, y in zip(("da2", "dW3"), got, want):
            x, y = x.float(), y.float()
            require(all(torch.equal(f(x), f(y)) for f in (torch.isnan, torch.isposinf,
                                                           torch.isneginf)),
                    f"kernel 7 backward {name}, non-finite inputs (W3 "
                    f"{'with' if w_bad else 'without'} Inf): {label}'s NaN or Inf differ")
            ok = y.isfinite()
            rel = rel_diff(x[ok], y[ok])
            require(rel <= BF16_SERVE_RTOL, f"kernel 7 backward {name}, non-finite inputs: "
                                            f"{label} vs plain rel {rel} > {BF16_SERVE_RTOL}")
            counts.append(f"{label} {int(y.isnan().sum())} NaN, {int(y.isinf().sum())} Inf, "
                          f"rest rel {rel:.3e}")
        if not w_bad:
            b, m, k, _ = a2.shape
            hit = torch.zeros((b, m, k + 1), dtype=torch.bool, device=a2.device)
            hit.scatter_(2, am.long(), True)
            require(bool((got[0][~hit[:, :, :k]] == 0).all()),
                    f"kernel 7 backward {name}, non-finite inputs: gradient at a slot no "
                    f"column routes to")
        seen.append(f"W3 {'with' if w_bad else 'without'} Inf: " + "; ".join(counts))
        del got, again, want, am
    return " | ".join(seen) + " (as the plain version's)"


def check_masked_stats(name: str, shape, device, ctx: dict) -> None:
    """Kernel 8 at one shape: s1 and s2 vs the plain version, two launches,
    timings; its slices' sum vs the plain sum."""
    from dl_biomass_tpu_torch.ops import sum_slices_kernel as ss
    from dl_biomass_tpu_torch.tools import bn_stats_bench as bn

    b, m, k, c = shape
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.randn((b, m, k, c), device=device, generator=gen).to(torch.bfloat16)
    m3 = torch.rand((b, m, k), device=device, generator=gen) > 0.1
    got, again = bn.stats_kernel(x, m3), bn.stats_kernel(x, m3)
    want = bn.stats_current(x, m3)
    slices = bn.stats_slices(x, m3)
    s_sum, w_sum = ss.sum_slices(slices), ss.sum_slices_plain(slices)
    torch.cuda.synchronize()
    require(all(same_bits(p, q) for p, q in zip(got, again)),
            f"kernel 8 {name}: two launches differ in bits")
    rels = [rel_diff(p, q) for p, q in zip(got, want)]
    require(max(rels) <= STATS_RTOL, f"kernel 8 {name}: s1, s2 vs plain rel {rels} > {STATS_RTOL}")
    rel_sum = rel_diff(s_sum, w_sum)
    require(rel_sum <= 1e-6, f"slice sum of kernel 8 {name}: vs plain rel {rel_sum} > 1e-6")
    require(same_bits(ss.sum_slices(slices), s_sum),
            f"slice sum of kernel 8 {name}: two launches differ in bits")
    t = time_ms(lambda: bn.stats_kernel(x, m3), reps=TOOL_REPS)
    tp = time_ms(lambda: bn.stats_current(x, m3), reps=TOOL_REPS)
    t_slices = time_ms(lambda: bn.stats_slices(x, m3), reps=TOOL_REPS)
    t_sum = time_ms(lambda: ss.sum_slices(slices), reps=TOOL_REPS)
    tsp = time_ms(lambda: ss.sum_slices_plain(slices), reps=TOOL_REPS)
    tsl = time_ms(lambda: torch.sum(slices, 0, dtype=torch.float64), reps=TOOL_REPS)
    t_sum_g, tsl_g = sum_slices_graph_ms(slices)
    bms_sum, by_sum = bound(slices.numel() * 4 + 2 * c * 4, slices.numel())
    nbytes = x.numel() * 2 + m3.numel() + 2 * c * 4
    bms, by = bound(nbytes, 4 * x.numel())
    print(f"kernel masked_stats {name} (B={b} M={m} K={k} C={c}): {t_slices:.4f} ms (median "
          f"of {TOOL_REPS}, {x.numel() * 2 / t_slices / 1e6:.1f} GB/s of x; {t:.4f} ms with the "
          f"slice sum; the sum of {slices.shape[0]} slices alone {t_sum:.4f} ms (graph "
          f"{t_sum_g:.4f}; plan {tuple(ss.plan(*slices.shape))}, repeat bit-identical), its "
          f"plain version {tsp:.4f} ms, torch.sum in f64 {tsl:.4f} ms (graph "
          f"{tsl_g:.4f}), bound {bms_sum:.6f} ms), plain "
          f"(stats_current, the yardstick) {tp:.4f} ms, bound {bms:.6f} ms ({by}: {nbytes} "
          f"bytes); vs plain max|diff| over the largest s1 {rels[0]:.3e}, s2 {rels[1]:.3e} (bound {STATS_RTOL}), slice sum "
          f"{rel_sum:.3e}; two launches bit-identical", flush=True)
    ctx.setdefault("masked_stats", []).append(dict(
        err=max(max_abs_err(p, q) for p, q in zip(got, want)), ms=t_slices, plain_ms=tp,
        bound_ms=bms, bound_by=by, yard=None))
    ctx.setdefault("sum_slices", []).append(dict(
        err=max_abs_err(s_sum, w_sum), ms=t_sum, plain_ms=tsp, bound_ms=bms_sum, bound_by=by_sum,
        yard=None, library=tsl, graph_ms=t_sum_g, library_graph_ms=tsl_g))


def check_block_copy(block_kb: int, device, ctx: dict) -> None:
    """Kernel 10 at one block size: bit-identical to x + 1.0, timings."""
    from dl_biomass_tpu_torch.tools import dma_probe as dp

    rows = block_kb * 1024 // (4 * 128)
    gen = torch.Generator(device=device).manual_seed(10)
    x = torch.randn((dp.BLOCKS, rows, 128), device=device, generator=gen)
    got = dp.block_copy(x)
    torch.cuda.synchronize()
    require(same_bits(got, dp.block_copy_plain(x)), f"kernel 10 {block_kb} KB: differs from x + 1")
    t = time_ms(lambda: dp.block_copy(x), reps=TOOL_REPS)
    tp = time_ms(lambda: dp.block_copy_plain(x), reps=TOOL_REPS)
    tl = time_ms(lambda: torch.add(x, 1.0), reps=TOOL_REPS)
    tg = graph_ms(lambda: dp.block_copy(x))
    tlg = graph_ms(lambda: torch.add(x, 1.0))
    nbytes = 2 * x.numel() * 4
    bms, by = bound(nbytes, x.numel())
    print(f"kernel block_copy {dp.BLOCKS} x {block_kb} KB: {t:.4f} ms (median of {TOOL_REPS}, "
          f"{nbytes / t / 1e6:.1f} GB/s; {tg:.4f} ms replayed from a CUDA graph, "
          f"{nbytes / tg / 1e6:.1f} GB/s), plain (x + 1.0) {tp:.4f} ms, library (torch.add) "
          f"{tl:.4f} ms (graph {tlg:.4f} ms, {nbytes / tlg / 1e6:.1f} GB/s), bound {bms:.6f} ms; "
          f"bit-identical", flush=True)
    ctx.setdefault("block_copy", []).append(dict(err=0.0, ms=t, plain_ms=tp, bound_ms=bms,
                                                 bound_by=by, yard=None, library=tl,
                                                 graph_ms=tg, library_graph_ms=tlg))


def bq_cap_case(device):
    """The tool's data, with 10% of the points and 20% of the centroids masked,
    and in every cloud point 0 (centroid 0) moved far from the cloud with
    bucket 5's 16 points around it: centroids 0, 5, 133, 261 and 389 then
    have bucket 5's points among their first 17 hits, of which caps below 16
    drop some."""
    from dl_biomass_tpu_torch.tools import bq_phase_bench as k9

    _, _, pos, mask = k9.tool_data(*BQ_SHAPE, device)
    gen = torch.Generator(device=device).manual_seed(9)
    pos, mask = pos.clone(), torch.rand(mask.shape, device=device, generator=gen) > 0.1
    cmask = torch.rand(mask[:, :BQ_SHAPE[1]].shape, device=device, generator=gen) > 0.2
    b, n = mask.shape
    pos[:, 0] = BQ_FAR
    pos[:, 5::128] = BQ_FAR + 0.1 * torch.randn((b, len(range(5, n, 128)), 3), device=device,
                                                generator=gen)
    mask[:, 0], mask[:, 5::128], cmask[:, 0] = True, True, True
    return pos[:, :BQ_SHAPE[1]].contiguous(), cmask, pos, mask


def bq_bound(args, radius: float, k: int, phase: str):
    """Kernel 9's bound for the variant ``phase`` on ``args``: (ms, what bounds
    it, bytes, distance tests). The bytes: the points (12 bytes and a mask
    byte each) and centroids read once, the (B, M, K) int32 output written
    once. The tests the data needs, over the valid centroids: all N for
    ``dist``, up to the first hit for ``rank`` and ``extract``, up to the K-th
    for the writing variants (none where a cap of 0 writes nothing), read
    from kernel 3's first K."""
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3
    from dl_biomass_tpu_torch.tools import bq_phase_bench as k9

    centers, cmask, pos, _ = args
    (b, m, _), n = centers.shape, pos.shape[1]
    mode, cap = k9.variant(phase)
    if mode == k9.DIST:
        scan = torch.full((b, m), n, device=pos.device)
    else:
        idx, nbr = k3.ball_query_first_k(*args, radius=radius, k=k)
        last = 0 if mode in (k9.RANK, k9.EXTRACT) else k - 1
        scan = torch.where(nbr[..., last], idx[..., last] + 1, n)
    tests = 0 if cap == 0 else int((scan * cmask).sum())
    nbytes = b * n * 13 + b * m * 13 + b * m * k * 4
    return (*bound(nbytes, tests * DIST_TEST_FLOPS), nbytes, tests)


def check_bq_phase(device, card: str, ctx: dict) -> None:
    """Kernel 9 at the tool's shape, every variant: bit-exact against its
    plain version on the tool's data and on the cap case, two launches
    identical, the writing variants against kernel 3 (``dyn`` equal, the
    capped ones wherever they keep a point), ``rank`` and ``extract`` equal to
    kernel 3's first slot; timed on the tool's data beside the bound, the plain
    version and kernel 3 on the same input."""
    from dl_biomass_tpu_torch.ops import ball_query_kernel as k3
    from dl_biomass_tpu_torch.tools import bq_phase_bench as k9

    b, m, n = BQ_SHAPE
    k, radius = BQ_K, k9.RADIUS
    require(k9.radius2(radius) == k3._radius2(radius),
            "kernel 3 squares the radius otherwise than the tool at this radius")
    cases = {"tool": k9.tool_data(b, m, n, device), "cap": bq_cap_case(device)}
    for label, args in cases.items():
        idx, nbr = k3.ball_query_first_k(*args, radius=radius, k=k)
        exact = torch.where(nbr, idx, n)
        first = torch.where(nbr[..., :1], idx[..., :1], k9.INT_BIG)
        dropped = {}
        for phase in k9.PHASES:
            got = k9.bq(*args, radius=radius, k=k, cm=32, phase=phase)
            again = k9.bq(*args, radius=radius, k=k, cm=32, phase=phase)
            want = k9.bq_plain(*args, radius=radius, k=k, phase=phase)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"kernel 9 {phase} ({label}): differs from plain")
            require(torch.equal(got, again), f"kernel 9 {phase} ({label}): two launches differ")
            mode, _ = k9.variant(phase)
            if mode == k9.WRITE:
                kept = got != n
                require(torch.equal(got[kept], exact[kept]),
                        f"kernel 9 {phase} ({label}): a kept point is not kernel 3's")
                dropped[phase] = int((exact != got).sum())
            elif phase != "dist":
                require(torch.equal(got, first.expand_as(got)),
                        f"kernel 9 {phase} ({label}): not kernel 3's first neighbour")
        require(dropped["dyn"] == 0, f"kernel 9 dyn ({label}): not kernel 3's first {k}")
        require(dropped["when0"] == int(nbr.sum()), f"kernel 9 when0 ({label}): wrote a slot")
        if label == "cap":
            require(dropped["when4"] > dropped["full"] > dropped["when12"] > 0,
                    f"kernel 9: the cap case drops {dropped}")
        print(f"kernel bq_phase ({label} data, B={b} M={m} N={n} K={k}): all {len(k9.PHASES)} "
              f"variants bit-exact vs plain, two launches identical, dyn = kernel 3, kept "
              f"points = kernel 3's, rank and extract = kernel 3's first; slots dropped against "
              f"kernel 3 by variant: {dropped}", flush=True)
    args = cases["tool"]
    t3 = time_ms(lambda: k3.ball_query_first_k(*args, radius=radius, k=k), reps=TOOL_REPS)
    d3 = graph_ms(lambda: k3.ball_query_first_k(*args, radius=radius, k=k))
    for phase in k9.PHASES:
        t = time_ms(lambda: k9.bq(*args, radius=radius, k=k, cm=32, phase=phase), reps=TOOL_REPS)
        tp = time_ms(lambda: k9.bq_plain(*args, radius=radius, k=k, phase=phase), reps=3,
                     warmup=1)
        dev_ms = graph_ms(lambda: k9.bq(*args, radius=radius, k=k, cm=32, phase=phase))
        bms, by, nbytes, tests = bq_bound(args, radius, k, phase)
        print(f"kernel bq_phase {phase} (tool data, B={b} M={m} N={n} K={k}, cm=32): {t:.4f} ms "
              f"(median of {TOOL_REPS}; {dev_ms:.4f} ms replayed from a CUDA graph), plain "
              f"{tp:.4f} ms, kernel 3 (ball_query_first_k) on the same input {t3:.4f} ms (graph "
              f"{d3:.4f}), bound {bms:.6f} ms ({by}: {nbytes} bytes, {tests} distance tests) "
              f"[{card}]", flush=True)
        ctx.setdefault("bq_phase", []).append(dict(err=0.0, ms=t, plain_ms=tp, bound_ms=bms,
                                                   bound_by=by, yard=t3, variant=phase,
                                                   graph_ms=dev_ms, yard_graph_ms=d3))
    plan, launch = k9.plan(n, m, k), k9.launch_of(b, n, m, k)
    require(launch["threads"] == 32 * plan.warps
            and launch["smem_bytes"] == k9.dynamic_smem(plan, k)
            and launch["grid"] == (-(-m // plan.centroids), b),
            f"kernel 9: launch {launch} is not the plan's {plan}")
    print(f"kernel bq_phase launch (B={b} M={m} N={n} K={k}): the plan's, {tuple(plan)}: "
          f"{launch} [{card}]", flush=True)


# the tools' kernels: (row name, source, the TPU kernel it replaces, what its
# yardstick key is)
TOOL_KERNELS = {
    "fused_tail_fwd": ("fused_tail.cu", "dl_biomass_tpu/ops/pallas_tail.py:63",
                       "yardstick_unfused_ms"),
    "fused_tail_bwd": ("fused_tail.cu", "dl_biomass_tpu/ops/pallas_tail.py:108",
                       "yardstick_unfused_backward_ms"),
    "masked_stats": ("masked_stats.cu", "tools/bn_stats_bench.py:92", None),
    # the cross-block step of 7-B and 8: on the TPU their grids accumulate in order
    "sum_slices": ("sum_slices.cu", "dl_biomass_tpu/ops/pallas_tail.py:108, "
                   "tools/bn_stats_bench.py:92", None),
    "block_copy": ("block_copy.cu", "tools/dma_probe.py:63", None),
    # kernel 3 on the same input, once per variant
    "bq_phase": ("bq_phase.cu", "tools/bq_phase_bench.py:286", "yardstick_ball_query_ms"),
}


def tool_paths(device, card: str, launches: dict) -> list:
    """Phase 13: each tool's main() on the card with its launches counted,
    then its kernels at the tool's full shapes against their plain versions,
    timed beside their bounds and yardsticks; returns the kernels' rows."""
    from dl_biomass_tpu_torch.tools import bn_stats_bench, bq_phase_bench, dma_probe, tail_bench

    tools = (tail_bench, bn_stats_bench, dma_probe, bq_phase_bench)
    for path, chains in zip(TOOL_PATHS, ((tail_bench.LOOPS, tail_bench.WINDOWS,
                                          len(tail_bench.SHAPES)),
                                         (bn_stats_bench.LOOPS, bn_stats_bench.WINDOWS,
                                          len(bn_stats_bench.SHAPES)),
                                         (dma_probe.CHAIN, dma_probe.WINDOWS,
                                          len(dma_probe.BLOCK_KBS)),
                                         (bq_phase_bench.LOOPS, bq_phase_bench.WINDOWS,
                                          len(bq_phase_bench.TIMED_PHASES)))):
        require(chains == TOOL_CHAINS[path], f"{path}'s timing constants changed: {chains}")
    for path, tool in zip(TOOL_PATHS, tools):
        t0 = time.perf_counter()
        counted_run(path, lambda: tool.main(device=device), launches, runs=1)
        print(f"{path} launches in one main() ({time.perf_counter() - t0:.1f} s): "
              f"{ {e: n for e, n in launches[path].items() if n} } [{card}]", flush=True)
    ctx = {}
    for name, shape in TAIL_SHAPES.items():
        require(dict(tail_bench.SHAPES)[name] == shape, f"tail_bench's {name} shape changed")
        args = tail_inputs(shape, device, seed=7)
        with torch.no_grad():
            check_tail_fwd(name, args, ctx)
        check_tail_bwd(name, args, ctx)
        del args
        torch.cuda.empty_cache()
    for name, shape in bn_stats_bench.SHAPES:
        check_masked_stats(name, shape, device, ctx)
    for kb in dma_probe.BLOCK_KBS:
        check_block_copy(kb, device, ctx)
    check_bq_phase(device, card, ctx)
    rows = []
    for name, (src, replaces, yard_key) in TOOL_KERNELS.items():
        runs = ctx[name]
        row = dict(name=name, source=f"dl_biomass_tpu_torch/csrc/{src}", replaces=replaces,
                   entry=f"dlbt_{name}", max_abs_err=max(r["err"] for r in runs),
                   ms=sum(r["ms"] for r in runs), plain_ms=sum(r["plain_ms"] for r in runs),
                   bound_ms=sum(r["bound_ms"] for r in runs),
                   bound_by=max(runs, key=lambda r: r["bound_ms"])["bound_by"],
                   library_ms=(sum(r["library"] for r in runs) if "library" in runs[0] else None))
        if yard_key:
            row[yard_key] = sum(r["yard"] for r in runs)
        if "graph_ms" in runs[0]:  # 7-F, 10 and Σ: also from CUDA graphs
            row["graph_ms"] = sum(r["graph_ms"] for r in runs)
        if "library_graph_ms" in runs[0]:
            row["library_graph_ms"] = sum(r["library_graph_ms"] for r in runs)
        if "variant" in runs[0]:
            row["by_variant"] = {r["variant"]: {key: r[key] for key in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "yard",
                "yard_graph_ms")} for r in runs}
        rows.append(row)
    return rows

if __name__ == "__main__":
    sys.exit(main())
