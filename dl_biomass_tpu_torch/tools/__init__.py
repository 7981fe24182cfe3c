"""Measurement tools, ports of the JAX package's ``tools/`` scripts of the same
names. Each runs as ``python -m dl_biomass_tpu_torch.tools.<name>`` on the
card, or as ``main(device="cpu")`` on the plain versions of its kernels:

- ``tail_bench``     — kernel 7 (``ops/tail_kernel.fused_tail``) beside the
                       unfused Linear + ``masked_max`` at SA-layer shapes
- ``bn_stats_bench`` — formulations of the masked BatchNorm statistics, and
                       kernel 8 (``stats_kernel``, ``csrc/masked_stats.cu``)
- ``dma_probe``      — the bandwidth of one elementwise PyTorch call against
                       kernel 10 (``block_copy``, ``csrc/block_copy.cu``)
- ``bq_phase_bench`` — the variants of the TPU's rank-scatter ball query
                       (``full``, ``mstatic``, ``munroll``) as kernel 9
                       (``bq``, ``csrc/bq_phase.cu``), with its phase stubs

and the tools that run no kernel of their own, each printing the card and
its power limit beside its numbers:

- ``profile_step``   — a ``torch.profiler`` window of the train, eval or
                       engine step, device time by kernel and by operator
- ``roofline``       — each step's GEMM FLOPs and kernels 1-4c's bytes and
                       operations beside the H100's peaks, and the step's time
- ``batch_sweep``    — train and eval clouds/s at B in {16, 32, 36, 48, 64}
- ``serving_matrix`` — the module's eval, both engines and the export
                       artifact at B in {1, 16, 36}; ``--cold``: process
                       start to predictions from the artifact
- ``dispatch_probe`` — the host's share of a step (the JAX package's
                       ``dispatch_probe`` and ``multistep_probe`` in one)
- ``bq_tile_sweep``  — kernel 3's launch choices at SA2's scale
- ``fps_divergence_probe`` — a seed-study row, ``--old-keys`` with the
                       augmentation seeded as the steps' generator
- ``torch_cpu_anchor`` — the reference algorithm in plain PyTorch beside
                       the port's step

and ``make_corpus`` writes a synthetic raw LAS corpus (``{train,val,test}/``
and ``biomass.csv``) for the disk path of ``python -m dl_biomass_tpu_torch``.
"""
