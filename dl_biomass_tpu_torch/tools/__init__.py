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
"""
