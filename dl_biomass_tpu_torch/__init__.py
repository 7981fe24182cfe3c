"""dl_biomass_tpu_torch — the PyTorch + CUDA port of ``dl_biomass_tpu``.

The JAX package beside this one is the reference; this package serves and
trains the same PointNet++ regressor on an NVIDIA H100, with every Pallas
kernel of those paths rewritten by hand as a CUDA kernel (``csrc/``):

- ``core``   — dense ``(B, N, ...)`` cloud batches and the config dataclasses
- ``ops``    — FPS, ball query, stratified ball grouping, row gather and its
               scatter-add backward, pooling; each kernel module holds its
               CUDA wrapper and its plain PyTorch version (used for CPU
               tensors only)
- ``models`` — layers (train-mode BatchNorm and dropout included),
               ``PointNet2Regressor`` and the folded serving engine
               ``compile_inference``
- ``train``  — the weighted loss, ``Trainer`` (Adam, early stopping, fit, the
               epochs over a ``DeviceDataset``) and checkpoints
- ``bridge`` — flax variables <-> torch ``state_dict``
- ``io``     — the synthetic forest-plot generator and ``DeviceDataset``
               (the plots on the device, batches gathered and augmented there)
- ``transforms`` — the on-device augmentation and its host numpy oracle

The package imports torch, numpy and the standard library only: nothing of JAX
and nothing of ``dl_biomass_tpu``.
"""

__version__ = "0.1.0"
