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
               ``PointNet2Regressor``, the folded serving engine
               ``compile_inference`` and its ``torch.export`` artifact
               (``export``)
- ``parallel`` — the data-parallel ``(dp, mp)`` device mesh over
               ``torch.distributed``
- ``train``  — the weighted loss, ``Trainer`` (Adam, early stopping, fit, the
               epochs over a ``DeviceDataset``), checkpoints and the LR range
               test
- ``bridge`` — flax variables <-> torch ``state_dict``
- ``io``     — the LAS codec (``las``, ``reader``), the file datasets
               (``dataset``), ``split``, the offline resampler
               (``resample``: native, numpy, cuda on kernel 1, sectored),
               the prefetching loader (``pipeline``), the synthetic
               forest-plot generator and ``DeviceDataset`` (the plots on the
               device, batches gathered and augmented there)
- ``transforms`` — the on-device augmentation and its host numpy oracle
- ``eval``   — metrics, figures (where matplotlib is installed),
               ``test_model``, ``predict_directory`` / ``watch_directory`` and
               the recorded parity pathway
- ``sweep``  — the study API (a copy of the JAX package's), the tuning
               objective and the trial-parallel grid sweep
- ``experiments`` — the point-density ablation, the seed study and the
               augmentation figure
- ``native`` — ctypes bindings of the C++ point ops in the repo's ``native/``
- ``utils``  — the TensorBoard event writer ``fit(metric_writer=)`` takes, and
               step timing and ``torch.profiler`` traces
- ``tools``  — the measurement tools and ``make_corpus``
- ``__main__`` — ``python -m dl_biomass_tpu_torch train | evaluate | resample
               | predict | export-model | sweep | tune | density | seed-study
               | visualize-aug | parity-record | parity-check``, on the card
               (``--device cpu`` asks for the CPU)

The package imports torch, numpy and the standard library only: nothing of JAX
and nothing of ``dl_biomass_tpu``.
"""

__version__ = "0.1.0"
