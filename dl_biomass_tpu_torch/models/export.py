"""Serving export: the folded serving function frozen into an artifact (port of
``dl_biomass_tpu/models/export.py``).

The reference deploys with ``torch.save(model)``, a whole-module pickle that
loads only beside the exact model source (``main.py:243-245``,
``testing_model.py:30-37``). The JAX package exports its folded serving
function as StableHLO with the weights beside it; here the same flat
function (``models/inference.serving_function``) is traced by
``torch.export`` under ``torch.no_grad`` at one static envelope, and the
kernels on its path (1, 2, 3, 4a and 4c) appear in the graph as the
registered ops ``torch.ops.dlbt.*``. A serving host needs torch, numpy and
this package's ops (``import dl_biomass_tpu_torch.ops``, as the JAX artifact
needs jax): no model class, no training config, no checkpoint.

Artifact layout (a directory):

    serving.pt2    torch.export.save of the flat serving function
    weights.npz    folded weights (arr_00000...), positional; bf16 ones as
                   their uint16 bits (meta's ``weight_dtypes``)
    meta.json      format, envelope, weights, platforms, torch version, model

The exported function takes ``(*weights, pos, feat, mask)`` as plain
tensors. Its graph holds the device it was traced on (the kernels' launches
on the card, the plain versions on the CPU): ``platforms`` names it, and the
loader refuses another.
"""

from __future__ import annotations

import json
import os
import numpy as np
import torch

FORMAT_VERSION = 1

_SERVING_FILE = "serving.pt2"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Flat(torch.nn.Module):
    """The flat serving function as the module ``torch.export`` takes."""

    def __init__(self, infer):
        super().__init__()
        self.infer = infer

    def forward(self, *args):
        return self.infer(*args)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def export_serving(model, *, batch_size: int, num_points: int, path: str,
                   device=None) -> dict:
    """Export the folded serving computation of ``model`` to ``path``.

    ``num_points`` is the served point-axis size: the dataset capacity
    (``round_up(base_n, 128)``, the shape ``DeviceDataset`` and ``CloudBatch``
    produce), not the nominal count before padding. ``device`` (None: the
    card) is where the artifact runs, the only platform it serves on.

    Returns the metadata dict (also written to ``meta.json``)."""
    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.models.inference import serving_function, serving_weights

    dev = resolve_device(device)
    weights = serving_weights(model, dev)
    infer = serving_function(model)
    num_features = int(model.num_features or 0)
    example = (torch.zeros((batch_size, num_points, 3), dtype=torch.float32, device=dev),
               torch.zeros((batch_size, num_points, num_features), dtype=torch.float32,
                           device=dev),
               torch.zeros((batch_size, num_points), dtype=torch.bool, device=dev))
    with torch.no_grad():
        exported = torch.export.export(_Flat(infer), (*weights, *example))

    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _SERVING_FILE))
    np.savez(os.path.join(path, _WEIGHTS_FILE),
             **{f"arr_{i:05d}": _to_numpy(w) for i, w in enumerate(weights)})
    meta = {
        "format": FORMAT_VERSION,
        "batch_size": int(batch_size),
        "num_points": int(num_points),
        "num_features": num_features,
        "num_outputs": int(model.num_outputs),
        "n_weights": len(weights),
        "weight_dtypes": [_dtype_name(w.dtype) for w in weights],
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "model_summary": {
            "family": type(model).__name__,
            "compute_dtype": _dtype_name(model.compute_dtype),
            "fast_fps": bool(model.fast_fps),
            "fast_group": bool(model.fast_group),
            "exact_selection": bool(model.exact_selection),
            "split_first_layer": bool(model.split_first_layer),
        },
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedServing:
    """A loaded serving artifact: ``fn(pos, feat, mask) -> (B, outputs)``.

    ``__call__`` is strict (inputs must match the exported envelope exactly);
    ``predict`` serves any number of plots by chunking to the envelope batch
    and padding the tail with masked-out clouds, every chunk queued before
    the one host sync. ``device`` (None: the card) must be the platform the
    artifact was exported for."""

    def __init__(self, path: str, device=None):
        import dl_biomass_tpu_torch.ops  # noqa: F401  (registers the torch.ops.dlbt kernels)
        from dl_biomass_tpu_torch.core.cloud import resolve_device

        self.device = resolve_device(device)
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta.get("format", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta['format']} is newer than this loader (supports "
                f"<= {FORMAT_VERSION}): upgrade the package")
        if self.device.type not in self.meta["platforms"]:
            raise RuntimeError(
                f"artifact at {path!r} was exported for {self.meta['platforms']} but this "
                f"process serves on {self.device.type!r}: re-export on this platform "
                "(export-model --device) or run where the artifact targets")
        self._fn = torch.export.load(os.path.join(path, _SERVING_FILE)).module()
        dtypes = self.meta["weight_dtypes"]
        with np.load(os.path.join(path, _WEIGHTS_FILE)) as z:
            self._weights = []
            for i in range(self.meta["n_weights"]):
                w = torch.from_numpy(z[f"arr_{i:05d}"])
                if dtypes[i] == "bfloat16":
                    w = w.view(torch.bfloat16)
                self._weights.append(w.to(self.device, _DTYPES[dtypes[i]]))
        self.batch_size = int(self.meta["batch_size"])
        self.num_points = int(self.meta["num_points"])
        self.num_features = int(self.meta["num_features"])
        self.num_outputs = int(self.meta["num_outputs"])

    def _tensor(self, x, dtype) -> torch.Tensor:
        x = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return x.to(self.device, dtype)

    def __call__(self, pos, feat, mask) -> torch.Tensor:
        b, n, f = self.batch_size, self.num_points, self.num_features
        if tuple(pos.shape) != (b, n, 3) or tuple(feat.shape) != (b, n, f) \
                or tuple(mask.shape) != (b, n):
            raise ValueError(
                f"envelope mismatch: artifact serves pos ({b}, {n}, 3) / feat ({b}, {n}, {f}) "
                f"/ mask ({b}, {n}); got {tuple(pos.shape)} / {tuple(feat.shape)} / "
                f"{tuple(mask.shape)}: use .predict() for arbitrary plot counts, or re-export "
                "for this envelope")
        with torch.no_grad():
            return self._fn(*self._weights, self._tensor(pos, torch.float32),
                            self._tensor(feat, torch.float32), self._tensor(mask, torch.bool))

    def predict(self, pos, feat, mask) -> np.ndarray:
        """Serve (P, N, ...) arrays or tensors for any P; returns (P,
        num_outputs) float32 numpy."""
        p = pos.shape[0]
        if pos.shape[1] != self.num_points:
            raise ValueError(
                f"artifact serves num_points={self.num_points}; got clouds with "
                f"{pos.shape[1]} point slots: resample/pad to match, or re-export for this "
                "envelope")
        pos, feat = self._tensor(pos, torch.float32), self._tensor(feat, torch.float32)
        mask = self._tensor(mask, torch.bool)
        b = self.batch_size
        outs = []
        for s in range(0, p, b):  # queue every chunk, sync once at the end
            chunk = [pos[s:s + b], feat[s:s + b], mask[s:s + b]]
            pad = b - chunk[0].shape[0]
            if pad:
                chunk = [torch.cat([c, c.new_zeros((pad, *c.shape[1:]))]) for c in chunk]
            outs.append(self(*chunk))
        return torch.cat(outs).float().cpu().numpy()[:p]


def load_serving(path: str, device=None) -> ExportedServing:
    """Load an artifact written by ``export_serving`` (or ``export-model``) to
    serve on ``device`` (None: the card)."""
    return ExportedServing(path, device)
