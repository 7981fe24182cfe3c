"""Offline point-cloud resampler (port of ``dl_biomass_tpu/io/resample.py``).

Parity with the reference's ``downsampling_point_clouds.py``: per LAS file —
read, normalize intensity, downsample to ``num_points`` (random, voxel, or
exact FPS seeded at index 0, ``:55-92``), center, and write parquet (x, y, z,
i_norm — ``:170-176``) or LAS with an ``intensity_normalized`` extra dim
(``:179-183``); output filenames ``{plot}_{method}_{num_points}``.

FPS engines:
  * ``native`` — the C++ library (``native/pointops.py``), float64;
  * ``numpy``  — ``ops/reference.fps_numpy``, float64;
  * ``cuda``   — exact FPS on kernel 1 (``ops/fps.farthest_point_sample``,
    start 0), in the JAX package's place of its ``tpu`` engine; on a CPU
    device (asked for with ``device="cpu"``) the kernel's plain version;
  * ``sectored`` — ``ops/fps.fps_sectored`` on kernel 1, the picks sorted: an
    opt-in approximation of exact FPS;
  * ``auto``   — ``native`` where the library loads, else ``cuda``.

Kernel 1 computes ``|p|^2 - 2 p.l + |l|^2`` in float32. Raw plot coordinates
are georeferenced (UTM eastings ~5e5 m, northings ~5e6 m), where ``|p|^2`` is
~2.5e13 and float32 cannot resolve a metre, so the ``cuda`` and ``sectored``
engines subtract the cloud's float64 mean before the cast. Exact FPS does not
change under a translation; the JAX ``tpu`` engine casts the raw coordinates.
The ``cuda`` engine never gives way to another engine or, on the card, to the
plain version.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.io.reader import normalize_intensity, read_las, write_las
from dl_biomass_tpu_torch.native import pointops
from dl_biomass_tpu_torch.ops.fps import farthest_point_sample, fps_sectored
from dl_biomass_tpu_torch.ops.reference import fps_numpy

ENGINES = ("auto", "cuda", "native", "numpy", "sectored")


def centred_f32(coords: np.ndarray, device) -> torch.Tensor:
    """(1, N, 3) float32 on ``device``: the cloud less its float64 mean, the
    input the ``cuda`` and ``sectored`` engines give kernel 1."""
    coords = np.asarray(coords, np.float64)
    local = (coords - coords.mean(axis=0)).astype(np.float32)
    return torch.from_numpy(local)[None].to(device)


def farthest_point_sampling(coords: np.ndarray, k: int, engine: str = "auto",
                            device=None) -> np.ndarray:
    """Exact FPS seeded at index 0 -> (k,) indices (reference ``:55-92``);
    ``sectored`` is the approximation, its picks sorted. ``device`` (None:
    the card) is where the ``cuda`` and ``sectored`` engines run."""
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto":
        engine = "native" if pointops.available() else "cuda"
    if engine == "native":
        return pointops.fps(coords, k, start=0)
    if engine == "numpy":
        return fps_numpy(coords, np.ones(n, bool), k, start=0)
    dev = resolve_device(device)
    pos = centred_f32(coords, dev)
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    if engine == "cuda":
        starts = torch.zeros(1, dtype=torch.int32, device=dev)
        return farthest_point_sample(pos, mask, k, starts=starts)[0].cpu().numpy()
    return np.sort(fps_sectored(pos, mask, k)[0].cpu().numpy())


def voxel_downsample(coords: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid downsampling: one (first) point per occupied voxel — returns
    indices.

    Packs the 3 voxel coords into one int64 key so the dedup is a single 1-D
    sort; first-occurrence semantics are those of
    ``np.unique(q, axis=0, return_index=True)``."""
    q = np.floor(coords / voxel_size).astype(np.int64)
    q -= q.min(axis=0)
    span = q.max(axis=0) + 1
    n = len(q)
    idx_bits = max(int(n - 1).bit_length(), 1)
    vox_bits = (int(span[0]) * int(span[1]) * int(span[2]) - 1).bit_length()
    if vox_bits + idx_bits <= 63:
        key = (q[:, 0] * span[1] + q[:, 1]) * span[2] + q[:, 2]
        # the point index in the low bits: a plain value sort groups points by
        # voxel with ascending index inside each group, so group starts are
        # the stable-unique first indices
        packed = np.sort((key << idx_bits) | np.arange(n, dtype=np.int64))
        starts = np.empty(n, bool)
        starts[0] = True
        np.not_equal(packed[1:] >> idx_bits, packed[:-1] >> idx_bits, out=starts[1:])
        first_idx = packed[starts] & ((1 << idx_bits) - 1)
    else:  # degenerate extents: the row-wise unique
        _, first_idx = np.unique(q, axis=0, return_index=True)
    return np.sort(first_idx)


def resample_point_clouds(
    in_dir: str,
    out_dir: str,
    num_points: int,
    use_columns: Sequence[str] = (),
    samp_meth: str = "random",  # random | fps | voxel
    glob: str = "*.las",
    use_parquet: bool = True,
    seed: int = 0,
    engine: str = "auto",
    voxel_size: float = 0.25,
    log_fn=print,
    device=None,
) -> List[str]:
    """Resample every LAS in ``in_dir``; returns the written file paths.
    ``device`` (None: the card, which must exist) runs the ``cuda`` and
    ``sectored`` FPS engines."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(Path(in_dir).glob(glob))
    rng = np.random.default_rng(seed)
    written = []
    for file in files:
        coords, attrs = read_las(str(file), get_attributes=True, filter_height=0)
        plot_id = file.name.rsplit(".", 1)[0]
        attrs["intensity_normalized"] = normalize_intensity(attrs["intensity"])
        cols = list(use_columns) if use_columns else ["intensity_normalized"]
        attr_arr = np.asarray(attrs[cols[0]], np.float64)

        n = coords.shape[0]
        if n >= num_points:
            if samp_meth == "random":
                use_idx = rng.choice(n, num_points, replace=False)
            elif samp_meth == "fps":
                use_idx = farthest_point_sampling(coords, num_points, engine=engine, device=dev)
            elif samp_meth == "voxel":
                vi = voxel_downsample(coords, voxel_size)
                use_idx = (
                    vi if len(vi) <= num_points
                    else vi[rng.choice(len(vi), num_points, replace=False)]
                )
            else:
                raise ValueError(f"unknown samp_meth {samp_meth!r}")
        else:
            use_idx = rng.choice(n, num_points, replace=True)

        coords_s = coords[use_idx]
        attr_s = attr_arr[use_idx]
        coords_s = coords_s - coords_s.mean(axis=0)

        stem = f"{plot_id}_{samp_meth}_{num_points}"
        if use_parquet:
            import pandas as pd

            df = pd.DataFrame(
                np.column_stack([coords_s, attr_s]), columns=["x", "y", "z", "i_norm"]
            )
            path = os.path.join(out_dir, stem + ".parq")
            df.to_parquet(path)
        else:
            path = os.path.join(out_dir, stem + ".las")
            write_las(coords_s, path, {"intensity_normalized": attr_s})
        written.append(path)
        log_fn(f"  resampled {file.name} ({n} -> {len(use_idx)} pts) -> {os.path.basename(path)}")
    return written


def check_resampling(in_dir: str, out_path: Optional[str] = None, seed: int = 0) -> None:
    """3-D render of 4 random resampled outputs (reference ``:186-240``)."""
    import pandas as pd

    from dl_biomass_tpu_torch.eval.plots import plot_cloud_grid

    # cloud files only: the out dir may also hold this function's own PNG
    files = sorted(
        f for f in Path(in_dir).glob("*")
        if f.suffix.lower() in (".las", ".laz", ".parq", ".parquet")
    )
    if not files:
        raise FileNotFoundError(f"no cloud files under {in_dir!r}")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(files), size=min(4, len(files)), replace=False)
    coords_list = []
    for i in pick:
        f = files[i]
        if f.suffix.lower() in (".parq", ".parquet"):
            coords_list.append(pd.read_parquet(f, columns=["x", "y", "z"]).to_numpy())
        else:
            coords_list.append(read_las(str(f), get_attributes=False, filter_height=0))
    plot_cloud_grid(coords_list, out_path)
