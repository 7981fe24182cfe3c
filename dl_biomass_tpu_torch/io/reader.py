"""Reference-parity LAS helper API (copied from ``dl_biomass_tpu/io/reader.py``).

Drop-in equivalents of the helpers every reference script re-defines:
``read_las`` (``pointcloud_dataloader.py:12-39``), ``normalize_intensity``
(``pointcloud_dataloader.py:42-44``), and ``write_las``
(``downsampling_point_clouds.py:95-125``) — backed by this framework's own LAS
codec instead of laspy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from dl_biomass_tpu_torch.io import las as lascodec


def read_las(
    pointcloudfile,
    get_attributes: bool = False,
    useevery: int = 1,
    filter_height: float = 0.2,
) -> Union[np.ndarray, Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """Read a LAS file into an (N, 3) xyz array (plus an attribute dict).

    Mirrors the reference helper: every ``useevery``-th point, points with
    ``z <= filter_height`` removed (only when filter_height > 0), attributes
    keyed by LAS dimension name. Unlike the reference (which strided attributes
    but forgot to height-filter them — ``pointcloud_dataloader.py:38`` returns
    attrs of a different length than coords when filtering), attributes here are
    kept row-aligned with the returned coords.
    """
    f = lascodec.read(str(pointcloudfile))
    coords = f.xyz[::useevery]
    keep = None
    if filter_height > 0:
        keep = coords[:, 2] > filter_height
        coords = coords[keep]
    if not get_attributes:
        return coords
    attrs: Dict[str, np.ndarray] = {}
    for name in f.dimension_names:
        v = np.asarray(f[name])[::useevery]
        attrs[name] = v[keep] if keep is not None else v
    return coords, attrs


def normalize_intensity(intensity_vals: np.ndarray) -> np.ndarray:
    """Min-max normalize then x20 "so intensity vals take on similar range to
    biomass vals" (reference quirk, ``pointcloud_dataloader.py:42-44``)."""
    intensity_vals = np.asarray(intensity_vals, np.float64)
    lo, hi = intensity_vals.min(), intensity_vals.max()
    if hi == lo:
        # constant-intensity cloud: the reference divides by zero here and
        # produces NaNs (pointcloud_dataloader.py:44); map to 0 instead
        return np.zeros_like(intensity_vals)
    return (intensity_vals - lo) / (hi - lo) * 20


def write_las(
    outpoints: np.ndarray,
    outfilepath,
    attribute_dict: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write LAS 1.4 / point format 6 with the reference resampler's header
    conventions: scale 0.00025, integer-truncated mean offsets, unknown
    attributes as Extra Bytes dims (``downsampling_point_clouds.py:95-125``)."""
    outpoints = np.asarray(outpoints, np.float64)
    hdr = lascodec.LasHeader(version=(1, 4), point_format=6)
    hdr.scales = np.asarray([0.00025] * 3)
    mean_extent = np.mean(outpoints, axis=0)
    hdr.offsets = np.asarray([int(mean_extent[0]), int(mean_extent[1]), int(mean_extent[2])], np.float64)
    lascodec.write(str(outfilepath), outpoints, header=hdr, attributes=attribute_dict or {})
