"""File-based plot datasets (port of ``dl_biomass_tpu/io/dataset.py``).

Rebuilds ``PointCloudsInFiles`` / ``PointCloudsInFilesPreSampled``
(``pointcloud_dataloader.py:47-204``) and their augmenting twins
(``augmentation.py:125-307``) minus the reference's pathologies:

  * the biomass CSV is read **once** per dataset, not once per sample per epoch
    (reference ``pointcloud_dataloader.py:114`` re-reads it in every
    ``__getitem__``);
  * decoded clouds are packed straight into the port's :class:`DeviceDataset`
    (on the card by default, ``device="cpu"`` when asked); augmentation
    happens on the device (``transforms/augment.py``), so the Augment*
    dataset classes collapse into a ``num_augs`` knob at batch time.

Quirks reproduced deliberately, as in the JAX package:
  * dataset-source filter = first two characters of the filename
    (``pointcloud_dataloader.py:67-75``);
  * raw path: subsample to exactly ``max_points`` (without replacement when
    enough points, with replacement otherwise) with numpy's generator, so the
    same seed draws the same subsample as the JAX package; features taken from
    attribute columns at the sampled indices;
  * raw path centers coordinates by the FULL cloud's mean before subsetting
    (``pointcloud_dataloader.py:108``) — unlike the augment path, which centers
    after (``augmentation.py:194-195``; exposed as ``center_after_subset``);
  * clouds with < 100 points are skipped (``pointcloud_dataloader.py:129-130``);
  * presampled path strips the ``_fps_7168``-style suffix from PlotIDs
    (``pointcloud_dataloader.py:184``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.io.reader import normalize_intensity, read_las
from dl_biomass_tpu_torch.transforms.numpy_augment import augment

BIOMASS_COLUMNS = ("bark_btphr", "branch_btphr", "foliage_btphr", "wood_btphr")
MIN_POINTS = 100

Item = Tuple[np.ndarray, np.ndarray, np.ndarray, str]


def load_biomass_table(csv_path: str) -> pd.DataFrame:
    """Read the plot-biomass table once; index by PlotID for O(1) joins."""
    t = pd.read_csv(csv_path, sep=",", header=0)
    if "PlotID" not in t.columns:
        raise ValueError(f"{csv_path}: missing PlotID column")
    missing = [c for c in BIOMASS_COLUMNS if c not in t.columns]
    if missing:
        raise ValueError(f"{csv_path}: missing biomass columns {missing}")
    return t.set_index("PlotID")


def _lookup_targets(table: Optional[pd.DataFrame], plot_id: str) -> np.ndarray:
    if table is None:
        raise ValueError("no biomass_csv configured")
    try:
        row = table.loc[plot_id]
    except KeyError:
        raise ValueError(
            f"PlotID {plot_id!r} not found in the biomass table — check the "
            "presampled_suffix / filename stems against the CSV's PlotID column"
        ) from None
    return np.asarray([row[c] for c in BIOMASS_COLUMNS], np.float32)


def _list_plot_files(root_dir: str, glob: str, datasets: Sequence[str]) -> List[Path]:
    """Glob + filter by dataset prefix (first 2 chars of the filename)."""
    files = sorted(Path(root_dir).glob(glob))
    return [f for f in files if f.name.split(".")[0][:2] in set(datasets)]


def _pack(items, base_n: Optional[int], for_augmentation: bool, device, n_files: int,
          hint: str) -> DeviceDataset:
    """The decoded clouds (None for skipped ones) as one DeviceDataset."""
    items = [it for it in items if it is not None]
    if not items:
        raise FileNotFoundError(
            f"no usable plots: {n_files} files matched the glob/prefix filter, 0 survived "
            f"the <{MIN_POINTS}-point guard (check {hint})")
    pos, feat, ys, ids = zip(*items)
    return DeviceDataset.from_clouds(list(pos), list(feat), np.stack(ys), list(ids),
                                     base_n=base_n, for_augmentation=for_augmentation,
                                     device=device)


class PointCloudsInFiles:
    """Raw-LAS dataset: height filter, random subsample to ``max_points``."""

    def __init__(
        self,
        root_dir: str,
        glob: str = "*",
        max_points: int = 200_000,
        use_columns: Optional[List[str]] = None,
        filter_height: float = 1.3,
        dataset: Sequence[str] = ("RM", "PF"),
        biomass_csv: Optional[str] = None,
        center_after_subset: bool = False,
    ):
        self.files = _list_plot_files(root_dir, glob, dataset)
        self.max_points = max_points
        self.use_columns = list(use_columns or [])
        self.filter_height = filter_height
        self.center_after_subset = center_after_subset
        self._table = load_biomass_table(biomass_csv) if biomass_csv else None

    def __len__(self) -> int:
        return len(self.files)

    def plot_id(self, idx: int) -> str:
        return self.files[idx].name.split(".")[0]

    def targets(self, plot_id: str) -> np.ndarray:
        return _lookup_targets(self._table, plot_id)

    def get(self, idx: int, rng: np.random.Generator) -> Optional[Item]:
        """Decode one plot -> (pos (max_points,3), feat (max_points,F), y (4,), id).
        Returns None for clouds under MIN_POINTS (reference guard rail)."""
        coords, attrs = read_las(
            str(self.files[idx]), get_attributes=True, filter_height=self.filter_height
        )
        if coords.shape[0] < MIN_POINTS:
            return None
        attrs["intensity_normalized"] = normalize_intensity(attrs["intensity"])
        n = coords.shape[0]
        use_idx = rng.choice(n, self.max_points, replace=n < self.max_points)
        if self.use_columns:
            feat = np.stack([attrs[c][use_idx] for c in self.use_columns], axis=1)
        else:
            feat = coords[use_idx]
        if self.center_after_subset:
            pos = coords[use_idx]
            pos = pos - pos.mean(axis=0)
        else:
            coords = coords - coords.mean(axis=0)  # FULL-cloud mean (quirk)
            pos = coords[use_idx]
        pid = self.plot_id(idx)
        y = self.targets(pid)
        return pos.astype(np.float32), feat.astype(np.float32), y, pid

    def load_all(self, rng: Optional[np.random.Generator] = None, for_augmentation: bool = True,
                 device=None) -> DeviceDataset:
        """Every plot decoded, in file order, packed on ``device`` (None: the card)."""
        device = resolve_device(device)
        rng = rng or np.random.default_rng(0)
        return _pack([self.get(i, rng) for i in range(len(self))], self.max_points,
                     for_augmentation, device, len(self), "--data dirs and dataset prefixes")


class AugmentPointCloudsInFiles(PointCloudsInFiles):
    """Reference API parity (``augmentation.py:125-224``): a raw-LAS dataset
    whose every access returns a freshly augmented cloud (host-side numpy
    transforms with the reference's exact distributions, ``transforms/
    numpy_augment.py``). Training augments on the device instead
    (``DeviceDataset.batches`` with ``num_augs``). This path centers
    coordinates AFTER subsetting (``augmentation.py:194-195``)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("center_after_subset", True)
        super().__init__(*args, **kwargs)

    def get(self, idx, rng):
        item = super().get(idx, rng)
        if item is None:
            return None
        pos, feat, y, pid = item
        pos, feat = augment(rng, pos.astype(np.float64), feat.astype(np.float64))
        return pos.astype(np.float32), feat.astype(np.float32), y, pid


class PointCloudsInFilesPreSampled:
    """Pre-resampled dataset: all points of each (fixed-size) cloud, one feature
    column, PlotID suffix stripped."""

    def __init__(
        self,
        root_dir: str,
        glob: str = "*",
        dataset: Sequence[str] = ("RM", "PF", "BC"),
        use_column: str = "intensity_normalized",
        biomass_csv: Optional[str] = None,
        presampled_suffix: str = "_fps_7168",
    ):
        self.files = _list_plot_files(root_dir, glob, dataset)
        self.use_column = use_column
        self.presampled_suffix = presampled_suffix
        self._table = load_biomass_table(biomass_csv) if biomass_csv else None

    def __len__(self) -> int:
        return len(self.files)

    def plot_id(self, idx: int) -> str:
        return self.files[idx].name.split(".")[0].replace(self.presampled_suffix, "")

    def targets(self, plot_id: str) -> np.ndarray:
        return _lookup_targets(self._table, plot_id)

    def get(self, idx: int) -> Optional[Item]:
        path = str(self.files[idx])
        if path.endswith(".parq") or path.endswith(".parquet"):
            df = pd.read_parquet(path)
            coords = df[["x", "y", "z"]].to_numpy()
            col = "i_norm" if "i_norm" in df.columns else self.use_column
            feat = df[col].to_numpy().reshape(-1, 1)
        else:
            coords, attrs = read_las(path, get_attributes=True, filter_height=0)
            feat = np.asarray(attrs[self.use_column]).reshape(len(coords), 1)
        if coords.shape[0] < MIN_POINTS:
            return None
        pid = self.plot_id(idx)
        return coords.astype(np.float32), feat.astype(np.float32), self.targets(pid), pid

    def load_all(self, for_augmentation: bool = True, device=None) -> DeviceDataset:
        """Every plot decoded, in file order, packed on ``device`` (None: the card)."""
        device = resolve_device(device)
        return _pack([self.get(i) for i in range(len(self))], None, for_augmentation, device,
                     len(self), "--data dirs, dataset prefixes, and the presampled suffix")


class AugmentPreSampledPoints(PointCloudsInFilesPreSampled):
    """Reference API parity (``augmentation.py:226-307``): pre-resampled clouds
    with the host-side augmentation chain applied on every access."""

    def get(self, idx, rng: Optional[np.random.Generator] = None):
        item = super().get(idx)
        if item is None:
            return None
        pos, feat, y, pid = item
        rng = rng or np.random.default_rng()
        pos, feat = augment(rng, pos.astype(np.float64), feat.astype(np.float64))
        return pos.astype(np.float32), feat.astype(np.float32), y, pid
