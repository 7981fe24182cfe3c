"""Dataset splitting utility (copied from ``dl_biomass_tpu/io/split.py``).

Parity with the reference's ad-hoc splitter
(``Misc/Old_PointNet_Scripts/Subsample_n_move_train_n_test_data.py``: random 70%
moved into ``train/``), generalized to a reproducible train/val/test split that
copies or moves plot files and can stratify by dataset source prefix.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def split_dataset(
    in_dir: str,
    out_dir: str,
    *,
    fractions: Tuple[float, float, float] = (0.7, 0.15, 0.15),
    glob: str = "*.las",
    seed: int = 0,
    move: bool = False,
    stratify_by_source: bool = True,
) -> Dict[str, List[str]]:
    """Split plot files into train/val/test subdirectories.

    Returns {"train": [...], "val": [...], "test": [...]} of destination paths.
    """
    if abs(sum(fractions) - 1.0) > 1e-6:
        raise ValueError(f"fractions must sum to 1, got {fractions}")
    files = sorted(Path(in_dir).glob(glob))
    if not files:
        raise ValueError(f"no files matching {glob!r} under {in_dir!r}")
    rng = np.random.default_rng(seed)

    groups: Dict[str, List[Path]] = {}
    for f in files:
        key = f.name[:2] if stratify_by_source else "all"
        groups.setdefault(key, []).append(f)

    out: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for split in out:
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
    for key, members in sorted(groups.items()):
        perm = rng.permutation(len(members))
        n_train = int(round(fractions[0] * len(members)))
        n_val = int(round(fractions[1] * len(members)))
        assignment = (
            [("train", i) for i in perm[:n_train]]
            + [("val", i) for i in perm[n_train : n_train + n_val]]
            + [("test", i) for i in perm[n_train + n_val :]]
        )
        for split, i in assignment:
            src = members[i]
            dst = os.path.join(out_dir, split, src.name)
            (shutil.move if move else shutil.copy2)(str(src), dst)
            out[split].append(dst)
    return out
