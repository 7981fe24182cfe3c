"""Generate a synthetic LAS corpus with the reference's on-disk layout (port of
the JAX package's ``tools/make_corpus.py``, on the port's own
``io/synthetic.synthetic_plot`` and ``io/reader.write_las``).

The reference's real plots (BC Gov / Romeo-Malette / Petawawa LAS files and a
plot-biomass CSV, reference ``pointcloud_dataloader.py:47-131`` /
``main.py:55-61``) are not shipped; this tool writes the same layout from the
procedural generator, so that the whole pipeline — raw LAS -> offline FPS
resample -> presampled dataset -> train -> evaluate -> predict — runs on
files on disk, as a user of the reference would run it.

Layout written:
  OUT/train/  OUT/val/  OUT/test/      {BC,RM,PF}_*.las  (raw clouds with an
                                        ``intensity`` dimension)
  OUT/biomass.csv                       PlotID + 4 *_btphr component columns

Usage:
  python -m dl_biomass_tpu_torch.tools.make_corpus --out DIR --plots 288 --points 12288
  python -m dl_biomass_tpu_torch resample --in-dir DIR/train \\
      --out-dir DIR/fps7168_train --num-points 7168 --format las --engine cuda
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from dl_biomass_tpu_torch.io.dataset import BIOMASS_COLUMNS
from dl_biomass_tpu_torch.io.reader import write_las
from dl_biomass_tpu_torch.io.synthetic import synthetic_plot

SPLITS = (("train", 2 / 3), ("val", 1 / 6), ("test", 1 / 6))


def make_corpus(out_dir: str, num_plots: int, n_points: int, seed: int = 0, splits=SPLITS):
    """Write ``num_plots`` plots of ``n_points`` raw points, split by the
    fractions of ``splits`` (the first split takes the rounding), and the
    biomass table."""
    rng = np.random.default_rng(seed)
    sources = ("BC", "RM", "PF")
    rows = []
    counts = [int(round(num_plots * f)) for _, f in splits]
    counts[0] = num_plots - sum(counts[1:])
    i = 0
    for (split, _), count in zip(splits, counts):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        for _ in range(count):
            coords, intensity, biomass = synthetic_plot(rng, n_points)
            pid = f"{sources[i % 3]}_{i:04d}"
            write_las(coords, os.path.join(d, f"{pid}.las"),
                      {"intensity": intensity.astype(np.uint16)})
            rows.append((pid, *biomass))
            i += 1
        print(f"{split}: {count} plots -> {d}")
    with open(os.path.join(out_dir, "biomass.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["PlotID", *BIOMASS_COLUMNS])
        w.writerows(rows)
    print(f"biomass table: {len(rows)} rows -> {out_dir}/biomass.csv")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="make_corpus")
    p.add_argument("--out", required=True)
    p.add_argument("--plots", type=int, default=288)
    p.add_argument("--points", type=int, default=12288)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    make_corpus(a.out, a.plots, a.points, a.seed)


if __name__ == "__main__":
    main()
