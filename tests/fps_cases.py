"""Inputs of kernel 1 (FPS) on the cases its argmax must get exactly right,
made with numpy from a seed. The CPU tests hold the plain version against the
Pallas kernel in interpret mode on them; the card's tests hold the kernel
against the plain version."""

import numpy as np

EDGE_CASES = ("duplicates", "all_masked", "beyond_valid", "masked_start")
ROWS = 3


def edge_case(name: str, n: int, seed: int = 0):
    """(pos (3, n, 3) float32, mask (3, n) bool, starts (3,) int32, k) for
    ``name``:

    - duplicates: integer coordinates on a 3 x 3 x 3 grid, so every distance
      is exact and most tie (0 once each grid point is picked); k = n, so the
      picks run through the ties, which go to the first index;
    - all_masked: row 1 has no valid point (it picks its start, then 0);
    - beyond_valid: rows of n, n // 8 and 3 valid points and k = n // 2, so
      rows 1 and 2 pick index 0 once their valid points are gone;
    - masked_start: every even point masked and every row starting on one.
    """
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(ROWS, n, 3)) * 3).astype(np.float32)
    mask = np.ones((ROWS, n), bool)
    starts = np.zeros(ROWS, np.int32)
    k = max(1, n // 2)
    if name == "duplicates":
        pos = rng.integers(-1, 2, size=(ROWS, n, 3)).astype(np.float32)
        starts = rng.integers(0, n, size=ROWS).astype(np.int32)
        k = n
    elif name == "all_masked":
        mask[1] = False
        starts[1] = n // 3
    elif name == "beyond_valid":
        mask = np.arange(n)[None] < np.asarray([n, max(1, n // 8), 3])[:, None]
    elif name == "masked_start":
        mask[:, ::2] = False
        starts = np.asarray([0, 2 * (n // 4), 2 * ((n - 1) // 2)], np.int32)
    else:
        raise ValueError(f"unknown case {name}")
    return pos, mask, starts, k
