"""Inputs of kernel 2 (the stratified ball group) on the cases its selection
and capture must get exactly right, made with numpy from a seed. The CPU
tests hold the plain version against the Pallas kernel in interpret mode on
them, and on the radius against ``select_reference``; the card's tests hold
the kernel against the plain version."""

import numpy as np

RADIUS = 1.5
# name: (clouds, points, centroids, features, out dtype, need_idx); the
# cases take every value of the last three between them
CASES = {
    "n1": (2, 1, 3, 1, "bfloat16", True),
    "n127": (2, 127, 9, 0, "float32", True),
    "n128": (2, 128, 9, 4, "bfloat16", False),
    "n129": (2, 129, 9, 1, "float32", False),
    "n300": (2, 300, 20, 1, "bfloat16", True),  # N no multiple of 128
    "empty_ball": (2, 256, 16, 1, "float32", True),
    "full_ball": (2, 384, 16, 4, "bfloat16", True),
    "on_radius": (1, 160, 2, 0, "float32", True),
    "masked_points": (2, 256, 16, 1, "bfloat16", True),
    "masked_centroids": (2, 256, 16, 4, "float32", False),
    "m_not_tile": (2, 256, 13, 1, "bfloat16", True),  # M no multiple of 8 (the tile)
}
BOUNDARY_POINTS = 24  # on_radius: points on the sphere, every 5th index


def _r2() -> np.float32:
    return np.float32(float(RADIUS) ** 2)  # squared in double, compared in f32


def separate_d2(d: np.ndarray) -> np.ndarray:
    """dx*dx + dy*dy + dz*dz in float32, every operation rounded on its own."""
    d = d.astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fma_d2(d: np.ndarray) -> np.ndarray:
    """The same sum with its first add contracted: fma(dx, dx, dy*dy) + dz*dz
    (a float32 square is exact in float64)."""
    d64 = d.astype(np.float64)
    sq = (d64 * d64).astype(np.float32).astype(np.float64)
    a = (d64[..., 0] * d64[..., 0] + sq[..., 1]).astype(np.float32)
    return (a.astype(np.float64) + sq[..., 2]).astype(np.float32)


def boundary_points(center: np.ndarray, count: int, rng) -> np.ndarray:
    """``count`` points within a rounding step of the sphere of RADIUS around
    ``center`` where the contracted sum and the rounded one disagree on
    d2 <= r2."""
    out = []
    while len(out) < count:
        u = rng.normal(size=(4096, 3))
        p = (center.astype(np.float64) + RADIUS * u / np.linalg.norm(u, axis=1, keepdims=True))
        p = p.astype(np.float32)
        d = p - center
        flip = (separate_d2(d) <= _r2()) != (fma_d2(d) <= _r2())
        out.extend(p[flip])
    return np.stack(out[:count])


def group_case(name: str, seed: int = 0):
    """(centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N),
    feat (B, N, F) or None) float32 and bool, for ``name``:

    - n1 .. n300: gaussian clouds, the second with its first 3/4 valid;
    - empty_ball: every other centroid 100 away from the cloud;
    - full_ball: the cloud shrunk twenty-fold, inside every ball;
    - on_radius: every 5th point on the sphere around centroid 0, where a
      fused multiply-add would flip the test;
    - masked_points: every other point masked, at its place in the cloud;
    - masked_centroids: every third centroid masked;
    - m_not_tile: 13 centroids.
    """
    b, n, m, f, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32)
    mask = np.ones((b, n), bool)
    if b > 1:
        mask[1, max(1, 3 * n // 4):] = False
    centers = pos[:, np.arange(m) % n].copy()
    cmask = np.ones((b, m), bool)
    if name == "empty_ball":
        centers[:, ::2] += 100.0
    elif name == "full_ball":
        pos *= 0.05
        centers = pos[:, np.arange(m) % n].copy()
    elif name == "on_radius":
        centers[0, 0] = np.float32([0.25, -0.5, 0.125])
        pos[0, ::5][:BOUNDARY_POINTS] = boundary_points(centers[0, 0], BOUNDARY_POINTS, rng)
    elif name == "masked_points":
        mask[:, ::2] = False
    elif name == "masked_centroids":
        cmask[:, ::3] = False
    feat = rng.normal(size=(b, n, f)).astype(np.float32) if f else None
    return centers, cmask, pos, mask, feat


def select_reference(centers, cmask, pos, mask):
    """The selection rule in numpy, every operation of the test rounded on
    its own: (idx (B, M, 64) int32, 0 where invalid; nbr_mask (B, M, 64))."""
    b, m, _ = centers.shape
    n = pos.shape[1]
    d2 = separate_d2(pos[:, None, :, :] - centers[:, :, None, :])  # (B, M, N)
    ok = (d2 <= _r2()) & mask[:, None, :] & cmask[:, :, None]
    n_pad = -(-n // 128) * 128
    keys = np.full((b, m, n_pad), n, np.int64)
    keys[..., :n] = np.where(ok, np.arange(n), n)
    first = keys.reshape(b, m, -1, 128).min(axis=2)
    pair = np.minimum(first[..., :64], first[..., 64:])
    valid = pair < n
    return np.where(valid, pair, 0).astype(np.int32), valid
