"""Inputs of kernel 3 (the exact first-K ball query) on the cases it must get
exactly right, made with numpy from a seed. The CPU tests hold the plain
version against the JAX package's exact path, its numpy reference and the
Pallas kernel in interpret mode on them; the card's tests hold the kernel
against the plain version."""

import numpy as np

RADIUS = 1.5
# name: (clouds, points, centroids, k); N takes values on either side of a
# chunk of 32 and of the kernel's group of 128, and k values below, at and
# above N
CASES = {
    "n1": (2, 1, 3, 16),
    "n31": (2, 31, 9, 64),  # k > N
    "n32": (2, 32, 9, 16),
    "n33": (2, 33, 9, 1),
    "n127": (2, 127, 9, 64),
    "n128": (2, 128, 9, 16),
    "n129": (2, 129, 13, 64),
    "n300": (2, 300, 20, 64),  # N no multiple of 32
    "few_in_radius": (2, 256, 16, 64),
    "empty_ball": (2, 256, 16, 16),
    "full_ball": (2, 384, 16, 64),
    "coincident": (2, 256, 16, 64),
    "masked_points": (2, 256, 16, 64),
    "masked_cloud": (2, 256, 16, 64),
    "masked_centroids": (2, 256, 16, 16),
    "on_radius": (1, 160, 2, 64),
    "bucket_overflow": (1, 1280, 2, 64),
}
BOUNDARY_POINTS = 24  # on_radius: points on the sphere, every 5th index
# bucket_overflow: the points of one residue class (index mod 128) near
# centroid 0, more of them than the Pallas kernel keeps of one bucket
OVERFLOW_BUCKET, PALLAS_BUCKET_CAP = 5, 8
# cases where the Pallas kernel drops neighbours by design (ROADMAP C)
PALLAS_DIVERGES = ("bucket_overflow",)


def r2() -> np.float32:
    return np.float32(RADIUS) * np.float32(RADIUS)


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
    ``center``, where the contracted sum and the rounded one disagree on
    d2 <= r2."""
    out = []
    while len(out) < count:
        u = rng.normal(size=(4096, 3))
        p = (center.astype(np.float64) + RADIUS * u / np.linalg.norm(u, axis=1, keepdims=True))
        p = p.astype(np.float32)
        d = p - center
        flip = (separate_d2(d) <= r2()) != (fma_d2(d) <= r2())
        out.extend(p[flip])
    return np.stack(out[:count])


def query_case(name: str, seed: int = 0):
    """(centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N), k)
    float32 and bool, for ``name``:

    - n1 .. n300: gaussian clouds, the second with its first 3/4 valid;
    - few_in_radius: the cloud spread fourfold, fewer than K in most balls;
    - empty_ball: every other centroid 100 away from the cloud;
    - full_ball: the cloud shrunk twenty-fold, all of it inside every ball;
    - coincident: every point repeated four times at one place;
    - masked_points: every other point masked, at its place in the cloud;
    - masked_cloud: every point of the second cloud masked;
    - masked_centroids: every third centroid masked;
    - on_radius: every 5th point on the sphere around centroid 0, where a
      fused multiply-add would flip the test;
    - bucket_overflow: centroid 0 far from the cloud, with the points of
      residue OVERFLOW_BUCKET around it: its first hits all share a bucket.
    """
    b, n, m, k = CASES[name]
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32)
    mask = np.ones((b, n), bool)
    if b > 1:
        mask[1, max(1, 3 * n // 4):] = False
    if name == "few_in_radius":
        pos *= 4.0
    elif name == "full_ball":
        pos *= 0.05
    elif name == "coincident":
        pos = np.repeat(pos[:, ::4], 4, axis=1)[:, :n].copy()
    elif name == "masked_points":
        mask[:, ::2] = False
    elif name == "masked_cloud":
        mask[1] = False
    centers = pos[:, np.arange(m) % n].copy()
    cmask = np.ones((b, m), bool)
    if name == "empty_ball":
        centers[:, ::2] += 100.0
    elif name == "masked_centroids":
        cmask[:, ::3] = False
    elif name == "on_radius":
        centers[0, 0] = np.float32([0.25, -0.5, 0.125])
        pos[0, ::5][:BOUNDARY_POINTS] = boundary_points(centers[0, 0], BOUNDARY_POINTS, rng)
    elif name == "bucket_overflow":
        centers[0, 0] = np.float32([50.0, 50.0, 50.0])
        sel = np.arange(OVERFLOW_BUCKET, n, 128)
        pos[0, sel] = centers[0, 0] + 0.1 * rng.normal(size=(len(sel), 3)).astype(np.float32)
    return centers, cmask, pos, mask, k


def first_k_reference(centers, cmask, pos, mask, k: int):
    """The selection in numpy, every operation of the test rounded on its own:
    (idx (B, M, k) int32, 0 where invalid; nbr_mask (B, M, k))."""
    b, m, _ = centers.shape
    d2 = separate_d2(pos[:, None, :, :] - centers[:, :, None, :])  # (B, M, N)
    ok = (d2 <= r2()) & mask[:, None, :] & cmask[:, :, None]
    idx = np.zeros((b, m, k), np.int32)
    valid = np.zeros((b, m, k), bool)
    for bi in range(b):
        for i in range(m):
            hits = np.flatnonzero(ok[bi, i])[:k]
            idx[bi, i, :len(hits)] = hits
            valid[bi, i, :len(hits)] = True
    return idx, valid
