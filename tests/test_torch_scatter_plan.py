"""Kernel 4b, the gather's scatter-add backward: the launch ``scatter_plan``
names (``csrc/gather_bwd.cu`` mirrors it) and the plain version
(``scatter_rows_plain``, which the wrapper runs on a CPU tensor and the kernel
matches bit for bit) on the cases the model's index gives it: row 0 takes a
cloud's pad slots beside its true neighbours, a cloud with no contribution,
an N no multiple of 32, no rows at all. Each is held bit for bit against a
sequential numpy float32 loop in ascending flat-row order."""

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.ops import gather_kernel

torch.set_num_threads(1)


@pytest.mark.parametrize("r,n,want", [
    (32768, 2048, (16, 8, 81920)),  # SA2 of a 16 or 36 x 10240 step: 512 centroids x 64
    (32768, 4096, (16, 8, 147456)),  # the most SA1 centroids the gather takes
    (2368, 500, (2, 8, 32384)),
    (0, 5, (1, 8, 16544)),  # no rows: one block a cloud all the same
    (100, 25600, (1, 1, 118784)),  # the widest N: one warp
])
def test_plan_gives_each_launch(r, n, want):
    assert tuple(gather_kernel.scatter_plan(r, n)) == want


@pytest.mark.parametrize("n", [1, 31, 33, 1003, 2048, 4096, 6000, 12000, 25600])
def test_every_plan_fits_its_shared_memory(n):
    """The place block (keys, ranks, a histogram a warp) and the scan block
    (two arrays of N) fit PLACE_SMEM_BYTES, with as many warps as fit up to
    MAX_PLACE_WARPS."""
    p = gather_kernel.scatter_plan(32768, n)
    budget = gather_kernel.PLACE_SMEM_BYTES
    assert 1 <= p.warps <= gather_kernel.MAX_PLACE_WARPS
    assert p.smem_bytes == 4 * (2 * gather_kernel.CSR_ROWS + p.warps * n) <= budget
    assert 8 * n <= budget
    assert p.warps == gather_kernel.MAX_PLACE_WARPS or \
        4 * (2 * gather_kernel.CSR_ROWS + (p.warps + 1) * n) > budget


@pytest.mark.parametrize("r,n", [(10, 0), (-1, 5), (10, 25601)])
def test_plan_refuses_what_no_launch_takes(r, n):
    assert gather_kernel.scatter_plan(r, n) is None


def _sequential(ct, idx, n):
    """float32 sums in ascending flat-row order, one numpy addition at a time."""
    b, m, k, c = ct.shape
    out = np.zeros((b, n, c), np.float32)
    for i in range(b):
        for key, row in zip(idx[i].reshape(-1), ct[i].reshape(-1, c)):
            if 0 <= key < n:
                out[i, key] = out[i, key] + row
    return out


# (b, m, n, c) and how the index is made, as tests/test_torch_cuda.py holds the
# kernel to the plain version on the card
CASES = {"row0_500": (2, 20, 60, 8), "empty_cloud": (3, 6, 40, 8), "n_odd": (2, 9, 33, 24),
         "no_rows": (2, 0, 7, 8)}


def _case(name):
    b, m, n, c = CASES[name]
    rng = np.random.default_rng(len(name))
    ct = (rng.normal(size=(b, m, 64, c)) * np.exp(rng.normal(size=(b, m, 64, 1)) * 3)
          ).astype(np.float32)
    idx = rng.integers(-1, n + 1, size=(b, m, 64)).astype(np.int32)  # some out of range
    if name == "row0_500":  # row 0: true neighbours and about 500 pad slots
        idx[0, :, 40:] = 0
        idx[0, 14:] = 0
    if name == "empty_cloud":
        idx[1] = -1  # contributes nothing
        idx[2] = 0  # every slot a pad
    return ct, idx, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_sums_each_case_in_row_order(name, dtype):
    ct, idx, n = _case(name)
    if name == "row0_500":
        assert int((idx[0] == 0).sum()) >= 500
    tdt = getattr(torch, dtype)
    ct_t = torch.from_numpy(ct).to(tdt)
    got = gather_kernel.scatter_rows_plain(ct_t, torch.from_numpy(idx), n)
    want = _sequential(ct_t.float().numpy(), idx, n)
    assert got.dtype == tdt and tuple(got.shape) == (ct.shape[0], n, ct.shape[-1])
    assert torch.equal(got, torch.from_numpy(want).to(tdt))
    if name == "empty_cloud":
        assert not got[1].any()
