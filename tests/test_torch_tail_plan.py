"""Kernel 7's launches. The forward's, ``ops/tail_kernel.plan``: the kind
(wgmma, or mma.sync with W3 in registers or in shared memory), warps, ring
stages, shared memory and registers it names at tail_bench's widths and at
the edges, the wrapper's refusal where it names none, and every width the
first kernel took (its W3^T and two buffers within a block's shared memory)
still planned. The backward's, ``bwd_plan``: its feature and column groups,
stages and shared memory at the card tests' widths and the forward's edges,
a launch at every width the forward takes, and the refusals (the wrapper's,
and ``fused_tail``'s before its forward)."""

from unittest import mock

import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.ops import tail_kernel as k7

SMEM = 232448  # a block's shared memory on an H100


def first_kernel_took(c2: int, c3: int) -> bool:
    """The widths the first forward kernel launched: C2 a multiple of 16, C3
    of 32, W3^T in bf16 (C3 rows of C2 + 8), b3 and two buffers of 64 rows of
    C2 + 8 bf16 and 64 flags within a block."""
    return (c2 % 16 == 0 and c3 % 32 == 0 and c2 > 0 and c3 > 0
            and 2 * c3 * (c2 + 8) + 4 * c3 + 2 * (128 * (c2 + 8) + 64) <= SMEM)


@pytest.mark.parametrize("c2,c3,want", [
    (64, 128, k7.Plan("wgmma", 8, 4, 50944, 32)),  # SA1: wgmma, two warpgroups
    (128, 256, k7.Plan("wgmma", 8, 2, 100480, 64)),  # SA2: two stages, two blocks an SM
    (64, 256, k7.Plan("mma", 8, 4, 75008, 72)),  # no wgmma instantiation
    (16, 32, k7.Plan("mma", 1, 4, 14208, 72)),  # the narrowest: one warp
    (96, 160, k7.Plan("mma", 5, 4, 87424, 72)),
    (64, 512, k7.Plan("mma", 8, 4, 112896, 72)),  # more slices than warps
    (256, 256, k7.Plan("mma", 8, 2, 203904, 72)),  # two stages fit, three do not
])
def test_plan_at_named_widths(c2, c3, want):
    p = k7.plan(c2, c3)
    assert p == want
    assert p.smem_bytes == k7.smem_bytes(c2, c3, p.kind, p.stages) <= SMEM
    assert p.registers <= 255 - 64  # fragments and accumulators leave room for the rest


@pytest.mark.parametrize("c2", [16, 64, 128, 256, 512, 704])
def test_widest_c3_planned_at_each_c2(c2):
    """The widest C3 the plan takes at each C2 fits with two stages, and the
    next one does not."""
    c3 = max(c for c in range(32, 8192, 32) if k7.plan(c2, c) is not None)
    p = k7.plan(c2, c3)
    assert p.stages >= 2 and p.smem_bytes <= SMEM
    assert k7.smem_bytes(c2, c3 + 32, "mma", 2) > SMEM and k7.plan(c2, c3 + 32) is None


def test_plan_takes_every_width_the_first_kernel_took():
    took = [(c2, c3) for c2 in range(16, 1024, 16) for c3 in range(32, 4608, 32)
            if first_kernel_took(c2, c3)]
    assert len(took) > 600
    for c2, c3 in took:
        p = k7.plan(c2, c3)
        assert p is not None, (c2, c3)
        assert 2 <= p.stages <= k7.MAX_STAGES and p.smem_bytes <= SMEM
        if p.kind == "wgmma":
            assert (c2, c3) in ((64, 128), (128, 256)) and p.warps == 8
        else:
            assert p.kind == "mma" and 1 <= p.warps <= min(8, c3 // 32)
    # and nothing the first kernel refused: its two buffers were the least
    for c2, c3 in [(720, 32), (16, 4352), (64, 1472)]:
        assert not first_kernel_took(c2, c3) and k7.plan(c2, c3) is None


@pytest.mark.parametrize("c2,c3", [(8, 32), (24, 32), (64, 48), (64, 0), (720, 32), (64, 1472)])
def test_wrapper_refuses_widths_the_plan_does_not_take(c2, c3):
    """Off the CPU the wrapper plans before it launches, and raises
    ValueError where the plan gives None (meta tensors stand in for the
    card's; on the CPU the plain version takes any width)."""
    a2 = torch.empty((1, 2, 64, c2), dtype=torch.bfloat16, device="meta")
    mask = torch.empty((1, 2, 64), dtype=torch.bool, device="meta")
    w3, b3 = torch.empty((c2, c3), device="meta"), torch.empty((c3,), device="meta")
    assert k7.plan(c2, c3) is None
    with pytest.raises(ValueError, match="takes no widths"):
        k7.fused_tail_fwd(a2, mask, w3, b3)
    with pytest.raises(ValueError, match="takes no widths"):
        k7.probe(a2, mask, w3, b3, "stage_only")


def test_wrapper_plans_then_wants_a_card():
    a2 = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device="meta")
    mask = torch.empty((1, 2, 64), dtype=torch.bool, device="meta")
    w3, b3 = torch.empty((64, 128), device="meta"), torch.empty((128,), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        k7.fused_tail_fwd(a2, mask, w3, b3, with_argmax=True)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        k7.probe(a2, mask, w3, b3, "compute_only")


def least_rounding_to(zb: np.ndarray) -> np.ndarray:
    """csrc/fused_tail.cu's least_rounding_to, in numpy: the f32 bits of the
    least float whose bf16 rounding equals the bf16 value of bits zb."""
    f = zb << 16
    bits = np.where(zb & 0x8000, f + 0x8000 - (zb & 1), f - 0x8000 + (zb & 1))
    return np.where((zb & 0x7FFF) == 0, np.uint32(0x80008000), bits).astype(np.uint32)


def test_argmax_threshold_is_the_least_float_rounding_to_the_max():
    """The wgmma argmax takes a slot where acc + b3 is at least
    least_rounding_to(max): for every bf16 value but NaN and -inf (those give
    argmax 64 on their own), that float rounds to the value (torch's
    round-to-nearest-even, -0.0 == +0.0) and the float below it does not."""
    zb = np.arange(65536, dtype=np.uint32)
    z = torch.from_numpy(zb.astype(np.int32).astype(np.int16)).view(torch.bfloat16).float()
    low = torch.from_numpy(least_rounding_to(zb).view(np.float32))
    below = torch.nextafter(low, torch.tensor(float("-inf")))
    ok = ~torch.isnan(z) & (z != float("-inf"))
    assert int(ok.sum()) == 65536 - 2 * 127 - 1  # the NaN patterns and -inf left out
    assert bool((low.to(torch.bfloat16).float() == z)[ok].all())
    assert not bool((below.to(torch.bfloat16).float() == z)[ok].any())


# the widths the card tests run (tests/test_torch_cuda.py TAIL_WIDTHS), and the
# forward plan's edges: the widest C3 at C2 = 64, the widest C2 at C3 = 32
# and the two-stage widths of test_plan_at_named_widths
@pytest.mark.parametrize("c2,c3,want", [
    (16, 32, k7.BwdPlan(256, 1, 1, 4, 15744, 16)),
    (64, 128, k7.BwdPlan(256, 1, 1, 4, 75264, 32)),  # SA1: three blocks an SM
    (128, 256, k7.BwdPlan(256, 2, 1, 4, 113152, 64)),  # SA2: two feature groups, two blocks
    (96, 160, k7.BwdPlan(256, 3, 1, 4, 47616, 32)),  # 32 features a group: 4 lanes a slot
    (704, 32, k7.BwdPlan(256, 11, 1, 4, 46848, 16)),
    (16, 4320, k7.BwdPlan(256, 2, 3, 2, 220160, 64)),  # column groups as well
    (64, 1440, k7.BwdPlan(256, 8, 1, 4, 111936, 64)),
    (256, 256, k7.BwdPlan(256, 4, 1, 4, 113152, 64)),
])
def test_bwd_plan_at_named_widths(c2, c3, want):
    p = k7.bwd_plan(c2, c3)
    assert p == want
    assert p.smem_bytes == k7.bwd_smem_bytes(c2, c3, p.groups_j, p.groups_c, p.stages) <= SMEM
    assert p.registers <= 64  # 8 features of at most 8 columns: room left in 128 registers
    # every (feature, column) of dW3 has one thread: J / 8 chunks, each over its columns
    j = c2 // p.groups_j
    jc = j // 8  # the lanes of a slot: a power of two, at most a warp
    assert j % 8 == 0 and jc <= 32 and jc & (jc - 1) == 0
    per_pass = p.threads // (j // 8)
    assert -(-(-(-c3 // p.groups_c)) // per_pass) * 8 <= p.registers


def test_bwd_plan_takes_every_width_the_forward_takes():
    """No width whose forward the kernel runs lacks a backward, so
    ``fused_tail`` under autograd never launches a forward whose backward
    it would refuse."""
    widths = [(c2, c3) for c2 in range(16, 1024, 16) for c3 in range(32, 4608, 32)
              if k7.plan(c2, c3) is not None]
    assert len(widths) > 600
    for c2, c3 in widths:
        p = k7.bwd_plan(c2, c3)
        assert p is not None, (c2, c3)
        assert 2 <= p.stages <= k7.BWD_MAX_STAGES and p.smem_bytes <= SMEM
        assert c2 % (8 * p.groups_j) == 0 and 1 <= p.groups_c <= 64


@pytest.mark.parametrize("c2,c3", [(8, 32), (24, 32), (64, 48), (64, 0), (0, 64)])
def test_bwd_wrapper_refuses_widths_the_plan_does_not_take(c2, c3):
    """Off the CPU the backward's wrapper plans before it launches, and raises
    ValueError where ``bwd_plan`` gives None (meta tensors stand in for the
    card's)."""
    a2 = torch.empty((1, 2, 64, c2), dtype=torch.bfloat16, device="meta")
    gb = torch.empty((1, 2, c3), dtype=torch.bfloat16, device="meta")
    am = torch.empty((1, 2, c3), dtype=torch.int32, device="meta")
    w3 = torch.empty((c2, c3), device="meta")
    assert k7.bwd_plan(c2, c3) is None
    for call in (lambda: k7.fused_tail_bwd_slices(a2, gb, am, w3),
                 lambda: k7.probe_bwd(a2, gb, am, w3, "stage_only")):
        with pytest.raises(ValueError, match="takes no widths"):
            call()


def test_bwd_wrapper_plans_then_wants_a_card():
    a2 = torch.empty((1, 2, 64, 96), dtype=torch.bfloat16, device="meta")
    gb = torch.empty((1, 2, 160), dtype=torch.bfloat16, device="meta")
    am = torch.empty((1, 2, 160), dtype=torch.int32, device="meta")
    w3 = torch.empty((96, 160), device="meta")
    with pytest.raises(RuntimeError, match="runs on cuda"):
        k7.fused_tail_bwd_slices(a2, gb, am, w3)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        k7.probe_bwd(a2, gb, am, w3, "stage_dw3")


def test_fused_tail_refuses_before_its_forward_where_the_backward_would():
    """Under autograd off the CPU, a width without a backward launch raises
    before the forward runs (none remain among the forward's widths: the
    refusal is forced here)."""
    a2 = torch.empty((1, 2, 64, 64), dtype=torch.bfloat16, device="meta", requires_grad=True)
    mask = torch.empty((1, 2, 64), dtype=torch.bool, device="meta")
    w3 = torch.empty((64, 128), device="meta", requires_grad=True)
    b3 = torch.empty((128,), device="meta", requires_grad=True)
    calls = []
    with mock.patch.object(k7, "bwd_plan", lambda *_: None), \
            mock.patch.object(k7, "fused_tail_fwd", lambda *a, **kw: calls.append(a)):
        with pytest.raises(ValueError, match="takes no widths"):
            k7.fused_tail(a2, mask, w3, b3)
    assert calls == []
