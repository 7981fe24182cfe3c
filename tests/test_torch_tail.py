"""Kernel 7, the fused tail (last Linear + masked max over the 64 slots): the
port's ``fused_tail`` on CPU tensors (its plain versions) against the JAX
package's ``fused_tail`` in interpret mode and ``jax.grad`` of it, on the
cases of tests/test_pallas_tail.py, one at SA2's channel widths, and the
argmax (64 on a row with no valid slot)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.ops.pallas_tail import _run_fwd
from dl_biomass_tpu.ops.pallas_tail import fused_tail as jax_fused_tail
from dl_biomass_tpu_torch.ops import tail_kernel

torch.set_num_threads(1)

# (B, M, C2, C3): the JAX test's shape, its unaligned M, and SA2's channels
CASES = {"jax_test": (2, 32, 64, 128), "unaligned_m": (2, 20, 64, 128), "sa2": (1, 8, 128, 256)}


def _data(case):
    b, m, c2, c3 = CASES[case]
    rng = np.random.default_rng(0)
    a2 = rng.normal(size=(b, m, 64, c2)).astype(np.float32)
    mask = rng.random(size=(b, m, 64)) > 0.3
    mask[0, 3] = False  # an all-invalid row exercises the empty-slot fill
    w3 = (rng.normal(size=(c2, c3)) * 0.1).astype(np.float32)
    b3 = (rng.normal(size=(c3,)) * 0.1).astype(np.float32)
    return a2, mask, w3, b3


_JAX = {}


def _jax_forward(case):
    """JAX's (out, argmax) in interpret mode, once per case."""
    if case not in _JAX:
        a2, mask, w3, b3 = _data(case)
        out, am = _run_fwd(jnp.asarray(a2, jnp.bfloat16), jnp.asarray(mask), jnp.asarray(w3),
                           jnp.asarray(b3), with_argmax=True, interpret=True)
        _JAX[case] = np.asarray(out, np.float32), np.asarray(am)
    return _JAX[case]


def _port(a2, mask, w3, b3):
    t = torch.from_numpy
    args = (t(a2).to(torch.bfloat16), t(mask), t(w3), t(b3))
    out, am = tail_kernel.fused_tail_fwd(*args, with_argmax=True)
    assert out.dtype == torch.bfloat16 and am.dtype == torch.int32
    assert torch.equal(tail_kernel.fused_tail(*args), out)
    return out.float().numpy(), am.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_argmax_match_jax(case):
    want, want_am = _jax_forward(case)
    got, got_am = _port(*_data(case))
    b, m, _, c3 = *CASES[case][:2], 64, CASES[case][3]
    assert got.shape == (b, m, c3)
    if case == "sa2":
        # 128-deep float32 sums in another order (torch's CPU GEMM, XLA's dot):
        # a value at a bf16 rounding boundary may round one step (2^-8 of it)
        # the other way; where the max agrees, so does its first slot
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0)
        same = got == want
        assert same.mean() > 0.99
        np.testing.assert_array_equal(got_am[same], want_am[same])
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_am, want_am)
    # the empty row: 0 out, argmax 64 (the JAX rule, not first_argmax's 0)
    np.testing.assert_array_equal(got[0, 3], 0.0)
    np.testing.assert_array_equal(got_am[0, 3], 64)


@pytest.mark.parametrize("junk", [1e4, np.nan, np.inf])
def test_junk_at_invalid_slots_is_ignored(junk):
    a2, mask, w3, b3 = _data("jax_test")
    want, want_am = _jax_forward("jax_test")
    got, got_am = _port(np.where(mask[..., None], a2, np.float32(junk)), mask, w3, b3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_am, want_am)


def _grads(case, ct):
    """(port, JAX) gradients in a2, w3, b3 of sum(fused_tail(...) * ct)."""
    a2, mask, w3, b3 = _data(case)
    leaves = [torch.from_numpy(a2).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(w3).requires_grad_(), torch.from_numpy(b3).requires_grad_()]
    out = tail_kernel.fused_tail(leaves[0], torch.from_numpy(mask), leaves[1], leaves[2])
    (out.float() * torch.from_numpy(ct)).sum().backward()
    jm = jnp.asarray(mask)

    def loss(a, w, b):
        return jnp.sum(jax_fused_tail(a, jm, w, b, True) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a2, jnp.bfloat16), jnp.asarray(w3),
                                             jnp.asarray(b3))
    got = [leaves[0].grad, leaves[1].grad, leaves[2].grad]
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    return [g.float().numpy() for g in got], [np.asarray(w, np.float32) for w in want], mask


@pytest.mark.parametrize("case", ["jax_test", "sa2"])
def test_grads_match_jax(case):
    b, m, _, c3 = CASES[case]
    ct = np.random.default_rng(1).normal(size=(b, m, c3)).astype(np.float32)
    got, want, mask = _grads(case, ct)
    # the JAX test's own tolerances: da2 routed to the same argmax slots; dW3
    # and db3 float32 sums in another order
    np.testing.assert_allclose(got[0], want[0], rtol=0.02, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0.02, atol=1e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=0.02, atol=1e-2)
    assert np.all(got[0][~mask] == 0.0)  # no gradient to invalid slots, exactly


def test_backward_routes_to_the_argmax_slot_only():
    """The plain backward on its own: each column's bf16 cotangent at its
    argmax row; argmax 64 routes nothing; dW3 = a2^T gs."""
    a2, mask, w3, b3 = _data("unaligned_m")
    a2t = torch.from_numpy(a2).to(torch.bfloat16)
    _, am = tail_kernel.fused_tail_fwd(a2t, torch.from_numpy(mask), torch.from_numpy(w3),
                                       torch.from_numpy(b3), with_argmax=True)
    gb = torch.from_numpy(np.random.default_rng(2).normal(size=am.shape).astype(np.float32))
    gb = gb.to(torch.bfloat16)
    da2, dw3 = tail_kernel.fused_tail_bwd(a2t, gb, am, torch.from_numpy(w3))
    gs = np.zeros((*am.shape[:2], 65, am.shape[2]), np.float32)
    bi, mi, ci = np.indices(am.shape)
    gs[bi, mi, am.numpy(), ci] = gb.float().numpy()
    gs = gs[:, :, :64]
    w3b = torch.from_numpy(w3).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(da2.float().numpy(), gs @ w3b.T, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(dw3.numpy(), np.einsum("bmkc,bmkd->cd", a2t.float().numpy(), gs),
                               rtol=1e-4, atol=1e-4)
    assert np.all(da2.float().numpy()[0, 3] == 0.0)


def _nan_case(where):
    """The JAX test's data with NaN in a2 at valid slots: "one" puts a NaN in
    one feature of valid slot 5 of centroid (0, 0) (so every column of that
    centroid is NaN there), "every" one in each valid slot of centroid (1, 2)."""
    a2, mask, w3, b3 = _data("jax_test")
    a2 = a2.copy()
    if where == "one":
        mask[0, 0, 5] = True
        a2[0, 0, 5, 3] = np.nan
    else:
        a2[1, 2, mask[1, 2], 7] = np.nan
    return a2, mask, w3, b3


@pytest.mark.parametrize("where", ["one", "every"])
def test_nan_at_valid_slots_matches_jax(where):
    """A column whose max is NaN: out NaN and argmax 64, as the TPU kernel
    takes ``jnp.max`` (NaN-propagating) and then the first slot equal to it
    (none); every other centroid as without the NaN."""
    a2, mask, w3, b3 = _nan_case(where)
    out, am = _run_fwd(jnp.asarray(a2, jnp.bfloat16), jnp.asarray(mask), jnp.asarray(w3),
                       jnp.asarray(b3), with_argmax=True, interpret=True)
    want, want_am = np.asarray(out, np.float32), np.asarray(am)
    t = torch.from_numpy
    args = (t(a2).to(torch.bfloat16), t(mask), t(w3), t(b3))
    got, got_am = tail_kernel.fused_tail_fwd(*args, with_argmax=True)
    assert torch.equal(tail_kernel.fused_tail(*args).isnan(), got.isnan())
    got, got_am = got.float().numpy(), got_am.numpy()
    bm = (0, 0) if where == "one" else (1, 2)
    assert np.isnan(want[bm]).all() and (want_am[bm] == 64).all()
    np.testing.assert_array_equal(got, want)  # NaN where JAX's is NaN
    np.testing.assert_array_equal(got_am, want_am)
    clean, clean_am = _jax_forward("jax_test")
    others = np.ones(mask.shape[:2], bool)
    others[bm] = False
    np.testing.assert_array_equal(got[others], clean[others])
    np.testing.assert_array_equal(got_am[others], clean_am[others])


@pytest.mark.parametrize("where", ["one", "every"])
def test_nan_at_valid_slots_grads_match_jax(where):
    """The NaN centroid routes nothing (argmax 64), though its cotangent is
    finite: da2 is 0 there, db3 leaves its columns out, and dW3 holds the NaN
    that the dense a2^T gs makes of 0 x NaN, as JAX's does."""
    a2, mask, w3, b3 = _nan_case(where)
    b, m, _, c3 = CASES["jax_test"]
    ct = np.random.default_rng(1).normal(size=(b, m, c3)).astype(np.float32)
    leaves = [torch.from_numpy(a2).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(w3).requires_grad_(), torch.from_numpy(b3).requires_grad_()]
    out = tail_kernel.fused_tail(leaves[0], torch.from_numpy(mask), leaves[1], leaves[2])
    (out.float() * torch.from_numpy(ct)).sum().backward()  # a NaN loss, finite cotangent
    jm = jnp.asarray(mask)

    def loss(a, w, bb):
        return jnp.sum(jax_fused_tail(a, jm, w, bb, True) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a2, jnp.bfloat16), jnp.asarray(w3),
                                             jnp.asarray(b3))
    got = [t.grad.float().numpy() for t in leaves]
    want = [np.asarray(w, np.float32) for w in want]
    bm = (0, 0) if where == "one" else (1, 2)
    assert (got[0][bm] == 0.0).all() and np.isnan(want[1]).any()
    np.testing.assert_allclose(got[0], want[0], rtol=0.02, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0.02, atol=1e-2)  # NaN rows equal
    np.testing.assert_allclose(got[2], want[2], rtol=0.02, atol=1e-2)
    assert np.isfinite(got[2]).all()


@pytest.mark.parametrize("junk", [1e4, np.nan, np.inf])
def test_junk_at_invalid_slots_grads_match_jax(junk):
    """Junk at every invalid slot through the backward: the forward masks it,
    but the dense a2^T gs of the TPU kernel makes 0 x NaN and 0 x Inf into
    NaN, so with NaN or Inf junk every dW3 entry is NaN in ``jax.grad`` and in
    the port; with 1e4 junk both are finite and agree. da2 and db3 never see
    the junk."""
    a2, mask, w3, b3 = _data("jax_test")
    a2 = np.where(mask[..., None], a2, np.float32(junk))
    b, m, _, c3 = CASES["jax_test"]
    ct = np.random.default_rng(1).normal(size=(b, m, c3)).astype(np.float32)
    leaves = [torch.from_numpy(a2).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(w3).requires_grad_(), torch.from_numpy(b3).requires_grad_()]
    out = tail_kernel.fused_tail(leaves[0], torch.from_numpy(mask), leaves[1], leaves[2])
    (out.float() * torch.from_numpy(ct)).sum().backward()
    jm = jnp.asarray(mask)

    def loss(a, w, bb):
        return jnp.sum(jax_fused_tail(a, jm, w, bb, True) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a2, jnp.bfloat16), jnp.asarray(w3),
                                             jnp.asarray(b3))
    got = [t.grad.float().numpy() for t in leaves]
    want = [np.asarray(w, np.float32) for w in want]
    assert np.isnan(want[1]).all() == (not np.isfinite(junk))
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0.02, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0.02, atol=1e-2)  # NaN where JAX's is
    np.testing.assert_allclose(got[2], want[2], rtol=0.02, atol=1e-2)
    assert np.all(got[0][~mask] == 0.0)


def _routed_bwd(a2, gb, am, w3):
    """The backward as csrc/fused_tail.cu forms it, in float32: da2 of slot r
    the sum over its bucket (the columns whose argmax is r) of gb[c] W3[:, c],
    dW3 the routed terms a2[am[c], j] gb[c]; then the NaN that the dense sums
    make of 0 x NaN and 0 x Inf, from counts: per feature j, N_j (the slots
    of a centroid whose a2 is not finite) less the routed slot's own for
    dW3, and W3's non-finite values on j less the bucket's for da2."""
    a, g = a2.float(), gb.float()
    w = w3.to(torch.bfloat16).float()
    b, m, k, c2 = a.shape
    slot = torch.arange(k).view(1, 1, k, 1)
    bucket = am.long().unsqueeze(2) == slot  # (B, M, 64, C3): column c routed to slot r
    terms = torch.where(bucket.unsqueeze(3), g[:, :, None, None, :] * w, 0.0)
    da2 = terms.sum(-1)
    w_bad = ~w.isfinite()
    in_bucket = (bucket.unsqueeze(3) & w_bad).sum(-1)  # (B, M, 64, C2)
    da2 = torch.where(w_bad.sum(1) - in_bucket > 0, float("nan"), da2)
    routed = am < k
    rows = am.long().clamp(max=k - 1)
    ar = torch.gather(a, 2, rows.unsqueeze(-1).expand(b, m, am.shape[2], c2))  # (B, M, C3, C2)
    term = torch.where(routed.unsqueeze(-1), ar * g.unsqueeze(-1), 0.0)
    n_bad = (~a.isfinite()).sum(2)  # (B, M, C2)
    own = routed.unsqueeze(-1) & ~ar.isfinite()
    term = torch.where(n_bad.unsqueeze(2) - own.int() > 0, float("nan"), term)
    return da2.to(torch.bfloat16), term.sum((0, 1)).t()


@pytest.mark.parametrize("where", ["unrouted", "invalid", "routed", "cotangent", "w3", "all"])
def test_routed_formulation_keeps_the_dense_sums_nonfinite_values(where):
    """The kernel's routed formulation (``_routed_bwd``) against the plain,
    dense backward with NaN and +-Inf in a2 at slots no column routes to
    (valid or invalid: an argmax never names an invalid slot), at routed
    slots, in the cotangent and in W3: NaN, +Inf and -Inf at the same
    positions, the finite values equal to float32 rounding."""
    rng = np.random.default_rng(4)
    b, m, c2, c3 = 2, 8, 16, 32
    a2 = torch.from_numpy(rng.normal(size=(b, m, 64, c2)).astype(np.float32)).to(torch.bfloat16)
    am = torch.from_numpy(rng.integers(0, 48, size=(b, m, c3)).astype(np.int32))
    am[0, 1, :5] = 64  # columns that route nothing
    am[1, 2] = 64  # a centroid that routes nothing (a NaN max)
    gb = torch.from_numpy(rng.normal(size=(b, m, c3)).astype(np.float32)).to(torch.bfloat16)
    w3 = torch.from_numpy((rng.normal(size=(c2, c3)) * 0.1).astype(np.float32))
    nan, inf = float("nan"), float("inf")
    if where in ("unrouted", "all"):  # slots 48-63 take no column: valid but unrouted
        a2[0, 0, 50, 3], a2[1, 5, 60, 7], a2[1, 2, 0, 9] = nan, inf, -inf
    if where in ("invalid", "all"):
        a2[0, 3, 63, 1] = nan
        a2[1, 1, 62, 5] = -inf
    if where in ("routed", "all"):
        r = int(am[0, 4, 6])
        a2[0, 4, r, 2], a2[1, 6, int(am[1, 6, 0]), 11] = inf, nan
        a2[0, 5, int(am[0, 5, 3]), 4] = 0.0
        gb[0, 5, 3] = inf  # 0 x Inf at a routed slot
    if where in ("cotangent", "all"):
        gb[0, 0, 1], gb[1, 3, 7], gb[0, 1, 2] = nan, -inf, nan  # the last routes nothing
    if where in ("w3", "all"):
        w3[5, 9], w3[12, 20], w3[0, 3] = inf, nan, 0.0
        gb[1, 4, 3] = inf  # Inf x 0 in da2
    got = _routed_bwd(a2, gb, am, w3)
    want = tail_kernel.fused_tail_bwd_plain(a2, gb, am, w3)
    assert any(bool((~t.float().isfinite()).any()) for t in want)
    for g_, w_ in zip(got, want):
        g_, w_ = g_.float(), w_.float()
        assert torch.equal(g_.isnan(), w_.isnan())
        assert torch.equal(g_.isposinf(), w_.isposinf())
        assert torch.equal(g_.isneginf(), w_.isneginf())
        ok = w_.isfinite()
        scale = float(w_[ok].abs().max())
        assert float((g_[ok] - w_[ok]).abs().max()) <= 1e-2 * scale  # bf16 da2; f32 dW3
