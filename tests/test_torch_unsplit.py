"""Kernel 4c and the unsplit SA2 path (``split_first_layer=False``): the
two-table gather against ``mxu_gather(..., aux=)`` in interpret mode (values,
zeros for out-of-range indices, the values' gradient and none for aux), SA2
alone, the model's eval forward and the serving engine against the JAX
package with the same flags."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.inference import compile_inference as jax_compile_inference
from dl_biomass_tpu.models.pointnet2 import SAModule as JaxSAModule
from dl_biomass_tpu.ops.pallas_mxu_gather import mxu_gather
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import SAModule
from dl_biomass_tpu_torch.ops import gather_kernel
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

B, N, M, C = 2, 300, 37, 24


def _tables(seed):
    """bf16-exact values (B, N, C), f32 aux (B, N, 3) and an index (B, M, 64)
    with out-of-range entries on both sides."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, N, C)).astype(jnp.bfloat16)
    aux = (rng.normal(size=(B, N, 3)) * 7).astype(np.float32)
    idx = rng.integers(-2, N + 2, size=(B, M, 64)).astype(np.int32)
    return values, aux, idx


def test_aux_gather_is_bit_exact_against_mxu_gather():
    values, aux, idx = _tables(0)
    jv, ja = mxu_gather(jnp.asarray(values), jnp.asarray(idx), aux=jnp.asarray(aux),
                        interpret=True)
    tv = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    gv, ga = gather_kernel.gather_rows(tv, torch.from_numpy(idx), aux=torch.from_numpy(aux))
    assert gv.dtype == torch.bfloat16 and ga.dtype == torch.float32
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(jv, np.float32))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    out = (idx < 0) | (idx >= N)
    assert out.any() and (gv.float().numpy()[out] == 0).all() and (ga.numpy()[out] == 0).all()
    plain = gather_kernel.gather_rows_aux_plain(tv, torch.from_numpy(idx), torch.from_numpy(aux))
    assert torch.equal(plain[0], gv) and torch.equal(plain[1], ga)


def test_aux_gather_gradient_goes_to_the_values_only():
    """Integer cotangents keep every sum exact, whatever its order: the values'
    gradient equals jax.grad's, and aux gets none (zeros in JAX)."""
    values, aux, idx = _tables(1)
    rng = np.random.default_rng(2)
    wv = rng.integers(-3, 4, size=(B, M, 64, C)).astype(np.float32)
    wa = rng.integers(-3, 4, size=(B, M, 64, 3)).astype(np.float32)
    vals32 = values.astype(np.float32)

    def f(v, a):
        gv, ga = mxu_gather(v, jnp.asarray(idx), aux=a, interpret=True)
        return jnp.sum(gv * wv) + jnp.sum(ga * wa)

    jdv, jda = jax.grad(f, argnums=(0, 1))(jnp.asarray(vals32), jnp.asarray(aux))
    tv = torch.from_numpy(vals32).requires_grad_()
    ta = torch.from_numpy(aux).requires_grad_()
    gv, ga = gather_kernel.gather_rows(tv, torch.from_numpy(idx), aux=ta)
    assert not ga.requires_grad
    ((gv * torch.from_numpy(wv)).sum() + (ga * torch.from_numpy(wa)).sum()).backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jdv))
    assert ta.grad is None and not np.asarray(jda).any()


def test_sa2_unsplit_gathers_through_the_aux_table_like_jax():
    """SA2 alone with split_first_layer=False on 1024 points of 128 features:
    one two-table gather, and the JAX module's output at f32."""
    n = 1024
    rng = np.random.default_rng(n)
    pos = (rng.normal(size=(1, n, 3)) * 4).astype(np.float32)
    feat = rng.normal(size=(1, n, 128)).astype(np.float32)
    mask = np.arange(n)[None] < n - 200
    args = jnp.asarray(feat), jnp.asarray(pos), jnp.asarray(mask)
    jsa = JaxSAModule(0.25, 8.0, [131, 128, 128, 256], use_pallas=True, fast_fps=True,
                      split_first_layer=False)
    v = jsa.init(jax.random.key(0), *args, train=False)
    want = [np.asarray(w) for w in jsa.apply(v, *args, train=False)]
    sa = SAModule(0.25, 8.0, [131, 128, 128, 256], fast_fps=True, split_first_layer=False)
    sa.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
    with torch.no_grad(), mock.patch.object(gather_kernel, "gather_rows_aux",
                                            wraps=gather_kernel.gather_rows_aux) as g:
        got = sa(torch.from_numpy(feat), torch.from_numpy(pos), torch.from_numpy(mask))
    assert g.call_count == 1
    for a, b in zip(got, want):
        assert np.abs(a.numpy().astype(np.float64) - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("preset,dtype,rtol", [
    ("production", "float32", F32_RTOL),
    ("production", "bfloat16", BF16_RTOL),
    ("parity", "float32", F32_RTOL),
    ("parity", "bfloat16", BF16_RTOL),
])
def test_unsplit_model_forward_matches_jax(preset, dtype, rtol):
    jb, tb = batches(6, 2, 640, [640, 517])
    jm, v, tm = models(preset, dtype, jb, split_first_layer=False)
    want = np.asarray(jm.apply(v, jb, train=False))
    with torch.no_grad():
        got = tm(tb)
    assert rel_err(got.numpy(), want) <= rtol


@pytest.mark.parametrize("preset,dtype,rtol,valid", [
    ("production", "float32", F32_RTOL, [640, 517]),
    ("production", "bfloat16", BF16_RTOL, [640, 517]),
    ("production", "float32", F32_RTOL, [640, 300, 129]),  # a ragged mask
    ("parity", "float32", F32_RTOL, [640, 517]),
])
def test_unsplit_engine_matches_jax_engine(preset, dtype, rtol, valid):
    jb, tb = batches(7, len(valid), 640, valid)
    jm, v, tm = models(preset, dtype, jb, split_first_layer=False)
    want = np.asarray(jax_compile_inference(jm, v)(jb))
    with mock.patch.object(gather_kernel, "gather_rows_aux",
                           wraps=gather_kernel.gather_rows_aux) as g:
        got = compile_inference(tm, device="cpu")(tb)
    assert g.call_count == 1
    assert rel_err(got.numpy(), want) <= rtol
