"""The fused SA layer's bf16 gradients at neuron_multiplier 2 and 3 depart from
its float32 gradients by design, in the JAX package as in the port.

On an H100, a bf16 ``fused_sa`` step on the kernels left the same step on the
plain versions by 0.48 (x2) and 0.42 (x3) in relative L2 norm at B=4, past
the 0.35 bound that ``chip_smoke.py`` holds at B=16. Both sides round every
hidden activation to bf16, in another summation order. Here the JAX
package's ``fused_sa_mlp`` (interpret mode, ``jax.grad``) in bf16 is held
against its own float32 at the widths of neuron_multiplier 2 and 3, and the
port's plain version likewise, on the same numpy inputs (B=1, M=8): JAX's
own bf16 leaves its float32 by 0.10-0.16 per layer, the port's by as much
(equal to the fourth digit), so the step's departure is bf16 rounding that
the reference shares, not a fault of the port.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from dl_biomass_tpu_torch.ops import sa_train_kernel
from test_torch_sa_train_bwd import PARAMS, _jax_grads, _torch_grads
from test_torch_sa_widths import FORMS, _case, _model_widths

# the port's bf16-vs-f32 departure may exceed JAX's by at most this factor
# (measured: equal to four digits); JAX's own is at least JAX_FLOOR
FACTOR, JAX_FLOOR = 1.1, 0.05
# b1 and b2 feed a train-mode BatchNorm, so their true gradient is 0
ZERO = ("b1", "b2")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _departure(grads):
    """Largest relative L2 norm of bf16 gradient minus f32 gradient, over the
    gradients that are not 0."""
    return max(_rel_l2(grads[True][k], grads[False][k]) for k in grads[False] if k not in ZERO)


@pytest.mark.parametrize("layer", ["SA1", "SA2"])
@pytest.mark.parametrize("nm", [2, 3])
def test_bf16_departs_from_f32_as_far_as_in_jax(nm, layer):
    cd, cp = FORMS[layer](nm)
    widths = _model_widths(nm)[layer]
    dense, planes, mask, p = _case(20 + cd, cd, cp, widths)
    r = np.random.default_rng(21).normal(size=(1, 8, widths[-1])).astype(np.float32)
    jax_g, port_g = {}, {}
    for bf16 in (False, True):
        jd, jg = _jax_grads(dense, planes, mask, p, None, r, "ReLU", bf16, True)
        jax_g[bf16] = {k: np.asarray(jg[k], np.float64) for k in PARAMS}
        td, tg = _torch_grads(sa_train_kernel.fused_sa_mlp_plain, dense, planes, mask, p, None,
                              r, "ReLU", bf16, True)
        port_g[bf16] = {k: tg[k].double().numpy() for k in PARAMS}
        if td is not None:
            jax_g[bf16]["dense"] = np.asarray(jd.astype(jnp.float32), np.float64)
            port_g[bf16]["dense"] = td.grad.double().numpy()
    jax_dep, port_dep = _departure(jax_g), _departure(port_g)
    assert jax_dep >= JAX_FLOOR, jax_dep
    assert port_dep <= FACTOR * jax_dep, (port_dep, jax_dep)
