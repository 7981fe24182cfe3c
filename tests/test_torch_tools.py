"""The port's tools (``dl_biomass_tpu_torch.tools``) and their kernels on CPU
tensors: kernel 8's plain version against the JAX tool's ``stats_pallas``
(its Pallas body in interpret mode) and ``stats_current``, kernel 10's plain
version against the JAX probe's Pallas body, and each tool's ``main`` at cut
sizes on the CPU, and refusing to run without a card unless asked."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu_torch.tools import bn_stats_bench, dma_probe, tail_bench
from torch_port_helpers import interpreted as _interpreted, jax_tool as _jax_tool

torch.set_num_threads(1)


def test_stats_kernel_plain_matches_stats_pallas_and_stats_current():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 64, 64)).astype(np.float32)
    m3 = rng.random(size=(2, 32, 64)) > 0.1
    jt = _jax_tool("bn_stats_bench")
    jx, jm = jnp.asarray(x, jnp.bfloat16), jnp.asarray(m3)
    with _interpreted():
        pallas = [np.asarray(s) for s in jt.stats_pallas(jx, jm, mt=8)]
    current = [np.asarray(s) for s in jt.stats_current(jx, jm)]
    got = bn_stats_bench.stats_kernel(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(m3))
    for g, p, c in zip(got, pallas, current):
        assert g.dtype == torch.float32 and g.shape == (64,)
        g = g.numpy()
        # float32 sums of 131072 terms in three orders: 1e-5 of the largest
        assert np.abs(g - p).max() <= 1e-5 * np.abs(p).max()
        assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()


def test_block_copy_plain_matches_the_pallas_body():
    jt = _jax_tool("dma_probe")
    seen = {}

    def once(fn, x):  # one call of the jitted copy instead of the timing chain
        seen["x"], seen["out"] = np.asarray(x), np.asarray(fn(x))
        return 1.0

    with _interpreted(), mock.patch.object(jt, "_time_chained", once):
        jt.pallas_bandwidth(block_kb=1, blocks=2)
    assert seen["x"].shape == (2, 2, 128)
    got = dma_probe.block_copy(torch.from_numpy(seen["x"].copy()))
    np.testing.assert_array_equal(got.numpy(), seen["out"])


CUT = {
    tail_bench: dict(SHAPES=(("SA1", (2, 16, 64, 16, 64)), ("SA2", (1, 8, 64, 32, 128))),
                     LOOPS=2, WINDOWS=1),
    bn_stats_bench: dict(SHAPES=(("SA1c64", (2, 16, 64, 64)), ("SA2c128", (1, 8, 64, 128))),
                         LOOPS=2, WINDOWS=1),
    dma_probe: dict(TORCH_MB=1, BLOCK_KBS=(1, 4), BLOCKS=2, CHAIN=2, WINDOWS=1),
}
LINES = {tail_bench: ["SA1 unfused: fwd", "SA1 fused  : fwd", "SA2 fused  : fwd"],
         bn_stats_bench: [f"{s} {f:9s}: " for s in ("SA1c64", "SA2c128")
                          for f in ("current", "unmasked", "twostage", "bf16part", "kernel")],
         dma_probe: ["torch add over 1 MB", "kernel block copy 2 x 4 KB blocks",
                     "BLOCK_COPY_CAP: {\"torch_gbps\": "]}


@pytest.mark.parametrize("tool", list(CUT), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_main_runs_on_the_cpu_when_asked(tool, capsys):
    with mock.patch.multiple(tool, **CUT[tool]):
        result = tool.main(device="cpu")
    out = capsys.readouterr().out
    for line in LINES[tool]:
        assert line in out, (line, out)
    assert result
    if tool is bn_stats_bench:  # the kernel's plain version is the reference itself
        assert all(r["max_rel_s1"] == 0.0 for r in result if r["label"] == "kernel")


@pytest.mark.parametrize("tool", list(CUT), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_main_without_a_device_needs_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
