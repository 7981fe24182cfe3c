"""On the card, at each one-card cell's own size: the program passes the cell's
limits and the control (the reference in fp8 in its place) fails them, on
one seed (PERF.md gives the readings over more). Skips without a card
(decided inside the test).

    python -m pytest --noconftest portbench/tests -m cuda
"""

import importlib
from types import SimpleNamespace

import pytest
import torch

from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ssg_train_b36", "msg_train_b36", "ssg_serve_watch"])
def test_control_fails_where_the_program_passes_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.fixed_environment()
    spec = run.resolve(run.load_manifest(), workload)
    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    k = kind.Kind(SimpleNamespace(seed=2**31 + 41, config=spec.config, traffic=spec.traffic,
                                  device=torch.device("cuda"), mesh=None, rank=0, world=1))
    k.setup()
    if spec.traffic["kind"] == "serve_requests":
        k.window(3.0)
    k.release()
    program, control = k.check("program"), k.check("control")
    assert run.judge(program, spec.limits), program
    assert not run.judge(control, spec.limits), control
