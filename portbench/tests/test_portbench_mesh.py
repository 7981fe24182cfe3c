"""The data-parallel cell's path, at a toy size on the CPU: four ranks over a
``dp`` mesh through gloo, rank 0 measuring and checking. A sound run is
correct; with the exchange between the ranks left out (each rank steps on
its own gradient) it is not."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run

SEED = 2**31 + 29
PB = Path(run.__file__).resolve().parent


def spec(before=None):
    cfg = json.loads((PB / "configs" / "pn2_ssg_biomass.json").read_text())
    cfg["hp"].update(batch_size=4, num_augs=1)
    tr = json.loads((PB / "traffic" / "train_b36_dp4.json").read_text())
    tr.update(plots=24, points=384)
    limits = json.loads((PB / "limits" / "ssg_train_dp4.json").read_text())
    return SimpleNamespace(cell={"name": "ssg_train_dp4", "chips": 4}, config=cfg, traffic=tr,
                           limits=limits, end_to_end=[], per_layer=[], before=before)


def no_exchange():
    """Every rank steps on its own gradient: the sum over the ranks is left out."""
    from dl_biomass_tpu_torch.parallel import mesh

    mesh.sum_grads = lambda params, m: None


@pytest.mark.parametrize("before, ok", [(None, True), (no_exchange, False)],
                         ids=["sound", "no_exchange"])
def test_four_ranks_on_the_cpu(before, ok):
    out = run.run_cell(spec(before), SEED, 0.5, False, "cpu")
    assert out["correct"] is ok, out["checks"]
    assert out["notes"]["ranks_forbidden"] == []
    assert out["attempted"] >= 48
