"""Rules of the PyTorch port that hold for every file of it.

- No module of ``dl_biomass_tpu_torch``, and neither ``chip_smoke.py`` nor
  ``chip_compare.py``, imports
  jax, flax or the JAX package (``dl_biomass_tpu`` or its submodules; note
  that ``dl_biomass_tpu_torch`` itself starts with that name).
- Importing the port leaves jax out of ``sys.modules``.
- ``chip_smoke.py`` fails, printing no result, without a card or away from
  the package.
- Each CUDA source opens with what it replaces, its bound and its design.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dl_biomass_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dl_biomass_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_names_are_matched_exactly():
    assert _forbidden("jax.numpy") and _forbidden("dl_biomass_tpu.ops.fps")
    assert _forbidden("dl_biomass_tpu")
    assert not _forbidden("dl_biomass_tpu_torch.ops") and not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
              "'dl_biomass_tpu')]\nassert not bad, bad\nprint('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if not torch.cuda.is_available():
        out = _run_smoke(ROOT / "chip_smoke.py", ROOT)
        assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = _run_smoke(alone, tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("name,replaces", [
    ("fps.cu", "pallas_fps.py fps_pallas"),
    ("ball_group.cu", "pallas_group.py ball_group_pallas"),
    ("ball_query.cu", "pallas_ballquery.py ball_query_pallas"),
    ("gather.cu", "pallas_mxu_gather.py mxu_gather"),
    ("gather_bwd.cu", "pallas_mxu_gather.py mxu_gather, its backward"),
    ("sa1_fused_eval.cu", "pallas_sa_eval.py sa1_fused_eval"),
    ("fused_sa_fwd.cu", "pallas_sa_train.py fused_sa_mlp"),
    ("fused_sa_bwd.cu", "pallas_sa_train.py fused_sa_mlp, its backward"),
    ("fused_sa_b1.cu", "pallas_sa_train.py fused_sa_mlp, its backward's first pass"),
    ("fused_sa_b2.cu", "pallas_sa_train.py fused_sa_mlp, its backward's second pass"),
    ("fused_sa_b3.cu", "pallas_sa_train.py fused_sa_mlp, its backward's last pass"),
    ("fused_sa_f1.cu", "pallas_sa_train.py fused_sa_mlp, its forward's first pass"),
    ("fused_sa_f2.cu", "pallas_sa_train.py fused_sa_mlp, its forward's second pass"),
    ("fused_sa_f3.cu", "pallas_sa_train.py fused_sa_mlp, its forward's last pass"),
    ("fused_tail.cu", "pallas_tail.py fused_tail"),
    ("masked_stats.cu", "tools/bn_stats_bench.py stats_pallas"),
    ("block_copy.cu", "tools/dma_probe.py pallas_bandwidth"),
    ("bq_phase.cu", "tools/bq_phase_bench.py bq"),
])
def test_cuda_source_opens_with_its_note(name, replaces):
    head = (PORT / "csrc" / name).read_text().split("#include")[0]
    flat = " ".join(line.lstrip("/ ") for line in head.splitlines())
    where = "" if replaces.startswith("tools/") else "dl_biomass_tpu/ops/"  # the JAX tools
    assert f"Replaces: {where}{replaces}" in flat
    assert "Bound on the H100:" in flat and "Design:" in flat


def test_pyproject_packages_the_port_and_registers_the_cuda_marker():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"dl_biomass_tpu_torch*"' in text
    assert '"csrc/*.cu"' in text
    assert '"cuda: ' in text
