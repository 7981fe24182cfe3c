"""Rules of the PyTorch port that hold for every file of it.

- No module of ``dl_biomass_tpu_torch``, and neither ``chip_smoke.py`` nor
  ``chip_compare.py``, imports
  jax, flax or the JAX package (``dl_biomass_tpu`` or its submodules; note
  that ``dl_biomass_tpu_torch`` itself starts with that name).
- Importing the port leaves jax out of ``sys.modules``, and so does
  ``python -m dl_biomass_tpu_torch --help``.
- ``chip_smoke.py`` fails, printing no result, without a card or away from
  the package.
- Each CUDA source opens with what it replaces, its bound and its design.
"""

import ast
import re
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


def test_the_mesh_and_export_modules_are_checked():
    """The no-jax checks above cover the data-parallel mesh and the serving
    export, and ``chip_smoke.py``, which drives both."""
    for sub in ("parallel/__init__.py", "parallel/mesh.py", "models/export.py"):
        assert PORT / sub in PORT_FILES, sub
    assert ROOT / "chip_smoke.py" in PORT_FILES


def test_the_disk_path_subpackages_and_the_cli_are_checked():
    """The no-jax checks above cover ``native``, ``eval``, ``utils`` and
    ``__main__.py`` (every file under the package is in ``PORT_FILES``)."""
    checked = {p.relative_to(PORT).parts[0] for p in PORT_FILES if PORT in p.parents}
    assert {"native", "eval", "utils", "io", "__main__.py"} <= checked
    for sub in ("native/pointops.py", "eval/testing.py", "eval/predict.py", "utils/tboard.py",
                "io/las.py", "io/dataset.py", "io/resample.py", "io/pipeline.py"):
        assert PORT / sub in PORT_FILES, sub


VARIANT_MODULES = ("models/voxelnet.py", "models/decoder.py", "ops/voxelize.py",
                   "models/layers.py", "models/pointnet2.py", "bridge.py")


@pytest.mark.parametrize("sub", VARIANT_MODULES)
def test_the_variant_modules_are_checked(sub):
    """The voxel family, the decoder and the variants' layers carry their own
    copies of what they take from the JAX package (the numpy voxel oracle
    among them) and are under the no-jax checks above."""
    assert PORT / sub in PORT_FILES
    assert not [m for m in imported_modules(PORT / sub) if _forbidden(m)]


RESEARCH_MODULES = ("sweep/__init__.py", "sweep/study.py", "sweep/objective.py",
                    "sweep/vmapped.py", "eval/recorded.py", "experiments/__init__.py",
                    "experiments/density.py", "experiments/seed_study.py",
                    "experiments/visualize_augmentation.py", "train/lr_finder.py",
                    "utils/profiling.py")


@pytest.mark.parametrize("sub", RESEARCH_MODULES)
def test_the_research_modules_are_checked(sub):
    """The sweeps, the recorded parity path, the experiments and the utilities
    are under the no-jax checks above."""
    assert PORT / sub in PORT_FILES


REST_TOOLS = ("profile_step", "roofline", "batch_sweep", "serving_matrix", "dispatch_probe",
              "bq_tile_sweep", "fps_divergence_probe", "torch_cpu_anchor")


@pytest.mark.parametrize("tool", REST_TOOLS)
def test_the_tools_without_kernels_are_checked(tool):
    """The ports of the JAX tools that run no kernel of their own are under
    the no-jax checks above, as is the test rank body of the point-parallel
    mesh (a spawned rank must not import jax)."""
    assert PORT / "tools" / f"{tool}.py" in PORT_FILES
    worker = ROOT / "tests" / "torch_mesh_mp_worker.py"
    assert not [m for m in imported_modules(worker) if _forbidden(m)]


def test_the_study_module_is_a_copy_of_the_jax_packages():
    """``sweep/study.py`` is the JAX package's file but for its docstring, so
    a study either package saves loads in the other."""
    def body(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body(PORT / "sweep" / "study.py") == body(ROOT / "dl_biomass_tpu" / "sweep" / "study.py")


def test_python_m_help_runs_without_importing_jax():
    out = subprocess.run([sys.executable, "-m", "dl_biomass_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "python -m dl_biomass_tpu_torch train" in out.stdout, out.stderr
    code = ("import runpy, sys\nsys.argv = ['dl_biomass_tpu_torch', '--help']\n"
            "try:\n    runpy.run_module('dl_biomass_tpu_torch', run_name='__main__', "
            "alter_sys=True)\nexcept SystemExit as e:\n    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
            "'dl_biomass_tpu')]\nassert not bad, bad\nprint('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr


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


@pytest.mark.parametrize("name", ["sum_slices.cu", "bn_train.cu"])
def test_cuda_source_without_a_tpu_kernel_opens_with_its_note(name):
    """The kernels that replace no TPU kernel say so, and why they were
    added, beside their bound and design."""
    head = (PORT / "csrc" / name).read_text().split("#include")[0]
    flat = " ".join(line.lstrip("/ ") for line in head.splitlines())
    assert "Replaces: no TPU kernel" in flat
    assert "Bound on the H100:" in flat and "Design:" in flat


def _column_group_launches(src: str, host: str):
    """{column groups a lane takes: the KG its launch instantiates} of each
    ``switch (groups(c, v))`` in the host function ``host`` of bn_train.cu,
    with v; ``default`` stands for every count above the cases."""
    body = src.split(f"cudaError_t {host}(")[1].split("\n}\n")[0]
    out = []
    for v, block in re.findall(r"switch \(groups\(c, (.*?)\)\) \{(.*?)\n *\}", body, re.S):
        launches = {}
        for label, arm in re.findall(r"(case \d+|default):(.*?)(?=case \d+:|default:|$)", block,
                                     re.S):
            kg = int(re.search(r"_kernel<T, (\d)", arm).group(1))
            launches[int(label.split()[1]) if label != "default" else "default"] = kg
        out.append((v, launches))
    return out


def test_bn_train_launches_the_column_groups_of_every_width():
    """Each launch of kernel 11 instantiates, for every width and dtype
    ``bn_train_kernel`` takes, the column groups a lane needs there: the row's
    16-byte vectors over the warp's 32 lanes (a lane that took fewer would
    leave channels unwritten, more would read past the row)."""
    from dl_biomass_tpu_torch.ops import bn_train_kernel as bk

    src = (PORT / "csrc" / "bn_train.cu").read_text()
    switches = {host: _column_group_launches(src, host) for host in ("stats", "apply",
                                                                      "backward")}
    assert [len(v) for v in switches.values()] == [2, 1, 1]
    for itemsize in (2, 4):  # bf16, float32
        for c in bk.WIDTHS:
            for host, cases in switches.items():
                for v, launches in cases:
                    vec = 4 if v == "4" else 16 // itemsize  # "16 / sizeof(T)"
                    need = max(c // vec // 32, 1)
                    kg = launches.get(need, launches["default"])
                    assert need == kg, (host, v, c, itemsize, need, launches)


def test_pyproject_packages_the_port_and_registers_the_cuda_marker():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"dl_biomass_tpu_torch*"' in text
    assert '"csrc/*.cu"' in text
    assert '"cuda: ' in text
