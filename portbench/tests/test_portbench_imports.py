"""Nothing the benchmark runs may load JAX or the JAX package: the check compares
each module's top-level name whole, since the port's name begins with the
JAX package's. Nothing under ``portbench/`` reads the JAX package's
benchmark files or the root ``tools/``."""

import ast
import re
from pathlib import Path

import pytest

from portbench import run

PORTBENCH = Path(run.__file__).resolve().parent


@pytest.mark.parametrize("name, bad", [
    ("dl_biomass_tpu_torch", False),
    ("dl_biomass_tpu_torch.models.pointnet2", False),
    ("dl_biomass_tpu", True),
    ("dl_biomass_tpu.ops.fps", True),
    ("jax", True),
    ("jax.numpy", True),
    ("jaxlib.xla_client", True),
    ("flax.linen", True),
    ("jaxtyping", False),
    ("portbench.run", False),
])
def test_forbidden_modules_compares_whole_top_level_names(name, bad):
    assert run.forbidden_modules([name]) == ([name] if bad else [])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return sorted(PORTBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = list(_imports(path))
    assert not run.forbidden_modules(names), (path, names)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_no_source_reads_the_jax_benchmark_files(path):
    text = path.read_text()
    if path.parent.name == "tests":
        text = "\n".join(l for l in text.splitlines() if "noqa: jaxfiles" not in l)
    for pat in (r"\bbench\.py\b", r"BENCH_r?\w*\.json", r"BASELINE\.json",
                r"MULTICHIP_\w*\.json", r"[\"']tools/"):
        assert not re.search(pat, text), (path, pat)


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py"))
                         + sorted((PORTBENCH / "yardstick").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_and_yardstick_import_nothing_of_the_port(path):
    for name in _imports(path):
        assert name.split(".")[0] != "dl_biomass_tpu_torch", (path, name)
