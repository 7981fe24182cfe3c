"""The port's LAS codec (``dl_biomass_tpu_torch/io/las.py``, ``io/reader.py``) and
its corpus tool (``tools/make_corpus.py``) against the JAX package's, on the
CPU: the files byte for byte, the decoded arrays exactly (tolerance 0: both are
the same numpy arithmetic on the same bytes)."""

import filecmp

import numpy as np
import pytest

from dl_biomass_tpu.io import las as jax_las
from dl_biomass_tpu.io import reader as jax_reader
from dl_biomass_tpu_torch.io import las
from dl_biomass_tpu_torch.io import reader
from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
from torch_port_helpers import jax_tool


def georeferenced_cloud(seed, n=400, origin=(512_345.0, 5_123_456.0, 210.0)):
    """A plot in UTM-like coordinates (as a survey's LAS holds them) with an
    intensity and a float attribute."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.uniform(-11, 11, n), rng.uniform(-11, 11, n),
                       rng.uniform(0, 30, n)], 1) + np.asarray(origin)
    attrs = {"intensity": rng.integers(0, 40000, n).astype(np.uint16),
             "intensity_normalized": rng.uniform(0, 20, n)}
    return coords, attrs


@pytest.mark.parametrize("origin", [(0.0, 0.0, 0.0), (512_345.0, 5_123_456.0, 210.0)])
@pytest.mark.parametrize("attr_names", [(), ("intensity",), ("intensity", "intensity_normalized")])
def test_write_las_writes_the_same_bytes(tmp_path, origin, attr_names):
    coords, attrs = georeferenced_cloud(1, origin=origin)
    attrs = {k: attrs[k] for k in attr_names}
    ours, theirs = tmp_path / "port.las", tmp_path / "jax.las"
    reader.write_las(coords, ours, attrs or None)
    jax_reader.write_las(coords, theirs, attrs or None)
    assert filecmp.cmp(ours, theirs, shallow=False)


@pytest.mark.parametrize("filter_height", [0, 0.2, 215.0])
@pytest.mark.parametrize("useevery", [1, 3])
def test_read_las_returns_equal_arrays(tmp_path, filter_height, useevery):
    coords, attrs = georeferenced_cloud(2)
    coords[:, 2] -= 200.0  # heights around 10-40 m, so the filter keeps a share
    path = tmp_path / "plot.las"
    jax_reader.write_las(coords, path, attrs)
    got = reader.read_las(path, get_attributes=True, useevery=useevery,
                          filter_height=filter_height)
    want = jax_reader.read_las(path, get_attributes=True, useevery=useevery,
                               filter_height=filter_height)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    for name in want[1]:
        np.testing.assert_array_equal(got[1][name], want[1][name], err_msg=name)
    np.testing.assert_array_equal(
        reader.read_las(path, filter_height=filter_height),
        jax_reader.read_las(path, filter_height=filter_height))


@pytest.mark.parametrize("values", [np.arange(7, dtype=np.uint16) * 311,
                                    np.full(5, 42, np.uint16),
                                    np.random.default_rng(3).uniform(-3, 9, 50)])
def test_normalize_intensity_is_equal(values):
    np.testing.assert_array_equal(reader.normalize_intensity(values),
                                  jax_reader.normalize_intensity(values))


def test_a_laz_path_raises_in_both(tmp_path):
    coords, attrs = georeferenced_cloud(4)
    path = tmp_path / "plot.las"
    reader.write_las(coords, path, attrs)
    raw = bytearray(path.read_bytes())
    raw[104] |= 0x80  # the LAZ compression bit
    laz = tmp_path / "plot.laz"
    laz.write_bytes(bytes(raw))
    for read in (las.read, jax_las.read):
        with pytest.raises(ValueError, match="laspy"):
            read(str(laz))


def test_make_corpus_writes_the_jax_tools_files(tmp_path):
    """The port's tool writes the JAX tool's corpus byte for byte: every
    split's LAS files and the biomass table."""
    make_corpus(str(tmp_path / "port"), 7, 300, seed=5)
    jax_tool("make_corpus").make_corpus(str(tmp_path / "jax"), 7, 300, seed=5)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 8 and sorted(
        p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
        if p.is_file()) == files
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f, shallow=False), f
