"""The port's disk path (``dl_biomass_tpu_torch/io/dataset.py``, ``split.py``,
``resample.py``, ``pipeline.py``) against the JAX package's on one small
corpus on the CPU. Datasets, the split, the resampled files and the loader's
batches are compared exactly (tolerance 0: the same numpy draws and the same
float32 casts of the same decoded values); kernel 1's picks index for index."""

import filecmp

import jax
import numpy as np
import pytest
import torch

from dl_biomass_tpu.io import dataset as jax_dataset
from dl_biomass_tpu.io import pipeline as jax_pipeline
from dl_biomass_tpu.io import resample as jax_resample
from dl_biomass_tpu.io.split import split_dataset as jax_split_dataset
from dl_biomass_tpu_torch.io import dataset, resample
from dl_biomass_tpu_torch.io.pipeline import PrefetchingLoader
from dl_biomass_tpu_torch.io.split import split_dataset
from dl_biomass_tpu_torch.native import pointops
from dl_biomass_tpu_torch.ops import fps_kernel
from dl_biomass_tpu_torch.ops.reference import fps_numpy
from dl_biomass_tpu_torch.tools.make_corpus import make_corpus

torch.set_num_threads(1)

PLOTS, RAW_POINTS, K = 9, 320, 160
SPLITS = (("train", 5 / 9), ("val", 2 / 9), ("test", 2 / 9))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A raw corpus (``make_corpus``) and its resampled train split (numpy FPS)."""
    root = tmp_path_factory.mktemp("corpus")
    make_corpus(str(root / "raw"), PLOTS, RAW_POINTS, seed=3, splits=SPLITS)
    resample.resample_point_clouds(str(root / "raw" / "train"), str(root / "fps"), K,
                                   samp_meth="fps", use_parquet=False, engine="numpy",
                                   log_fn=lambda _: None, device="cpu")
    return root


def _same_dataset(tds, jds):
    assert tds.device.type == "cpu"
    for name in ("pos", "feat", "mask", "y"):
        np.testing.assert_array_equal(getattr(tds, name).numpy(), np.asarray(getattr(jds, name)),
                                      err_msg=name)
    assert tds.plot_ids == jds.plot_ids and tds.base_n == jds.base_n


@pytest.mark.parametrize("max_points,use_columns,center_after,for_aug", [
    (200, ["intensity_normalized"], False, True),   # subsample without replacement
    (400, ["intensity_normalized"], False, False),  # with replacement
    (200, [], True, True),                          # coordinates as features, centred after
])
def test_raw_dataset_load_all_equals_jax(corpus, max_points, use_columns, center_after, for_aug):
    kw = dict(max_points=max_points, use_columns=use_columns, filter_height=0.2,
              dataset=("BC", "RM", "PF"), biomass_csv=str(corpus / "raw" / "biomass.csv"),
              center_after_subset=center_after)
    raw = str(corpus / "raw" / "train")
    tds = dataset.PointCloudsInFiles(raw, "*.las", **kw).load_all(
        np.random.default_rng(7), for_augmentation=for_aug, device="cpu")
    jds = jax_dataset.PointCloudsInFiles(raw, "*.las", **kw).load_all(
        np.random.default_rng(7), for_augmentation=for_aug)
    _same_dataset(tds, jds)


def test_presampled_dataset_load_all_equals_jax(corpus):
    kw = dict(dataset=("BC", "RM", "PF"), biomass_csv=str(corpus / "raw" / "biomass.csv"),
              presampled_suffix=f"_fps_{K}")
    tds = dataset.PointCloudsInFilesPreSampled(str(corpus / "fps"), "*.las", **kw).load_all(
        device="cpu")
    jds = jax_dataset.PointCloudsInFilesPreSampled(str(corpus / "fps"), "*.las", **kw).load_all()
    _same_dataset(tds, jds)
    assert tds.plot_ids[0] == "BC_0000" and len(tds) == 5


def test_dataset_filters_prefixes_and_refuses_an_empty_set(corpus):
    raw = str(corpus / "raw" / "train")
    only_rm = dataset.PointCloudsInFiles(raw, "*.las", dataset=("RM",))
    assert [f.name for f in only_rm.files] == [
        f.name for f in jax_dataset.PointCloudsInFiles(raw, "*.las", dataset=("RM",)).files]
    with pytest.raises(FileNotFoundError, match="no usable plots"):
        dataset.PointCloudsInFiles(raw, "*.las", dataset=("XX",)).load_all(device="cpu")
    with pytest.raises(ValueError, match="not found in the biomass table"):
        dataset.PointCloudsInFilesPreSampled(
            str(corpus / "fps"), "*.las", biomass_csv=str(corpus / "raw" / "biomass.csv"),
            presampled_suffix="_none").load_all(device="cpu")


def test_load_all_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataset.PointCloudsInFilesPreSampled(str(corpus / "fps"), "*.las").load_all()


def test_augmenting_dataset_equals_jax(corpus):
    """The host-side augmentation twin draws what the JAX one draws."""
    kw = dict(max_points=200, use_columns=["intensity_normalized"], filter_height=0.2,
              dataset=("BC", "RM", "PF"), biomass_csv=str(corpus / "raw" / "biomass.csv"))
    raw = str(corpus / "raw" / "train")
    got = dataset.AugmentPointCloudsInFiles(raw, "*.las", **kw).get(1, np.random.default_rng(2))
    want = jax_dataset.AugmentPointCloudsInFiles(raw, "*.las", **kw).get(
        1, np.random.default_rng(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stratify", [True, False])
def test_split_dataset_gives_the_same_file_lists(corpus, tmp_path, stratify):
    src = str(corpus / "raw" / "train")
    got = split_dataset(src, str(tmp_path / "port"), seed=4, stratify_by_source=stratify)
    want = jax_split_dataset(src, str(tmp_path / "jax"), seed=4, stratify_by_source=stratify)
    assert {k: [p.split("/")[-1] for p in v] for k, v in got.items()} == {
        k: [p.split("/")[-1] for p in v] for k, v in want.items()}


@pytest.mark.parametrize("method,engine", [("random", "numpy"), ("voxel", "numpy"),
                                           ("fps", "numpy"), ("fps", "native")])
def test_resample_writes_the_jax_files(corpus, tmp_path, method, engine):
    """LAS outputs byte for byte, and the parquet outputs' frames equal."""
    if engine == "native" and not pointops.available():
        pytest.skip("the native library does not build here")
    src = str(corpus / "raw" / "val")
    for fmt in ("las", "parq"):
        kw = dict(samp_meth=method, use_parquet=fmt == "parq", engine=engine, seed=6,
                  voxel_size=2.0, log_fn=lambda _: None)
        got = resample.resample_point_clouds(src, str(tmp_path / f"p{fmt}"), K, device="cpu",
                                             **kw)
        want = jax_resample.resample_point_clouds(src, str(tmp_path / f"j{fmt}"), K, **kw)
        assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
        assert len(got) == 2
        for g, w in zip(got, want):
            if fmt == "las":
                assert filecmp.cmp(g, w, shallow=False), g
            else:
                import pandas as pd

                pd.testing.assert_frame_equal(pd.read_parquet(g), pd.read_parquet(w))


def _clouds_without_near_ties(seed, n=256, k=64):
    """A random cloud and the margin of its exact FPS: at each step the
    smallest gap between the winner's running distance and the next one's,
    in float64. A gap far above float32's rounding of |p|^2 - 2 p.l + |l|^2
    (~1e-6 of the squared extent) means float32 and float64 pick alike."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-10, 10, (n, 3))
    dists = np.full(n, np.inf)
    last, gap = 0, np.inf
    for _ in range(1, k):
        dists = np.minimum(dists, ((coords - coords[last]) ** 2).sum(-1))
        dists[last] = -np.inf
        top = np.sort(dists)[-2:]
        gap = min(gap, top[1] - top[0])
        last = int(np.argmax(dists))
    return coords, gap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_engine_on_the_cpu_picks_as_the_numpy_engine(seed):
    """The ``cuda`` engine on a CPU device is kernel 1's plain version; on a
    cloud whose every step leads by more than 1e-3 m^2 it picks index for
    index what the float64 engines pick."""
    coords, gap = _clouds_without_near_ties(seed)
    assert gap > 1e-3
    want = resample.farthest_point_sampling(coords, 64, engine="numpy")
    np.testing.assert_array_equal(
        resample.farthest_point_sampling(coords, 64, engine="cuda", device="cpu"), want)
    np.testing.assert_array_equal(want, fps_numpy(coords, np.ones(len(coords), bool), 64, 0))
    if pointops.available():
        np.testing.assert_array_equal(
            resample.farthest_point_sampling(coords, 64, engine="native"), want)


def test_cuda_engine_centres_a_georeferenced_plot():
    """The centring guard: a plot moved by (5e5, 5e6, 0) m picks what the
    unmoved plot picks. Cast raw, as the JAX ``tpu`` engine casts it, float32
    cannot resolve the moved plot's distances and kernel 1 picks otherwise
    (the divergence by design, ROADMAP C)."""
    coords, _ = _clouds_without_near_ties(1)
    moved = coords + np.asarray([5e5, 5e6, 0.0])
    want = resample.farthest_point_sampling(coords, 64, engine="numpy")
    np.testing.assert_array_equal(
        resample.farthest_point_sampling(moved, 64, engine="cuda", device="cpu"), want)
    raw = torch.from_numpy(moved.astype(np.float32))[None]
    raw_picks = fps_kernel.fps_rows_plain(raw, torch.ones(1, len(coords), dtype=torch.bool),
                                          torch.zeros(1, dtype=torch.int32), 64)[0].numpy()
    assert not np.array_equal(raw_picks, want)
    jax_moved = jax_resample.farthest_point_sampling(moved, 64, engine="tpu")
    assert not np.array_equal(jax_moved, want)


def test_sectored_engine_sorts_its_picks_and_the_engines_refuse_bad_input():
    coords, _ = _clouds_without_near_ties(2)
    got = resample.farthest_point_sampling(coords, 64, engine="sectored", device="cpu")
    assert len(np.unique(got)) == 64 and np.all(np.diff(got) > 0)
    with pytest.raises(ValueError, match="unknown engine"):
        resample.farthest_point_sampling(coords, 64, engine="tpu")
    with pytest.raises(ValueError, match="k=300 > n=256"):
        resample.farthest_point_sampling(coords, 300, engine="numpy")


def _raw_fileset(module, corpus):
    return module.PointCloudsInFiles(
        str(corpus / "raw" / "train"), "*.las", max_points=200,
        use_columns=["intensity_normalized"], filter_height=0.2, dataset=("BC", "RM", "PF"),
        biomass_csv=str(corpus / "raw" / "biomass.csv"))


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_equal_jax_without_augmentation(corpus, shuffle):
    key = jax.random.key(11)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))  # what the JAX loader derives
    got = list(PrefetchingLoader(_raw_fileset(dataset, corpus), 2, 200,
                                 device="cpu").epoch(seed, shuffle=shuffle))
    want = list(jax_pipeline.PrefetchingLoader(_raw_fileset(jax_dataset, corpus), 2,
                                               200).epoch(key, shuffle=shuffle))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for name in ("pos", "feat", "mask", "y"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                          err_msg=name)


def test_loader_augments_the_flagged_copies_on_the_device_stream(corpus):
    """num_augs=1: the unaugmented samples equal JAX's; each augmented one
    keeps 90-100% of its 200 points in [0, base_n) and appends at most 10%."""
    key = jax.random.key(12)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    loader = PrefetchingLoader(_raw_fileset(dataset, corpus), 4, 200, num_augs=1, device="cpu")
    got = list(loader.epoch(seed))
    want = list(jax_pipeline.PrefetchingLoader(_raw_fileset(jax_dataset, corpus), 4, 200,
                                               num_augs=1).epoch(key))
    assert len(got) == len(want) == 3 and loader.capacity == 256
    augmented = 0
    for g, w in zip(got, want):
        same = (g.mask.numpy() == np.asarray(w.mask)).all(1) & (
            g.pos.numpy() == np.asarray(w.pos)).all((1, 2))
        base = g.mask[:, :200].sum(1).numpy()
        extra = g.mask[:, 200:].sum(1).numpy()
        for i in range(4):
            if same[i]:
                continue
            augmented += 1
            assert 180 <= base[i] <= 200 and extra[i] <= 20
    assert augmented > 0
    again = list(loader.epoch(seed))
    for g, a in zip(got, again):
        assert torch.equal(g.pos, a.pos) and torch.equal(g.mask, a.mask)


def test_loader_surfaces_a_decode_error(corpus):
    fs = _raw_fileset(dataset, corpus)
    fs.files = fs.files + [corpus / "raw" / "biomass.csv"]  # not a LAS file
    with pytest.raises(RuntimeError, match="producer failed") as err:
        list(PrefetchingLoader(fs, 2, 200, device="cpu").epoch(0, shuffle=False))
    assert "not a LAS file" in str(err.value.__cause__)
