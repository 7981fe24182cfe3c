"""The port's serving export (``models/export.py``) and its registered ops on
the CPU: the counterparts of ``tests/test_export.py:37-112`` (files and meta,
engine equality, envelope, chunk and pad, wrong point count, wrong platform,
newer format; ``export-model`` then ``predict --from-export`` is in
``tests/test_torch_cli.py``), the port's artifact against the JAX package's
``export_serving`` artifact on the same weights (the engine tolerance of
``tests/test_torch_inference.py``), the exported graph's calls of the
registered kernels, and ``torch.library.opcheck`` on each of those ops."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.export import export_serving as jax_export_serving
from dl_biomass_tpu.models.export import load_serving as jax_load_serving
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.models.export import export_serving, load_serving
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.ops import (ball_group_kernel, ball_query_kernel, fps_kernel,
                                      gather_kernel)
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

B, N, VALID = 2, 384, [384, 300]
DTYPES = {"float32": F32_RTOL, "bfloat16": BF16_RTOL}
KERNEL_OPS = ("fps_rows", "ball_group", "ball_query_first_k", "gather_rows_forward",
              "gather_rows_aux")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per dtype: the JAX model and variables, the bridged port model, the
    batch pair, and the port's artifact path and meta."""
    out = {}
    for dtype in DTYPES:
        jb, tb = batches(1, B, N, VALID)
        jm, v, tm = models("production", dtype, jb)
        path = str(tmp_path_factory.mktemp(f"artifact_{dtype}"))
        meta = export_serving(tm, batch_size=B, num_points=N, path=path, device="cpu")
        out[dtype] = dict(jm=jm, v=v, tm=tm, jb=jb, tb=tb, path=path, meta=meta)
    return out


def test_a_v2_artifact_writes_its_one_output(tmp_path):
    """``pointnet2_v2`` (one output, SA3 and the head twice as wide): the
    artifact's meta names its one output, and it serves the engine's rows."""
    jb, tb = batches(0, B, N, VALID)
    _, _, tm = models("production", "float32", jb, num_outputs=1, global_width_mult=2)
    meta = export_serving(tm, batch_size=B, num_points=N, path=str(tmp_path), device="cpu")
    assert meta["num_outputs"] == 1
    got = load_serving(str(tmp_path), device="cpu")(tb.pos, tb.feat, tb.mask)
    assert tuple(got.shape) == (B, 1)
    assert torch.equal(got, compile_inference(tm, device="cpu")(tb))


def _meta_edit(path, **changes):
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


@pytest.fixture
def scratch_artifact(exported, tmp_path):
    """A copy of the float32 artifact that a test may edit."""
    import shutil

    dst = tmp_path / "artifact"
    shutil.copytree(exported["float32"]["path"], dst)
    return str(dst)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_artifact_files_and_meta(exported, dtype):
    e = exported[dtype]
    assert {"serving.pt2", "weights.npz", "meta.json"} <= set(os.listdir(e["path"]))
    meta = e["meta"]
    assert meta["batch_size"] == B and meta["num_points"] == N
    assert meta["num_features"] == 1 and meta["num_outputs"] == 4
    assert meta["platforms"] == ["cpu"] and meta["n_weights"] == 24
    assert meta["model_summary"]["compute_dtype"] == dtype
    assert meta["weight_dtypes"][0::2] == [dtype] * 12 and set(meta["weight_dtypes"][1::2]) == {
        "float32"}
    assert meta["torch_version"] == torch.__version__


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matches_engine_exactly(exported, dtype):
    """The same ops on the same weights in the same order: bit for bit."""
    e = exported[dtype]
    want = compile_inference(e["tm"], "cpu")(e["tb"])
    got = load_serving(e["path"], "cpu")(e["tb"].pos, e["tb"].feat, e["tb"].mask)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matches_the_jax_exported_artifact(exported, dtype, tmp_path):
    """JAX's artifact of the same weights at the same envelope, on the CPU."""
    e = exported[dtype]
    jax_export_serving(e["jm"], e["v"], batch_size=B, num_points=N, path=str(tmp_path))
    jb = e["jb"]
    want = np.asarray(jax_load_serving(str(tmp_path))(jb.pos, jb.feat, jb.mask))
    got = load_serving(e["path"], "cpu")(np.asarray(jb.pos), np.asarray(jb.feat),
                                         np.asarray(jb.mask)).numpy()
    assert rel_err(got, want) <= DTYPES[dtype]


def test_unsplit_model_artifact_matches_its_engine(tmp_path):
    """``split_first_layer=False``: SA2 gathers through kernel 4c's op."""
    jb, tb = batches(2, B, N, VALID)
    _, _, tm = models("production", "bfloat16", jb, split_first_layer=False)
    export_serving(tm, batch_size=B, num_points=N, path=str(tmp_path), device="cpu")
    loaded = load_serving(str(tmp_path), "cpu")
    assert torch.equal(loaded(tb.pos, tb.feat, tb.mask), compile_inference(tm, "cpu")(tb))
    targets = {str(n.target) for n in loaded._fn.graph.nodes if n.op == "call_function"}
    assert "dlbt.gather_rows_aux.default" in targets
    assert "dlbt.gather_rows_forward.default" not in targets


def test_the_graph_calls_the_registered_kernels(exported):
    """Kernels 1, 2, 3 and 4a appear as ``torch.ops.dlbt`` calls: two FPS
    (SA1, SA2), one ball group, one ball query, one row gather."""
    loaded = load_serving(exported["bfloat16"]["path"], "cpu")
    calls = [str(n.target) for n in loaded._fn.graph.nodes if n.op == "call_function"]
    counts = {op: calls.count(f"dlbt.{op}.default") for op in KERNEL_OPS}
    assert counts == {"fps_rows": 2, "ball_group": 1, "ball_query_first_k": 1,
                      "gather_rows_forward": 1, "gather_rows_aux": 0}


def test_envelope_mismatch_raises(exported):
    loaded = load_serving(exported["float32"]["path"], "cpu")
    bad = np.zeros((3, N, 3), np.float32)  # batch 3 != envelope 2
    with pytest.raises(ValueError, match="envelope"):
        loaded(bad, np.zeros((3, N, 1), np.float32), np.zeros((3, N), bool))


def test_predict_chunks_and_pads(exported):
    """Any plot count, chunked to the envelope batch with masked-out clouds
    padding the tail; each row is its plot served alone in a padded batch."""
    e = exported["float32"]
    loaded = load_serving(e["path"], "cpu")
    rng = np.random.default_rng(0)
    p = 5
    pos = rng.normal(size=(p, N, 3)).astype(np.float32) * 3
    feat = rng.normal(size=(p, N, 1)).astype(np.float32)
    mask = np.arange(N)[None] < rng.integers(200, N + 1, size=(p, 1))
    got = loaded.predict(pos, feat, mask)
    assert got.shape == (p, 4) and got.dtype == np.float32
    serve = compile_inference(e["tm"], "cpu")
    for i in range(p):
        two = lambda a: torch.from_numpy(np.concatenate([a[i:i + 1], np.zeros_like(a[:1])]))
        want = serve(CloudBatch(pos=two(pos), feat=two(feat), mask=two(mask))).numpy()[0]
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_predict_wrong_point_count_raises(exported):
    loaded = load_serving(exported["float32"]["path"], "cpu")
    with pytest.raises(ValueError, match="num_points"):
        loaded.predict(np.zeros((2, 256, 3), np.float32), np.zeros((2, 256, 1), np.float32),
                       np.zeros((2, 256), bool))


def test_wrong_platform_refused(scratch_artifact):
    _meta_edit(scratch_artifact, platforms=["cuda"])
    with pytest.raises(RuntimeError, match="exported for"):
        load_serving(scratch_artifact, "cpu")


def test_newer_format_refused(scratch_artifact):
    _meta_edit(scratch_artifact, format=999)
    with pytest.raises(ValueError, match="newer"):
        load_serving(scratch_artifact, "cpu")


def test_loading_needs_a_card_or_device_cpu(exported):
    from unittest import mock

    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_serving(exported["float32"]["path"])


def _op_cases():
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    mask = torch.from_numpy(np.arange(64)[None] < np.asarray([[64], [40]]))
    feat = torch.from_numpy(rng.normal(size=(2, 64, 1)).astype(np.float32))
    centers, cmask = pos[:, :8].contiguous(), mask[:, :8].contiguous()
    idx = torch.from_numpy(rng.integers(0, 64, size=(2, 8, 16)).astype(np.int32))
    return {
        "fps_rows": (pos, mask, torch.zeros(2, dtype=torch.int32), 8),
        "ball_group": (centers, cmask, pos, mask, feat, 2.0, torch.bfloat16, True),
        "ball_query_first_k": (centers, cmask, pos, mask, 2.0, 16),
        "gather_rows_forward": (feat.to(torch.bfloat16), idx),
        "gather_rows_aux": (feat, idx, pos),
    }


@pytest.mark.parametrize("op", KERNEL_OPS)
def test_opcheck(op):
    """The schema, the fake implementation against the CPU one, and the op
    under AOT dispatch with dynamic shapes."""
    torch.library.opcheck(getattr(torch.ops.dlbt, op).default, _op_cases()[op])


def test_the_wrappers_call_the_registered_ops():
    """Each wrapper's CPU result is its op's and its plain version's."""
    cases = _op_cases()
    pos, mask, starts, k = cases["fps_rows"]
    assert torch.equal(fps_kernel.fps_rows(pos, mask, starts, k),
                       fps_kernel.fps_rows_plain(pos, mask, starts, k))
    c, cm, p, m, f, r, dt, _ = cases["ball_group"]
    got = ball_group_kernel.ball_group(c, cm, p, m, f, radius=r, out_dtype=dt, need_idx=False)
    want = ball_group_kernel.ball_group_plain(c, cm, p, m, f, radius=r, out_dtype=dt,
                                              need_idx=False)
    assert got[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    c, cm, p, m, r, k = cases["ball_query_first_k"]
    assert all(torch.equal(a, b) for a, b in zip(
        ball_query_kernel.ball_query_first_k(c, cm, p, m, radius=r, k=k),
        ball_query_kernel.ball_query_plain(c, cm, p, m, radius=r, k=k)))
    v, idx, aux = cases["gather_rows_aux"]
    assert all(torch.equal(a, b) for a, b in zip(gather_kernel.gather_rows_aux(v, idx, aux),
                                                 gather_kernel.gather_rows_aux_plain(v, idx,
                                                                                     aux)))


def test_a_jax_backend_is_the_cpu_here():
    assert jax.default_backend() == "cpu"
