"""The port's Procrustes (``ops/procrustes.py``), Align3R
(``models/align3r.py``), its ``align3r`` pipeline and the ``pair`` command
against the JAX package on the CPU, fp32, with one set of seeded weights.

``weighted_procrustes`` is held to the JAX SVD's R and t, a reflection and
a rank-2 (coplanar) set included. Align3R is cut to a tiny encoder
(dim 64, 2 blocks, patch 16 at 64²) and decoder (dim 32, 4 blocks); the
pipeline's frozen prior is the full DA-V2 vits, as the JAX builder fixes it,
at 56² (4x4 patches)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import cli as jcli
from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import align3r as ja3r
from monocular_depth_estimation_trt_tpu.models.depth_anything_v2 import DepthAnythingV2
from monocular_depth_estimation_trt_tpu.models.vit import ViTConfig as JViTConfig
from monocular_depth_estimation_trt_tpu.ops import procrustes as jproc
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.apps.ply import read_ply
from monocular_depth_estimation_trt_tpu_torch.models import align3r as ta3r
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops import procrustes as tproc
from monocular_depth_estimation_trt_tpu_torch.utils import imageio
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    align3r_from_jax,
    align3r_pair_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
SIZE = 64
ENC = dict(dim=64, depth=2, num_heads=2, patch_size=16, pretrain_img_size=SIZE)
DEC = dict(dec_dim=32, dec_depth=4, dec_heads=2, head_features=16,
           head_out_channels=(8, 16, 32, 32))
MANIFEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "monocular_depth_estimation_trt_tpu", "weights", "manifests",
                        "align3r.json")


def _rotation(rng):
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.mark.parametrize("case", ["exact", "noisy", "reflection", "rank2"])
def test_weighted_procrustes_matches_jax(case):
    """Batches of two: a rigid motion (exact, or with noise), a mirrored
    target (the best proper rotation: det +1), coplanar points (the SVD's
    third singular vectors are free, R is not)."""
    rng = np.random.default_rng(["exact", "noisy", "reflection", "rank2"].index(case))
    src = rng.standard_normal((2, 400, 3))
    if case == "rank2":
        src[..., 2] = 0.0
    rot = np.stack([_rotation(rng) for _ in range(2)])
    dst = np.einsum("bij,bnj->bni", rot, src) + rng.standard_normal((2, 1, 3))
    if case == "noisy":
        dst += 0.05 * rng.standard_normal(dst.shape)
    if case == "reflection":
        dst[..., 2] *= -1.0
    w = rng.uniform(0.0, 1.0, (2, 400))
    src, dst, w = (a.astype(np.float32) for a in (src, dst, w))
    jr, jt = jproc.weighted_procrustes(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    r, t = tproc.weighted_procrustes(*(torch.from_numpy(a) for a in (src, dst, w)))
    assert r.dtype == t.dtype == torch.float32 and r.shape == (2, 3, 3) and t.shape == (2, 3)
    assert np.abs(r.numpy() - np.asarray(jr)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.det(r.numpy()), 1.0, atol=1e-5)
    if case == "exact":
        np.testing.assert_allclose(r.numpy(), rot, atol=1e-5)
    moved = tproc.se3_apply(r, t, torch.from_numpy(src))
    ref = jproc.se3_apply(jr, jt, jnp.asarray(src))
    assert np.abs(moved.numpy() - np.asarray(ref)).max() < 1e-4


def test_jacobi_eigensolve_diagonalizes(rng):
    a = torch.from_numpy(rng.standard_normal((5, 4, 4)))
    a = a + a.transpose(-1, -2)
    vals, vecs = tproc.symmetric_eigh_jacobi(a)
    np.testing.assert_allclose((vecs @ torch.diag_embed(vals) @ vecs.transpose(-1, -2)).numpy(),
                               a.numpy(), atol=1e-12)
    np.testing.assert_allclose(np.sort(vals.numpy(), -1), np.linalg.eigvalsh(a.numpy()),
                               atol=1e-12)


@pytest.fixture(scope="module")
def params():
    """(JAX Align3R, its params, the DA-V2 vits prior's params at 56²)."""
    model = ja3r.Align3R(enc=JViTConfig(**ENC), dtype=jnp.float32, attn_impl="xla", **DEC)
    img = jnp.zeros((1, SIZE, SIZE, 3))
    a3r = random_params(model, img, img, jnp.zeros((1, SIZE, SIZE)),
                        jnp.zeros((1, SIZE, SIZE)), seed=41)
    prior = random_params(DepthAnythingV2(encoder="vits", dtype=jnp.float32, attn_impl="xla"),
                          jnp.zeros((1, 56, 56, 3)), seed=42)
    return model, a3r, prior


def test_align3r_matches_jax(params, rng):
    model, a3r, _ = params
    img1, img2 = (rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    pri1, pri2 = (rng.uniform(0.5, 3.0, (2, SIZE, SIZE)).astype(np.float32) for _ in range(2))
    ref = jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        a3r, *(jnp.asarray(a) for a in (img1, img2, pri1, pri2)))
    tm = ta3r.Align3R(TViTConfig(**ENC), **DEC)
    tm.load_state_dict(align3r_from_jax(a3r), strict=True)
    with torch.no_grad():
        ours = tm.eval()(*(torch.from_numpy(a) for a in (img1, img2, pri1, pri2)))
    assert sorted(ours) == sorted(ref) == ["conf1", "conf2", "pts1", "pts2"]
    for k in ours:
        assert ours[k].shape == ref[k].shape, k
        assert rel_err(ours[k].numpy(), ref[k]) < REL_TOL, k


@pytest.fixture(scope="module")
def pipes(params):
    _, a3r, prior = params
    both = {"align3r": a3r, "prior": prior}
    jpipe = jreg.build_pipeline("align3r", input_size=SIZE, precision="fp32", attn_impl="xla",
                                params=both, model_kw=dict(enc=JViTConfig(**ENC), **DEC))
    tpipe = treg.build_pipeline("align3r", input_size=SIZE, precision="fp32", device="cpu",
                                params=align3r_pair_from_jax(both),
                                model_kw=dict(enc=TViTConfig(**ENC), **DEC))
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    return jpipe, tpipe


def _frames(seed):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (2, 7, 9, 3)).astype(np.uint8)
    return [np.ascontiguousarray(np.repeat(np.repeat(c, 8, 0), 8, 1)[:48, :64]) for c in coarse]


def test_pair_forward_matches_jax(pipes):
    """Both pair orders in one batch, the in-graph prior and the pose."""
    jpipe, tpipe = pipes
    f1, f2 = _frames(9)
    ref, ours = jpipe(f1, f2), tpipe(f1, f2)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        assert ours[k].shape == np.shape(ref[k]), k
        assert rel_err(ours[k], ref[k]) < REL_TOL, k
    np.testing.assert_allclose(np.linalg.det(ours["rotation"]), 1.0, atol=1e-5)
    assert ours["depth"].min() >= 1e-3
    with pytest.raises(ValueError, match="differ in size"):
        tpipe(f1, f2[:40])


def test_pair_command_writes_the_in_process_answer(pipes, monkeypatch, tmp_path):
    """``pair``: the PLY's points and colors and the pose JSON against the
    in-process call (and the JAX CLI's, run on the same pipeline)."""
    jpipe, tpipe = pipes
    paths = []
    for i, f in enumerate(_frames(10)):
        paths.append(str(tmp_path / f"frame{i}.png"))
        imageio.write_image(paths[-1], f)
    monkeypatch.setattr(treg, "build_pipeline", lambda name, **kw: tpipe)
    monkeypatch.setattr(jreg, "build_pipeline", lambda name, **kw: jpipe)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--image1", paths[0], "--image2", paths[1]]
    assert cli.main(["--device", "cpu", "pair", *args, "--out", out_t]) == 0
    assert jcli.main(["pair", *args, "--out", out_j]) == 0
    name = tpipe.spec.artifact_name()
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == sorted(
        f"frame0_{name}{s}" for s in (".jpg", ".ply", "_pose.json"))

    frames = [imageio.read_image(p) for p in paths]
    want = tpipe(*frames)
    pts, cols = read_ply(os.path.join(out_t, f"frame0_{name}.ply"))
    np.testing.assert_array_equal(pts, np.concatenate([want["pts1"].reshape(-1, 3),
                                                       want["pts2"].reshape(-1, 3)]))
    colors = [imageio.resize(f, (SIZE, SIZE)).reshape(-1, 3) for f in frames]
    np.testing.assert_array_equal(cols, np.concatenate(colors))
    with open(os.path.join(out_t, f"frame0_{name}_pose.json")) as f:
        pose = json.load(f)
    assert np.array_equal(pose["rotation"], want["rotation"].tolist())
    assert np.array_equal(pose["translation"], want["translation"].tolist())
    jpts, jcols = read_ply(os.path.join(out_j, f"frame0_{name}.ply"))
    assert rel_err(pts, jpts) < REL_TOL and np.array_equal(cols, jcols)
    with open(os.path.join(out_j, f"frame0_{name}_pose.json")) as f:
        jpose = json.load(f)
    assert rel_err(pose["rotation"], jpose["rotation"]) < REL_TOL
    assert rel_err(pose["translation"], jpose["translation"]) < REL_TOL


def test_keys_equal_the_manifest():
    with open(MANIFEST) as f:
        want = json.load(f)["keys"]
    with torch.device("meta"):
        got = {k: list(v.shape) for k, v in ta3r.Align3R().state_dict().items()}
    assert got == want
