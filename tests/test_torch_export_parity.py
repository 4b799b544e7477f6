"""The port's artifacts of real families against the JAX package's on the
CPU, fp32, one set of weights on both sides (``weights/from_jax.py``): each
artifact is loaded on both sides (JAX through ``export_pipeline(...,
platforms=("cpu",))`` and ``load_engine``) and compared within REL_TOL; the
port's loaded artifact equals its in-process pipeline bit for bit. Then one
artifact is loaded in a process that cannot import the model zoo.

Families: tiny DA-V2 (b1, b2, viz; the head_dim-64 config, whose graph holds
K1's operator once a block), DA-V2 int8 on the JAX ``q8`` bundle (K4's
operator once a quantized linear) and WAFT's two-image artifact; VGGT's and
StreamVGGT's are in ``test_torch_export_parity_views.py``."""

import os
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu import registry as jreg
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu.models.flow import waft as jwaft
from monocular_depth_estimation_trt_tpu.runtime.export import export_pipeline as jexport
from monocular_depth_estimation_trt_tpu.runtime.export import load_engine as jload
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.quant import install_q8
from monocular_depth_estimation_trt_tpu_torch.runtime.export import export_pipeline, load_engine
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    q8_from_jax,
    state_dict_from_jax,
)

from test_torch_da_v2_slice import KERNEL, TINY
from test_torch_da_v2_slice import _pipelines as da_pipelines
from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

REL_TOL = 2e-3  # fp32 on both sides
SIZE = 70
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _ops(path, key, platform="cpu"):
    """Counts of the ``mdet`` operators in one module and platform of a port
    artifact."""
    with zipfile.ZipFile(path) as z:
        ep = torch.export.load(z.open(f"modules/{platform}/{key}.bin"))
    counts = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("mdet."):
            counts[name] = counts.get(name, 0) + 1
    return counts


def _both(tmp_path, name, jpipe, tpipe, in_hw, **kw):
    """(JAX loaded engine, port artifact path, port loaded engine)."""
    jpath = jexport(jpipe, in_hw, path=str(tmp_path / f"{name}_jax.mdeteng"),
                    platforms=("cpu",), **kw)
    tpath = export_pipeline(tpipe, in_hw, path=str(tmp_path / f"{name}.mdeteng"), **kw)
    return jload(jpath), tpath, load_engine(tpath, "cpu")


def _check(got, ref, here, keys=None):
    """``got`` (the port's loaded artifact) against the JAX artifact's
    outputs (REL_TOL) and the port's in-process outputs (bit for bit)."""
    for k in keys or ref:
        assert np.shape(got[k]) == np.shape(ref[k]), k
        if np.asarray(ref[k]).dtype == np.uint8:  # the viz: colormap steps
            assert np.mean(np.abs(got[k].astype(int) - np.asarray(ref[k]).astype(int)) > 3) < 0.01
        else:
            assert rel_err(got[k], ref[k]) < REL_TOL, k
        np.testing.assert_array_equal(got[k], here[k], err_msg=k)


@pytest.fixture(scope="module")
def da_tiny(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jpipe, tpipe = da_pipelines(mp, TINY)
        d = tmp_path_factory.mktemp("da")
        yield (jpipe, tpipe, *_both(d, "da", jpipe, tpipe, (SIZE, SIZE), with_viz=True,
                                     batches=(1, 2)))


def test_da_v2_b1_b2_and_viz_match_jax_and_in_process(da_tiny):
    """The b1_viz and b2_viz modules: a raw call falls back to them on both
    sides and gets the viz beside the depth."""
    _, tpipe, jeng, tpath, teng = da_tiny
    f1, f2 = _frames(2, (SIZE, SIZE), seed=3)
    _check(teng(f1), jeng(f1), tpipe(f1, viz=True))
    frames = np.stack([f1, f2])
    _check(teng.batch_call(frames, viz=True), jeng.batch_call(frames, viz=True),
           tpipe.batch_call(frames, viz=True))
    assert _ops(tpath, "b1_viz") == {}  # head_dim 32: the plain attention route


@pytest.fixture(scope="module")
def da_kernel(tmp_path_factory):
    """head_dim 64 (dim 128, 2 heads, 2 blocks): the port's default route,
    K1's operator; the JAX side runs its plain attention on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        jpipe, tpipe = da_pipelines(mp, KERNEL, port_attn="auto")
        d = tmp_path_factory.mktemp("k1")
        yield (jpipe, tpipe, *_both(d, "k1", jpipe, tpipe, (SIZE, SIZE)))


def test_head_dim_64_graph_holds_k1_once_a_block(da_kernel):
    _, tpipe, jeng, tpath, teng = da_kernel
    assert _ops(tpath, "b1") == {"mdet.flash_attention_packed.default": KERNEL["vit"]["depth"]}
    f = _frames(1, (48, 64), seed=4)[0]
    fitted = teng.fit(f)
    _check(teng(fitted), jeng(fitted), tpipe(fitted))


def test_loads_where_the_model_zoo_cannot_be_imported(da_kernel, tmp_path):
    """A second process in which importing the port's ``models`` or
    ``registry`` raises loads the artifact and answers as this one."""
    _, _, _, tpath, teng = da_kernel
    frame = _frames(1, (SIZE, SIZE), seed=8)[0]
    np.save(tmp_path / "frame.npy", frame)
    code = f"""
import importlib.abc, sys
import numpy as np
import torch
torch.set_num_threads(1)
BLOCKED = ("monocular_depth_estimation_trt_tpu_torch.models",
           "monocular_depth_estimation_trt_tpu_torch.registry", "jax",
           "monocular_depth_estimation_trt_tpu.")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.startswith(BLOCKED) or name == "monocular_depth_estimation_trt_tpu":
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from monocular_depth_estimation_trt_tpu_torch.runtime.export import load_engine
out = load_engine({tpath!r}, "cpu")(np.load({str(tmp_path / 'frame.npy')!r}), viz=True)
np.savez({str(tmp_path / 'out.npz')!r}, **out)
assert not [m for m in sys.modules if m.startswith(BLOCKED[:2])]
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    want = teng(frame, viz=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_int8_on_the_jax_q8_bundle(monkeypatch, tmp_path):
    """The JAX int8 pipeline in fp32 (its compute type patched), its q8
    bundle installed in the port's fp32 model: one K4 operator a quantized
    linear in the graph, the loaded artifacts within REL_TOL."""
    import monocular_depth_estimation_trt_tpu.config as jconfig

    jpipe32, tpipe = da_pipelines(monkeypatch, TINY)
    monkeypatch.setattr(jconfig, "compute_dtype", lambda precision: jnp.float32)
    calib = _frames(2, (80, 80), seed=1)
    jpipe = jreg.build_pipeline("depth_anything_v2", encoder="tiny", input_size=SIZE,
                                precision="int8", params=jpipe32.params, attn_impl="xla",
                                calib_images=calib)
    q8 = q8_from_jax(jpipe.params["q8"], "depth_anything_v2")
    install_q8(tpipe.model, q8)
    jeng, tpath, teng = _both(tmp_path, "q8", jpipe, tpipe, (SIZE, SIZE))
    assert _ops(tpath, "b1") == {"mdet.w8a8_matmul.default": len(q8)}
    assert len(q8) == 4 * TINY["vit"]["depth"]
    f = _frames(1, (SIZE, SIZE), seed=2)[0]
    _check(teng(f), jeng(f), tpipe(f))


def test_waft_two_image_artifact(tmp_path):
    hw = (56, 84)
    vit = dict(dim=128, depth=2, num_heads=2, pretrain_img_size=70)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, "tiny", jvit.ViTConfig(**vit))
        x = jnp.zeros((1, *hw, 3))
        params = random_params(jwaft.WAFT(iters=2, encoder="tiny"), x, x, seed=4)
        kw = dict(precision="fp32", iters=2, encoder="tiny", input_hw=hw)
        jpipe = jreg.build_pipeline("waft", params=params, **kw)
        tpipe = treg.build_pipeline("waft", params=state_dict_from_jax(params), device="cpu",
                                    model_kw={"vit_config": TViTConfig(**vit)}, **kw)
        jeng, tpath, teng = _both(tmp_path, "waft", jpipe, tpipe, hw)
    assert teng.meta["n_image_args"] == 2
    assert _ops(tpath, "b1") == {"mdet.flash_attention_packed.default": vit["depth"]}
    f1, f2 = _frames(2, hw, seed=9)
    _check(teng(f1, f2), jeng(f1, f2), tpipe(f1, f2))
