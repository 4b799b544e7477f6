"""The port's optical-flow building blocks against the JAX package on the CPU:
the sampler and both correlation lookups (``ops/flow_sampler.py``), MeFlow's
1D lookups, the color wheel (``ops/flow_viz.py``), the convex upsamplings
(8x, 16x and 7x); the five flow models' state-dict layouts against their
upstream manifests and the torch mirrors (``tests/torch_mirror_*.py``)
through the JAX converters and back (``weights/from_jax.py``); random
weights that fill the norms; and the point-cloud viewer's fallbacks."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models.flow import meflow as jmeflow
from monocular_depth_estimation_trt_tpu.models.flow import memfof as jmemfof
from monocular_depth_estimation_trt_tpu.models.flow import raft as jraft
from monocular_depth_estimation_trt_tpu.models.flow import waft as jwaft
from monocular_depth_estimation_trt_tpu.ops import flow_sampler as jfs
from monocular_depth_estimation_trt_tpu.ops import flow_viz as jviz
from monocular_depth_estimation_trt_tpu.weights import convert as jconvert
from monocular_depth_estimation_trt_tpu_torch.apps import viewer
from monocular_depth_estimation_trt_tpu_torch.apps.ply import write_ply
from monocular_depth_estimation_trt_tpu_torch.models.flow import meflow as tmeflow
from monocular_depth_estimation_trt_tpu_torch.models.flow import memfof as tmemfof
from monocular_depth_estimation_trt_tpu_torch.models.flow import neuflow as tneuflow
from monocular_depth_estimation_trt_tpu_torch.models.flow import raft as traft
from monocular_depth_estimation_trt_tpu_torch.models.flow import waft as twaft
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops import flow_sampler as tfs
from monocular_depth_estimation_trt_tpu_torch.ops import flow_viz as tviz
from monocular_depth_estimation_trt_tpu_torch.weights import from_jax, store

from torch_port_params import rel_err

torch.set_num_threads(1)

EXACT = 1e-5  # fp32 functions on both sides: summation order only
MANIFESTS = os.path.join(os.path.dirname(jraft.__file__), "..", "..", "weights", "manifests")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def feats():
    """Two (B, H, W, C) feature maps and level-0 coordinates reaching past
    every edge."""
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 6, 8, 16
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    base = np.stack(np.meshgrid(np.arange(w), np.arange(h)), axis=-1).astype(np.float32)
    coords = base[None] + rng.uniform(-5.0, 5.0, (b, h, w, 2)).astype(np.float32)
    return f1, f2, coords


def test_bilinear_sample_matches_jax_past_the_edges():
    rng = np.random.default_rng(1)
    fmap = rng.standard_normal((2, 10, 12, 3)).astype(np.float32)
    x = rng.uniform(-2.5, 13.5, (2, 7, 9)).astype(np.float32)
    y = rng.uniform(-2.5, 11.5, (2, 7, 9)).astype(np.float32)
    x[0, 0, :3] = [-1.0, 11.0, 0.0]  # on the edges: whole and half taps
    ref = np.asarray(jfs.bilinear_sample_nhwc(jnp.asarray(fmap), jnp.asarray(x), jnp.asarray(y)))
    ours = tfs.bilinear_sample_nhwc(_t(fmap), _t(x), _t(y)).numpy()
    assert ours.shape == ref.shape == (2, 7, 9, 3)
    np.testing.assert_allclose(ours, ref, atol=EXACT)
    far = tfs.bilinear_sample_nhwc(_t(fmap), _t(x) + 100.0, _t(y))
    assert not far.any()  # wholly outside: zero


def test_avg_pool_and_pyramid_match_jax(feats):
    f1, f2, _ = feats
    np.testing.assert_allclose(tfs.avg_pool2x2(_t(f1[:, :5, :7])).numpy(),
                               np.asarray(jfs.avg_pool2x2(jnp.asarray(f1[:, :5, :7]))), atol=EXACT)
    ref = jfs.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    ours = tfs.build_corr_pyramid(_t(f1), _t(f2), 4)
    assert [tuple(p.shape) for p in ours] == [p.shape for p in ref] == [
        (96, 6, 8, 1), (96, 3, 4, 1), (96, 1, 2, 1), (96, 0, 1, 1)]
    for a, b in zip(ours[:3], ref[:3]):
        assert rel_err(a.numpy(), b) < EXACT


def test_both_lookups_match_jax_and_each_other(feats):
    """The gather and separable forms: the same taps in the same order (x
    offset on tap axis 0), zero outside, against JAX and against each
    other, as ``tests/test_flow.py:84`` holds them in JAX."""
    f1, f2, coords = feats
    pyr = tfs.build_corr_pyramid(_t(f1), _t(f2), 3)
    jpyr = jfs.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    gather = tfs.corr_lookup(pyr, _t(coords), 4).numpy()
    sep = tfs.corr_lookup_separable(pyr, _t(coords), 4).numpy()
    assert gather.shape == sep.shape == (2, 6, 8, 3 * 81)
    np.testing.assert_allclose(sep, gather, atol=EXACT)
    np.testing.assert_allclose(gather, np.asarray(jfs.corr_lookup(jpyr, jnp.asarray(coords), 4)),
                               atol=EXACT)
    np.testing.assert_allclose(
        sep, np.asarray(jfs.corr_lookup_separable(jpyr, jnp.asarray(coords), 4)), atol=EXACT)
    # tap order: at integer coordinates, tap (i, j) of level 0 is the
    # correlation with the pixel (x + i - 4, y + j - 4)
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(6)), -1).astype(np.float32)[None]
    taps = tfs.corr_lookup(pyr, _t(np.repeat(grid, 2, 0)), 4).numpy()[..., :81]
    corr0 = pyr[0].numpy().reshape(2, 6, 8, 6, 8)
    assert taps[0, 2, 3, 5 * 9 + 3] == pytest.approx(corr0[0, 2, 3, 2 - 1, 3 + 1], abs=EXACT)
    assert taps[1, 0, 0, 0] == 0.0  # (x - 4, y - 4) is outside


def test_meflow_1d_lookups_match_jax(feats):
    f1, f2, coords = feats
    pyr = tuple(tmeflow._corr_matrix(_t(f1), _t(f)) for f in (
        f2, tfs.avg_pool2x2(_t(f2)).numpy(), tfs.avg_pool2x2(tfs.avg_pool2x2(_t(f2))).numpy()))
    jpyr = tuple(jnp.asarray(p.numpy()) for p in pyr)
    np.testing.assert_allclose(
        pyr[0].numpy(), np.asarray(jmeflow._corr_matrix(jnp.asarray(f1), jnp.asarray(f2))),
        atol=EXACT)
    for horizontal in (True, False):
        ours = tmeflow.meflow_corr(pyr, _t(coords), 4, horizontal).numpy()
        ref = np.asarray(jmeflow.meflow_corr(jpyr, jnp.asarray(coords), 4, horizontal))
        assert ours.shape == ref.shape == (2, 6, 8, 17)
        np.testing.assert_allclose(ours, ref, atol=EXACT)


def test_flow_to_color_matches_jax_within_one_level():
    rng = np.random.default_rng(2)
    flow = rng.standard_normal((24, 32, 2)).astype(np.float32) * 3.0
    flow[0, 0] = [-1e-9, 0.0]  # the wheel's seam
    np.testing.assert_array_equal(tviz.color_wheel(), jviz.color_wheel())
    for clip in (None, 2.0):
        ours = tviz.flow_to_color(_t(flow), clip=clip).numpy()
        ref = np.asarray(jviz.flow_to_color(jnp.asarray(flow), clip=clip))
        assert ours.shape == ref.shape == (24, 32, 3) and ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    zero = tviz.flow_to_color(torch.zeros(4, 4, 2)).numpy()
    assert (zero == 255).all()  # no motion: white


@pytest.mark.parametrize("k,scale,channels", [(8, 8.0, 2), (16, 16.0, 2), (16, 1.0, 4), (7, 7.0, 2)])
def test_convex_upsamplings_match_jax(k, scale, channels):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 3, 5, channels)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 5, 9 * k * k)).astype(np.float32)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    if k == 8:
        ours, ref = traft.upsample_flow_convex(_t(x), _t(mask)), jraft.upsample_flow_convex(jx, jm)
    elif k == 16:
        ours = tmemfof.upsample_convex_16(_t(x), _t(mask), scale)
        ref = jmemfof.upsample_convex_16(jx, jm, scale)
    else:
        ours, ref = twaft.upsample_flow_convex_k(_t(x), _t(mask), k), \
            jwaft.upsample_flow_convex_k(jx, jm, k)
    assert tuple(ours.shape) == ref.shape == (2, 3 * k, 5 * k, channels)
    assert rel_err(ours.numpy(), ref) < EXACT


def _full_size(name):
    return {"raft": traft.RAFT, "neuflow": tneuflow.NeuFlow, "meflow": tmeflow.MeFlow,
            "memfof": tmemfof.MEMFOF, "waft_vits": twaft.WAFT}[name]()


@pytest.mark.parametrize("name,size", [("raft", 154), ("neuflow", 86), ("meflow", 162),
                                       ("memfof", 104), ("waft_vits", 206)])
def test_state_dict_keys_and_shapes_equal_upstream_manifests(name, size):
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        want = json.load(f)["keys"]
    with torch.device("meta"):
        model = _full_size(name)
    ours = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(ours) == len(want) == size
    assert ours == want


def _mirrors():
    from torch_mirror_meflow import TorchMeFlow
    from torch_mirror_memfof import TorchMEMFOF
    from torch_mirror_neuflow import TorchNeuFlow
    from torch_mirror_raft import TorchRAFT
    from torch_mirror_waft import TorchWAFT

    vit = dict(dim=64, depth=2, num_heads=2)
    return {
        "raft": (TorchRAFT, jconvert.convert_raft, from_jax.raft_from_jax,
                 lambda: traft.RAFT(iters=2)),
        "neuflow": (TorchNeuFlow, jconvert.convert_neuflow, from_jax.neuflow_from_jax,
                    lambda: tneuflow.NeuFlow(refine_iters_16=2, refine_iters_8=2)),
        "meflow": (TorchMeFlow, jconvert.convert_meflow, from_jax.meflow_from_jax,
                   lambda: tmeflow.MeFlow(iters=2)),
        "memfof": (TorchMEMFOF, jconvert.convert_memfof, from_jax.memfof_from_jax,
                   lambda: tmemfof.MEMFOF(iters=2)),
        "waft": (lambda: TorchWAFT(vit["dim"], vit["depth"], vit["num_heads"], iters=2,
                                   pretrain_img=70),
                 lambda sd: jconvert.convert_waft(sd, depth=vit["depth"]),
                 from_jax.waft_from_jax,
                 lambda: twaft.WAFT(iters=2, vit_config=ViTConfig(**vit, pretrain_img_size=70))),
    }


@pytest.mark.parametrize("family", ["raft", "neuflow", "meflow", "memfof", "waft"])
def test_from_jax_inverts_the_jax_converters(family):
    """A torch mirror's upstream-named state dict (``tests/torch_mirror_*.py``)
    loads into the port as it is (its BatchNorms' ``num_batches_tracked``
    dropped), and through the JAX converter and back every key returns:
    bit for bit, but for the BatchNorms, which come back folded (the same
    affine map) and the GRU gates, split from the fused ``convzr`` again."""
    make_mirror, convert, back, make_port = _mirrors()[family]
    torch.manual_seed(7)
    mirror = make_mirror()
    with torch.no_grad():  # running statistics away from (0, 1)
        for m in mirror.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    sd = {k: v.detach() for k, v in mirror.state_dict().items()}
    port = make_port()
    store.load_state_dict(port, sd)  # strict
    upstream = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(port.state_dict()) == sorted(upstream)
    got = back(convert(sd))
    assert sorted(got) == sorted(upstream)
    assert from_jax.state_dict_from_jax(convert(sd)).keys() == got.keys()
    bn = {k.rsplit(".", 1)[0] for k in upstream if k.endswith("running_var")}
    for k, v in upstream.items():
        if k.rsplit(".", 1)[0] not in bn:
            assert torch.equal(got[k], v), k
    for prefix in bn:
        def fold(s):
            scale = s[f"{prefix}.weight"] / torch.sqrt(s[f"{prefix}.running_var"] + 1e-5)
            return scale, s[f"{prefix}.bias"] - s[f"{prefix}.running_mean"] * scale
        for a, b in zip(fold(got), fold(upstream)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    port_back = make_port()
    store.load_state_dict(port_back, got)
    if family == "raft":  # the released checkpoints come from nn.DataParallel
        store.load_state_dict(port_back, {f"module.{k}": v for k, v in sd.items()})
        assert torch.equal(port_back.state_dict()["fnet.conv1.weight"], sd["fnet.conv1.weight"])


@pytest.mark.parametrize("name", ["raft", "neuflow", "meflow", "memfof", "waft"])
def test_init_random_fills_every_parameter_and_the_norms(name):
    """The registry builds on the meta device and fills random weights after:
    every parameter and BatchNorm statistic written; the BatchNorms and
    GroupNorms the identity, MEMFOF's aggregation gate 0 (the JAX inits)."""
    with torch.device("meta"):
        model = _mirrors()[name][3]()
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.fill_(float("nan"))
    store.init_random_(model, 0)
    assert [n for n, t in (*model.named_parameters(), *model.named_buffers())
            if torch.isnan(t).any()] == []
    for m in model.modules():
        if isinstance(m, traft.FoldedBatchNorm):
            x = torch.randn(1, m.num_features, 3, 3)
            torch.testing.assert_close(m(x), x, rtol=1e-6, atol=1e-6)
        if isinstance(m, torch.nn.GroupNorm):
            assert m.weight.eq(1).all() and not m.bias.any()
    if name == "memfof":
        assert float(model.update_block.aggregator_gamma.detach()) == 0.0


def test_viewer_falls_back_without_open3d_and_viser(tmp_path, capsys):
    assert not viewer.have_open3d() and not viewer.have_viser()
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    path = write_ply(str(tmp_path / "c.ply"), pts, rng.integers(0, 256, (50, 3), dtype=np.uint8))
    viewer.view_ply(path)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert f"{path}: 50 points" in line and str(pts.min(axis=0)) in line
    clouds = [(pts * i, None) for i in range(3)]
    viewer.stream_pointclouds(iter(clouds), out_dir=str(tmp_path / "stream"))
    written = sorted(os.listdir(tmp_path / "stream"))
    assert written == ["cloud_00000.ply", "cloud_00001.ply", "cloud_00002.ply"]
    from monocular_depth_estimation_trt_tpu_torch.apps.ply import read_ply

    got, col = read_ply(str(tmp_path / "stream" / written[2]))
    np.testing.assert_array_equal(got, pts * 2)
    assert col is None
    assert "wrote 3 .ply frames" in capsys.readouterr().out
