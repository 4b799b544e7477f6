"""The port's multi-platform artifacts (``runtime/export.py``): one file holds
a program for each platform it names, traced on fake tensors of that
platform's device, so that this CPU-only host writes the CUDA programs.

* tiny DA-V2 exported for ``("cpu", "cuda")``: the meta names both (the JAX
  key); the CPU program within REL_TOL of the JAX artifact exported for
  ``("cpu",)`` and equal to the in-process pipeline bit for bit; the CUDA
  program's inputs, constants and outputs all on ``cuda``;
* the CUDA programs were traced along the card's branches, not moved from
  a CPU trace: at head_dim 32 K2's operands (VGGT ``views_s2``) and K3's
  (Depth Pro) are zero-padded to 64 before the operator, and an int8 bf16
  DA-V2 with K % 16 != 0 hands K4 columns padded to 16; the CPU programs
  take the unpadded widths;
* the weights are stored once: a second platform adds its programs' bytes
  and nothing else;
* a stream module (StreamVGGT, window 2) and a flow pair module (WAFT)
  export for both platforms with the same operators on each;
* an artifact of the single-device layout still loads, a JAX artifact is
  refused, ``--platforms tpu`` exits 2, and a module that cannot be traced
  for a platform raises naming the model, the module and the platform."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.runtime.export import export_pipeline as jexport
from monocular_depth_estimation_trt_tpu.runtime.export import load_engine as jload
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
from monocular_depth_estimation_trt_tpu_torch.models import depth_pro as tdp
from monocular_depth_estimation_trt_tpu_torch.models import vggt as tvggt
from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig as TViTConfig
from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline
from monocular_depth_estimation_trt_tpu_torch.runtime import export as texport
from monocular_depth_estimation_trt_tpu_torch.runtime.export import (
    export_pipeline,
    load_engine,
    parse_platforms,
    read_meta,
)
from monocular_depth_estimation_trt_tpu_torch.weights.store import allow_random_weights

from test_torch_da_v2_slice import KERNEL
from test_torch_da_v2_slice import _pipelines as da_pipelines
from test_torch_export_parity import SIZE, _check, _frames

torch.set_num_threads(1)

BOTH = ("cpu", "cuda")
K1 = "mdet.flash_attention_packed.default"
K2 = "mdet.flash_attention.default"
K3 = "mdet.flash_attention_batched.default"
K4 = "mdet.w8a8_matmul.default"


def _program(path, platform, key):
    with zipfile.ZipFile(path) as z:
        return torch.export.load(z.open(f"modules/{platform}/{key}.bin"))


def _calls(ep, op):
    return [n for n in ep.graph.nodes if n.op == "call_function" and str(n.target) == op]


def _ops(ep):
    counts = {}
    for node in ep.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("mdet."):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def _vals(nodes):
    return [n.meta["val"] for n in nodes if isinstance(n.meta.get("val"), torch.Tensor)]


@pytest.fixture(scope="module")
def da(tmp_path_factory):
    """(JAX loaded engine, the port pipeline, the two-platform artifact, the
    cpu-only one), head_dim 64 (K1's route), with the viz epilogue."""
    d = tmp_path_factory.mktemp("platforms")
    with pytest.MonkeyPatch.context() as mp:
        jpipe, tpipe = da_pipelines(mp, KERNEL, port_attn="auto")
        jpath = jexport(jpipe, (SIZE, SIZE), path=str(d / "jax.mdeteng"), with_viz=True,
                        platforms=("cpu",))
        both = export_pipeline(tpipe, (SIZE, SIZE), path=str(d / "both.mdeteng"),
                               with_viz=True, platforms=BOTH)
        cpu = export_pipeline(tpipe, (SIZE, SIZE), path=str(d / "cpu.mdeteng"),
                              with_viz=True, platforms=("cpu",))
        yield jload(jpath), tpipe, both, cpu, jpath


def test_two_platform_artifact_serves_its_cpu_program(da):
    jeng, tpipe, both, _, _ = da
    meta = read_meta(both)
    assert meta["platforms"] == ["cpu", "cuda"] and "device" not in meta
    assert sorted(meta["export_seconds_by_platform"]) == ["cpu", "cuda"]
    teng = load_engine(both, "cpu")
    assert "platforms=['cpu', 'cuda'] device=cpu" in teng.describe()
    f = _frames(1, (SIZE, SIZE), seed=4)[0]
    _check(teng(f), jeng(f), tpipe(f, viz=True))


def test_cuda_program_lives_on_the_card(da):
    """Inputs, weights, the folded constants (the colormap table, the
    normalization and resampling constants) and outputs: all ``cuda``."""
    _, _, both, _, _ = da
    cpu, cuda = _program(both, "cpu", "b1_viz"), _program(both, "cuda", "b1_viz")
    assert _ops(cuda) == _ops(cpu) == {K1: KERNEL["vit"]["depth"]}
    placeholders = [n for n in cuda.graph.nodes if n.op == "placeholder"]
    assert {v.device.type for v in _vals(placeholders)} == {"cuda"}
    assert len(cuda.constants) >= 1
    assert {v.device.type for v in _vals(next(iter(
        n for n in cuda.graph.nodes if n.op == "output")).args[0])} == {"cuda"}
    # no constant reaches the card through a copy in the graph
    moves = [n for n in cuda.graph.nodes if n.op == "call_function"
             and n.target in texport._MOVES and n.args[0].op == "placeholder"
             and n.args[0].name.startswith("c_")]
    assert moves == []


def test_weights_are_stored_once_for_every_platform(da):
    _, _, both, cpu, _ = da
    with zipfile.ZipFile(both) as zb, zipfile.ZipFile(cpu) as zc:
        params_b = {i.filename: (i.CRC, i.file_size) for i in zb.infolist()
                    if i.filename.startswith("params/")}
        params_c = {i.filename: (i.CRC, i.file_size) for i in zc.infolist()
                    if i.filename.startswith("params/")}
        cuda_bytes = sum(i.compress_size for i in zb.infolist()
                         if i.filename.startswith("modules/cuda/"))
        meta_growth = (zb.getinfo("meta.json").compress_size
                       - zc.getinfo("meta.json").compress_size)
        n_cuda = sum(i.filename.startswith("modules/cuda/") for i in zb.infolist())
    assert params_b == params_c and params_b
    growth = os.path.getsize(both) - os.path.getsize(cpu)
    overhead = growth - cuda_bytes - meta_growth
    assert 0 <= overhead <= 200 * n_cuda  # the programs' zip headers, nothing else


def test_dispatched_indexing_computes_what_the_bindings_compute(da, monkeypatch, tmp_path):
    """The CUDA traces index through the dispatcher (``_DispatchedIndexing``):
    a CPU program traced that way equals the in-process pipeline bit for bit."""
    _, tpipe, _, _, _ = da
    monkeypatch.setattr(texport, "DISPATCHED_INDEXING", {"cpu", "cuda"})
    path = export_pipeline(tpipe, (SIZE, SIZE), path=str(tmp_path / "d.mdeteng"),
                           with_viz=True, platforms=("cpu",))
    f = _frames(1, (SIZE, SIZE), seed=11)[0]
    got, want = load_engine(path, "cpu")(f, viz=True), tpipe(f, viz=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _set(index, value):
    def fn(x):
        y = x.clone()
        y[index] = value(x) if callable(value) else value
        return y

    return fn


INDEXING = {
    "int": lambda x: x[1],
    "negative_int": lambda x: x[:, -1],
    "slices": lambda x: x[1:3, ::2],
    "none_ellipsis": lambda x: x[None, ..., 1:],
    "ellipsis_int": lambda x: x[..., 0],
    "tensor": lambda x: x[torch.tensor([2, 0, 2])],
    "tensor_after_slice": lambda x: x[:, torch.tensor([[1, 0], [3, 3]])],
    "two_tensors": lambda x: x[torch.tensor([0, 1]), :, torch.tensor([2, 3])],
    "list": lambda x: x[[0, 2]],
    "set_scalar": _set((slice(None), 1), 7.0),
    "set_tensor": _set((0, ..., slice(1, 3)), lambda x: x[1, ..., :2]),
    "set_advanced": _set(torch.tensor([0, 2]), -1.0),
    "copy_": lambda x: x.clone().transpose(0, 1).copy_(x.flip(0).transpose(0, 1)),
    "contiguous": lambda x: x.transpose(0, 2).contiguous(),
    "invert": lambda x: ~(x > 0),
}


@pytest.mark.parametrize("form", sorted(INDEXING))
def test_dispatched_indexing_is_the_bindings_indexing(form):
    """Each form through the aten operators (``_DispatchedIndexing``, how
    the CUDA programs are traced) against the bindings' own result."""
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5) - 20
    want = INDEXING[form](x)
    with texport._DispatchedIndexing():
        got = INDEXING[form](x)
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


def test_single_device_layout_still_loads_and_a_jax_artifact_is_refused(da, tmp_path):
    """An artifact of the earlier layout (meta ``device``, ``modules/<key>.bin``)
    loads as a one-platform artifact; asking it for another device raises
    the JAX package's hint."""
    _, tpipe, _, cpu, jpath = da
    old = str(tmp_path / "old.mdeteng")
    with zipfile.ZipFile(cpu) as src, zipfile.ZipFile(old, "w") as dst:
        for info in src.infolist():
            data = src.read(info)
            if info.filename == "meta.json":
                meta = json.loads(data)
                del meta["platforms"]
                meta.update(device="cpu", device_name="cpu")
                dst.writestr("meta.json", json.dumps(meta))
            else:
                info.filename = info.filename.replace("modules/cpu/", "modules/")
                dst.writestr(info, data)
    f = _frames(1, (SIZE, SIZE), seed=5)[0]
    got, want = load_engine(old, "cpu")(f, viz=True), tpipe(f, viz=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for path in (old, cpu):
        with pytest.raises(ValueError, match=r"exported for \['cpu'\]; re-export with "
                                             "--platforms including cuda"):
            load_engine(path, "cuda")
        with pytest.raises(ValueError, match="--platforms including cuda"):
            load_engine(path)  # the default device is the card
    with pytest.raises(ValueError, match="exported by the JAX package"):
        load_engine(jpath, "cpu")


def _da_int8_bf16():
    """DA-V2 int8 (bf16 activations) at width 40: every attention and MLP
    input linear has K = 40, no multiple of 16."""
    vit = dict(dim=40, depth=2, num_heads=2, pretrain_img_size=70)
    head = dict(features=16, out_channels=(8, 16, 32, 32))
    calib = _frames(2, (SIZE, SIZE), seed=1)
    with allow_random_weights():
        return treg.build_pipeline(
            "depth_anything_v2", encoder="tiny", input_size=SIZE, precision="int8",
            device="cpu", calib_images=calib,
            model_kw=dict(vit_config=TViTConfig(**vit), head_features=head["features"],
                          head_out_channels=head["out_channels"], out_indices=(0, 1, 0, 1)))


def _vggt_head_dim_32():
    vit = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIZE)
    cfg = tvggt.VGGTConfig(vit_config=TViTConfig(**vit), dim=128, depth=2, num_heads=4,
                           head_layers=(0, 1, 0, 1), encoder="vits", head_features=16,
                           head_out_channels=(8, 16, 32, 32))
    with allow_random_weights():
        return treg.build_pipeline("vggt", input_size=SIZE, precision="fp32", device="cpu",
                                   vggt_cfg=cfg)


def _depth_pro(dim, num_heads):
    """The 512 geometry (every ratio of the 1536 preset), 8 heads: the
    patch encoder's 35 windows take K3's route."""
    cfg = tdp.DepthProConfig(img_size=512, window=128, stride0=96, stride1=64,
                             hook_block_ids=(0, 1), vit_config=TViTConfig(
                                 dim=dim, depth=2, num_heads=num_heads, patch_size=16,
                                 pretrain_img_size=128))
    with allow_random_weights():
        return treg.build_pipeline("depth_pro", precision="fp32", device="cpu",
                                   model_kw=dict(cfg=cfg, decoder_features=16,
                                                 dims_encoder=(8, 16, 32, 32)))


def _kernel_width(d):
    return 64 if d <= 64 else -(-d // 128) * 128


CARD_BRANCHES = {
    # name: (pipeline, export kwargs, module, operator, the card's width of an operand)
    "vggt_views_k2": (_vggt_head_dim_32, dict(views=(2,), batches=()), "views_s2", K2,
                      _kernel_width),
    "depth_pro_k3": (lambda: _depth_pro(256, 8), {}, "b1", K3, _kernel_width),
    "int8_k4": (_da_int8_bf16, {}, "b1", K4, lambda k: k + -k % 16),
}


@pytest.mark.parametrize("name", sorted(CARD_BRANCHES))
def test_cuda_program_was_traced_along_the_card_branch(name, tmp_path):
    """Operator by operator, in graph order: the CUDA program hands the
    kernel the padded widths, the CPU program the model's own."""
    make, kw, key, op, on_card = CARD_BRANCHES[name]
    pipe = make()
    path = export_pipeline(pipe, pipe.spec.input_hw, path=str(tmp_path / f"{name}.mdeteng"),
                           platforms=BOTH, **kw)
    cpu, cuda = _program(path, "cpu", key), _program(path, "cuda", key)
    assert _ops(cpu) == _ops(cuda) and _ops(cuda)[op] >= 1

    def operands(program, device):
        # K4's (x, weight_q, ...): the K columns; K2/K3's (q, k, v, scale): d
        widths = []
        for node in _calls(program, op):
            vals = _vals(node.args[:2] if op == K4 else node.args[:3])
            assert {v.device.type for v in vals} == {device}
            assert len({v.shape[-1] for v in vals}) == 1
            widths.append(vals[0].shape[-1])
        return widths

    cpu_widths, cuda_widths = operands(cpu, "cpu"), operands(cuda, "cuda")
    assert cuda_widths == [on_card(w) for w in cpu_widths]
    assert any(w != on_card(w) for w in cpu_widths)  # the card branch pads here


class _QuantLayer(torch.nn.Module):
    def __init__(self, k, n, device):
        super().__init__()
        self.register_buffer("weight_q", torch.ones((n, k), dtype=torch.int8, device=device))
        self.register_buffer("qmul", torch.ones(k, device=device))
        self.register_buffer("out_scale", torch.ones(n, device=device))

    def forward(self, x):
        from monocular_depth_estimation_trt_tpu_torch.ops.cuda.quant_matmul import w8a8_matmul

        return w8a8_matmul(x, self.weight_q, self.qmul, self.out_scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("platform,k,want", [("cuda", 40, 48), ("cuda", 48, 48),
                                             ("cpu", 40, 40)])
def test_k4_card_branch_pads_k_in_both_types(platform, k, want, dtype):
    """The int8 pipelines run bf16, so no exported model hands K4 fp32
    activations; traced alone on fake tensors of each platform, the
    wrapper's card branch zero-pads x, weight_q and qmul to K % 16 == 0 in
    fp32 as in bf16 (the fp32 kernel's weight map needs 16-byte rows), and
    the CPU branch hands the operator the layer's own K."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        layer = _QuantLayer(k, 24, platform)
        x = torch.empty((2, 5, k), dtype=dtype, device=platform)
        ep = torch.export.export(layer, (x,), strict=False)
    (node,) = _calls(ep, K4)
    vals = _vals(node.args[:3])
    assert [v.shape[-1] for v in vals] == [want] * 3
    assert vals[0].dtype == dtype and {v.device.type for v in vals} == {platform}
    assert node.meta["val"].shape == (10, 24) and node.meta["val"].dtype == dtype


def _streamvggt():
    vit = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=SIZE)
    cfg = tvggt.VGGTConfig(vit_config=TViTConfig(**vit), dim=128, depth=2, num_heads=2,
                           head_layers=(0, 1, 0, 1), encoder="vits", head_features=16,
                           head_out_channels=(8, 16, 32, 32))
    with allow_random_weights():
        return treg.build_pipeline("streamvggt", input_size=SIZE, precision="fp32",
                                   device="cpu", vggt_cfg=cfg)


def _waft():
    with allow_random_weights():
        return treg.build_pipeline(
            "waft", precision="fp32", iters=2, encoder="tiny", input_hw=(56, 84), device="cpu",
            model_kw={"vit_config": TViTConfig(dim=128, depth=2, num_heads=2,
                                               pretrain_img_size=70)})


@pytest.mark.parametrize("name,make,in_hw,kw,key,ops", [
    ("stream", _streamvggt, (48, 64), dict(stream_window=2, batches=()), "stream",
     {K1: 1, K2: 2}),
    ("flow_pair", _waft, (56, 84), {}, "b1", {K1: 2}),
])
def test_stream_and_flow_pair_modules_export_for_both_platforms(name, make, in_hw, kw, key,
                                                                ops, tmp_path):
    path = export_pipeline(make(), in_hw, path=str(tmp_path / f"{name}.mdeteng"),
                           platforms=BOTH, **kw)
    meta = read_meta(path)
    assert meta["platforms"] == list(BOTH) and key in meta["modules"]
    for platform in BOTH:
        program = _program(path, platform, key)
        assert _ops(program) == ops, platform
        # no grad-mode region, which the load would refuse (a constant that
        # another builds inside the trace)
        assert not [n for n in program.graph.nodes if "grad" in str(n.target)], platform
    assert read_meta(path)["n_image_args"] == (2 if name == "flow_pair" else 1)


def test_platform_names():
    assert parse_platforms("cuda, cpu,cuda") == ("cuda", "cpu")
    assert parse_platforms(["cpu"]) == ("cpu",)
    for bad in ("tpu", "", "cpu,rocm"):
        with pytest.raises(ValueError, match="platforms must be"):
            parse_platforms(bad)
    # refused before any pipeline is built: the model name is never looked up
    assert cli.main(["--device", "cpu", "export", "no_such_model", "--platforms", "tpu"]) == 2


def test_a_platform_that_cannot_be_traced_raises_naming_it(tmp_path):
    def forward(img_u8, out_hw):
        if img_u8.device.type == "cuda":
            raise RuntimeError("this model has no card path")
        return {"depth": img_u8.float().mean(-1)}

    pipe = DepthPipeline(ModelSpec(model="cpu_only", input_hw=(8, 8)), forward, device="cpu",
                         viz="none")
    with pytest.raises(RuntimeError, match="cpu_only: module b1 cannot be traced for "
                                           "platform cuda: this model has no card path"):
        export_pipeline(pipe, (8, 8), path=str(tmp_path / "x.mdeteng"))
    path = export_pipeline(pipe, (8, 8), path=str(tmp_path / "y.mdeteng"), platforms=("cpu",))
    assert read_meta(path)["platforms"] == ["cpu"]
