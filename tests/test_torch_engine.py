"""The port's engines, buffers and transfers on the CPU (``runtime/engine.py``,
``runtime/buffers.py``, ``runtime/transfer.py``), against the JAX package's
engine names and registry records. On the CPU an engine calls its function
eagerly; the captured graphs run on the card only
(``tests/test_torch_cuda_engine.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.config import ModelSpec as JModelSpec
from monocular_depth_estimation_trt_tpu.pipelines import DepthPipeline as JDepthPipeline
from monocular_depth_estimation_trt_tpu.runtime.engine import EngineRegistry as JEngineRegistry
from monocular_depth_estimation_trt_tpu_torch import cli
from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec
from monocular_depth_estimation_trt_tpu_torch.pipelines import VGGTPipeline
from monocular_depth_estimation_trt_tpu_torch.runtime.buffers import DeviceBuffer, IOBinding
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine, EngineRegistry
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import (
    device_put_chunked,
    supports_device_out,
    tree_fetch_async,
    tree_get_chunked,
)

SPEC = dict(model="toy_engine", encoder="vits", input_hw=(16, 16), precision="fp32")


def _forward(img_u8, out_hw):
    x = img_u8.float() / 255.0
    return {"depth": x[..., 0] + 1.0}


def _port_pipe():
    return VGGTPipeline(ModelSpec(**SPEC), _forward,
                        lambda v: {"depth": v[..., 0].float()}, device="cpu", viz="relative")


def _jax_pipe():
    def forward(params, img_u8, out_hw):
        return {"depth": img_u8.astype(jnp.float32)[..., 0] / 255.0 + 1.0}

    return JDepthPipeline(JModelSpec(**SPEC), forward, {}, viz="relative")


@pytest.mark.parametrize("hw,viz", [((20, 24), False), ((20, 24), True), ((7, 9), False)])
def test_engine_names_are_the_jax_packages(hw, viz):
    ours, ref = _port_pipe(), _jax_pipe()
    assert ours.engine_for(hw, viz).name == ref.engine_for(hw, viz).name
    assert (ours.batch_engine_for(hw, 4, viz).name
            == ref.batch_engine_for(hw, 4, with_viz=viz).name)


def test_views_engine_names_follow_the_jax_vggt_pipeline():
    # the JAX VGGTPipeline is local to its registry factory; its name rule:
    # f"{spec.artifact_name()}_views{s}_{h}x{w}", default size the input size
    pipe = _port_pipe()
    name = ModelSpec(**SPEC).artifact_name()
    assert pipe.views_engine(3).name == f"{name}_views3_16x16"
    assert pipe.views_engine(2, (20, 24)).name == f"{name}_views2_20x24"
    assert pipe.views_engine(3) is pipe.views_engine(3)


def test_cpu_engine_calls_eagerly_and_records_like_jax(tmp_path):
    pipe = _port_pipe()
    frame = np.random.default_rng(0).integers(0, 256, (20, 24, 3), dtype=np.uint8)
    eng = pipe.engine_for((20, 24), True)
    out = eng(torch.from_numpy(frame))
    eager = pipe._run(torch.from_numpy(frame), (20, 24), True)
    assert set(out) == {"depth", "viz"}
    for k in out:
        assert torch.equal(out[k], eager[k])
    assert eng.build_seconds is not None and eng.captured_launches is None
    # same record keys as the JAX registry, torch_version for jax_version
    entry = EngineRegistry().load(eng.name)
    assert entry["name"] == eng.name and entry["backend"] == "cpu"
    assert entry["inputs"] == [{"shape": [20, 24, 3], "dtype": "uint8"}]
    jax_keys = {"name", "build_seconds", "inputs", "backend", "jax_version", "timestamp"}
    assert set(entry) >= (jax_keys - {"jax_version"}) | {"torch_version"}
    assert eng.name in EngineRegistry().list()
    reg = JEngineRegistry(str(tmp_path))
    assert reg.path(eng.name).endswith(f"{eng.name}.json")  # the same file name rule


def test_engine_checks_its_signature():
    eng = Engine(lambda x: x * 2, (torch.zeros(2, 3),), name="toy_sig")
    assert torch.equal(eng(torch.ones(2, 3)), torch.full((2, 3), 2.0))
    with pytest.raises(ValueError, match="built for"):
        eng(torch.ones(3, 3))
    with pytest.raises(TypeError, match="arguments"):
        eng(torch.ones(2, 3), torch.ones(2, 3))
    with pytest.raises(TypeError, match="tensors"):
        Engine(lambda x: x, ((2, 3),))


def test_engine_on_a_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(lambda x: x, (torch.empty(4, device="meta"),), name="toy_cuda", device="cuda")


def test_pipeline_calls_through_engines_on_the_cpu():
    pipe = _port_pipe()
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    one = pipe(frames[0])
    assert isinstance(one["depth"], np.ndarray) and one["depth"].shape == (16, 16)
    dev = pipe(frames[0], device_out=True)
    assert isinstance(dev["depth"], torch.Tensor)
    batch = pipe.batch_call(frames, viz=True)
    assert batch["depth"].shape == (3, 16, 16) and batch["viz"].shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(batch["depth"][0], one["depth"])
    views = pipe.multi_view(frames)
    assert views["depth"].shape == (3, 16, 16)
    names = set(pipe._engines)
    assert len(names) == 3
    pipe.release_engines()
    assert not pipe._engines


def test_transfers_on_the_cpu():
    tree = {"a": torch.arange(4.0), "b": [np.ones(2), torch.zeros(2, dtype=torch.uint8)],
            "c": 3.5}
    host = tree_get_chunked(tree)
    assert isinstance(host["a"], np.ndarray) and host["a"].tolist() == [0, 1, 2, 3]
    assert isinstance(host["b"][1], np.ndarray) and host["b"][1].dtype == np.uint8
    assert host["c"] == 3.5
    assert tree_fetch_async(tree).result()["a"].tolist() == [0, 1, 2, 3]
    t = device_put_chunked(np.arange(6, dtype=np.uint8).reshape(2, 3), device="cpu")
    assert t.device.type == "cpu" and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert supports_device_out(_port_pipe()) and supports_device_out(_port_pipe().batch_call)
    assert not supports_device_out(lambda frame, viz=False: None)


def test_io_binding_runs_an_engine_on_the_cpu():
    binding = IOBinding({"x": ((2, 3), np.float32)},
                        {"y": ((2, 3), np.float32), "z": ((3,), np.float32)}, device="cpu")
    binding.inputs["x"].host = np.arange(6, dtype=np.float32)
    eng = Engine(lambda x: {"y": x + 1, "z": x.sum(0)}, (torch.zeros(2, 3),), name="toy_io")
    out = binding.run(eng)
    np.testing.assert_array_equal(out["y"], np.arange(6, dtype=np.float32).reshape(2, 3) + 1)
    np.testing.assert_array_equal(out["z"], [3, 5, 7])
    buf = DeviceBuffer((4,), np.uint8, name="u8", device="cpu")
    with pytest.raises(ValueError, match="size mismatch"):
        buf.host = np.zeros(5)
    buf.host = [1, 2, 3, 4]
    assert buf.h2d().tolist() == [1, 2, 3, 4] and buf.d2h().tolist() == [1, 2, 3, 4]
    binding.free()


def test_engines_command_lists_the_registry(capsys):
    pipe = _port_pipe()
    pipe.engine_for((5, 6)).compile()
    assert cli.main(["engines"]) == 0
    listed = capsys.readouterr().out
    assert pipe.engine_for((5, 6)).name in listed and "build=" in listed
    assert json.load(open(EngineRegistry().path(pipe.engine_for((5, 6)).name)))["inputs"]
