"""Rules of the torch port as a package: it never imports JAX or the JAX
package, its entry points run on the card unless told otherwise, and its
registry, names and configuration follow the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import monocular_depth_estimation_trt_tpu.registry as jreg
from monocular_depth_estimation_trt_tpu import config as jconfig
from monocular_depth_estimation_trt_tpu_torch import config as tconfig
from monocular_depth_estimation_trt_tpu_torch import registry as treg
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log
from monocular_depth_estimation_trt_tpu_torch.weights import store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "monocular_depth_estimation_trt_tpu_torch")
JAX_PKG = "monocular_depth_estimation_trt_tpu"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "orbax", "optax")
DA_FAMILY = ("bridge", "depth_anything_ac", "depth_anything_v2", "distill_any_depth", "dkt")
PORTED = tuple(sorted(DA_FAMILY + ("depth_pro", "vggt", "depth_anything_v3", "metric3d_v2",
                                    "moge2", "metric_anything", "unidepth_v2", "unik3d",
                                    "sidepth", "geocalib", "prior_depth_anything",
                                    "streamvggt", "litevggt", "stream3r", "map_anything",
                                    "align3r", "dinov3", "video_depth_anything",
                                    "flashdepth", "raft", "neuflow", "meflow", "memfof",
                                    "waft", "cotracker3", "megasam", "vipe", "wildgs_slam")))


def _forbidden(module: str) -> bool:
    # the JAX package's name is a prefix of the port's: match it exactly
    return (module.split(".")[0] in FORBIDDEN_ROOTS
            or module == JAX_PKG or module.startswith(JAX_PKG + "."))


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_kernel_ab.py"),
             os.path.join(REPO, "scripts", "torch_int8_vggt_frames.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_forbidden_matcher_tells_the_two_packages_apart():
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".ops.resize")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen") and _forbidden("orbax")
    assert _forbidden("optax") and _forbidden("optax.schedules")
    assert not _forbidden(JAX_PKG + "_torch") and not _forbidden(JAX_PKG + "_torch.ops")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")


def test_no_port_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    for new in ("models/depth_pro.py", "ops/cuda/flash_attention.py", "weights/from_jax.py",
                "ops/quant.py", "ops/cuda/quant_matmul.py", "models/cotracker3.py",
                "slam/ba.py", "slam/recipes.py", "apps/tracking.py", "training/__init__.py",
                "training/losses.py", "training/metrics.py", "training/trainer.py",
                "training/distill.py", "weights/manifest.py"):
        assert os.path.join(PORT, new) in sources
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import monocular_depth_estimation_trt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "pkg.build_pipeline, pkg.list_models, pkg.ModelSpec\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {FORBIDDEN_ROOTS!r}\n"
        f"       or k == {JAX_PKG!r} or k.startswith({JAX_PKG + '.'!r})]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(pkg.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 15


def test_build_pipeline_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with store.allow_random_weights(True):
        with pytest.raises(RuntimeError, match="CUDA"):
            treg.build_pipeline("depth_anything_v2")
        with pytest.raises(RuntimeError, match="CUDA"):
            treg.build_pipeline("depth_anything_v2", encoder="vits", device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            treg.build_pipeline("vggt")
        with pytest.raises(RuntimeError, match="CUDA"):
            treg.build_pipeline("depth_pro")
        for name in ("depth_anything_v3", "metric3d_v2", "moge2", "metric_anything",
                     "unidepth_v2", "unik3d", "sidepth", "geocalib", "prior_depth_anything",
                     "video_depth_anything", "flashdepth", "raft", "neuflow", "meflow",
                     "memfof", "waft", "cotracker3", "megasam", "vipe", "wildgs_slam"):
            with pytest.raises(RuntimeError, match="CUDA"):
                treg.build_pipeline(name)
    assert treg.resolve_device("cpu") == torch.device("cpu")


def test_registry_lists_the_da_family_with_the_jax_fidelity():
    """The port's registry holds every name of the JAX registry, each with
    the JAX fidelity; an unknown name raises."""
    assert tuple(treg.list_models()) == PORTED == tuple(jreg.list_models())
    for name in PORTED:
        assert treg.get_fidelity(name) == jreg.get_fidelity(name)
    assert treg.get_fidelity("vggt") == treg.get_fidelity("depth_pro") == "converter-verified"
    assert treg.get_fidelity("megasam") == "approximated"
    with pytest.raises(KeyError):
        treg.build_pipeline("no_such_model")


@pytest.mark.parametrize("name", DA_FAMILY)
@pytest.mark.parametrize("kw", [
    {},
    {"encoder": "vitb", "precision": "fp16"},
    {"metric": True, "dataset": "vkitti", "precision": "fp32"},
    {"metric": True, "input_size": 364, "resize_mode": "lower_bound"},
])
def test_da_family_builds_with_the_jax_artifact_names(monkeypatch, name, kw):
    """Both registries build without weights here: the JAX side skips its
    param resolution, the port builds on the meta device."""
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline(name, **kw)
    tpipe = treg.build_pipeline(name, device="meta", **kw)
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.viz == jpipe.viz
    model = tpipe.model
    assert model.metric == bool(kw.get("metric", name == "dkt"))
    expected_max = 80.0 if kw.get("dataset") == "vkitti" else 20.0
    assert model.max_depth == expected_max


@pytest.mark.parametrize("kw", [{}, {"depth_only": True}, {"precision": "fp32"},
                                {"input_size": 364, "depth_only": True, "precision": "fp16"}])
def test_vggt_builds_with_the_jax_artifact_names(monkeypatch, kw):
    """The port builds the full-size VGGT on the meta device, no weights."""
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline("vggt", **kw)
    tpipe = treg.build_pipeline("vggt", device="meta", **kw)
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.viz == jpipe.viz == "metric"
    assert hasattr(tpipe.model, "camera_head") == (not kw.get("depth_only", False))
    assert callable(tpipe.multi_view) and callable(tpipe.benchmark_views)


@pytest.mark.parametrize("kw", [{}, {"precision": "fp32"}, {"precision": "fp16"},
                                {"attn_impl": "xla", "f_px": 1000.0}])
def test_depth_pro_builds_with_the_jax_artifact_names(monkeypatch, kw):
    """The port builds the full-size Depth Pro on the meta device, no weights."""
    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    jpipe = jreg.build_pipeline("depth_pro", **kw)
    tpipe = treg.build_pipeline("depth_pro", device="meta", **kw)
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.spec.input_hw == (1536, 1536)
    assert tpipe.viz == jpipe.viz == "metric"
    attn = tpipe.model.patch_encoder.blocks[0].attn
    assert attn.attn_impl == kw.get("attn_impl", "auto") and attn.num_heads == 16


@pytest.mark.parametrize("name,kw,roots", [
    ("depth_anything_v2", {"encoder": "vitl"}, ("pretrained",)),
    ("vggt", {}, ("aggregator",)),
    ("streamvggt", {}, ("aggregator",)),
    ("map_anything", {}, ("aggregator",)),
    ("depth_pro", {}, ("patch_encoder", "image_encoder")),
])
def test_int8_builds_with_the_jax_artifact_names(monkeypatch, name, kw, roots):
    """The full-size int8 builds on the meta device, no weights: calibration
    (which runs the model) reports layers that never fired, so every target
    is swapped for a QuantLinear; the spec and artifact name are the JAX
    package's."""
    from monocular_depth_estimation_trt_tpu_torch.ops import quant as tquant

    monkeypatch.setattr(jreg, "_params_for", lambda *a, **k: {})
    monkeypatch.setattr(store, "resolve_weights", lambda *a, **k: None)
    monkeypatch.setattr(tquant, "calibrate", lambda model, targets, samples: {
        t: torch.zeros(model.get_submodule(t).in_features, device="meta") for t in targets})
    jpipe = jreg.build_pipeline(name, precision="int8", **kw)
    tpipe = treg.build_pipeline(name, device="meta", precision="int8", **kw)
    assert tpipe.spec == tconfig.ModelSpec(**jpipe.spec.to_dict())
    assert tpipe.spec.artifact_name() == jpipe.spec.artifact_name()
    assert tpipe.spec.precision == "int8"
    swapped = [n for n, m in tpipe.model.named_modules() if isinstance(m, tquant.QuantLinear)]
    assert swapped and {n.split(".")[0] for n in swapped} == set(roots)
    assert not [n for n, m in tpipe.model.named_modules()
                if isinstance(m, torch.nn.Linear) and n.split(".")[0] in roots]
    layer = tpipe.model.get_submodule(swapped[0])
    assert layer.weight_q.dtype == torch.int8 and layer.qmul.dtype == torch.float32
    assert layer.out_dtype == torch.bfloat16


def test_every_int8_family_takes_calib_images():
    import inspect

    assert treg.INT8_FAMILIES <= set(treg.list_models())
    for name in sorted(treg.INT8_FAMILIES | {"dkt", "bridge"}):
        params = inspect.signature(getattr(treg, name)).parameters
        takes_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
        assert "calib_images" in params or (
            takes_kw and "calib_images" in inspect.signature(treg._build_da_family).parameters)
    with pytest.raises(ValueError, match="serving mode"):
        tconfig.compute_dtype("int8")


@pytest.mark.parametrize("fields", [
    dict(model="depth_anything_v2", encoder="vits"),
    dict(model="dkt", encoder="vitl", input_hw=(364, 518), precision="fp32",
         metric=True, dataset="hypersim"),
    dict(model="x", variant="normal", batch=4, extra=(("k", 3),), precision="fp16"),
])
def test_model_spec_and_config_match_jax(fields):
    assert (tconfig.ModelSpec(**fields).artifact_name()
            == jconfig.ModelSpec(**fields).artifact_name())
    assert tconfig.IMAGENET_MEAN == jconfig.IMAGENET_MEAN
    assert tconfig.IMAGENET_STD == jconfig.IMAGENET_STD
    assert tconfig.HALF_MEAN == jconfig.HALF_MEAN == tconfig.HALF_STD == jconfig.HALF_STD
    assert tconfig.BenchmarkConfig() == tconfig.BenchmarkConfig(
        **jconfig.BenchmarkConfig().__dict__)
    assert tconfig.compute_dtype("fp16") == tconfig.compute_dtype("bf16") == torch.bfloat16
    assert tconfig.compute_dtype("fp32") == torch.float32
    with pytest.raises(ValueError):
        tconfig.ModelSpec(model="m", precision="fp8")


def test_log_lines_carry_the_mdet_tag(capsys):
    log("hello %d", 3)
    log("careful", tag="WARN")
    assert capsys.readouterr().out.splitlines()[-2:] == ["[MDET] hello 3", "[WARN] careful"]
