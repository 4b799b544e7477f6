"""Per-family sharding on a CPU gloo group of 4 processes, against the JAX
package's ``parallel/sharding.py`` (the counterpart of
``tests/test_sharding_families.py`` and of the mesh cases of
``tests/test_quant.py`` and ``tests/test_training.py``).

For DA-V2, VGGT, Depth Pro, Metric3D, UniDepth V2 and MoGe-2 at tiny
configurations, with one set of weights on both sides: the port's rules
shard the tensors that the JAX tables shard on the JAX model (the JAX set
is mapped to upstream names through ``weights/from_jax.py``); more than a
quarter of the parameter bytes are sharded; the 2x2-sharded forward equals
the unsharded port at the JAX test's bars and the JAX forward at the
parity tests' bar. Then int8 VGGT over 1x4 (the JAX int8 TP bars) and one
sharded train step over 2x2 against the unsharded step (the JAX training
bars).

The group is spawned once (``tests/torch_parallel_members.py::families``)
and each test reads its part of rank 0's readings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import monocular_depth_estimation_trt_tpu.models.depth_anything_v2 as jda
import monocular_depth_estimation_trt_tpu.models.depth_pro as jdp
import monocular_depth_estimation_trt_tpu.models.geometric as jgeo
import monocular_depth_estimation_trt_tpu.models.metric3d_v2 as jm3
import monocular_depth_estimation_trt_tpu.models.moge2 as jmoge
import monocular_depth_estimation_trt_tpu.models.vggt as jvggt
import monocular_depth_estimation_trt_tpu.models.vit as jvit
from monocular_depth_estimation_trt_tpu.parallel.sharding import rules_for_family
from monocular_depth_estimation_trt_tpu_torch.parallel import run_in_process_group
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import state_dict_from_jax

import torch_parallel_members as members
from torch_port_params import lift_depth_pro_outputs, random_params, rel_err

FAMILIES = ("depth_anything_v2", "vggt", "depth_pro", "metric3d_v2", "unidepth_v2", "moge2")
# sharded vs unsharded: the JAX test's bars (the iterative GRU amplifies
# reduction-order noise); port vs JAX: the family parity tests' bar
SHARDED_TOL = {"vggt": 1e-4, "metric3d_v2": 1e-4}
DEFAULT_SHARDED_TOL = 2e-5
JAX_REL_TOL = 2e-3
MIN_FRACTION = 0.25


def _jax_model(name):
    f32 = dict(dtype=jnp.float32, attn_impl="xla")
    if name == "depth_anything_v2":
        c = members.DA_V2
        return jda.DepthAnythingV2(encoder="tiny", vit_config=jvit.ViTConfig(**c["vit"]),
                                   head_features=c["head"]["features"],
                                   head_out_channels=c["head"]["out_channels"],
                                   out_indices=c["taps"], **f32)
    if name == "vggt":
        c = members.VGGT
        cfg = jvggt.VGGTConfig(vit_config=jvit.ViTConfig(**c["vit"]), **c["agg"])
        return jvggt.VGGT(cfg=cfg, with_camera=False, **f32)
    if name == "depth_pro":
        c = members.DEPTH_PRO
        cfg = jdp.DepthProConfig(**c["geo"], vit_config=jvit.ViTConfig(**c["vit"]))
        return jdp.DepthPro(cfg=cfg, **c["head"], **f32)
    if name == "metric3d_v2":
        c = members.METRIC3D
        cfg = jm3.Metric3DConfig(vit_config=jvit.ViTConfig(**c["vit"]), **c["head"])
        return jm3.Metric3DV2(encoder="tiny", iters=c["iters"], cfg=cfg, **f32)
    if name == "unidepth_v2":
        c = members.GEOMETRIC
        cfg = jgeo.GeometricConfig(vit_config=jvit.ViTConfig(**c["vit"]),
                                   decoder_dim=c["decoder_dim"], out_indices=c["taps"])
        return jgeo.GeometricDepthModel(encoder="tiny", mode="unidepth", cfg=cfg, **f32)
    c = members.MOGE
    cfg = jmoge.MoGeConfig(vit_config=jvit.ViTConfig(**c["vit"]), **c["cfg"])
    return jmoge.MoGe2(encoder="tiny", num_tokens=c["tokens"], predict_normal=False, cfg=cfg,
                       **f32)


def _input(name, seed):
    hw = getattr(members, {"depth_anything_v2": "DA_V2", "vggt": "VGGT", "depth_pro": "DEPTH_PRO",
                           "metric3d_v2": "METRIC3D", "unidepth_v2": "GEOMETRIC",
                           "moge2": "MOGE"}[name])["hw"]
    lead = (1, members.VGGT["views"]) if name == "vggt" else (1,)
    return (np.random.default_rng(seed).standard_normal((*lead, *hw, 3)) * 0.5).astype(np.float32)


def _path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _jax_sharded(name, params):
    """The upstream names of the tensors the JAX table shards on the JAX
    model: each leaf marked 1 (sharded) or 0, then converted."""
    rules = rules_for_family(name)

    def mark(kp, leaf):
        spec = rules.spec_for(_path(kp), np.ndim(leaf))
        return np.full(np.shape(leaf), float(any(a is not None for a in spec)), np.float32)

    marked = state_dict_from_jax(jax.tree_util.tree_map_with_path(mark, params))
    mixed = [k for k, v in marked.items() if 0 < float(v.sum()) < v.numel()]
    assert not mixed, mixed
    return {k for k, v in marked.items() if v.numel() and bool((v == 1).all())}


@pytest.fixture(scope="module")
def readings():
    cases, expected = {}, {}
    for seed, name in enumerate(FAMILIES):
        model = _jax_model(name)
        x = _input(name, seed)
        params = random_params(model, jnp.asarray(x), seed=30 + seed)
        if name == "depth_pro":
            lift_depth_pro_outputs(params)
        out = jax.jit(lambda p, y, m=model: m.apply({"params": p}, y))(params, jnp.asarray(x))
        key = members.OUTPUT[name]
        expected[name] = dict(out=np.asarray(out if key is None else out[key], np.float32),
                              sharded=_jax_sharded(name, params))
        cases[name] = dict(x=x, state_dict={k: v.numpy() for k, v in
                                            state_dict_from_jax(params).items()})
    got = run_in_process_group(members.families, 4, cases)
    return expected, got


@pytest.mark.parametrize("name", FAMILIES)
def test_the_port_shards_the_tensors_jax_shards(readings, name):
    """The weights the port shards are those the JAX tables shard on the
    same model; every other sharded tensor is the bias or output scale of a
    column-split layer, split with its weight."""
    expected, got = readings
    sharded = got[name]["sharded"]
    weights = {k for k in sharded if k.endswith((".weight", ".weight_q"))}
    assert weights == expected[name]["sharded"]
    for k in set(sharded) - weights:
        layer = k.rsplit(".", 1)[0]
        assert k.endswith((".bias", ".out_scale")) and sharded[f"{layer}.weight"] == "S(0)", k


@pytest.mark.parametrize("name", FAMILIES)
def test_more_than_a_quarter_of_the_bytes_are_sharded(readings, name):
    assert readings[1][name]["fraction"] > MIN_FRACTION


@pytest.mark.parametrize("name", FAMILIES)
def test_the_sharded_forward_equals_the_unsharded_port(readings, name):
    got = readings[1][name]
    tol = SHARDED_TOL.get(name, DEFAULT_SHARDED_TOL)
    np.testing.assert_allclose(got["sharded_out"], got["plain"], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_the_sharded_forward_equals_the_jax_forward(readings, name):
    expected, got = readings
    assert got[name]["sharded_out"].shape == expected[name]["out"].shape
    assert rel_err(got[name]["sharded_out"], expected[name]["out"]) < JAX_REL_TOL


def test_the_metric3d_gru_shards_convq_alone_as_jax_does(readings):
    """JAX's ``gru/conv[zrq]/kernel`` misses its fused ``convzr``: only convq
    of the GRU's gates is split, in JAX and so in the port."""
    sharded = readings[1]["metric3d_v2"]["sharded"]
    assert sorted(k for k in sharded if k.startswith("gru.")) == ["gru.convq.bias",
                                                                  "gru.convq.weight"]
    assert any("resConfUnit" in k for k in sharded)


def test_column_outputs_stay_split_into_their_row_partners(readings):
    """Over 2 model ranks the MLP's fc1 -> fc2 and the residual units'
    conv1 -> conv2 hand the split activation on, and qkv -> proj runs each
    rank's heads (one all-reduce a pair); layers outside a pair gather. Over
    4 ranks a 2-head qkv is not split by heads: it gathers."""
    da = readings[1]["depth_anything_v2"]["plans"]
    block = "pretrained.blocks.0."
    assert da[block + "attn.qkv"] == ("2", False) and da[block + "attn.proj"] == ("gather", True)
    assert da[block + "mlp.fc1"] == ("split", False) and da[block + "mlp.fc2"] == ("gather", True)
    m3 = readings[1]["metric3d_v2"]["plans"]
    unit = next(k[: -len(".conv1")] for k in m3 if k.endswith("resConfUnit2.conv1"))
    assert m3[unit + ".conv1"] == ("split", False) and m3[unit + ".conv2"] == ("gather", True)
    assert all(v == ("gather", False) for k, v in m3.items() if k.endswith("gru.convq"))
    geo = readings[1]["unidepth_v2"]["plans"]
    assert any(k.endswith("fc1") and v == ("split", False) for k, v in geo.items()
               if not k.startswith("pixel_encoder") and ".mlp." not in k)
    int8 = readings[1]["int8_vggt"]["plans"]
    assert int8["aggregator.frame_blocks.0.attn.qkv"] == ("gather", False)
    assert int8["aggregator.frame_blocks.0.attn.proj"] == ("gather", False)


def test_int8_vggt_composes_with_tensor_parallel(readings):
    """int8 serving over a 1x4 mesh: the qkv's weight_q is column-sharded,
    and the depth agrees with the unsharded int8 pipeline (the row split's
    partial sums round in another order: JAX test_quant.py's bars)."""
    got = readings[1]["int8_vggt"]
    assert got["kind"] == "QuantLinear" and got["weight_q"] == "(Replicate(), Shard(dim=0))"
    out, ref = got["out"], got["ref"]
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999
    assert float(np.median(np.abs(out - ref)) / np.median(np.abs(ref))) < 0.01


def test_the_sharded_train_step_matches_the_unsharded_step(readings):
    """shard_train_state + shard_batch_tree over 2x2 (data x model): the
    same loss and update as the unsharded step (JAX test_training.py's
    bars), with the qkv weight and its AdamW moment split over model."""
    got = readings[1]["train_step"]
    assert got["loss_sharded"] == pytest.approx(got["loss"], rel=1e-4)
    assert got["grad_norm_sharded"] == pytest.approx(got["grad_norm"], rel=1e-3)
    assert got["step"] == 1
    assert sorted(got["params_sharded"]) == sorted(got["params"])
    for k, v in got["params"].items():
        np.testing.assert_allclose(got["params_sharded"][k], v, rtol=5e-2, atol=5e-4, err_msg=k)
    assert got["qkv"] == got["moment"] == "(Replicate(), Shard(dim=0))"


def _grad_rel(got, name):
    g, gs = got["grads"][name], got["grads_sharded"][name]
    return float(np.linalg.norm(gs - g) / np.linalg.norm(g))


def test_the_sharded_step_takes_the_unsharded_gradients(readings):
    """The first step's gradients, before AdamW's update (which a sign
    flip of a small gradient would pass): the encoder's, every replicated
    leaf upstream of a column split (patch and position embeddings, norms)
    included, at rel 1e-4; every other at rel 1e-3 (the head's last bias
    sums terms over every pixel that nearly cancel)."""
    got = readings[1]["train_step"]
    assert sorted(got["grads_sharded"]) == sorted(got["grads"])
    for name in ("pretrained.patch_embed.proj.weight", "pretrained.blocks.0.norm1.weight",
                 "pretrained.pos_embed", "pretrained.blocks.1.attn.qkv.weight"):
        assert name in got["grads"]
    for name in got["grads"]:
        bar = 1e-4 if name.startswith("pretrained.") else 1e-3
        assert _grad_rel(got, name) <= bar, (name, _grad_rel(got, name))


def test_the_replicated_parameters_stay_equal_across_ranks(readings):
    """After two sharded steps every plain (replicated) parameter is the
    same on all four ranks."""
    spread = readings[1]["train_step"]["rank_spread"]
    assert "pretrained.blocks.0.norm1.weight" in spread
    assert max(spread.values()) == 0.0, sorted(spread.items(), key=lambda kv: -kv[1])[:3]
