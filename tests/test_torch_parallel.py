"""Meshes, sharding rules, the kernels' operators on DTensors, ``apply_mesh``,
``--device-mesh`` and the lock-step server (the counterpart of the JAX
package's ``tests/test_parallel.py``, ``tests/test_parallel_vggt.py`` and
``tests/test_device_mesh_cli.py``).

JAX runs one process over 8 virtual CPU devices; PyTorch runs one process
per device, so the multi-device cases run on gloo groups of CPU processes
(``parallel.mesh.run_in_process_group``): one of 4 ranks for the meshes,
the operators and the pipeline, one of 2 ranks for the command line and
the server. Each group is spawned once; the tests read rank 0's readings
(``tests/torch_parallel_members.py``).
"""

import os

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from monocular_depth_estimation_trt_tpu.parallel import sharding as jsharding
from monocular_depth_estimation_trt_tpu_torch import cli, registry
from monocular_depth_estimation_trt_tpu_torch.parallel import (
    ShardingRules,
    get_mesh,
    replicate,
    rules_for_family,
    run_in_process_group,
    shard_batch,
    single_device_mesh,
    vit_tp_rules,
)
from monocular_depth_estimation_trt_tpu_torch.utils.imageio import write_image

import torch_parallel_members as members

ATOL = 2e-5  # the row split's all-reduce reorders fp32 sums


def _frame(seed=0, hw=(70, 70)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def four():
    return run_in_process_group(members.four_ranks, 4, _frame())


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    frame_path = write_image(str(tmp / "frame.png"), _frame(1, (48, 64)))
    out_dirs = [str(tmp / f"rank{r}") for r in range(2)]
    frames = [_frame(2), _frame(3)]
    return tmp, frame_path, out_dirs, run_in_process_group(members.two_ranks, 2, frame_path,
                                                           out_dirs, frames)


# --- meshes and placements ----------------------------------------------------


def test_get_mesh_default_puts_every_rank_on_data(four):
    assert four["meshes"]["default"] == {"data": 4, "model": 1}


def test_get_mesh_2d(four):
    assert four["meshes"]["square"] == {"data": 2, "model": 2}


def test_a_shape_that_does_not_cover_the_group_raises(four):
    assert four["meshes"]["uncovered"] == "mesh shape (3, 1) does not cover 4 devices"


def test_shard_batch_and_replicate(four):
    m = four["meshes"]
    assert m["shard_batch"] == "(Shard(dim=0), Replicate())"
    assert m["shard_batch_local"] == (4, 4)
    assert m["replicate"] == "(Replicate(), Replicate())"


def test_a_one_device_mesh_needs_no_group_and_changes_nothing():
    mesh = single_device_mesh("cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
    x = torch.ones(4, 2)
    assert shard_batch(mesh, x) is x and replicate(mesh, {"x": x})["x"] is x
    lin = torch.nn.Linear(4, 8)
    before = lin.weight
    vit_tp_rules().apply(mesh, lin)
    assert lin.weight is before and "forward" not in vars(lin)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        get_mesh((2, 1))


# --- the rule tables -----------------------------------------------------------

# (JAX flax path, the port's upstream name) of the same tensor
_PAIRS = [
    ("pretrained/blocks_0/attn/qkv/kernel", "pretrained.blocks.0.attn.qkv.weight"),
    ("pretrained/blocks_3/attn/proj/kernel", "pretrained.blocks.3.attn.proj.weight"),
    ("pretrained/blocks_3/mlp/fc1/kernel", "pretrained.blocks.3.mlp.fc1.weight"),
    ("pretrained/blocks_3/mlp/fc2/kernel", "pretrained.blocks.3.mlp.fc2.weight"),
    ("pretrained/blocks_3/mlp/w12/kernel", "pretrained.blocks.3.mlp.w12.weight"),
    ("pretrained/blocks_3/mlp/w3/kernel", "pretrained.blocks.3.mlp.w3.weight"),
    ("aggregator/frame_0/attn/qkv/kernel", "aggregator.frame_blocks.0.attn.qkv.weight"),
    ("pretrained/blocks_3/norm1/scale", "pretrained.blocks.3.norm1.weight"),
    ("depth_head/projects_0/kernel", "depth_head.projects.0.weight"),
]
_TRANSLATED = {P(None, "model"): Shard(0), P("model", None): Shard(1), P(): Replicate()}


@pytest.mark.parametrize("jax_path,name", _PAIRS)
def test_vit_rules_place_upstream_names_as_jax_places_its_paths(jax_path, name):
    """A JAX ``P(None, "model")`` on an (in, out) kernel is ``Shard(0)`` of
    the (out, in) weight, ``P("model", None)`` is ``Shard(1)``."""
    want = _TRANSLATED[jsharding.vit_tp_rules().spec_for(jax_path, 2)]
    assert vit_tp_rules().spec_for(name, 2) == want


def test_column_layers_split_their_bias_and_int8_buffers():
    rules = vit_tp_rules()
    for suffix in ("bias", "weight_q", "out_scale"):
        assert rules.spec_for(f"pretrained.blocks.0.attn.qkv.{suffix}", 1 + (suffix ==
                                                                             "weight_q")) == Shard(0)
    assert rules.spec_for("pretrained.blocks.0.attn.proj.weight_q", 2) == Shard(1)
    for name in ("pretrained.blocks.0.attn.proj.bias", "pretrained.blocks.0.attn.qkv.qmul"):
        assert rules.spec_for(name, 1) == Replicate()


def test_rules_for_family_default_is_vit():
    assert rules_for_family("depth_anything_v2").spec_for(
        "pretrained.blocks.0.attn.qkv.weight", 2) == Shard(0)
    assert rules_for_family("not_a_model").spec_for("x.attn.proj.weight", 2) == Shard(1)
    assert rules_for_family("unidepth_v2").spec_for("depth_module.blocks.1.kv.weight", 2) \
        == Shard(0)
    assert rules_for_family("metric3d_v2").spec_for("gru.convz.weight", 4) == Replicate()


def test_a_rule_on_a_layer_without_a_parallel_forward_raises(four):
    """Only Linear, Conv2d and QuantLinear layers have tensor-parallel
    forwards; a rule that reaches another layer is refused when applied
    (a one-device mesh applies nothing)."""
    rules = ShardingRules([(r"weight$", Shard(0))])
    norm = torch.nn.LayerNorm(8)
    assert rules.apply(single_device_mesh("cpu"), norm) is norm
    assert "LayerNorm" in four["meshes"]["no_parallel_forward"]


# --- the kernels' operators on DTensors -----------------------------------------


def test_k1_takes_a_batch_split_as_it_is(four):
    placements, err = four["meshes"]["k1_batch"]
    assert placements == "(Shard(dim=0), Replicate())" and err < 1e-6


def test_k1_never_runs_on_a_column_split_of_the_packed_qkv(four):
    """A column shard is all of q and part of k: the operator's strategies
    take whole batch items or the whole tensor, so the qkv is redistributed
    first, and the result is the full attention."""
    placements, err = four["meshes"]["k1_columns"]
    assert "dim=2" not in placements and err < 1e-6


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_batched"])
def test_k2_and_k3_take_a_batch_split_as_it_is(four, name):
    placements, err = four["meshes"][name]
    assert placements == "(Shard(dim=0), Replicate())" and err < 1e-6


@pytest.mark.parametrize("label,placements", [
    ("k4_rows", "(Shard(dim=0), Replicate())"),
    ("k4_columns", "(Replicate(), Shard(dim=1))"),
    ("k4_row_split_weight", "(Replicate(), Replicate())"),
])
def test_k4_keeps_its_numbers_under_every_split(four, label, placements):
    """Rows of x and output columns split exactly; a row-split weight is
    gathered before the kernel. The plain version's bits in every case."""
    got, equal = four["meshes"][label]
    assert got == placements and equal


# --- apply_mesh ------------------------------------------------------------------


def test_apply_mesh_on_one_device_changes_nothing(four):
    p = four["pipeline"]
    assert p["unchanged"]
    np.testing.assert_array_equal(p["single"], p["ref"])
    np.testing.assert_array_equal(p["single_viz"], p["ref_viz"])


def test_apply_mesh_2x2_preserves_numerics(four):
    p = four["pipeline"]
    np.testing.assert_allclose(p["meshed"], p["ref"], rtol=ATOL, atol=ATOL)


def test_batch_call_under_a_mesh_equals_single_calls(four):
    p = four["pipeline"]
    np.testing.assert_allclose(p["batch"][0], p["ref"], rtol=ATOL, atol=ATOL)


# --- the command line -------------------------------------------------------------


def _toy(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, "toy_mesh", lambda **kw: members._toy_pipeline())


def test_run_2x1_writes_on_rank_0_the_npz_of_the_1x1_run(two, monkeypatch):
    tmp, frame_path, out_dirs, got = two
    assert got["cli"]["rc"] == 0
    written = got["cli"]["written"]
    assert written[1] == [] and sorted(os.path.splitext(f)[1] for f in written[0]) == [
        ".jpg", ".npz"]
    _toy(monkeypatch)
    single = str(tmp / "single")
    assert cli.main(["--device", "cpu", "run", "toy_mesh", "--image", frame_path, "--out",
                     single, "--device-mesh", "1x1"]) == 0
    npz = next(f for f in written[0] if f.endswith(".npz"))
    assert sorted(os.listdir(single)) == sorted(written[0])
    a, b = np.load(os.path.join(out_dirs[0], npz)), np.load(os.path.join(single, npz))
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(a["depth"], b["depth"], rtol=ATOL, atol=ATOL)


def test_a_mesh_larger_than_the_group_exits_naming_the_devices(two, monkeypatch):
    assert two[3]["cli"]["too_large"] == "[MDET] --device-mesh 4x1 needs 4 devices; 2 available"
    _toy(monkeypatch)
    with pytest.raises(SystemExit, match="needs 2 devices; 1 available"):
        cli.main(["--device", "cpu", "run", "toy_mesh", "--device-mesh", "2x1"])


@pytest.mark.parametrize("bad", ["banana", "2x", "0x1", "1x2x3"])
def test_a_malformed_mesh_exits(monkeypatch, bad):
    _toy(monkeypatch)
    with pytest.raises(SystemExit, match="bad --device-mesh"):
        cli.main(["--device", "cpu", "bench", "toy_mesh", "--device-mesh", bad])


def test_device_mesh_1x1_runs_the_plain_path(monkeypatch, tmp_path):
    _toy(monkeypatch)
    applied = []
    real = members._toy_pipeline

    def spy(**kw):
        pipe = real()
        orig = pipe.apply_mesh
        pipe.apply_mesh = lambda mesh, rules=None: applied.append(
            dict(zip(mesh.mesh_dim_names, mesh.shape))) or orig(mesh, rules)
        return pipe

    monkeypatch.setitem(registry._REGISTRY, "toy_mesh", spy)
    frame = write_image(str(tmp_path / "frame.png"), _frame(4, (48, 64)))
    for mesh in ("", "1x1"):
        assert cli.main(["--device", "cpu", "run", "toy_mesh", "--image", frame, "--out",
                         str(tmp_path / (mesh or "plain")), "--device-mesh", mesh]) == 0
    assert applied == [{"data": 1, "model": 1}]
    npz = [f for f in os.listdir(tmp_path / "plain") if f.endswith(".npz")]
    a, b = (np.load(tmp_path / d / npz[0]) for d in ("plain", "1x1"))
    np.testing.assert_array_equal(a["depth"], b["depth"])


def test_bench_engine_refuses_a_device_mesh(monkeypatch):
    from monocular_depth_estimation_trt_tpu_torch.runtime import export

    monkeypatch.setattr(export, "read_meta", lambda path: {"in_hw": [70, 70]})
    assert cli.main(["bench", "--engine", "a.mdeteng", "--device-mesh", "1x1"]) == 2


def test_serve_engine_ignores_a_device_mesh_with_a_warning(monkeypatch, capsys):
    monkeypatch.setattr(cli, "_load_artifact", lambda *a, **kw: None)
    assert cli.main(["serve", "--engine", "a.mdeteng", "--device-mesh", "1x8"]) == 2
    assert "--device-mesh ignored" in capsys.readouterr().out


def test_the_parser_takes_device_mesh_where_jax_does():
    p = cli.build_parser()
    for argv in (["run", "x"], ["bench", "x"], ["views", "--images", "a"], ["serve", "x"]):
        a = p.parse_args([*argv, "--device-mesh", "1x8"])
        assert a.device_mesh == "1x8" and a.fn.__name__ == f"cmd_{argv[0]}"


# --- the server ---------------------------------------------------------------------


def test_a_two_rank_mesh_serves_as_the_unsharded_pipeline(two):
    """Rank 0 answers through its worker, rank 1 follows its calls."""
    got = two[3]["server"]
    assert len(got["got"]) == 2
    for ours, ref in zip(got["got"], got["ref"]):
        np.testing.assert_allclose(ours, ref, rtol=ATOL, atol=ATOL)
