"""What each rank of a CPU gloo group runs for ``tests/test_torch_parallel.py``
and ``tests/test_torch_sharding_families.py``: the port's meshes, sharding
rules, sharded forwards, sharded train step, lock-step server and
``--device-mesh`` command line. Imports torch and the port only (the ranks
are new processes; JAX stays in the test process, which compares).

Each function runs on every rank of the group
(``parallel.mesh.run_in_process_group``); rank 0's return value, plain
Python and numpy, goes back to the tests.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.parallel import (
    ShardingRules,
    get_mesh,
    replicate,
    rules_for_family,
    shard_batch,
    single_device_mesh,
    vit_tp_rules,
)

# The tiny configurations (the JAX side builds the same ones).
DA_V2 = dict(vit=dict(dim=64, depth=2, num_heads=2, pretrain_img_size=70),
             head=dict(features=16, out_channels=(8, 16, 32, 32)), taps=(0, 1, 0, 1), hw=(70, 70))
VGGT = dict(vit=dict(dim=48, depth=2, num_heads=2, pretrain_img_size=70),
            agg=dict(dim=64, depth=2, num_heads=4, head_layers=(0, 1, 0, 1), encoder="vits",
                     head_features=16, head_out_channels=(8, 16, 32, 32)),
            hw=(70, 70), views=2)
DEPTH_PRO = dict(geo=dict(img_size=256, window=64, stride0=48, stride1=32, hook_block_ids=(0, 1)),
                 vit=dict(dim=32, depth=3, num_heads=2, patch_size=16, pretrain_img_size=64),
                 head=dict(decoder_features=16, dims_encoder=(8, 16, 32, 32)), hw=(256, 256))
METRIC3D = dict(vit=dict(dim=64, depth=2, num_heads=2, pretrain_img_size=70),
                head=dict(features=16, out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1),
                          hidden=32, upsample_factor=7), hw=(56, 84), iters=2)
GEOMETRIC = dict(vit=dict(dim=64, depth=2, num_heads=2, pretrain_img_size=70), decoder_dim=64,
                 taps=(0, 1, 0, 1), hw=(70, 70))
MOGE = dict(vit=dict(dim=64, depth=2, num_heads=2, pretrain_img_size=70),
            cfg=dict(proj_dim=32, up_dims=(16, 16, 8), out_indices=(0, 1, 0, 1)), tokens=25,
            hw=(63, 112))
# the output each family's comparison reads
OUTPUT = {"depth_anything_v2": None, "vggt": "depth", "depth_pro": 0, "metric3d_v2": "depth",
          "unidepth_v2": "pts_3d", "moge2": "points"}


def port_model(name):
    """The port's tiny model of a family, fp32, plain attention route."""
    if name == "depth_anything_v2":
        from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
            DepthAnythingV2,
        )

        c = DA_V2
        return DepthAnythingV2(encoder="tiny", attn_impl="xla", vit_config=ViTConfig(**c["vit"]),
                               head_features=c["head"]["features"],
                               head_out_channels=c["head"]["out_channels"], out_indices=c["taps"])
    if name == "vggt":
        from monocular_depth_estimation_trt_tpu_torch.models import vggt

        cfg = vggt.VGGTConfig(vit_config=ViTConfig(**VGGT["vit"]), **VGGT["agg"])
        return vggt.VGGT(cfg, attn_impl="xla", with_camera=False)
    if name == "depth_pro":
        from monocular_depth_estimation_trt_tpu_torch.models import depth_pro

        cfg = depth_pro.DepthProConfig(**DEPTH_PRO["geo"],
                                       vit_config=ViTConfig(**DEPTH_PRO["vit"]))
        return depth_pro.DepthPro(cfg, attn_impl="xla", **DEPTH_PRO["head"])
    if name == "metric3d_v2":
        from monocular_depth_estimation_trt_tpu_torch.models import metric3d_v2

        cfg = metric3d_v2.Metric3DConfig(vit_config=ViTConfig(**METRIC3D["vit"]),
                                         **METRIC3D["head"])
        return metric3d_v2.Metric3DV2(iters=METRIC3D["iters"], attn_impl="xla", cfg=cfg)
    if name == "unidepth_v2":
        from monocular_depth_estimation_trt_tpu_torch.models import geometric

        cfg = geometric.GeometricConfig(vit_config=ViTConfig(**GEOMETRIC["vit"]),
                                        decoder_dim=GEOMETRIC["decoder_dim"],
                                        out_indices=GEOMETRIC["taps"])
        return geometric.GeometricDepthModel("tiny", "unidepth", "xla", cfg=cfg)
    if name == "moge2":
        from monocular_depth_estimation_trt_tpu_torch.models import moge2

        cfg = moge2.MoGeConfig(vit_config=ViTConfig(**MOGE["vit"]), **MOGE["cfg"])
        return moge2.MoGe2(num_tokens=MOGE["tokens"], predict_normal=False, attn_impl="xla",
                           cfg=cfg)
    raise KeyError(name)


def output_of(name, out):
    key = OUTPUT[name]
    return (out if key is None else out[key]).detach().float().numpy()


def _tensors(model):
    return [*model.named_parameters(), *model.named_buffers()]


def _forward(name, model, x):
    with torch.no_grad():
        return output_of(name, model(torch.from_numpy(x)))


# --- tests/test_torch_sharding_families.py -------------------------------------


def families(cases):
    """Each family's model on its weights, unsharded then placed by its
    family's rules over a 2x2 mesh: the sharded tensors, the sharded byte
    fraction, both outputs. Then int8 VGGT over 1x4 and one train step
    over 2x2."""
    torch.manual_seed(0)
    mesh = get_mesh((2, 2))
    out = {}
    for name, case in cases.items():
        model = port_model(name)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()},
                              strict=True)
        model.eval()
        plain = _forward(name, model, case["x"])
        rules_for_family(name).apply(mesh, model)
        sharded = {k: t for k, t in _tensors(model) if isinstance(t, DTensor)}
        total = sum(t.numel() * t.element_size() for _, t in _tensors(model))
        out[name] = dict(
            plain=plain, sharded_out=_forward(name, model, case["x"]), plans=_plans(model),
            sharded={k: str(t.placements[1]) for k, t in sharded.items()},
            fraction=sum(t.numel() * t.element_size() for t in sharded.values()) / total)
    out["int8_vggt"] = int8_vggt()
    out["train_step"] = train_step()
    return out


def _plans(model):
    """How each tensor-parallel layer of ``model`` passes its activations:
    name -> (a column layer's output: gather, split or the qkv's head count;
    whether a row layer's input arrives split)."""
    return {name: (str(mod.forward.args[1].output), mod.forward.args[1].split_input)
            for name, mod in model.named_modules()
            if getattr(getattr(mod, "forward", None), "args", None)}


def int8_vggt():
    """An int8 VGGT pipeline (head_dim 64) before and after placing it over
    a 1x4 mesh: the first qkv's weight_q placement and both depths."""
    from monocular_depth_estimation_trt_tpu_torch.models import vggt
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import set_allow_random_weights

    set_allow_random_weights(True)
    vit = dict(dim=128, depth=1, num_heads=2, pretrain_img_size=70)
    common = dict(dim=128, depth=2, num_heads=2, head_layers=(0, 1, 0, 1), encoder="vits",
                  head_features=16, head_out_channels=(8, 16, 32, 32))
    rng = np.random.default_rng(2)
    calib = [rng.integers(0, 256, (70, 70, 3), dtype=np.uint8) for _ in range(3)]
    pipe = build_pipeline("vggt", precision="int8", calib_images=calib, input_size=70,
                          device="cpu",
                          vggt_cfg=vggt.VGGTConfig(vit_config=ViTConfig(**vit), **common))
    img = np.random.default_rng(4).integers(0, 256, (70, 70, 3), dtype=np.uint8)
    ref = pipe(img)["depth"]
    pipe.apply_mesh(get_mesh((1, 4)))
    qkv = pipe.model.aggregator.frame_blocks[0].attn.qkv
    return dict(ref=ref, out=pipe(img)["depth"], kind=type(qkv).__name__,
                plans=_plans(pipe.model),
                weight_q=str(qkv.weight_q.placements) if isinstance(qkv.weight_q, DTensor)
                else "plain")


def _train_model():
    from monocular_depth_estimation_trt_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2,
    )

    torch.manual_seed(0)
    return DepthAnythingV2(encoder="tiny", attn_impl="xla",
                           vit_config=ViTConfig(dim=64, depth=2, num_heads=4,
                                                pretrain_img_size=70),
                           head_features=32, head_out_channels=(16, 32, 64, 64),
                           out_indices=(0, 1, 0, 1))


def _grads_at_step(state):
    """A dict that the state's next optimizer steps fill with each
    parameter's full gradient (a sharded one gathered), by name."""
    names = {id(p): k for k, p in state.params.items()}
    grads = {}

    def hook(opt, *_):
        for group in opt.param_groups:
            for p in group["params"]:
                g = p.grad
                if g is not None:
                    g = g.full_tensor() if isinstance(g, DTensor) else g
                    grads[names[id(p)]] = g.detach().clone().numpy()

    state.optimizer.register_step_pre_hook(hook)
    return grads


def train_step():
    """Two AdamW steps of a tiny DA-V2 on a batch of 4, unsharded and
    through shard_train_state + shard_batch_tree on a 2x2 mesh (JAX
    tests/test_training.py::test_sharded_train_step_matches_single_device):
    the first step's loss, gradients and update, and how far each
    replicated parameter differs between the ranks after the second."""
    from monocular_depth_estimation_trt_tpu_torch.training import (
        create_train_state,
        make_train_step,
        shard_batch_tree,
        shard_train_state,
        ssi_loss,
    )
    from monocular_depth_estimation_trt_tpu_torch.training.trainer import adamw

    model = _train_model()
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    images = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal(
        (4, 70, 70, 3))).astype(np.float32))
    target = images[..., 0] + 0.3 * images[..., 2]

    def loss_fn(params, batch):
        imgs, tgt = batch
        return ssi_loss(torch.func.functional_call(model, params, (imgs,)), tgt)

    step = make_train_step(loss_fn)
    s1 = create_train_state(params0, adamw(1e-3))
    grads = _grads_at_step(s1)
    s1, m1 = step(s1, (images, target))
    grads = dict(grads)

    mesh = get_mesh((2, 2))
    rules = vit_tp_rules()
    rules.apply(mesh, model)  # the layers' tensor-parallel forwards
    ss = shard_train_state(mesh, rules, create_train_state(params0, adamw(1e-3)))
    grads_sharded = _grads_at_step(ss)
    batch = shard_batch_tree(mesh, (images, target))
    s1_sh, m1_sh = step(ss, batch)
    grads_sharded = dict(grads_sharded)
    full = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().numpy().copy()
            for k, v in s1_sh.params.items()}  # a copy: the second step updates in place
    qkv = s1_sh.params["pretrained.blocks.0.attn.qkv.weight"]
    moment = ss.optimizer.state[qkv]["exp_avg"]
    step_after_one = s1_sh.step
    s2_sh, _ = step(s1_sh, batch)
    spread = {}
    for k, v in s2_sh.params.items():
        if not isinstance(v, DTensor):
            parts = [torch.empty_like(v) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, v.detach().contiguous())
            spread[k] = max(float((p - parts[0]).abs().max()) for p in parts)
    return dict(loss=float(m1["loss"]), loss_sharded=float(m1_sh["loss"]),
                grad_norm=float(m1["grad_norm"]), grad_norm_sharded=float(m1_sh["grad_norm"]),
                grads=grads, grads_sharded=grads_sharded,
                params={k: v.detach().numpy() for k, v in s1.params.items()},
                params_sharded=full, qkv=str(qkv.placements), moment=str(moment.placements),
                step=step_after_one, rank_spread=spread)


# --- tests/test_torch_parallel.py ----------------------------------------------


def four_ranks(frame):
    return dict(meshes=meshes_and_kernels(), pipeline=pipeline_meshes(frame))


def meshes_and_kernels():
    """Mesh shapes, placements, and the mdet operators on DTensor operands
    (on the CPU they run their plain versions)."""
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
    from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as qm

    out = {}
    default, square = get_mesh(), get_mesh((2, 2))
    out["default"] = dict(zip(default.mesh_dim_names, default.shape))
    out["square"] = dict(zip(square.mesh_dim_names, square.shape))
    try:
        get_mesh((3, 1))
        out["uncovered"] = "no error"
    except ValueError as e:
        out["uncovered"] = str(e)
    one = single_device_mesh("cpu")
    out["single"] = (one.size(), torch.equal(shard_batch(one, torch.ones(2)), torch.ones(2)))
    out["shard_batch"] = str(shard_batch(default, torch.zeros(16, 4)).placements)
    out["shard_batch_local"] = tuple(shard_batch(default, torch.zeros(16, 4)).to_local().shape)
    out["replicate"] = str(replicate(square, {"w": torch.zeros(3, 3)})["w"].placements)
    try:
        ShardingRules([(r"weight$", Shard(0))]).apply(square, torch.nn.LayerNorm(8))
        out["no_parallel_forward"] = "no error"
    except NotImplementedError as e:
        out["no_parallel_forward"] = str(e)

    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(4, 33, 3 * 2 * 64, generator=gen)
    want = fa.flash_attention_packed_reference(qkv, 2)
    for label, placements in (("k1_batch", [Shard(0), Replicate()]),
                              ("k1_columns", [Replicate(), Shard(2)])):
        got = torch.ops.mdet.flash_attention_packed(distribute_tensor(qkv, square, placements),
                                                    2, 0.125)
        out[label] = (str(got.placements), (got.full_tensor() - want).abs().max().item())
    q, k, v = (torch.randn(4, 2, 33, 64, generator=gen) for _ in range(3))
    want = fa.flash_attention_reference(q, k, v).transpose(1, 2)
    dq, dk, dv = (distribute_tensor(t, square, [Shard(0), Replicate()]) for t in (q, k, v))
    for name in ("flash_attention", "flash_attention_batched"):
        got = getattr(torch.ops.mdet, name)(dq, dk, dv, 0.125)
        out[name] = (str(got.placements), (got.full_tensor() - want).abs().max().item())
    x = torch.randn(8, 32, generator=gen)
    wq = torch.randint(-127, 128, (16, 32), generator=gen, dtype=torch.int8)
    qmul, scale = torch.rand(32, generator=gen) * 40, torch.rand(16, generator=gen) * 1e-3
    bias = torch.randn(16, generator=gen)
    want = qm.w8a8_matmul_reference(x, wq, qmul, scale, bias)
    R = [Replicate(), Replicate()]
    col = [Replicate(), Shard(0)]
    for label, args in (
            ("k4_rows", (distribute_tensor(x, square, [Shard(0), Replicate()]),
                         *(distribute_tensor(t, square, R) for t in (wq, qmul, scale, bias)))),
            ("k4_columns", (distribute_tensor(x, square, R), distribute_tensor(wq, square, col),
                            distribute_tensor(qmul, square, R),
                            distribute_tensor(scale, square, col),
                            distribute_tensor(bias, square, col))),
            ("k4_row_split_weight", (distribute_tensor(x, square, R),
                                     distribute_tensor(wq, square, [Replicate(), Shard(1)]),
                                     *(distribute_tensor(t, square, R)
                                       for t in (qmul, scale, bias))))):
        got = torch.ops.mdet.w8a8_matmul(*args, torch.float32)
        out[label] = (str(got.placements), bool(torch.equal(got.full_tensor(), want)))
    return out


def _toy_pipeline():
    from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
    from monocular_depth_estimation_trt_tpu_torch.weights.store import set_allow_random_weights

    set_allow_random_weights(True)
    c = DA_V2
    return build_pipeline("depth_anything_v2", encoder="tiny", input_size=70, precision="fp32",
                          device="cpu", attn_impl="xla",
                          model_kw=dict(vit_config=ViTConfig(**c["vit"]),
                                        head_features=c["head"]["features"],
                                        head_out_channels=c["head"]["out_channels"],
                                        out_indices=c["taps"]))


def pipeline_meshes(frame):
    """apply_mesh on a tiny DA-V2 pipeline: 1x1 (nothing changes) and 2x2."""
    pipe = _toy_pipeline()
    ref = pipe(frame, viz=True)
    before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    pipe.apply_mesh(single_device_mesh("cpu"))
    single = pipe(frame, viz=True)
    unchanged = all(type(v) is torch.Tensor and torch.equal(v, before[k])
                    for k, v in pipe.model.state_dict().items())
    pipe.apply_mesh(get_mesh((2, 2)))
    qkv = pipe.model.pretrained.blocks[0].attn.qkv.weight
    meshed = pipe(frame, viz=True)
    batch = pipe.batch_call(np.stack([frame, frame[::-1].copy()]))
    return dict(ref=ref["depth"], ref_viz=ref["viz"], single=single["depth"],
                single_viz=single["viz"], unchanged=unchanged, meshed=meshed["depth"],
                qkv=str(qkv.placements), batch=batch["depth"])


def two_ranks(frame_path, out_dirs, frames):
    """The command line, then the lock-step server, on a 2-rank group."""
    return dict(cli=command_line(frame_path, out_dirs), server=lockstep_server(frames))


def command_line(frame_path, out_dirs):
    """``run --device-mesh 2x1`` on every rank of a 2-rank group, each rank
    with its own output directory; then ``--device-mesh 4x1`` (too large)."""
    from monocular_depth_estimation_trt_tpu_torch import cli, registry

    registry._REGISTRY["toy_mesh"] = lambda **kw: _toy_pipeline()
    rank = dist.get_rank()
    rc = cli.main(["--device", "cpu", "run", "toy_mesh", "--image", frame_path,
                   "--out", out_dirs[rank], "--device-mesh", "2x1"])
    try:
        cli.main(["--device", "cpu", "run", "toy_mesh", "--image", frame_path,
                  "--out", out_dirs[rank], "--device-mesh", "4x1"])
        too_large = "no exit"
    except SystemExit as e:
        too_large = str(e)
    written = {r: sorted(os.listdir(d)) if os.path.isdir(d) else [] for r, d in
               enumerate(out_dirs)}
    dist.barrier()
    return dict(rc=rc, too_large=too_large, written=written)


def lockstep_server(frames):
    """A 2-rank mesh behind the HTTP server's worker: rank 0 serves, rank 1
    follows; the answers to two requests, and the unsharded pipeline's."""
    from monocular_depth_estimation_trt_tpu_torch.apps import server

    pipe = _toy_pipeline()
    ref = [pipe(f)["depth"] for f in frames] if dist.get_rank() == 0 else None
    pipe.apply_mesh(get_mesh((1, 2)))
    if dist.get_rank() != 0:
        server.follow(pipe)
        return None
    ds = server.DepthServer(server.lockstep(pipe), max_batch=1)
    ds.warmup()
    ds.start()
    try:
        jobs = [ds.submit(f, viz=False) for f in frames]
        for job in jobs:
            assert job.done.wait(60) and job.error is None, job.error
    finally:
        ds.stop()
        server.release_followers()
    return dict(ref=ref, got=[job.result["depth"] for job in jobs])
