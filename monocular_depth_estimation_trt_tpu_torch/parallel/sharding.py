"""Sharding rules: map parameter and buffer names to placements on a mesh
(counterpart of the JAX package's ``parallel/sharding.py``).

The tables follow the JAX package's as they act on the same models, with
the layouts translated. JAX matches flax paths (``.../attn/qkv/kernel``,
kernels ``(in, out)``, conv kernels HWIO); the port matches upstream dotted
names (``....attn.qkv.weight``, weights ``(out, in)``, conv weights OIHW).
So a JAX ``P(None, "model")`` on a dense kernel (column parallel) is
``Shard(0)`` on the torch weight and on its bias, and a JAX
``P("model", None)`` (row parallel) is ``Shard(1)`` with the bias
replicated; an HWIO output-channel split is ``Shard(0)`` of OIHW and an
input-channel split ``Shard(1)``. The int8 serving layers
(``ops/quant.py::QuantLinear``) keep ``weight_q``, ``out_scale`` and
``bias`` as buffers, which the rules place as the weight they replace
(JAX's ``attn/qkv/kernel`` rule also reaches ``kernel_q``).

:meth:`ShardingRules.apply` places a module's sharded parameters and
buffers with ``torch.distributed.tensor.distribute_tensor`` (every other
tensor stays a plain tensor, the same on every rank) and gives each layer
that holds a sharded tensor the tensor-parallel forward of its kind
(``nn.Linear``, ``nn.Conv2d``, ``QuantLinear``), which computes on the
layer's local shard. A column layer and its row partner (a table's
``pairs``) pass the activation on split, and the row layer's all-reduce over
the ``model`` axis ends the pair: an MLP's fc1 -> fc2, a residual unit's
conv1 -> conv2, and an attention's qkv -> proj, where each rank runs its own
heads (the packed qkv is gathered first, since a contiguous shard of it is
not a set of whole heads). Other column layers all-gather their output and
other row layers slice their input. So a ViT block over M model ranks runs
three collectives (the qkv gather, two all-reduces) and 1/M of its matmul
and attention work. In backward, a column layer's input gradient is summed
over the ``model`` ranks. The rest of the model runs on plain tensors, as
XLA runs what it does not partition. On a one-device mesh every placement
collapses to the plain tensor and nothing is changed.

The ``mdet`` operators (kernels K1 to K4) get sharding strategies for
DTensor operands (:func:`register_kernel_sharding`): batch sharding and
replication are taken as they are, K4 also takes a column-sharded weight,
and anything else is redistributed to replication before the kernel, as
XLA's partitioner does with a custom call it cannot partition. A
column-sharded packed qkv is not a set of whole heads, so K1 never runs on
a shard of its last axis. The port's own layers hand the kernels plain
local tensors (above); the strategies serve callers that hand them DTensors.

One JAX quirk is followed, not repaired: the JAX Metric3D rule
``.*gru/conv[zrq]/kernel`` misses JAX's fused ``convzr``, so JAX shards only
``convq`` among the GRU's gates; the port keeps upstream's separate
``convz``/``convr`` and shards ``convq`` alone, the same tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

# importing the kernels' modules registers their torch.ops.mdet operators
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention  # noqa: F401
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import quant_matmul as _qm
from monocular_depth_estimation_trt_tpu_torch.ops.quant import QuantLinear

COLUMN = Shard(0)  # an output-feature (output-channel) split
ROW = Shard(1)  # an input-feature (input-channel) split

# the tensors a column-parallel layer splits with its weight
_COLUMN_TENSORS = r"(weight|weight_q|bias|out_scale)"
_ROW_TENSORS = r"(weight|weight_q)"


def _placements(mesh: DeviceMesh, axis: str, placement: Placement):
    out = [Replicate()] * mesh.ndim
    out[mesh.mesh_dim_names.index(axis)] = placement
    return out


def replicate(mesh: DeviceMesh, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every tensor replicated over the mesh (plain tensors on a one-device
    mesh)."""
    if mesh.size() == 1:
        return dict(tensors)
    return {k: distribute_tensor(v, mesh, [Replicate()] * mesh.ndim) for k, v in tensors.items()}


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The leading (batch) axis split over ``axis`` (the plain tensor on a
    one-device mesh)."""
    if mesh.size() == 1:
        return x
    return distribute_tensor(x, mesh, _placements(mesh, axis, Shard(0)))


class ShardingRules:
    """Regex -> placement on the ``model`` axis, searched in order over
    dotted names; the first rule that matches and whose split dimension the
    tensor has wins, else ``default`` (replication).

    Example (VGGT aggregator tensor parallelism)::

        rules = ShardingRules([
            (r".*attn\\.qkv\\.(weight|bias)$", Shard(0)),
            (r".*attn\\.proj\\.weight$", Shard(1)),
        ])
        rules.apply(mesh, model)
    """

    def __init__(self, rules: Sequence[Tuple[str, Placement]],
                 default: Placement = Replicate(), axis: str = "model",
                 pairs: Sequence[Tuple[str, str, str]] = ()):
        self.rules = [(re.compile(pat), placement) for pat, placement in rules]
        self.default = default
        self.axis = axis
        # (parent regex, column child, row child): a column layer whose output
        # feeds its row partner split (see "the tensor-parallel forward" below)
        self.pairs = [(re.compile(pat), a, b) for pat, a, b in pairs]

    def spec_for(self, path: str, ndim: int) -> Placement:
        for pat, placement in self.rules:
            if pat.search(path) and (not isinstance(placement, Shard) or placement.dim < ndim):
                return placement
        return self.default

    def tree_specs(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, Placement]:
        return {k: self.spec_for(k, v.dim()) for k, v in tensors.items()}

    def place(self, mesh: DeviceMesh, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` placed by its rule: a DTensor where it is sharded, else ``t``."""
        placement = self.spec_for(name, t.dim())
        if mesh.size() == 1 or not isinstance(placement, Shard):
            return t
        return distribute_tensor(t, mesh, _placements(mesh, self.axis, placement))

    def apply(self, mesh: DeviceMesh, target):
        """Place a module's parameters and buffers (in place; returns the
        module) or a mapping of named tensors (returns a new dict)."""
        if not isinstance(target, nn.Module):
            return {k: self.place(mesh, k, v) for k, v in target.items()}
        if mesh.size() == 1:
            return target
        split = {}  # the layers holding a sharded tensor, by name
        for prefix, mod in target.named_modules():
            for store in (mod._parameters, mod._buffers):
                for name, t in list(store.items()):
                    if t is None:
                        continue
                    plain = t.detach()
                    placed = self.place(mesh, f"{prefix}.{name}" if prefix else name, plain)
                    if placed is plain:
                        continue
                    if store is mod._parameters:
                        placed = nn.Parameter(placed, requires_grad=t.requires_grad)
                    store[name] = placed
                    split[prefix] = mod
        outputs, split_inputs = self._pair_up(mesh, target, split)
        group = mesh.get_group(self.axis)
        for prefix, mod in split.items():
            plan = _Plan(mesh, self.axis, group, outputs.get(prefix, _GATHER),
                         prefix in split_inputs)
            mod.forward = _tensor_parallel_forward(mod, prefix, plan)
        return target

    def _pair_up(self, mesh: DeviceMesh, target: nn.Module, split):
        """The column layers whose output stays split into their row partner
        (name -> _SPLIT, or the attention's head count for a qkv), and the
        row layers that take a split input. An attention whose heads are
        split is left with its rank's heads and width."""
        from monocular_depth_estimation_trt_tpu_torch.models.vggt import RopeAttention
        from monocular_depth_estimation_trt_tpu_torch.models.vit import Attention

        ranks = mesh.size(mesh.mesh_dim_names.index(self.axis))
        outputs, split_inputs = {}, set()
        for prefix, mod in target.named_modules():
            for pat, first, second in self.pairs:
                a, b = (f"{prefix}.{c}" if prefix else c for c in (first, second))
                if not (pat.search(prefix) and a in split and b in split
                        and _split(_weight(split[a])) == COLUMN
                        and _split(_weight(split[b])) == ROW):
                    continue
                if first != "qkv":
                    outputs[a] = _SPLIT
                elif type(mod) in (Attention, RopeAttention) and mod.num_heads % ranks == 0:
                    # exactly these classes: a subclass may hold state per head
                    outputs[a] = mod.num_heads
                    mod.num_heads //= ranks
                    mod.dim //= ranks
                else:
                    continue
                split_inputs.add(b)
        return outputs, split_inputs


# --- the tensor-parallel forward of a layer holding sharded tensors -----------
#
# A column-split layer computes its output features from a replicated input;
# a row-split layer computes a partial output from its slice of the input's
# features, and the ``model`` ranks' partials are summed (one all-reduce). A
# pair with only elementwise work between its layers (an MLP's fc1 -> GELU ->
# fc2, a residual unit's conv1 -> ReLU -> conv2) keeps the column layer's
# output split into the row layer. An attention's packed qkv is gathered, since
# a contiguous shard of it is not a set of whole heads, and each rank keeps the
# q, k and v of its own heads: the rank's attention runs those heads, whose
# outputs are the proj's input features on that rank. Any other column layer
# gathers its output, and any other row layer slices its input.

_GATHER, _SPLIT = "gather", "split"


@dataclasses.dataclass(frozen=True)
class _Plan:
    mesh: DeviceMesh
    axis: str
    group: object  # the process group of this rank's ``axis`` ranks
    output: object  # a column layer's: _GATHER, _SPLIT or the qkv's head count
    split_input: bool  # a row layer's input arrives split


class _ToModel(torch.autograd.Function):
    """The identity forward; backward sums the gradient over the ``model``
    ranks. A column-split layer's input gets from its rank only the part of
    the gradient that flows through the rank's output features."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _to_model(x: torch.Tensor, plan: _Plan) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _ToModel.apply(x, plan.group)
    return x


def _weight(mod: nn.Module):
    return mod.weight_q if isinstance(mod, QuantLinear) else mod.weight


def _split(t) -> Optional[Placement]:
    """The placement of a DTensor on its mesh's ``model`` dimension (None for
    a plain tensor)."""
    if not isinstance(t, DTensor):
        return None
    return next((p for p in t.placements if not isinstance(p, Replicate)), None)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _slice(x: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim``, cut as a
    ``Shard(dim)`` weight is cut."""
    xd = DTensor.from_local(x, plan.mesh, [Replicate()] * plan.mesh.ndim, run_check=False)
    return xd.redistribute(plan.mesh,
                           _placements(plan.mesh, plan.axis, Shard(dim % x.dim()))).to_local()


def _row_input(x: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """A row layer's input: as it arrives where it arrives split, else this
    rank's slice."""
    return x if plan.split_input else _slice(x, plan, dim)


def _column_output(y: torch.Tensor, plan: _Plan, dim: int, full: int) -> torch.Tensor:
    """A column layer's output from this rank's ``Shard(dim)`` part ``y``:
    kept split, gathered, or gathered with this rank's heads kept."""
    if plan.output == _SPLIT:
        return y
    dim = dim % y.dim()
    shape = list(y.shape)
    shape[dim] = full
    stride, acc = [0] * len(shape), 1
    for i in reversed(range(len(shape))):
        stride[i], acc = acc, acc * shape[i]
    yd = DTensor.from_local(y.contiguous(), plan.mesh, _placements(plan.mesh, plan.axis, Shard(dim)),
                            run_check=False, shape=torch.Size(shape), stride=tuple(stride))
    y = yd.full_tensor()
    if plan.output == _GATHER:
        return y
    # (..., 3 * H * d) -> the rank's heads (..., 3 * H/M * d), q | k | v: each
    # rank's gradient covers its heads only, so the sum over the ranks is the
    # gathered output's
    ranks = plan.mesh.size(plan.mesh.mesh_dim_names.index(plan.axis))
    y = _to_model(y, plan).unflatten(-1, (3, ranks, -1))
    return y[..., plan.mesh.get_local_rank(plan.axis), :].flatten(-2)


def _reduce(y: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """The sum over the ``axis`` ranks of their partial ``y``."""
    return DTensor.from_local(y, plan.mesh, _placements(plan.mesh, plan.axis, Partial()),
                              run_check=False).full_tensor()


def _tensor_parallel_forward(mod: nn.Module, name: str, plan: _Plan):
    if isinstance(mod, QuantLinear):
        fn = _quant_linear_forward
    elif isinstance(mod, nn.Linear):
        fn = _linear_forward
    elif isinstance(mod, nn.Conv2d) and mod.groups == 1:
        fn = _conv_forward
    else:
        raise NotImplementedError(
            f"{name} ({type(mod).__name__}) holds a sharded tensor but has no "
            "tensor-parallel forward: only nn.Linear, nn.Conv2d (groups=1) and QuantLinear "
            "layers may match a sharding rule")
    return functools.partial(fn, mod, plan)


def _linear_forward(mod: nn.Linear, plan: _Plan, x):
    w = mod.weight  # read at call time: functional_call may have swapped it
    if _split(w) == COLUMN:
        y = F.linear(_to_model(x, plan), w.to_local(), _local(mod.bias))
        return _column_output(y, plan, -1, mod.out_features)
    y = _reduce(F.linear(_row_input(x, plan, -1), w.to_local()), plan)
    return y if mod.bias is None else y + mod.bias


def _conv_forward(mod: nn.Conv2d, plan: _Plan, x):
    w = mod.weight
    if _split(w) == COLUMN:
        y = mod._conv_forward(_to_model(x, plan), w.to_local(), _local(mod.bias))
        return _column_output(y, plan, 1, mod.out_channels)
    y = _reduce(mod._conv_forward(_row_input(x, plan, 1), w.to_local(), None), plan)
    return y if mod.bias is None else y + mod.bias[:, None, None]


def _quant_linear_forward(mod: QuantLinear, plan: _Plan, x):
    wq = mod.weight_q
    if _split(wq) == COLUMN:
        y = _qm.w8a8_matmul(x, wq.to_local(), mod.qmul, _local(mod.out_scale),
                            _local(mod.bias), mod.out_dtype)
        return _column_output(y, plan, -1, mod.out_features)
    x_local = _row_input(x, plan, -1)
    qmul = _slice(mod.qmul, plan, 0)
    y = _reduce(_qm.w8a8_matmul(x_local, wq.to_local(), qmul, mod.out_scale, None,
                                mod.out_dtype), plan)
    return y if mod.bias is None else (y.float() + mod.bias).to(y.dtype)


# --- the tables -------------------------------------------------------------------

# ViT-style transformers (every DinoViT in the zoo, whatever its parent's name:
# pretrained, encoder, pixel_encoder, patch_encoder, image_encoder ..., the VGGT
# aggregator and its camera trunk). Column-parallel qkv/fc1/w12, row-parallel
# proj/fc2/w3.
VIT_TP_RULES = [
    (rf".*attn\.qkv\.{_COLUMN_TENSORS}$", COLUMN),
    (rf".*attn\.proj\.{_ROW_TENSORS}$", ROW),
    (rf".*mlp\.fc1\.{_COLUMN_TENSORS}$", COLUMN),
    (rf".*mlp\.fc2\.{_ROW_TENSORS}$", ROW),
    (rf".*mlp\.w12\.{_COLUMN_TENSORS}$", COLUMN),
    (rf".*mlp\.w3\.{_ROW_TENSORS}$", ROW),
]
# qkv -> attention -> proj over each rank's heads; fc1 -> GELU -> fc2 split
# (SwiGLU's w12 output is cut in two halves, so it is gathered)
VIT_TP_PAIRS = [(r"(^|\.)attn$", "qkv", "proj"), (r"(^|\.)mlp$", "fc1", "fc2")]

# The cross/self-attention decoder blocks of the geometric family
# (models/geometric.py CrossAttentionBlock: camera.cross, camera.self_block,
# depth_module.blocks.N, rays_module.block0): q/kv split over heads (column),
# proj row; the MLP as the ViT's.
_XATTN = r"(cross|self_block|blocks\.\d+|block0)"
CROSS_ATTN_TP_RULES = [
    (rf".*{_XATTN}\.(q|kv|fc1)\.{_COLUMN_TENSORS}$", COLUMN),
    (rf".*{_XATTN}\.(proj|fc2)\.{_ROW_TENSORS}$", ROW),
]
CROSS_ATTN_TP_PAIRS = [(rf"(^|\.){_XATTN}$", "fc1", "fc2")]

# Metric3D V2's decoder: the DPT-neck fusion blocks as a conv pair
# (ResidualConvUnit conv1 output channels, conv2 input channels) and the
# ConvGRU's convq over its hidden channels (JAX's convzr is not matched: see the
# module docstring). Upstream's refinenet4.resConfUnit1 is never run and the
# JAX model has none: it stays replicated.
_RUN_UNITS = r"^(?!.*refinenet4\.resConfUnit1\.).*resConfUnit\d"
METRIC3D_DECODER_TP_RULES = [
    (rf"{_RUN_UNITS}\.conv1\.(weight|bias)$", COLUMN),
    (rf"{_RUN_UNITS}\.conv2\.weight$", ROW),
    (r"(^|.*\.)gru\.convq\.(weight|bias)$", COLUMN),
]
METRIC3D_DECODER_TP_PAIRS = [(rf"{_RUN_UNITS}$", "conv1", "conv2")]  # conv1 -> ReLU -> conv2


def vit_tp_rules() -> ShardingRules:
    return ShardingRules(VIT_TP_RULES, pairs=VIT_TP_PAIRS)


def geometric_tp_rules() -> ShardingRules:
    """UniDepth V2 / UniK3D / MoGe-2 / Metric Anything: ViT encoder TP +
    cross-attention decoder TP."""
    return ShardingRules(VIT_TP_RULES + CROSS_ATTN_TP_RULES,
                         pairs=VIT_TP_PAIRS + CROSS_ATTN_TP_PAIRS)


def metric3d_tp_rules() -> ShardingRules:
    """Metric3D V2: ViT encoder TP + DPT-neck/GRU decoder channel split."""
    return ShardingRules(VIT_TP_RULES + METRIC3D_DECODER_TP_RULES,
                         pairs=VIT_TP_PAIRS + METRIC3D_DECODER_TP_PAIRS)


# Registry family -> rule factory; every other family takes the ViT table.
FAMILY_TP_RULES = {
    "unidepth_v2": geometric_tp_rules,
    "unik3d": geometric_tp_rules,
    "moge2": geometric_tp_rules,
    "metric_anything": geometric_tp_rules,
    "metric3d_v2": metric3d_tp_rules,
}


def rules_for_family(name: Optional[str]) -> ShardingRules:
    """Sharding rules for a registry family name (default: the ViT table)."""
    return FAMILY_TP_RULES.get((name or "").lower(), vit_tp_rules)()


# --- DTensor strategies of the kernels' operators ---------------------------------


def register_kernel_sharding() -> None:
    """Sharding strategies of ``torch.ops.mdet.*`` for DTensor operands: each
    item is (output placements, input placements) on one mesh dimension,
    None for an argument that is not a tensor."""
    from torch.distributed.tensor.experimental import register_sharding

    R, B = Replicate(), Shard(0)

    @register_sharding(torch.ops.mdet.flash_attention_packed.default)
    def _(qkv, num_heads, scale):
        return [([R], [R, None, None]), ([B], [B, None, None])]

    @register_sharding([torch.ops.mdet.flash_attention.default,
                        torch.ops.mdet.flash_attention_batched.default])
    def _(q, k, v, scale):
        return [([R], [R, R, R, None]), ([B], [B, B, B, None])]

    @register_sharding(torch.ops.mdet.w8a8_matmul.default)
    def _(x, weight_q, qmul, out_scale, bias, out_dtype):
        b = None if bias is None else R
        cb = None if bias is None else COLUMN
        return [([R], [R, R, R, R, b, None]),  # replicated
                ([B], [B, R, R, R, b, None]),  # rows of x split
                ([Shard(1)], [R, COLUMN, R, COLUMN, cb, None])]  # output features split


register_kernel_sharding()
