"""Serialized engine artifacts: the port's ``.engine`` file (counterpart of
the JAX package's ``runtime/export.py``).

The reference's deployment artifact is a serialized TensorRT plan that a
second process deserializes and runs with no model code
(``Depth_Anything_V2/onnx2trt.py:60-68``, ``common_runtime.py``). Here
:func:`export_pipeline` writes a pipeline's fused programs (preprocess,
model, postprocess and, where asked, the colormap) with ``torch.export``
into one ``.mdeteng`` zip, and :func:`load_engine` reads it back into a
:class:`LoadedEngine` that serves with the pipeline's calling convention
and imports none of the model zoo. The kernels K1 to K4 are ``mdet``
operators (``ops/cuda/``), so an exported graph holds them.

One artifact holds a program for each platform it names (``cpu``,
``cuda``; by default both, as the JAX package's holds ``cpu`` and ``tpu``):
each module is traced once per platform on fake tensors of that platform's
device, so a host with no card builds the CUDA programs, and each platform
is traced along its own branches (the wrappers pad K2/K3's heads and K4's
columns on a card only). The pipeline may live on either device.

Container (``MDETENG`` v2, the JAX package's layout):

* ``meta.json``: model, artifact, in_hw, precision, viz, metric, inputs,
  ``n_image_args``, ``output_names``, the module table keyed
  ``b<batch>[_viz]``, ``views_s<S>`` and ``stream``, the weight manifest,
  ``platforms`` (the JAX key) and ``runtime: "torch"`` with
  ``torch_version`` (a JAX artifact, which has no runtime, is refused);
* ``modules/<platform>/<key>.bin``: one ``torch.export.save``d program per
  module and platform, each a function of ``(weights, *images)`` (the
  stream module ``(weights, frame, state) -> (outputs, state')``); a
  constant that a forward builds (``ops/constants.py``) is stored on the
  host and goes to the platform's device at load;
* ``params/<i>.bin``: the weights, stored once, uncompressed, and shared by
  every module and platform: each distinct tensor storage of the pipeline's
  modules is one entry (a streaming model that shares the joint model's
  tensors adds none);
* ``state/<i>.bin``: the stream's initial state, where it is not zero; a
  zero tensor is a manifest entry only and is made on the device at load.

:func:`load_engine` reads the programs of one platform, the device its
caller asks for (``cuda`` unless told otherwise), and raises where the
artifact lacks that platform or the device is a card and none is present.
On the card each loaded module is served through
``runtime/engine.py::Engine``: the first call at a module captures a CUDA
graph, later calls replay it. An artifact of the single-device layout
(``device`` in its meta, ``modules/<key>.bin``) loads as one of that
platform.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec, cache_dir
from monocular_depth_estimation_trt_tpu_torch.runtime.engine import Engine
from monocular_depth_estimation_trt_tpu_torch.runtime.transfer import tree_get_chunked
from monocular_depth_estimation_trt_tpu_torch.utils.logging import log

_META_NAME = "meta.json"
FORMAT_VERSION = 2
RUNTIME = "torch"  # tells the port's artifacts from the JAX package's
PLATFORMS = ("cpu", "cuda")  # the device types a program can be traced for
DEFAULT_PLATFORMS: Tuple[str, ...] = PLATFORMS


def exported_dir() -> str:
    d = os.path.join(cache_dir(), "exported")
    os.makedirs(d, exist_ok=True)
    return d


def _module_key(batch: int, viz: bool) -> str:
    return f"b{batch}" + ("_viz" if viz else "")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def parse_platforms(platforms) -> Tuple[str, ...]:
    """The platform names of ``platforms`` (a sequence, or a comma-separated
    string) in order, duplicates dropped; raises on an empty list or a name
    other than ``cpu`` and ``cuda``."""
    if isinstance(platforms, str):
        platforms = platforms.split(",")
    names = tuple(dict.fromkeys(str(p).strip().lower() for p in platforms if str(p).strip()))
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(f"platforms must be a non-empty subset of {list(PLATFORMS)}, got "
                         f"{list(platforms)!r}" + (" (a TPU program is the JAX package's)"
                                                   if "tpu" in bad else ""))
    return names


def artifact_platforms(meta: Dict[str, Any]) -> List[str]:
    """The platforms an artifact's programs were traced for (an artifact of
    the single-device layout names its one device type)."""
    if "platforms" in meta:
        return list(meta["platforms"])
    return [meta["device"]] if meta.get("device") else []


def _module_name(meta: Dict[str, Any], platform: str, key: str) -> str:
    if "platforms" in meta:
        return f"modules/{platform}/{key}.bin"
    return f"modules/{key}.bin"


def _write_tensors(z: zipfile.ZipFile, tensors, prefix: str,
                   skip_zeros: bool = False) -> list:
    """Raw bytes plus a manifest, uncompressed (bf16 and int8 barely
    deflate, and zlib over ViT-L's weights would cost tens of seconds).
    ``skip_zeros``: an all-zero tensor is a manifest entry only."""
    manifest = []
    for i, t in enumerate(tensors):
        entry = {"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
        if skip_zeros and not bool(t.any()):
            entry["zero"] = True
        else:
            raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
            info = zipfile.ZipInfo(f"{prefix}/{i}.bin", date_time=time.localtime()[:6])
            info.compress_type = zipfile.ZIP_STORED
            with z.open(info, "w", force_zip64=True) as f:
                f.write(memoryview(raw))
        manifest.append(entry)
    return manifest


def _read_tensor(z: zipfile.ZipFile, raw_file, name: str, entry, device) -> torch.Tensor:
    """One stored tensor, read straight from the archive's file into a
    host buffer (the entries are stored uncompressed) and sent to
    ``device``; a zero entry is made there."""
    import struct

    dtype = getattr(torch, entry["dtype"])
    if entry.get("zero"):
        return torch.zeros(entry["shape"], dtype=dtype, device=device)
    info = z.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{name}: a stored tensor must be uncompressed")
    raw_file.seek(info.header_offset)
    header = raw_file.read(30)  # the local file header: its name and extra lengths at 26, 28
    name_len, extra_len = struct.unpack("<HH", header[26:30])
    raw_file.seek(info.header_offset + 30 + name_len + extra_len)
    raw = torch.empty(info.file_size, dtype=torch.uint8)
    if raw_file.readinto(memoryview(raw.numpy())) != info.file_size:
        raise ValueError(f"{name}: the stored tensor is cut short")
    t = raw.view(dtype).reshape(entry["shape"])
    return t.to(device) if device.type != "cpu" else t


class _Snapshot(nn.Module):
    """The modules whose tensors an artifact stores, and the function that
    runs them (set per exported module)."""

    def __init__(self, modules: Dict[str, nn.Module]):
        super().__init__()
        self.mods = nn.ModuleDict(modules)
        self.fn: Optional[Callable] = None

    def forward(self, *args):
        return self.fn(*args)


def _distinct_tensors(snapshot: _Snapshot):
    """(names, tensors): every parameter and buffer of the snapshot by name,
    with the index of its tensor in ``tensors``, one entry per distinct
    storage view."""
    names, tensors, index = [], [], {}
    named = list(snapshot.named_parameters()) + list(snapshot.named_buffers())
    for name, t in named:
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape),
               tuple(t.stride()), t.dtype)
        if key not in index:
            index[key] = len(tensors)
            tensors.append(t.detach())
        names.append((name, index[key]))
    return names, tensors


class _Program(nn.Module):
    """What ``torch.export`` traces: ``fn(*inputs)`` with the snapshot's
    tensors taken from the first argument (``torch.func.functional_call``),
    so that the weights are inputs of the graph and not constants of it.
    The snapshot is not a submodule: the program holds no parameter."""

    def __init__(self, snapshot: _Snapshot, names, fn: Callable, platform: str):
        super().__init__()
        object.__setattr__(self, "_snapshot", snapshot)
        self._names = names
        self._fn = fn
        self._platform = platform

    def forward(self, weights: List[torch.Tensor], *inputs):
        self._snapshot.fn = self._fn
        tensors = {name: weights[i] for name, i in self._names}
        if self._platform not in DISPATCHED_INDEXING:
            return torch.func.functional_call(self._snapshot, tensors, inputs)
        with _DispatchedIndexing():
            return torch.func.functional_call(self._snapshot, tensors, inputs)


# The platforms whose traces index through the dispatcher: a CPU-only build
# cannot index a fake CUDA tensor through Tensor.__getitem__ (its binding
# holds a CUDA device guard, which such a build lacks), so every CUDA program
# is traced this way, on any host, and is the same program wherever it is
# exported.
DISPATCHED_INDEXING = {"cuda"}
_INT64_MAX = 2 ** 63 - 1


def _basic_index(x: torch.Tensor, index):
    """``at::indexing::applySlicing``: the view of ``x`` that ``index``'s
    ints, slices, None and Ellipsis select, and its tensor indices placed
    on the view's dimensions (None where a dimension is not indexed)."""
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(torch.tensor(i) if isinstance(i, list) else i for i in index)
    specified = sum(i.dim() if isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                    else 1 for i in index if i is not None and i is not Ellipsis)
    out, dim, tensors = x, 0, []
    for i in index:
        if i is Ellipsis:
            dim += x.dim() - specified
        elif i is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(i, slice):
            step = 1 if i.step is None else int(i.step)
            start = 0 if i.start is None else int(i.start)
            stop = _INT64_MAX if i.stop is None else int(i.stop)
            if (start, stop, step) != (0, _INT64_MAX, 1):
                out = torch.ops.aten.slice.Tensor(out, dim, start, stop, step)
            dim += 1
        elif isinstance(i, torch.Tensor):
            tensors += [None] * (dim - len(tensors)) + [i]
            dim += i.dim() if i.dtype in (torch.bool, torch.uint8) else 1
        elif isinstance(i, (int, np.integer)) and not isinstance(i, bool):
            out = out.select(dim, int(i))
        else:
            raise TypeError(f"unsupported index {i!r} in a traced CUDA program")
    return out, tensors


class _DispatchedIndexing(torch.overrides.TorchFunctionMode):
    """``Tensor.__getitem__``, ``__setitem__``, ``copy_``, ``contiguous``
    and ``__invert__`` as the aten operators their bindings run (``slice``,
    ``select``, ``unsqueeze``, ``index``, ``index_put_``, ``copy_``,
    ``fill_``, ``contiguous``, ``bitwise_not``), which a fake CUDA tensor
    takes on any host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            view, tensors = _basic_index(*args)
            return torch.ops.aten.index.Tensor(view, tensors) if tensors else view
        if func is torch.Tensor.__setitem__:
            x, index, value = args
            view, tensors = _basic_index(x, index)
            if tensors:
                if not isinstance(value, torch.Tensor):
                    value = torch.full((), value, dtype=x.dtype, device=x.device)
                torch.ops.aten.index_put_.default(view, tensors, value)
            elif isinstance(value, torch.Tensor):
                torch.ops.aten.copy_.default(view, value)
            else:
                view.fill_(value)
            return None
        if func is torch.Tensor.copy_:
            return torch.ops.aten.copy_.default(*args, **kwargs)
        if func is torch.Tensor.contiguous:
            return torch.ops.aten.contiguous.default(*args, **kwargs)
        if func is torch.Tensor.__invert__:
            return torch.ops.aten.bitwise_not.default(*args)
        return func(*args, **kwargs)


def _engine_of(pipe, in_hw, viz: bool) -> Engine:
    """The pipeline's single-call engine at ``in_hw`` (a pair pipeline's
    takes no viz flag)."""
    import inspect

    if "with_viz" in inspect.signature(pipe.engine_for).parameters:
        return pipe.engine_for(tuple(in_hw), viz)
    if viz:
        raise ValueError(f"{pipe.spec.model} has no viz epilogue to export")
    return pipe.engine_for(tuple(in_hw))


def _user_outputs(ep) -> list:
    """The exported program's output tree of fake tensors."""
    from torch.utils import _pytree

    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in out_node.args[0]]
    kinds = [s.kind.name for s in ep.graph_signature.output_specs]
    vals = [v for v, k in zip(vals, kinds) if k == "USER_OUTPUT"]
    return _pytree.tree_unflatten(vals, ep.call_spec.out_spec)


def _signature(tree) -> list:
    from torch.utils import _pytree

    return [{"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
            for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


_MOVES = (torch.ops.aten.to.dtype_layout, torch.ops.aten.to.device,
          torch.ops.aten._to_copy.default)


def _fold_constant_moves(ep) -> None:
    """In place: a constant that the trace built on the host and moved to
    the traced device (``ops/constants.py`` inside a trace) becomes a
    constant of that device, as one built there would be. Its placeholder
    takes the moved value's device and its users read it straight; the
    stored tensor stays on the host and goes to the device at load
    (:func:`_load_program`), so that a card-less host can write it."""
    from torch.export.graph_signature import InputKind

    constants = {spec.arg.name for spec in ep.graph_signature.input_specs
                 if spec.kind == InputKind.CONSTANT_TENSOR}
    graph = ep.graph
    assert_meta = torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op != "placeholder" or node.name not in constants:
            continue
        val = node.meta.get("val")
        moves = [u for u in node.users
                 if u.op == "call_function" and u.target in _MOVES
                 and isinstance(u.meta.get("val"), torch.Tensor)
                 and u.meta["val"].dtype == val.dtype and u.meta["val"].device != val.device]
        checks = [u for u in node.users if u.target is assert_meta]
        if not moves or len(moves) + len(checks) != len(node.users):
            continue
        if len({m.meta["val"].device for m in moves}) != 1:
            continue
        node.meta["val"] = moves[0].meta["val"]
        for m in moves:
            m.replace_all_uses_with(node)
            graph.erase_node(m)
        for c in checks:
            graph.erase_node(c)
    ep.graph_module.recompile()


def _load_program(blob: bytes, device: torch.device) -> nn.Module:
    """A saved program as a module, with its constants on the devices its
    graph reads them on (``device`` for those of ``device``'s type)."""
    from torch.export.graph_signature import InputKind

    ep = torch.export.load(io.BytesIO(blob))
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes if n.op == "placeholder"}
    for spec in ep.graph_signature.input_specs:
        if spec.kind != InputKind.CONSTANT_TENSOR:
            continue
        want = getattr(vals.get(spec.arg.name), "device", None)
        if want is not None:
            ep.constants[spec.target] = ep.constants[spec.target].to(
                device if want.type == device.type else want)
    return ep.module()


def export_pipeline(
    pipe,
    in_hw: Tuple[int, int],
    *,
    with_viz=False,  # False | True | "both"
    batches: Sequence[int] = (1,),
    views: Sequence[int] = (),
    stream_window: int = 0,
    path: Optional[str] = None,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
) -> str:
    """Export a pipeline's fused programs and its weights as one
    ``.mdeteng`` file; returns its path.

    ``with_viz``: False/True export that colormap variant, ``"both"`` both
    (what HTTP serving needs: npz answers use the raw module, jpg answers
    the colormapped one). ``batches``: one module per batch size (none is
    needed where ``views`` or ``stream_window`` gives a module).
    ``views``: one S-view module per S (the VGGT family). ``stream_window``:
    the causal KV-cache step (StreamVGGT, through the pipeline's
    ``stream_export_bundle``). ``platforms``: the device types to trace
    each module for (``cpu``, ``cuda``), whatever device the pipeline lives
    on; the weights are stored once for all of them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    platforms = parse_platforms(platforms)
    viz_modes = (False, True) if with_viz == "both" else (bool(with_viz),)
    batches = tuple(sorted({int(b) for b in batches}))
    views = tuple(sorted({int(s) for s in views}))
    stream_window = int(stream_window)
    # a views or stream artifact may leave out the per-frame modules
    if (not batches and not views and not stream_window) or any(b < 1 for b in batches):
        raise ValueError(f"batches must be a non-empty list of sizes >= 1, got {batches!r}")
    if views and not hasattr(pipe, "views_engine"):
        raise ValueError(f"{pipe.spec.model} has no multi-view protocol "
                         "(--views is VGGT-family only)")
    if stream_window < 0:
        raise ValueError(f"--stream-window must be >= 1, got {stream_window}")
    if stream_window and not hasattr(pipe, "stream_export_bundle"):
        raise ValueError(f"{pipe.spec.model} has no serializable streaming step "
                         "(--stream-window is streamvggt-style only)")
    in_hw = (int(in_hw[0]), int(in_hw[1]))
    base = _engine_of(pipe, in_hw, False)
    name = base.name
    n_images = len(base._example)
    if n_images > 1 and batches not in ((1,), ()):
        raise ValueError(f"batched modules are single-image only; this pipeline takes "
                         f"{n_images} images per call")
    if path is None:
        path = os.path.join(exported_dir(), f"{name}.mdeteng")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    modules = dict(pipe.export_modules())
    stream = None
    if stream_window:
        step, state0, stream_modules = pipe.stream_export_bundle(stream_window, in_hw)
        modules.update(stream_modules)
        stream = (step, state0)
    snapshot = _Snapshot(modules)
    names, weights = _distinct_tensors(snapshot)

    # (key, function, example shapes and types, table entry), traced per platform
    plan: List[Tuple[str, Callable, list, Dict[str, Any]]] = []
    for batch in batches:
        for viz in viz_modes:
            if batch == 1:
                eng = _engine_of(pipe, in_hw, viz)
                shapes = [tuple(a.shape) for a in eng._example]
            else:
                eng = pipe.batch_engine_for(in_hw, batch, viz)
                shapes = [(batch, *in_hw, 3)]
            plan.append((_module_key(batch, viz), eng._fn,
                         [(s, torch.uint8) for s in shapes], {"batch": batch, "viz": viz}))
    for s in views:
        # at the requested size, which need not be the pipeline's own
        eng = pipe.views_engine(s, in_hw)
        plan.append((f"views_s{s}", eng._fn, [((s, *in_hw, 3), torch.uint8)],
                     {"batch": 1, "viz": False, "views": s}))
    if stream is not None:
        step, state0 = stream
        plan.append(("stream", step,
                     [((*in_hw, 3), torch.uint8), [(tuple(t.shape), t.dtype) for t in state0]],
                     {"batch": 1, "viz": True, "stream": True, "window": stream_window}))

    table: Dict[str, Dict[str, Any]] = {}
    blobs: Dict[str, bytes] = {}
    output_names: List[str] = []
    seconds: Dict[str, float] = {}
    for platform in platforms:
        begin = time.perf_counter()
        # the weights and inputs as fake tensors on the platform's device:
        # nothing is allocated there, so a host with no card traces for one
        mode = FakeTensorMode(allow_non_fake_inputs=True)

        def fake(shape, dtype):
            with mode:
                return torch.empty(shape, dtype=dtype, device=platform)

        fake_weights = [fake(w.shape, w.dtype) for w in weights]
        for key, fn, example, entry in plan:
            args = [[fake(*a) for a in x] if isinstance(x, list) else fake(*x)
                    for x in example]
            try:
                # under no_grad, so that a forward's own no_grad regions
                # leave no grad-mode switch in the graph
                with torch.no_grad():
                    ep = torch.export.export(_Program(snapshot, names, fn, platform),
                                             (fake_weights, *args), strict=False)
            except Exception as e:
                raise RuntimeError(f"{pipe.spec.model}: module {key} cannot be traced for "
                                   f"platform {platform}: {e}") from e
            _fold_constant_moves(ep)
            ep._example_inputs = None  # the weights are stored once, beside
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            blobs[f"modules/{platform}/{key}.bin"] = buf.getvalue()
            outputs = _user_outputs(ep)
            signature = _signature(outputs)
            if key in table and table[key]["outputs"] != signature:
                raise RuntimeError(
                    f"{pipe.spec.model}: module {key} has outputs {signature} for platform "
                    f"{platform}, {table[key]['outputs']} for {platforms[0]}")
            table[key] = {**entry, "outputs": signature}
            if (isinstance(outputs, dict) and not entry.get("views")
                    and not entry.get("stream") and (not entry["viz"] or not output_names)):
                output_names[:] = sorted(outputs)
        seconds[platform] = round(time.perf_counter() - begin, 3)

    meta = {
        "format": "MDETENG",
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "model": pipe.spec.model,
        "artifact": name,
        "in_hw": list(in_hw),
        "precision": pipe.spec.precision,
        "viz": getattr(pipe, "viz", "none"),
        "metric": bool(pipe.spec.metric),
        "inputs": [{"shape": [*in_hw, 3], "dtype": "uint8"}] * n_images,
        "n_image_args": n_images,
        "output_names": output_names,
        "modules": table,
        "export_seconds": round(sum(seconds.values()), 3),
        "export_seconds_by_platform": seconds,
        "timestamp": time.time(),
    }
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        meta["param_manifest"] = _write_tensors(z, weights, "params")
        if stream is not None:
            meta["state_manifest"] = _write_tensors(z, stream[1], "state", skip_zeros=True)
        z.writestr(_META_NAME, json.dumps(meta, indent=2))
        for name_in_zip, blob in blobs.items():
            z.writestr(name_in_zip, blob)
    log(f"exported engine -> {path} ({os.path.getsize(path) / 1e6:.2f} MB, "
        f"modules {sorted(table)}, platforms {','.join(platforms)}"
        + ("" if torch.cuda.is_available() else ", traced on a host with no CUDA device")
        + ")")
    return path


def read_meta(path: str) -> Dict[str, Any]:
    """The artifact's ``meta.json`` (a zip header read: nothing is loaded)."""
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read(_META_NAME))


def check_meta(path: str, meta: Dict[str, Any], device=None) -> torch.device:
    """The device to serve ``meta``'s artifact on (``device``, default
    ``cuda``); raises unless it is a port artifact with a program for that
    device's type, and that device is present."""
    if meta.get("format") != "MDETENG":
        raise ValueError(f"{path}: not an MDETENG artifact")
    if meta.get("runtime") != RUNTIME:
        made = f" (jax {meta['jax_version']})" if "jax_version" in meta else ""
        raise ValueError(
            f"{path}: exported by the JAX package{made}; the PyTorch port cannot run a "
            "JAX artifact. Re-export it with the port's export command")
    device = torch.device(device if device is not None else "cuda")
    platforms = artifact_platforms(meta)
    if device.type not in platforms:
        raise ValueError(f"{path} was exported for {platforms}; re-export with --platforms "
                         f"including {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: its cuda program needs a CUDA device and there is no "
                           "CUDA device (--device cpu serves its cpu program)"
                           if "cpu" in platforms else
                           f"{path}: no CUDA device is available to serve it")
    return device


class LoadedEngine:
    """A deserialized ``.mdeteng`` artifact with the pipeline calling
    convention (``__call__``, ``batch_call``, ``stream``, ``multi_view``,
    ``engine_for``, ``batch_engine_for``, ``benchmark``, ``spec``), so that
    ``run``, ``batch``, ``video``, the server and the other serving surfaces
    take it where they take a pipeline. Imports no model code.

    ``device`` (default ``cuda``) picks the programs: only that platform's
    are read, and the weights go to that device once, at load. Each module
    is served by an
    :class:`~monocular_depth_estimation_trt_tpu_torch.runtime.engine.Engine`
    (one CUDA graph per module on the card), built at its first call."""

    def __init__(self, path: str, device=None):
        # the operators a graph may hold must be registered before a load
        from monocular_depth_estimation_trt_tpu_torch.ops.cuda import (  # noqa: F401
            flash_attention,
            quant_matmul,
        )

        begin = time.perf_counter()
        with zipfile.ZipFile(path) as z, open(path, "rb") as raw_file:
            self.meta = json.loads(z.read(_META_NAME))
            self.device = check_meta(path, self.meta, device)
            if self.meta["torch_version"] != torch.__version__:
                log(f"{os.path.basename(path)}: exported with torch "
                    f"{self.meta['torch_version']}, running {torch.__version__}; re-export "
                    "if loading fails", tag="WARN")
            self._weights = [_read_tensor(z, raw_file, f"params/{i}.bin", e, self.device)
                             for i, e in enumerate(self.meta["param_manifest"])]
            self._programs = {
                key: _load_program(
                    z.read(_module_name(self.meta, self.device.type, key)), self.device)
                for key in self.meta["modules"]}
            self._state0 = [_read_tensor(z, raw_file, f"state/{i}.bin", e, self.device)
                            for i, e in enumerate(self.meta.get("state_manifest", ()))]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_seconds = time.perf_counter() - begin
        self.path = path
        self._engines: Dict[str, Engine] = {}
        hw = self.meta["in_hw"]
        self.spec = ModelSpec(model=self.meta.get("model") or "engine",
                              input_hw=(int(hw[0]), int(hw[1])),
                              precision=self.meta.get("precision") or "bf16",
                              metric=bool(self.meta.get("metric", False)))
        self.viz = self.meta.get("viz", "none")

    # -- introspection ------------------------------------------------------
    @property
    def in_shapes(self):
        return [tuple(i["shape"]) for i in self.meta["inputs"]]

    @property
    def batches(self):
        return sorted({m["batch"] for m in self.meta["modules"].values()
                       if not m.get("views") and not m.get("stream")})

    def describe(self) -> str:
        m = self.meta
        ins = ", ".join(f"{i['dtype']}{tuple(i['shape'])}" for i in m["inputs"])
        return (f"{m.get('model', '?')} [{m.get('artifact', '')}] in=({ins}) "
                f"outputs={m.get('output_names', [])} modules={sorted(m['modules'])} "
                f"platforms={artifact_platforms(m)} device={self.device.type}")

    # -- engines ------------------------------------------------------------
    def _engine(self, key: str) -> Engine:
        """The engine of one module: its inputs' shapes from the table."""
        if key not in self._engines:
            entry = self.meta["modules"][key]
            program, weights = self._programs[key], self._weights
            h, w = self.meta["in_hw"]
            if entry.get("stream"):
                shapes = [(h, w, 3)]
                state = [(tuple(e["shape"]), getattr(torch, e["dtype"]))
                         for e in self.meta["state_manifest"]]

                def fn(frame, *state_in):
                    out, state_out = program(weights, frame, list(state_in))
                    return out, tuple(state_out)
            else:
                s, b = entry.get("views"), entry["batch"]
                shapes = ([(s, h, w, 3)] if s else
                          [(h, w, 3)] * int(self.meta["n_image_args"]) if b == 1 else
                          [(b, h, w, 3)])
                state = []

                def fn(*images):
                    return program(weights, *images)
            example = [torch.empty(shape, dtype=torch.uint8, device="meta") for shape in shapes]
            example += [torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in state]
            self._engines[key] = Engine(fn, example, device=self.device,
                                        name=f"{self.meta['artifact']}_{key}")
        return self._engines[key]

    def release_engines(self) -> None:
        for eng in self._engines.values():
            eng.release()
        self._engines.clear()

    def _key_for(self, batch: int, viz: bool) -> Tuple[str, int]:
        """The smallest exported bucket >= batch in the viz mode asked for,
        else in the other one: a viz caller of a raw artifact gets no
        ``viz``, a raw caller of a viz-only artifact an extra ``viz`` (the
        JAX package's fallbacks)."""
        for want_viz in (viz, not viz):
            buckets = sorted(m["batch"] for m in self.meta["modules"].values()
                             if m["viz"] == want_viz and m["batch"] >= batch
                             and not m.get("views") and not m.get("stream"))
            if buckets:
                return _module_key(buckets[0], want_viz), buckets[0]
        raise ValueError(f"{self.path}: no exported module serves batch={batch} "
                         f"(available: {sorted(self.meta['modules'])}); re-export with "
                         "--batches/--serve-bundle")

    # -- execution ----------------------------------------------------------
    def fit(self, img: np.ndarray) -> np.ndarray:
        """Resize a frame to the artifact's fixed input size (TensorRT plan
        semantics: the reference's video apps resize every frame to the
        engine's binding shape)."""
        from monocular_depth_estimation_trt_tpu_torch.utils.imageio import resize

        want = tuple(self.meta["in_hw"])
        if tuple(img.shape[:2]) == want:
            return img
        if not getattr(self, "_warned_resize", False):
            log(f"engine input {tuple(img.shape[:2])} -> {want} (fixed-shape artifact; "
                "frames are resized)")
            self._warned_resize = True
        return resize(np.asarray(img), want)

    def _frame(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img
        return torch.from_numpy(np.ascontiguousarray(self.fit(np.asarray(img))))

    def __call__(self, *images, viz: bool = False, device_out: bool = False):
        want = int(self.meta.get("n_image_args", 1))
        if len(images) != want:
            raise TypeError(f"{self.path} takes {want} image(s) per call, got {len(images)}")
        key, bucket = self._key_for(1, viz)
        frames = [self._frame(im) for im in images]
        if bucket > 1:  # only batched modules exported: a batch of one, padded
            out = self._engine(key)(frames[0][None].expand(bucket, *frames[0].shape))
            out = {k: v[0] for k, v in out.items()}
        else:
            out = self._engine(key)(*frames)
        return out if device_out else tree_get_chunked(out)

    def batch_call(self, frames, *, viz: bool = False, device_out: bool = False):
        if int(self.meta.get("n_image_args", 1)) != 1:
            raise ValueError(f"{self.path}: batched serving is single-image only; this "
                             f"artifact takes {self.meta['n_image_args']} images per call")
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames)
            if tuple(frames.shape[1:3]) != tuple(self.meta["in_hw"]):
                frames = np.stack([self.fit(f) for f in frames])
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        n = frames.shape[0]
        key, bucket = self._key_for(n, viz)
        if bucket > n:
            frames = torch.cat([frames, frames[-1:].expand(bucket - n, *frames.shape[1:])])
        if bucket == 1:
            out = {k: v[None] for k, v in self._engine(key)(frames[0]).items()}
        else:
            out = self._engine(key)(frames)
        out = {k: v[:n] for k, v in out.items()}
        return out if device_out else tree_get_chunked(out)

    def stream(self, window: int = 0):
        """``run_video``'s hook. With a stream module: a causal KV-cache
        runner whose state (the manifest's, made on the device) goes from
        step to step on the device. Without one: the per-frame call."""
        if "stream" not in self.meta["modules"]:
            return lambda frame, viz=False, device_out=False: self(
                frame, viz=viz, device_out=device_out)
        baked = int(self.meta["modules"]["stream"].get("window", 0))
        if window and baked and window != baked:
            raise ValueError(f"{self.path} was exported with --stream-window {baked}; "
                             f"window={window} cannot apply (re-export)")
        eng = self._engine("stream")
        state = [t.clone() for t in self._state0]

        def runner(frame, viz: bool = False):
            nonlocal state
            out, state = eng(self._frame(frame), *state)
            return tree_get_chunked(out)

        return runner

    def _views_key(self, s: int) -> str:
        key = f"views_s{int(s)}"
        if key not in self.meta["modules"]:
            avail = sorted(m["views"] for m in self.meta["modules"].values() if m.get("views"))
            raise ValueError(f"{self.path}: no views module for S={s} (available: {avail}); "
                             "re-export with --views")
        return key

    def multi_view(self, views_u8, *, device_out: bool = False):
        """(S, H, W, 3) uint8 -> the views module's outputs (depth,
        depth_conf, pose_enc), as ``VGGTPipeline.multi_view``."""
        views_u8 = np.asarray(views_u8)
        eng = self._engine(self._views_key(views_u8.shape[0]))
        out = eng(torch.from_numpy(np.stack([self.fit(v) for v in views_u8])))
        return out if device_out else tree_get_chunked(out)

    def benchmark_views(self, s: int, config=None):
        """Per-frame throughput of the S-view module on device-resident
        views (``bench --engine --views S``)."""
        from monocular_depth_estimation_trt_tpu_torch.runtime.benchmark import benchmark

        eng = self._engine(self._views_key(s))
        rng = np.random.default_rng(0)
        views = torch.from_numpy(rng.integers(0, 255, (int(s), *self.meta["in_hw"], 3),
                                              dtype=np.uint8)).to(self.device)
        rep = benchmark(lambda: eng(views), device=self.device, config=config,
                        name=f"{self.meta['artifact']}_s{s}")
        rep.frames_per_iteration = int(s)
        return rep

    def _check_hw(self, in_hw) -> None:
        if tuple(in_hw) != tuple(self.meta["in_hw"]):
            raise ValueError(f"{self.path} was exported at {tuple(self.meta['in_hw'])}, "
                             f"requested {tuple(in_hw)} (fixed-shape, like TensorRT plans)")

    def engine_for(self, in_hw: Tuple[int, int], with_viz: bool = False) -> Engine:
        """The engine of the b1 module (or the other viz mode's)."""
        return self.batch_engine_for(in_hw, 1, with_viz)

    def batch_engine_for(self, in_hw: Tuple[int, int], batch: int,
                         with_viz: bool = False) -> Engine:
        self._check_hw(in_hw)
        key, bucket = self._key_for(batch, with_viz)
        if bucket != batch:
            raise ValueError(f"{self.path}: no exported b{batch} module (nearest bucket "
                             f"{bucket}); re-export with --batches/--serve-bundle")
        return self._engine(key)

    def benchmark(self, in_hw=None, config=None):
        """The pipeline's timing protocol on the artifact (``bench
        --engine``): pinned H2D, the b1 module, the depth D2H."""
        from monocular_depth_estimation_trt_tpu_torch.pipelines import DepthPipeline

        if int(self.meta.get("n_image_args", 1)) != 1:
            raise ValueError("benchmark supports single-image artifacts; this one takes "
                             f"{self.meta['n_image_args']} images per call")
        return DepthPipeline.benchmark(self, tuple(in_hw or self.meta["in_hw"]), config)


def load_engine(path: str, device=None) -> LoadedEngine:
    """The artifact at ``path`` served on ``device`` (default ``cuda``)."""
    return LoadedEngine(path, device)
