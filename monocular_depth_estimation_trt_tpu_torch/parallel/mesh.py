"""Device meshes over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

The launch model differs from JAX's. JAX is one controller process that
sees every chip and lets XLA insert the collectives. PyTorch runs one
process per device: start ``D*M`` of them with ``torchrun
--nproc-per-node D*M``, each on ``cuda:LOCAL_RANK`` over NCCL (gloo on the
CPU). :func:`init_process_group` joins the group that the launcher
describes. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the group's ranks, and ``parallel/sharding.py`` places tensors on it.

Axis conventions, as in the JAX package:

* ``data``: batch/data parallelism (frames, views);
* ``model``: tensor parallelism within a layer (attention heads, MLP
  hidden width, decoder channels).

A one-device mesh needs no process group: on it every placement collapses
to the plain tensor, and the served path runs as it does without a mesh.

:func:`run_in_process_group` is the counterpart of JAX's
``virtual_cpu_devices``: it runs a function in ``n`` processes that form a
gloo group on the CPU, joined through a file in a temporary directory (no
TCP port, so that test workers side by side cannot collide), and returns
rank 0's result.
"""

from __future__ import annotations

import os
import tempfile
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")


def world_size() -> int:
    """The ranks of the process group: 1 where no group is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_process_group(device_type: str) -> int:
    """Join the group a launcher (``torchrun``) describes in the environment
    (``WORLD_SIZE`` > 1), over NCCL on ``cuda:LOCAL_RANK`` or gloo on the CPU.
    Returns the world size: 1 where nothing was launched."""
    if dist.is_initialized():
        return dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 1
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def get_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = AXES, *,
             devices: Optional[Sequence[int]] = None,
             device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over ``devices`` (ranks of the process group; all of them by
    default). ``shape=None`` puts every rank on the first axis. A shape
    whose size is not the number of ranks raises ``ValueError``. A mesh of
    one device needs no process group."""
    ranks = list(devices if devices is not None else range(world_size()))
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} devices")
    mesh = torch.tensor(ranks, dtype=torch.int).reshape(tuple(shape))
    if n == 1:
        return DeviceMesh(_device_type(device_type), mesh, mesh_dim_names=tuple(axis_names),
                          _init_backend=False, _rank=rank())
    return DeviceMesh(_device_type(device_type), mesh, mesh_dim_names=tuple(axis_names))


def single_device_mesh(device_type: Optional[str] = None,
                       axis_names: Sequence[str] = AXES) -> DeviceMesh:
    """The one-device mesh of this process (no process group needed)."""
    return get_mesh((1,) * len(axis_names), axis_names, devices=[rank()],
                    device_type=device_type)


def _member(fn, args, index, world, store_path, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=index,
                                world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((index, True, out if index == 0 else None))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((index, False, traceback.format_exc()))


def run_in_process_group(fn: Callable[..., Any], n: int, *args, timeout: float = 600.0) -> Any:
    """Run ``fn(*args)`` in ``n`` new processes that form a gloo group on the
    CPU; returns rank 0's result and raises if any rank raised. ``fn`` must
    be importable by name (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_member, args=(fn, args, i, n, store, results))
                 for i in range(n)]
        for p in procs:
            p.start()
        try:
            got = {}
            for _ in range(n):
                index, ok, out = results.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {index} of {n} raised:\n{out}")
                got[index] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:  # a rank blocked in a collective of a failed group
                if p.is_alive():
                    p.kill()
                    p.join()
    return got[0]
