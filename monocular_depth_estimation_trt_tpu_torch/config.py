"""Typed model/run configuration (counterpart of the JAX package's ``config.py``).

:meth:`ModelSpec.artifact_name` reproduces the reference's name mangling::

    depth_anything_v2_{enc}_{H}x{W}[_metric_{ds}]_{precision}

so that the port's cache keys and result files match the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import torch

# "fp16" is accepted as an alias of bf16 compute, as in the JAX package, so
# that artifact names and numerics follow the reference.
_PRECISIONS = ("fp32", "bf16", "fp16", "int8")  # int8 = w8a8 encoder serving


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Immutable description of one model configuration; its artifact name
    keys the pipeline's cached forwards."""

    model: str  # e.g. "depth_anything_v2"
    encoder: str = ""  # e.g. "vits" / "vitb" / "vitl" / "vitg"
    input_hw: Tuple[int, int] = (518, 518)
    precision: str = "bf16"
    batch: int = 1
    metric: bool = False
    dataset: str = ""  # metric checkpoint domain, e.g. "hypersim" / "vkitti"
    variant: str = ""  # free-form extra tag (e.g. "normal" for MoGe-2)
    extra: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, got {self.precision!r}"
            )

    @property
    def height(self) -> int:
        return self.input_hw[0]

    @property
    def width(self) -> int:
        return self.input_hw[1]

    def artifact_name(self) -> str:
        """Reference-compatible name mangling (``onnx2trt.py:160-166``)."""
        name = self.model
        if self.encoder:
            name += f"_{self.encoder}"
        if self.variant:
            name += f"_{self.variant}"
        name += f"_{self.height}x{self.width}"
        if self.metric:
            name += "_metric"
            if self.dataset:
                name += f"_{self.dataset}"
        if self.batch != 1:
            name += f"_b{self.batch}"
        for k, v in self.extra:
            name += f"_{k}{v}"
        name += f"_{self.precision}"
        return name

    def with_(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Mapping[str, Any]:
        return dataclasses.asdict(self)


def compute_dtype(precision: str) -> torch.dtype:
    """Map a precision name to the torch compute dtype (fp16 -> bf16, as in
    the JAX package)."""
    if precision == "int8":
        raise ValueError(
            "int8 (w8a8) serving is not ported to the torch package yet; "
            "use bf16/fp16/fp32"
        )
    return {
        "fp32": torch.float32,
        "bf16": torch.bfloat16,
        "fp16": torch.bfloat16,
    }[precision]


# ImageNet statistics (reference Depth_Anything_V2/onnx2trt.py:121).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    """Warmup + timed-loop protocol (reference ``infer.py:21-44``)."""

    warmup: int = 10
    iterations: int = 100
    include_transfers: bool = True  # H2D + forward + D2H per iteration
    # separate synchronised pass whose per-iteration times give p50/p99
    latency_iterations: int = 10


DEFAULT_CACHE_DIR_ENV = "MDET_CACHE_DIR"


def cache_dir() -> str:
    import os

    root = os.environ.get(
        DEFAULT_CACHE_DIR_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "mdet_tpu"),
    )
    os.makedirs(root, exist_ok=True)
    return root
