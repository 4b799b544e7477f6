"""PyTorch and CUDA port of the monocular depth inference framework.

The package beside it, ``monocular_depth_estimation_trt_tpu``, is the JAX
reference; this one keeps its module layout, registry names and
``ModelSpec.artifact_name()`` keys, runs on an NVIDIA H100, and replaces
each Pallas TPU kernel with a CUDA kernel written for Hopper (``csrc/``).

Typical use::

    import monocular_depth_estimation_trt_tpu_torch as mdet
    pipe = mdet.build_pipeline("depth_anything_v2", encoder="vits")
    out = pipe(image_rgb_uint8)            # depth map at original resolution

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from monocular_depth_estimation_trt_tpu_torch.version import __version__

__all__ = ["__version__", "build_pipeline", "list_models", "ModelSpec"]


def __getattr__(name):
    if name in ("build_pipeline", "list_models"):
        from monocular_depth_estimation_trt_tpu_torch import registry

        return getattr(registry, name)
    if name == "ModelSpec":
        from monocular_depth_estimation_trt_tpu_torch.config import ModelSpec

        return ModelSpec
    raise AttributeError(name)
