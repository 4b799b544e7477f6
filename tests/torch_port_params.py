"""Test-only helpers shared by ``tests/test_torch_*.py``: seeded random Flax
parameter trees made without running Flax's ``init``.

``jax.eval_shape`` gives the tree's structure at no compute cost; numpy fills
it from a seed (eager Flax ``init`` on the CPU takes tens of seconds for a
tiny DPT head). The values are scaled like trained weights, so that every
branch of the network moves the output: LayerNorm scales near 1, kernels at
fan-in scale, small biases, LayerScale gammas near 0.1.
"""

import jax
import numpy as np


def random_params(module, *args, seed=0):
    """Seeded numpy params for ``module.init(key, *args)["params"]``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: module.init(key, *args),
                            jax.random.PRNGKey(0))["params"]

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "scale":  # LayerNorm
            return 1.0 + 0.1 * noise
        if name == "kernel":
            return noise / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        if name == "gamma":  # LayerScale
            return 0.1 + 0.02 * noise
        return 0.02 * noise  # biases, class/register tokens, position table

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lift_depth_pro_outputs(params):
    """Random weights put Depth Pro's canonical inverse depth at about 0
    (relu) and its field of view near 0 degrees, so that the depth would sit
    at the clip and the focal would be huge; output biases of 1 and 60
    degrees make every pixel and the focal count."""
    params["head_conv2"]["bias"] = np.ones(1, np.float32)
    params["fov"]["head"]["bias"] = np.full(1, 60.0, np.float32)


def rel_err(a, b):
    """max |a - b| / max |b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))
