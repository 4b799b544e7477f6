"""Kernel K1 of the torch port (packed-qkv attention) against the JAX
package's ``flash_attention_packed`` in Pallas interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version, which repeats
the kernel's numerics; the CUDA kernel itself is compared with that plain
version by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` on a
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monocular_depth_estimation_trt_tpu.ops.pallas.flash_attention import (
    attention_reference as jax_attention_reference,
    flash_attention_packed as jax_flash_attention_packed,
)
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa

D = fa.HEAD_DIM
DTYPES = {
    "float32": (jnp.float32, torch.float32, 1e-5),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),  # bf16 output mantissa
}


@pytest.mark.parametrize("b,n,h", [(1, 200, 2), (2, 130, 6), (1, 1370, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_jax_packed_kernel(rng, b, n, h, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = rng.standard_normal((b, n, 3 * h * D)).astype(np.float32)
    ref = jax_flash_attention_packed(jnp.asarray(x, jdt), h, interpret=True)
    out = fa.flash_attention_packed(torch.from_numpy(x).to(tdt), h)
    assert out.shape == (b, n, h * D) and out.dtype == tdt
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32)))
    assert err < tol, f"max abs err {err:.2e}"


@pytest.mark.parametrize("b,n", [(1, 65), (2, 200)])
def test_plain_k1_odd_heads_matches_jax_attention_reference(rng, b, n):
    h = 3  # the JAX packed kernel needs even H; the port's kernel does not
    x = rng.standard_normal((b, n, 3 * h * D)).astype(np.float32)
    q, k, v = (np.swapaxes(t.reshape(b, n, h, D), 1, 2)
               for t in np.split(x, 3, axis=-1))
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = np.swapaxes(np.asarray(ref), 1, 2).reshape(b, n, h * D)
    out = fa.flash_attention_packed(torch.from_numpy(x), h).numpy()
    assert np.max(np.abs(out - ref)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_attention_reference_matches_jax(rng, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (rng.standard_normal((2, 3, 90, D)).astype(np.float32)
               for _ in range(3))
    ref = jax_attention_reference(*(jnp.asarray(t, jdt) for t in (q, k, v)))
    out = fa.attention_reference(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)))
    assert np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32))) < tol


@pytest.mark.parametrize(
    "shape,heads,dtype,exc",
    [
        ((1, 10, 3 * 2 * 32), 2, torch.float32, ValueError),  # d = 32
        ((1, 10, 3 * 2 * 128), 2, torch.float32, ValueError),  # d = 128
        ((1, 10, 3 * 2 * 64 + 1), 2, torch.float32, ValueError),  # not 3*H*d
        ((10, 3 * 2 * 64), 2, torch.float32, ValueError),  # no batch axis
        ((1, 10, 3 * 2 * 64), 2, torch.float16, TypeError),
        ((1, 10, 3 * 2 * 64), 2, torch.float64, TypeError),
    ],
)
def test_wrapper_rejects_unsupported_inputs(shape, heads, dtype, exc):
    with pytest.raises(exc):
        fa.flash_attention_packed(torch.zeros(shape, dtype=dtype), heads)


def test_wrapper_rejects_non_contiguous_and_other_devices():
    x = torch.zeros((1, 3 * 2 * 64, 10)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_packed(x, 2)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_packed(torch.zeros((1, 10, 3 * 2 * 64), device="meta"), 2)


def test_cpu_tensor_never_touches_launch_counter(rng):
    before = fa.flash_attention_packed.launches
    x = torch.from_numpy(rng.standard_normal((1, 70, 3 * 2 * D)).astype(np.float32))
    fa.flash_attention_packed(x, 2)
    fa.flash_attention_packed(x.to(torch.bfloat16), 2)
    assert fa.flash_attention_packed.launches == before


def test_plain_k1_is_one_softmax_attention(rng):
    """Deferred normalization: every output row is a convex combination of
    the value rows (rows of P sum to 1), so constant V maps to itself."""
    x = rng.standard_normal((1, 50, 3 * 2 * D)).astype(np.float32)
    x[..., 2 * 2 * D:] = 0.5
    out = fa.flash_attention_packed_reference(torch.from_numpy(x), 2)
    np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-6)

