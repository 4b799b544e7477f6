"""Kernels K1 (packed-qkv attention) and K2 ((B, H, N, d) attention) of the
torch port against the JAX package's ``flash_attention_packed`` and
``flash_attention`` in Pallas interpret mode.

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
    flash_attention as jax_flash_attention,
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



@pytest.mark.parametrize("n", [1, 65, 130, 300])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k2_matches_jax_kernel(rng, n, d, dtype):
    """The JAX entry pads N to 128 with masked keys and d to 64, or above
    64 to a multiple of 128, with zeros; the port's plain version pads
    nothing and takes any d."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (rng.standard_normal((2, 3, n, d)).astype(np.float32) for _ in range(3))
    ref = jax_flash_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), interpret=True)
    out = fa.flash_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)))
    assert out.shape == (2, 3, n, d) and out.dtype == tdt
    err = np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32)))
    assert err < tol, f"max abs err {err:.2e}"


def test_plain_k2_takes_strided_views_and_a_scale(rng):
    """q, k, v as views of one qkv tensor (the VGGT layout), any scale."""
    b, n, h = 2, 90, 3
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, D)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = fa.flash_attention(q, k, v, scale=0.3)
    ref = fa.attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), 0.3)
    assert np.max(np.abs(out.numpy() - ref.numpy())) < 1e-5


@pytest.mark.parametrize("d", [80, 128, 192, 320, 384])
def test_k2_computes_head_dims_above_64_as_jax_does(rng, d):
    """Widths that used to raise: on the CPU the plain version computes them
    with the scale of the unpadded d, as the JAX entry does (on a card K2
    pads them to 128 or, above 128, to the next multiple of 64 in either
    type)."""
    q, k, v = (rng.standard_normal((1, 2, 10, d)).astype(np.float32) for _ in range(3))
    ref = jax_flash_attention(*(jnp.asarray(t) for t in (q, k, v)), interpret=True)
    out = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.shape == (1, 2, 10, d)
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) < 1e-5


@pytest.mark.parametrize("d,dtype,width", [
    (16, torch.bfloat16, 64), (64, torch.float32, 64), (80, torch.bfloat16, 128),
    (128, torch.float32, 128), (130, torch.bfloat16, 192), (192, torch.bfloat16, 192),
    (200, torch.bfloat16, 256), (320, torch.bfloat16, 320), (1000, torch.bfloat16, 1024),
    (130, torch.float32, 192), (192, torch.float32, 192), (320, torch.float32, 320),
    (1000, torch.float32, 1024),
])
def test_k2_and_k3_pad_a_head_to_the_width_their_kernel_takes(rng, d, dtype, width):
    """On a card the wrapper zero-pads d: to 64, to 128, and above 128 to a
    multiple of 64 in either type (the wide forms of the bf16 and the fp32
    mainloops; the JAX entry pads to 128). Zero columns change no result:
    the plain version on the padded operands, cut back to d, is the
    unpadded one."""
    assert fa._kernel_head_dim(d) == width
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 33, d)).astype(np.float32))
               for _ in range(3))
    padded = fa._padded(q.to(dtype), k.to(dtype), v.to(dtype))
    assert all(t.shape == (1, 2, 33, width) and t.dtype == dtype for t in padded)
    scale = d ** -0.5
    got = fa.flash_attention_reference(*padded, scale)[..., :d].float()
    want = fa.flash_attention_reference(q.to(dtype), k.to(dtype), v.to(dtype), scale).float()
    assert (got - want).abs().max().item() <= (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("shapes,dtypes,exc", [
    ([(1, 2, 10, 0)] * 3, [torch.float32] * 3, ValueError),  # no head width
    ([(2, 10, 64)] * 3, [torch.float32] * 3, ValueError),  # no head axis
    ([(1, 2, 10, 64), (1, 2, 11, 64), (1, 2, 10, 64)], [torch.float32] * 3, ValueError),
    ([(1, 2, 10, 64)] * 3, [torch.float16] * 3, TypeError),
    ([(1, 2, 10, 64)] * 3, [torch.float32, torch.bfloat16, torch.float32], TypeError),
])
def test_k2_wrapper_rejects_unsupported_inputs(shapes, dtypes, exc):
    with pytest.raises(exc, match="head_dim|shape|float"):
        fa.flash_attention(*(torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes)))


def test_k2_wrapper_rejects_other_devices():
    q = torch.zeros((1, 2, 10, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q, q)


def test_cpu_tensor_never_touches_the_k2_launch_counter(rng):
    before = fa.flash_attention.launches
    q = torch.from_numpy(rng.standard_normal((1, 2, 70, 32)).astype(np.float32))
    fa.flash_attention(q, q, q)
    fa.flash_attention(q.to(torch.bfloat16), q.to(torch.bfloat16), q.to(torch.bfloat16))
    assert fa.flash_attention.launches == before


def test_plain_k2_is_one_softmax_attention(rng):
    """Rows of P sum to 1: a constant V maps to itself, at any length."""
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, 500, D)).astype(np.float32) * 3)
            for _ in range(2))
    out = fa.flash_attention_reference(q, k, torch.full((1, 2, 500, D), 0.5))
    np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-6)
