"""The tile algorithms of the port's Hopper attention kernels K1, K2 and K3
(``monocular_depth_estimation_trt_tpu_torch/csrc/attention_sm90.cuh``),
modelled here in plain PyTorch, against the JAX package's Pallas kernels in
interpret mode.

The CUDA kernels cannot run on the CPU; these models repeat their algorithms
step by step (64-row query tiles, 128-key tiles, the softmax in fp32 with
exp2 and scale*log2(e) folded in, P cast to bf16 before P.V; at head_dim
128 the scores summed over two 64-column regions and O computed region by
region, as the kernels' tiles hold them; K1 as K2's online mode over the
strided q, k and v views of the packed qkv tensor), so that the algorithms
are settled against the TPU kernels before any card time is spent. The kernels themselves are held against the port's plain version on
a card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Bars, in bf16 steps at the largest output of the JAX kernel: K3's exact
two-pass model divides P by the row sum before its cast, as the TPU kernel
does, so the two differ only by the rounding of a few fp32 values before a
cast: 1 step. K2's online model casts the unnormalised exponentials and
divides at the end: K2_BF16_ULPS steps, the bar ``chip_smoke.py`` holds the
kernel to. A model that skips one key tile must fail both.

The fp32 K1 and K2 (``csrc/attention_sm90_f32.cuh``) keep fp32 accuracy on
the TF32 tensor cores by the split "3xTF32" products: each operand x as
hi = x truncated to TF32 (the tensor core drops a raw fp32 word's low 13
mantissa bits) and lo = x - hi, truncated in turn, each product as
lo.hi + hi.lo + hi.hi in fp32. Their model repeats that arithmetic, the
kernel's tiles (64 query rows; 64-key tiles at d = 64, 32-key tiles at d =
128) and its online softmax (exp2, the row sum dividing once after P.V),
held against the JAX kernels' fp32 forms at ``FP32_TOL``, the bar
``chip_smoke.py`` holds the fp32 kernels to. One TF32 pass, or a skipped
key tile, must fail it. The fp32 K3 runs the same loop in the same online
mode (its division after P.V changes only fp32 rounding, since in fp32 the
TPU kernel's division has no cast to stand before): the model is held
against the batched JAX kernel ``_attn_kernel_batched`` too.

The fp32 K2's and K3's heads wider than 128 run the fp32 mainloop's wide
form: d zero-padded to a multiple of 64, 64-key tiles, S summed region by
region (32 columns, one swizzle atom) over the K pieces the ring carries,
with Q's regions resident or streamed beside each piece (the same values,
another order of loads), and the output in chunks of 128 columns, each
chunk's CTA recomputing S. Its model is held to
``FP32_TOL`` against both JAX kernels; one TF32 pass, a skipped key tile,
the last region left out of S or the last chunk left out of the output must
fail it.

K2's and K3's bf16 heads wider than 128 run the mainloop's wide form: d
zero-padded to a multiple of 64, S summed over every 64-column region of
the head, 64-key tiles, the output computed in chunks of 256 columns (each
chunk's CTA recomputing S), K2 online and K3 exact, P cast to bf16 before
P.V. Its model is held to the same bars against the JAX kernels, which pad
d to a multiple of 128; a model that leaves out the last 64-column region
of the S reduction must fail them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_packed as jax_flash_attention_packed,
)
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa

BLOCK_Q = 64  # query rows per CTA: one consumer warpgroup
BLOCK_K = 128  # keys per K/V tile of the ring
LOG2E = 1.4426950408889634
K2_BF16_ULPS = 4  # chip_smoke.py's bar for K2 against its plain version
K3_BF16_ULPS = 1
FP32_TOL = 1e-4  # chip_smoke.py's bar for the fp32 kernels against their plain versions
F32_BLOCK_K = {64: 64, 128: 32}  # keys per K/V tile of the fp32 loop (Head64, Head128)
F32_WIDE_CHUNK = 128  # output columns of one fp32 wide CTA (d > 128)
F32_WIDE_BLOCK_K = 64  # keys per K/V tile of the fp32 wide form
F32_REGION = 32  # fp32 columns of one 128-byte swizzle region
SMEM_BYTES = 232448  # the shared memory of one CTA
WIDE_BLOCK_K = 64  # keys per K/V tile of the wide form (d > 128)
WIDE_CHUNK = 256  # output columns of one wide CTA


def _blocks(n, size):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


def _regions(d):
    """The 64-column regions of a head (one at d <= 64, two at d = 128)."""
    return [slice(c, c + 64) for c in range(0, d, 64)]


def _scores(rows, keys, width=None):
    """Q . K^T summed over the 64-column regions of d (of its first
    ``width`` columns where given)."""
    return sum(rows[..., r] @ keys[..., r].transpose(-1, -2)
               for r in _regions(width or rows.shape[-1]))


def _pv(p, values):
    """P . V, one 64-column region of the output after the other."""
    return torch.cat([p @ values[..., r] for r in _regions(values.shape[-1])], dim=-1)


def k2_model(q, k, v, scale, skip_tile=None, block_k=BLOCK_K, s_width=None):
    """K2 (online mode): per query tile, one pass over the key tiles with a
    running row max m and sum l; O rescaled by exp(m_old - m_new) on every
    tile; the unnormalised exponentials cast to bf16 before P.V; the row
    sum divides once at the end. ``v`` may be a chunk of the head's columns
    (the wide form's); ``s_width`` cuts the S reduction."""
    c = scale * LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((*q.shape[:-1], v.shape[-1]))
    for r0, r1 in _blocks(q.shape[2], BLOCK_Q):
        rows = qf[:, :, r0:r1]
        m = torch.full(rows.shape[:-1], -math.inf)
        l = torch.zeros(rows.shape[:-1])
        o = torch.zeros((*rows.shape[:-1], v.shape[-1]))
        for t, (k0, k1) in enumerate(_blocks(k.shape[2], block_k)):
            if t == skip_tile:
                continue
            s = _scores(rows, kf[:, :, k0:k1], s_width)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * c)  # 0 on the first tile
            p = torch.exp2(s * c - (m_new * c)[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _pv(p.to(q.dtype).float(), vf[:, :, k0:k1])
            m = m_new
        out[:, :, r0:r1] = o / l[..., None]
    return out.to(q.dtype)


def k3_model(q, k, v, scale, skip_tile=None, block_k=BLOCK_K, s_width=None):
    """K3 (exact mode): per query tile, pass 1 over the key tiles keeps the
    row max m and the rescaled row sum l; pass 2 recomputes the scores and
    forms P = exp(s*scale - m) / l as exp2(s*c - (m*c + log2 l)), cast to
    bf16 before P.V; O accumulates with no rescaling and is only cast.
    ``v`` and ``s_width`` as for :func:`k2_model`."""
    c = scale * LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((*q.shape[:-1], v.shape[-1]))
    key_tiles = [kt for t, kt in enumerate(_blocks(k.shape[2], block_k)) if t != skip_tile]
    for r0, r1 in _blocks(q.shape[2], BLOCK_Q):
        rows = qf[:, :, r0:r1]
        m = torch.full(rows.shape[:-1], -math.inf)
        l = torch.zeros(rows.shape[:-1])
        for k0, k1 in key_tiles:  # pass 1: K tiles only
            s = _scores(rows, kf[:, :, k0:k1], s_width)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s * c - (m_new * c)[..., None])
            l = l * torch.exp2((m - m_new) * c) + p.sum(-1)
            m = m_new
        bias = (m * c + torch.log2(l))[..., None]
        o = torch.zeros((*rows.shape[:-1], v.shape[-1]))
        for k0, k1 in key_tiles:  # pass 2: K and V tiles
            s = _scores(rows, kf[:, :, k0:k1], s_width)
            p = torch.exp2(s * c - bias)
            o = o + _pv(p.to(q.dtype).float(), vf[:, :, k0:k1])
        out[:, :, r0:r1] = o
    return out.to(q.dtype)


MODELS = {"k2": k2_model, "k3": k3_model}


def wide_model(kernel, q, k, v, scale, drop_last_region=False):
    """The wide form (d > 128) of K2 or K3: d zero-padded to a multiple of
    64; 64-key tiles; the output in chunks of WIDE_CHUNK columns, each
    chunk's CTA computing S over the whole padded head (all but its last
    64-column region with ``drop_last_region``) in the kernel's mode."""
    d = q.shape[-1]
    width = -(-d // 64) * 64
    q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
    s_width = width - 64 if drop_last_region else width
    chunks = [MODELS[kernel](q, k, v[..., c:c + WIDE_CHUNK], scale, block_k=WIDE_BLOCK_K,
                             s_width=s_width) for c in range(0, width, WIDE_CHUNK)]
    return torch.cat(chunks, dim=-1)[..., :d]


def _inputs(rng, n, d):
    return [rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(3)]


def _jax_kernel(kernel, q, k, v):
    """``_attn_kernel`` (blk_b=1) for K2, ``_attn_kernel_batched`` (blk_b=2,
    both heads in one program) for K3, in interpret mode, in bf16."""
    kw = {"blk_b": 2} if kernel == "k3" else {}
    out = jax_flash_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                              interpret=True, **kw)
    return np.asarray(out, np.float32)


def _model(kernel, q, k, v, skip_tile=None):
    args = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    out = MODELS[kernel](*args, 1.0 / math.sqrt(q.shape[-1]), skip_tile=skip_tile)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    return out.float().numpy()


def _wide(kernel, q, k, v, drop_last_region=False):
    args = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    out = wide_model(kernel, *args, 1.0 / math.sqrt(q.shape[-1]),
                     drop_last_region=drop_last_region)
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    return out.float().numpy()


def _bf16_step(ref):
    """Spacing of bf16 numbers at the largest output."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


@pytest.mark.parametrize("n", [1, 65, 129, 577])
@pytest.mark.parametrize("d", [64, 16, 128])
def test_k2_tile_model_matches_the_jax_kernel(rng, n, d):
    q, k, v = _inputs(rng, n, d)
    ref = _jax_kernel("k2", q, k, v)
    err = np.abs(_model("k2", q, k, v) - ref).max()
    assert err <= K2_BF16_ULPS * _bf16_step(ref), (err, _bf16_step(ref))


@pytest.mark.parametrize("n", [1, 65, 129, 577])
@pytest.mark.parametrize("d", [64, 16, 128])
def test_k3_tile_model_matches_the_batched_jax_kernel(rng, n, d):
    q, k, v = _inputs(rng, n, d)
    ref = _jax_kernel("k3", q, k, v)
    err = np.abs(_model("k3", q, k, v) - ref).max()
    assert err <= K3_BF16_ULPS * _bf16_step(ref), (err, _bf16_step(ref))


@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("n,skip_tile,d", [(129, 0, 64), (129, 1, 64), (577, 2, 64),
                                           (577, 2, 128)])
def test_a_model_that_skips_a_key_tile_fails_both_bars(rng, kernel, n, skip_tile, d):
    q, k, v = _inputs(rng, n, d)
    ref = _jax_kernel(kernel, q, k, v)
    err = np.abs(_model(kernel, q, k, v, skip_tile=skip_tile) - ref).max()
    assert err > max(K2_BF16_ULPS, K3_BF16_ULPS) * _bf16_step(ref), (err, _bf16_step(ref))


@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("n", [65, 577])
def test_tile_models_match_the_plain_version(rng, kernel, n):
    """The port's plain version of K2 and K3 (what a CPU tensor runs, and
    what the kernels are held against on the card) is the TPU kernels'
    single-pass softmax: the models sit within their bars of it too."""
    q, k, v = _inputs(rng, n, 64)
    plain = fa.flash_attention_reference(*(torch.from_numpy(t).to(torch.bfloat16)
                                           for t in (q, k, v))).float().numpy()
    bar = {"k2": K2_BF16_ULPS, "k3": K3_BF16_ULPS}[kernel]
    err = np.abs(_model(kernel, q, k, v) - plain).max()
    assert err <= bar * _bf16_step(plain), (err, _bf16_step(plain))


@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("d", [192, 320])
@pytest.mark.parametrize("n", [65, 200])
def test_wide_tile_model_matches_the_jax_kernel(rng, kernel, n, d):
    """The wide form against ``_attn_kernel`` (K2) and ``_attn_kernel_batched``
    (K3), which pad d to 256 and 384, at each kernel's bar: one output
    chunk at d = 192, two (256 + 64 columns) at d = 320."""
    q, k, v = _inputs(rng, n, d)
    ref = _jax_kernel(kernel, q, k, v)
    bar = {"k2": K2_BF16_ULPS, "k3": K3_BF16_ULPS}[kernel] * _bf16_step(ref)
    err = np.abs(_wide(kernel, q, k, v) - ref).max()
    assert err <= bar, (err, _bf16_step(ref))


@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("d", [192, 320])
def test_a_wide_model_that_drops_the_last_region_fails_both_bars(rng, kernel, d):
    """Leaving the last 64-column region out of the S reduction moves the
    output past both bars (what a kernel that stepped one region short of d
    would compute)."""
    q, k, v = _inputs(rng, 200, d)
    ref = _jax_kernel(kernel, q, k, v)
    err = np.abs(_wide(kernel, q, k, v, drop_last_region=True) - ref).max()
    assert err > max(K2_BF16_ULPS, K3_BF16_ULPS) * _bf16_step(ref), (err, _bf16_step(ref))


def k1_model(qkv, heads, scale, skip_tile=None):
    """K1: K2's online mode over the (B, H, N, 64) views of the packed
    (B, N, 3*H*64) tensor (q at column 0, k at H*64, v at 2*H*64; strides
    N*3*H*64, 64 and 3*H*64), the output written (B, N, H*64)."""
    b, n, _ = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, heads, 64).unbind(2))
    assert q.stride() == (n * 3 * heads * 64, 64, 3 * heads * 64, 1)
    out = k2_model(q, k, v, scale, skip_tile=skip_tile)
    return out.transpose(1, 2).reshape(b, n, heads * 64)


@pytest.mark.parametrize("n,heads", [(1, 2), (65, 2), (577, 4), (1370, 2)])
def test_k1_tile_model_matches_the_packed_jax_kernel(rng, n, heads):
    """K1's online mode over packed strides against ``_attn_kernel_packed``
    (which, like it, divides after P.V): within K2's bar; with a key tile
    skipped, outside it."""
    qkv = rng.standard_normal((1, n, 3 * heads * 64)).astype(np.float32)
    ref = np.asarray(jax_flash_attention_packed(jnp.asarray(qkv, jnp.bfloat16), heads,
                                                interpret=True), np.float32)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    bar = K2_BF16_ULPS * _bf16_step(ref)
    err = np.abs(k1_model(x, heads, 0.125).float().numpy() - ref).max()
    assert err <= bar, (err, bar)
    if n > BLOCK_K:
        skipped = k1_model(x, heads, 0.125, skip_tile=n // BLOCK_K // 2).float().numpy()
        assert np.abs(skipped - ref).max() > bar


def _tf32(x):
    """x truncated to TF32: the low 13 of fp32's 23 mantissa bits dropped, as
    the tensor core reads a raw fp32 word."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _tf32_product(a, b, passes=3):
    """a @ b as the fp32 loop's wgmma chains take it: lo.hi + hi.lo + hi.hi
    with hi = tf32(x), lo = tf32(x - hi), fp32 sums (products of two TF32
    values are exact in fp32). ``passes=1`` is a single TF32 pass, hi.hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    return _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + a_hi @ b_hi


def f32_wide_plan(d, chunk=F32_WIDE_CHUNK, block_k=F32_WIDE_BLOCK_K):
    """The fp32 wide form's ring at a padded head width ``d`` (a multiple of
    64 above 128) (``csrc/attention_sm90_f32.cuh``, ``wide_args``): the
    regions of a K piece, whether Q is streamed beside each piece, the slots
    of the ring and the CTA's shared memory. A slot holds the larger of a K
    piece (K and K lo, with Q and Q lo when streamed) and a chunk's V^T and
    V^T lo; Q and Q lo stay resident where they fit beside two slots, else a
    piece narrows until two slots fit."""
    regions = d // F32_REGION
    q_region, k_region = BLOCK_Q * 128, block_k * 128
    vt = 2 * chunk * block_k * 4
    bars, max_stages = 8 * (2 + 3 * 6), 6
    room = SMEM_BYTES - bars - 1024

    def slot(p, streamed):
        return max(vt, 2 * p * (k_region + (q_region if streamed else 0)))

    p = min(regions, chunk // F32_REGION)
    q_bytes = 2 * regions * q_region
    streamed = q_bytes + 2 * slot(p, False) > room
    if streamed:
        while p > 1 and 2 * slot(p, True) > room:
            p -= 1
        q_bytes = 0
    stages = min(max_stages, (room - q_bytes) // slot(p, streamed))
    return {"piece_regions": p, "q_streamed": streamed, "stages": stages,
            "smem": q_bytes + stages * slot(p, streamed) + bars + 1024}


def f32_model(q, k, v, scale, skip_tile=None, passes=3, cut=None):
    """The fp32 K2 and K3 (and K1 over its views): per 64-row query tile and
    output chunk, one pass over the key tiles; S = Q.K^T and O += P.V each as
    the split TF32 products, S summed region by region over the K pieces of
    the head; a running row max m and sum l in fp32, O rescaled by
    exp2((m_old - m_new) * c) on every tile, P = exp2(s*c - m*c) split like
    any operand (hi is p itself), the row sum dividing once at the end. At
    d <= 128 the loop's tiles: F32_BLOCK_K[d] keys, one piece, one chunk of
    d columns. Above 128 the wide form's: d zero-padded to a multiple of 64,
    F32_WIDE_BLOCK_K keys, chunks of F32_WIDE_CHUNK columns (each
    recomputing S) and the pieces of :func:`f32_wide_plan`. ``cut``:
    "last_region" leaves the
    last region out of S, "chunk" the last chunk out of the output (zeros).
    The kernel masks the ragged last tile's keys past N to -inf; here the
    tile is cut at N, which is the same sum."""
    c = scale * LOG2E
    d = q.shape[-1]
    if d > 128:
        width = -(-d // 64) * 64
        q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
        chunk, block_k = F32_WIDE_CHUNK, F32_WIDE_BLOCK_K
        piece = f32_wide_plan(width)["piece_regions"]
    else:
        width, block_k, chunk = d, F32_BLOCK_K[d], d
        piece = -(-d // F32_REGION)
    regions = -(-width // F32_REGION) - (cut == "last_region")
    pieces = [range(r0, min(r0 + piece, regions)) for r0 in range(0, regions, piece)]
    chunks = _blocks(width, chunk)[:-1 if cut == "chunk" else None]
    out = torch.zeros(q.shape)
    for c0, c1 in chunks:
        for r0, r1 in _blocks(q.shape[2], BLOCK_Q):
            rows = q[:, :, r0:r1]
            m = torch.full(rows.shape[:-1], -math.inf)
            l = torch.zeros(rows.shape[:-1])
            o = torch.zeros((*rows.shape[:-1], c1 - c0))
            for t, (k0, k1) in enumerate(_blocks(k.shape[2], block_k)):
                if t == skip_tile:
                    continue
                s = 0
                for regs in pieces:
                    for r in regs:
                        cols = slice(F32_REGION * r, F32_REGION * (r + 1))
                        s = s + _tf32_product(rows[..., cols],
                                              k[:, :, k0:k1, cols].transpose(-1, -2), passes)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - m_new) * c)  # 0 on the first tile
                p = torch.exp2(s * c - (m_new * c)[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + _tf32_product(p, v[:, :, k0:k1, c0:c1], passes)
                m = m_new
            out[:, :, r0:r1, c0:c1] = o / l[..., None]
    return out[..., :d]


def _f32_case(rng, layout, n, d, **kw):
    """(the fp32 model's output, the JAX kernel's in interpret mode, the
    port's plain version's) on one seeded input: K2's (1, 2, n, d) operands,
    K3's the same against the batched JAX kernel (both heads in one
    program), or K1's packed (1, n, 3*2*64) tensor through its strided
    views."""
    scale = 1.0 / math.sqrt(d)
    if layout == "k1":
        heads = 2
        qkv = rng.standard_normal((1, n, 3 * heads * d)).astype(np.float32)
        ref = np.asarray(jax_flash_attention_packed(jnp.asarray(qkv), heads, interpret=True))
        x = torch.from_numpy(qkv)
        q, k, v = (t.transpose(1, 2) for t in x.view(1, n, 3, heads, d).unbind(2))
        got = f32_model(q, k, v, scale, **kw).transpose(1, 2).reshape(1, n, heads * d)
        plain = fa.flash_attention_packed_reference(x, heads)
    else:
        q, k, v = _inputs(rng, n, d)
        kw_jax = {"blk_b": 2} if layout == "k3" else {}
        ref = np.asarray(jax_flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                             interpret=True, **kw_jax))
        args = [torch.from_numpy(t) for t in (q, k, v)]
        got = f32_model(*args, scale, **kw)
        plain = fa.flash_attention_reference(*args)
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    return got.numpy(), ref, plain.numpy()


@pytest.mark.parametrize("layout,d", [("k2", 64), ("k2", 128), ("k1", 64), ("k2", 192),
                                      ("k2", 320)])
@pytest.mark.parametrize("n", [65, 200, 300])
def test_fp32_tile_model_matches_the_jax_kernel(rng, layout, n, d):
    """The split TF32 model against the JAX kernels' fp32 forms (interpret
    mode) and the port's plain version, at FP32_TOL; above 128 the wide form
    (d = 192: Q resident, two chunks; d = 320: Q streamed in 3-region
    pieces, three chunks of 128 + 128 + 64)."""
    got, ref, plain = _f32_case(rng, layout, n, d)
    assert np.abs(got - ref).max() <= FP32_TOL, np.abs(got - ref).max()
    assert np.abs(got - plain).max() <= FP32_TOL, np.abs(got - plain).max()


@pytest.mark.parametrize("d", [64, 128, 192, 320])
@pytest.mark.parametrize("n", [65, 200, 577])
def test_fp32_k3_tile_model_matches_the_batched_jax_kernel(rng, n, d):
    """The fp32 K3 (the split TF32 loop in its online mode) against
    ``_attn_kernel_batched`` in fp32 (interpret mode), which divides P by
    the row sum before P.V, and the port's plain version, at FP32_TOL: 577
    tokens pad to 640 keys, 10 key tiles at d = 64 and 19 at d = 128 and in
    the wide form (d = 192, 320)."""
    got, ref, plain = _f32_case(rng, "k3", n, d)
    assert np.abs(got - ref).max() <= FP32_TOL, np.abs(got - ref).max()
    assert np.abs(got - plain).max() <= FP32_TOL, np.abs(got - plain).max()


@pytest.mark.parametrize("cut", ["one_tf32_pass", "skipped_key_tile", "dropped_last_region",
                                 "dropped_chunk"])
@pytest.mark.parametrize("layout,d", [("k2", 64), ("k2", 128), ("k1", 64), ("k3", 64),
                                      ("k3", 128), ("k2", 192), ("k2", 320), ("k3", 192),
                                      ("k3", 320)])
def test_fp32_models_that_cut_a_corner_fail_the_bar(rng, cut, layout, d):
    """A single TF32 pass (operands rounded to about 11 bits), a model that
    skips one key tile, one that stops one 32-column region short of d in S
    and one that leaves the last output chunk out (at d <= 128 the only one)
    all miss FP32_TOL against the JAX kernel: the split is needed, and the
    bar catches a dropped tile, region or chunk."""
    kw = {"one_tf32_pass": {"passes": 1}, "skipped_key_tile": {"skip_tile": 1},
          "dropped_last_region": {"cut": "last_region"}, "dropped_chunk": {"cut": "chunk"}}[cut]
    got, ref, _ = _f32_case(rng, layout, 200, d, **kw)
    assert np.abs(got - ref).max() > FP32_TOL, np.abs(got - ref).max()


@pytest.mark.parametrize("d", [192, 256, 320, 384, 1024, 1536, 2048])
def test_fp32_wide_plan_fits_a_cta_and_streams_q_where_it_must(d):
    """The fp32 wide form's ring at every width: at least two slots in the
    227 KB of a CTA; Q resident up to d = 192 and streamed above, in pieces
    of 3 regions (a piece at most one chunk wide)."""
    plan = f32_wide_plan(d)
    assert plan["stages"] >= 2 and plan["smem"] <= SMEM_BYTES, plan
    assert plan["q_streamed"] == (d > 192), plan
    assert plan["piece_regions"] == (F32_WIDE_CHUNK // F32_REGION if d == 192 else 3), plan
