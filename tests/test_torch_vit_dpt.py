"""The torch port's DINOv2 encoder, DPT head and attention module against the
JAX package's Flax modules, fp32, at the parity tests' tiny config.

One set of seeded weights drives both sides: a Flax params tree filled by
numpy (``torch_port_params.random_params``), and ``weights/from_jax.py`` for
the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu.models import dpt as jdpt
from monocular_depth_estimation_trt_tpu.models import vit as jvit
from monocular_depth_estimation_trt_tpu_torch.models import dpt as tdpt
from monocular_depth_estimation_trt_tpu_torch.models import vit as tvit
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.weights.from_jax import (
    dinovit_from_jax,
    dpt_head_from_jax,
)

from torch_port_params import random_params, rel_err

torch.set_num_threads(1)

# tests/test_parity_da_v2.py's tiny config (head_dim 32)
TINY = dict(dim=64, depth=4, num_heads=2, pretrain_img_size=70)
TINY_HEAD = dict(features=16, out_channels=(8, 16, 32, 32))
REL_TOL = 2e-3  # fp32: summation order and erf/exp implementations only


def _vit_pair(cfg_kw, x, out_indices, raw_indices=(), seed=0):
    jm = jvit.DinoViT(jvit.ViTConfig(**cfg_kw), out_indices=out_indices,
                      dtype=jnp.float32, attn_impl="xla", raw_indices=raw_indices)
    params = random_params(jm, jnp.asarray(x), seed=seed)
    # head_dim 32: the plain route on both sides (K1 takes head_dim 64 only)
    tm = tvit.DinoViT(tvit.ViTConfig(**cfg_kw), out_indices=out_indices,
                      attn_impl="xla", raw_indices=raw_indices)
    tm.load_state_dict(dinovit_from_jax(params, prefix=""), strict=True)
    return jm, params, tm.eval()


def _check_taps(tm, jm, params, x):
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert len(ours) == len(ref)
    for (tp, tc), (jp, jc) in zip(ours, ref):
        assert rel_err(tp.numpy(), jp) < REL_TOL
        assert rel_err(tc.numpy(), jc) < REL_TOL


@pytest.mark.parametrize("hw", [(70, 70), (84, 56)])
def test_dinovit_matches_jax(rng, hw):
    """(84, 56) is a 6x4 grid: the pos-embed table is interpolated."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32) * 0.5
    jm, params, tm = _vit_pair(TINY, x, (0, 1, 2, 3))
    _check_taps(tm, jm, params, x)


@pytest.mark.parametrize("variant", ["swiglu", "registers", "raw_taps"])
def test_dinovit_variants_match_jax(rng, variant):
    cfg = dict(TINY, depth=2)
    raw = ()
    if variant == "swiglu":
        cfg["ffn"] = "swiglu"
    elif variant == "registers":
        cfg["num_register_tokens"] = 4
    else:
        raw = (0,)
    x = rng.standard_normal((1, 84, 56, 3)).astype(np.float32) * 0.5
    jm, params, tm = _vit_pair(cfg, x, (0, -1), raw, seed=1)
    _check_taps(tm, jm, params, x)


@pytest.mark.parametrize("grid", [(6, 4), (5, 5), (9, 3)])
def test_interpolate_pos_embed_matches_jax(rng, grid):
    pos = rng.standard_normal((1, 1 + 25, 8)).astype(np.float32)
    ref = jvit.interpolate_pos_embed(jnp.asarray(pos), 5, grid)
    ours = tvit.interpolate_pos_embed(torch.from_numpy(pos), 5, grid)
    assert rel_err(ours.numpy(), ref) < 1e-6


@pytest.mark.parametrize("hw,final_act", [((70, 70), "relu"), ((84, 56), "sigmoid")])
def test_dpt_head_matches_jax(rng, hw, final_act):
    ph, pw = hw[0] // 14, hw[1] // 14
    feats = [(rng.standard_normal((2, ph * pw, 64)).astype(np.float32),
              rng.standard_normal((2, 64)).astype(np.float32)) for _ in range(4)]
    jfeats = [tuple(jnp.asarray(t) for t in f) for f in feats]
    jm = jdpt.DPTHead(in_channels=64, final_act=final_act, dtype=jnp.float32,
                      **TINY_HEAD)
    params = random_params(jm, jfeats, (ph, pw), seed=2)
    tm = tdpt.DPTHead(in_channels=64, final_act=final_act, **TINY_HEAD)
    tm.load_state_dict(dpt_head_from_jax(params, prefix=""), strict=True)
    ref = jm.apply({"params": params}, jfeats, (ph, pw))
    with torch.no_grad():
        ours = tm.eval()([tuple(torch.from_numpy(t) for t in f) for f in feats],
                         (ph, pw))
    assert ours.shape == (2, hw[0], hw[1]) and ours.dtype == torch.float32
    assert rel_err(ours.numpy(), ref) < REL_TOL


def _attention_pair(impl, jdtype, x):
    jm = jvit.Attention(128, 2, dtype=jdtype, attn_impl=impl)
    params = random_params(jm, jnp.asarray(x[:, :8]), seed=3)
    tm = tvit.Attention(128, 2, attn_impl="auto" if impl == "packed" else impl)
    sd = {}
    for name in ("qkv", "proj"):
        sd[f"{name}.weight"] = torch.from_numpy(params[name]["kernel"].T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(params[name]["bias"])
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_packed_kernel(rng, dtype):
    """dim 128 / 2 heads gives head_dim 64 and an even head count, which the
    JAX packed kernel needs; N=1030 is inside its 1024..4096 gate, so the
    Flax module runs the Pallas kernel (interpret mode on the CPU) and the
    port's default route runs K1's plain version."""
    # bf16: the qkv and proj matmuls round at other places in the two
    # frameworks; the bar is a few bf16 steps (3.9e-3 each) of the output
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 1e-4),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    x = rng.standard_normal((1, 1030, 128)).astype(np.float32)
    jm, params, tm = _attention_pair("packed", jdt, x)
    ref = jm.apply({"params": params}, jnp.asarray(x, jdt))
    tm = tm.to(tdt)
    before = fa.flash_attention_packed.launches
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).to(tdt))
    assert fa.flash_attention_packed.launches == before  # CPU: plain version
    assert rel_err(ours.float().numpy(), np.asarray(ref, np.float32)) < tol


def test_attention_plain_route_matches_jax(rng):
    x = rng.standard_normal((2, 37, 128)).astype(np.float32)
    jm, params, tm = _attention_pair("xla", jnp.float32, x)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    assert rel_err(ours.numpy(), ref) < 1e-5


def test_rope_and_flash_routes_name_the_missing_kernel():
    with pytest.raises(NotImplementedError, match="K2"):
        tvit.DinoViT(tvit.ViTConfig(dim=64, depth=1, num_heads=1, rope=True))
    with pytest.raises(NotImplementedError, match="K2"):
        tvit.rope_2d_normalized(4, 4, 64)
    attn = tvit.Attention(128, 2, attn_impl="flash")
    with pytest.raises(NotImplementedError, match="K2"):
        attn(torch.zeros(1, 4, 128))
    with pytest.raises(ValueError):
        tvit.Attention(128, 2, attn_impl="sdpa")


def test_swiglu_hidden_and_configs_match_jax():
    for dim in (64, 384, 1536):
        assert tvit.swiglu_hidden(dim) == jvit.swiglu_hidden(dim)
    assert tvit.VIT_CONFIGS.keys() == jvit.VIT_CONFIGS.keys()
    for name, cfg in jvit.VIT_CONFIGS.items():
        assert tvit.VIT_CONFIGS[name].__dict__ == cfg.__dict__
