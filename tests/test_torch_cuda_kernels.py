"""The port's CUDA kernels on a card (marker ``cuda``; each test skips where
``torch.cuda.is_available()`` is false, the kernels having no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies. ``tests/conftest.py`` imports JAX,
so there it runs without it::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from monocular_depth_estimation_trt_tpu_torch.models.vit import ViTConfig
from monocular_depth_estimation_trt_tpu_torch.ops.cuda import flash_attention as fa
from monocular_depth_estimation_trt_tpu_torch.registry import build_pipeline
from monocular_depth_estimation_trt_tpu_torch.weights.store import allow_random_weights

pytestmark = pytest.mark.cuda

D = fa.HEAD_DIM
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # bf16 output mantissa; fp32 order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(b, n, h, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, 3 * h * D), generator=gen).to(device, dtype)


@pytest.mark.parametrize("b,n,h,dtype", [
    (1, 1370, 6, torch.bfloat16), (2, 65, 3, torch.bfloat16), (1, 1, 6, torch.bfloat16),
    (1, 64, 16, torch.bfloat16), (2, 130, 3, torch.float32), (1, 1370, 6, torch.float32),
])
def test_k1_matches_its_plain_version(cuda, b, n, h, dtype):
    x = _qkv(b, n, h, dtype, cuda)
    before = fa.flash_attention_packed.launches
    out = fa.flash_attention_packed(x, h)
    torch.cuda.synchronize()
    assert fa.flash_attention_packed.launches == before + 1
    assert out.shape == (b, n, h * D) and out.dtype == dtype and out.is_cuda
    ref = fa.flash_attention_packed_reference(x, h)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_k1_takes_a_scale_and_refuses_what_it_cannot_read(cuda):
    x = _qkv(1, 100, 2, torch.bfloat16, cuda)
    out = fa.flash_attention_packed(x, 2, scale=0.3)
    ref = fa.flash_attention_packed_reference(x, 2, 0.3)
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]
    wide = _qkv(1, 100, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_packed(wide[:, ::2], 2)
    flat = torch.zeros(1 + 100 * 3 * 2 * D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_packed(flat[1:].view(1, 100, 3 * 2 * D), 2)
    with pytest.raises(TypeError):
        fa.flash_attention_packed(x.half(), 2)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_pipeline_on_the_card_goes_through_k1(cuda, precision):
    """A small DA-V2 (head_dim 64, 2 blocks) on the card: one K1 launch per
    block per frame, and the depth of the card against the CPU fp32 path at
    the same weights."""
    kw = dict(encoder="small", input_size=70, model_kw=dict(
        vit_config=ViTConfig(dim=128, depth=2, num_heads=2, pretrain_img_size=70),
        head_features=16, head_out_channels=(8, 16, 32, 32), out_indices=(0, 1, 0, 1)))
    with allow_random_weights(True):
        card = build_pipeline("depth_anything_v2", precision=precision, **kw)
        cpu = build_pipeline("depth_anything_v2", precision="fp32", device="cpu", **kw)
    frame = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    before = fa.flash_attention_packed.launches
    out = card(frame, viz=True)
    assert fa.flash_attention_packed.launches == before + 2
    ref = cpu(frame)["depth"]
    rel = np.abs(out["depth"] - ref).max() / np.abs(ref).max()
    assert rel < (5e-2 if precision == "bf16" else 1e-3)
    assert out["viz"].shape == (48, 64, 3) and out["viz"].dtype == np.uint8
