"""DPT decoder head (counterpart of the JAX package's ``models/dpt.py``).

Four intermediate ViT feature maps -> per-level 1x1 projections -> up/down
resize layers (ConvTranspose2d k=s=4, k=s=2, identity, Conv 3x3 s=2) ->
RefineNet-style fusion pyramid with bilinear ``align_corners=True``
upsampling -> 2-conv output head. Module names follow the upstream DA-V2
checkpoint (``projects.i``, ``resize_layers.i``, ``scratch.layer{i}_rn``,
``scratch.refinenet{i}``, ``scratch.output_conv2.{0,2}``).

Tokens arrive as (B, N, D) and are reshaped to (B, ph, pw, D) before the
permute to NCHW, as the JAX head does; the output is (B, H, W) float32
(or (B, H, W, C) for ``num_outputs > 1``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from monocular_depth_estimation_trt_tpu_torch.ops.resize import resample_tensor


def _bilinear_ac(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of NCHW as two contractions in the
    activation dtype (bf16 on the card, fp32 in the parity tests), as the JAX
    head's ``_bilinear_ac`` on NHWC."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == tuple(out_hw):
        return x
    wh = resample_tensor(h, out_hw[0], "linear", True, device=x.device, dtype=x.dtype)
    ww = resample_tensor(w, out_hw[1], "linear", True, device=x.device, dtype=x.dtype)
    y = torch.einsum("oh,nchw->ncow", wh, x)
    return torch.einsum("pw,ncow->ncop", ww, y)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out = x
        if res is not None:
            out = out + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        if size is None:
            size = (out.shape[-2] * 2, out.shape[-1] * 2)
        out = _bilinear_ac(out, size)
        return self.out_conv(out)


class _Scratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], features: int,
                 num_outputs: int):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, 1, 1),
            nn.ReLU(),
            nn.Conv2d(32, num_outputs, 1),
        )


class DPTHead(nn.Module):
    """Input: list of 4 (patch_tokens (B, N, D), cls (B, D)); output (B, H, W)
    at resolution (patch_h*14, patch_w*14)."""

    def __init__(self, in_channels: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384),
                 patch_size: int = 14, final_act: str = "relu",
                 num_outputs: int = 1):
        super().__init__()
        if final_act not in ("relu", "sigmoid", "none"):
            raise ValueError(f"unknown final_act {final_act!r}")
        oc = list(out_channels)
        self.patch_size = patch_size
        self.final_act = final_act
        self.num_outputs = num_outputs
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, 2, 1),
        ])
        self.scratch = _Scratch(oc, features, num_outputs)

    def forward(self, features, patch_hw: Tuple[int, int]) -> torch.Tensor:
        ph, pw = patch_hw
        dtype = self.projects[0].weight.dtype
        s = self.scratch
        levels = []
        for i, feat in enumerate(features):
            tokens = feat[0] if isinstance(feat, (tuple, list)) else feat
            b, _, d = tokens.shape
            x = tokens.reshape(b, ph, pw, d).permute(0, 3, 1, 2).to(dtype)
            x = self.resize_layers[i](self.projects[i](x))
            levels.append(x)

        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(levels))
        path4 = s.refinenet4(l4, size=l3.shape[-2:])
        path3 = s.refinenet3(path4, l3, size=l2.shape[-2:])
        path2 = s.refinenet2(path3, l2, size=l1.shape[-2:])
        path1 = s.refinenet1(path2, l1)

        out = s.output_conv1(path1)
        out = _bilinear_ac(out, (ph * self.patch_size, pw * self.patch_size))
        out = s.output_conv2(out)
        if self.final_act == "relu":
            out = F.relu(out)
        elif self.final_act == "sigmoid":
            out = torch.sigmoid(out)
        out = out.float()
        if self.num_outputs > 1:
            return out.permute(0, 2, 3, 1)
        return out[:, 0]
