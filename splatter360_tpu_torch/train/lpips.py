"""LPIPS with a VGG16 backbone, the perceptual term of the training loss.

Counterpart of splatter360_tpu/train/lpips_jax.py: VGG16 conv features at
relu1_2/2_2/3_3/4_3/5_3 (3x3 convolutions with zero padding 1, 2x2 max
pools), inputs shifted and scaled by the LPIPS constants, channels
unit-normalised (+1e-10 inside the square root), |lin| channel weights, a
spatial mean, and the sum over the five layers. Parameter names follow the
flax module (`vgg.conv{stage}_{i}`, `lin{i}`) so convert.lpips_state_from_flax
maps them one to one. The network is frozen: it takes no optimizer state.

No LPIPS weights are in the repository, so `init_lpips` draws seeded random
VGG features (and lin = 1/C, flax's initial value); loading the released
weights is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = (
    (64, 64),            # -> relu1_2
    (128, 128),          # -> relu2_2
    (256, 256, 256),     # -> relu3_3
    (512, 512, 512),     # -> relu4_3
    (512, 512, 512),     # -> relu5_3
)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for si, stage in enumerate(_VGG_CFG):
            for ci, ch in enumerate(stage):
                self.add_module(f"conv{si}_{ci}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [B, 3, H, W] -> the five stages' features, NCHW."""
        feats = []
        for si, stage in enumerate(_VGG_CFG):
            for ci in range(len(stage)):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            feats.append(x)
            if si != len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, stage in enumerate(_VGG_CFG):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((stage[-1],), 1.0 / stage[-1])))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1 [B, H, W, 3] in [0, 1] -> [B] distances."""
        shift = torch.tensor(_SHIFT, dtype=img0.dtype, device=img0.device)
        scale = torch.tensor(_SCALE, dtype=img0.dtype, device=img0.device)

        def norm_input(x):
            return ((2.0 * x - 1.0 - shift) / scale).permute(0, 3, 1, 2)

        f0 = self.vgg(norm_input(img0))
        f1 = self.vgg(norm_input(img1))
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            w = torch.abs(getattr(self, f"lin{i}"))
            d = torch.sum((a - b) ** 2 * w[None, :, None, None], dim=1)
            total = total + torch.mean(d, dim=(-2, -1))
        return total


def init_lpips(model: LPIPS, seed: int) -> None:
    """Seeded random VGG weights N(0, 1/fan_in) and zero biases, drawn on the
    CPU in parameter-name order; the lin weights keep 1/C."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.vgg.named_parameters()):
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.zero_()
