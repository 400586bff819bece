"""Training losses.

Counterpart of splatter360_tpu/train/losses.py: MSE, the 5x5 max-pool
dilation and erosion of the depth hole mask (reflect padding), and the
sin(phi)-weighted ERP depth L1 with holes set to far.
`depth_smoothness_weight` is accepted and, as in the JAX package, changes
nothing: its `compute_losses` never calls the smoothness loss, so that loss
is not ported (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class LossConfig:
    mse_weight: float = 1.0
    lpips_weight: float = 0.05
    lpips_apply_after_step: int = 0
    # a torch LPIPS(net='vgg') / torchvision vgg16 checkpoint (lpips.
    # load_lpips_torch_weights); None: seeded random VGG features
    lpips_weights: str | None = None
    depth_weight: float = 0.1
    depth_smoothness_weight: float = 0.0


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def sin_weighted_mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """ERP supervision MSE, each image row weighted by sin(phi) of its centre
    (the ERP branch of the JAX compute_losses). pred, gt [B, V, H, W, 3]."""
    b, v, h, w = pred.shape[:4]
    rows = torch.arange(h, dtype=pred.dtype, device=pred.device)
    rows = torch.sin((rows + 0.5) * math.pi / h)[None, None, :, None, None]
    return torch.sum(((pred - gt) ** 2) * rows) / (torch.sum(rows) * b * v * w * 3)


def max_pool_dilate(mask: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Binary dilation by a ksize x ksize max filter over reflect-padded
    (edge excluded, as numpy's "reflect") borders. mask [..., H, W]."""
    pad = (ksize - 1) // 2
    h, w = mask.shape[-2:]
    x = mask.reshape(-1, 1, h, w)
    rows = F.pad(x, (0, 0, pad, pad), mode="reflect")
    x = torch.stack([rows[..., i:i + h, :] for i in range(ksize)]).amax(dim=0)
    cols = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    x = torch.stack([cols[..., i:i + w] for i in range(ksize)]).amax(dim=0)
    return x.reshape(mask.shape)


def erode(mask: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    return 1.0 - max_pool_dilate(1.0 - mask, ksize)


def depth_l1_terms(
    pred_depth: torch.Tensor,  # [B, V, H, W] encoder-predicted ERP depth
    gt_depth: torch.Tensor,    # [B, V, H, W] ground-truth ERP depth (0 = hole)
    far: torch.Tensor,         # [B, V]
    hole_threshold: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """sin_weighted_depth_l1's numerator and denominator: the weighted L1
    sum and the weight sum over the whole batch."""
    h = pred_depth.shape[-2]
    mask = erode((gt_depth > hole_threshold).to(pred_depth.dtype), 5)
    gt = torch.where(mask > 0.5, gt_depth, far[..., None, None])
    rows = torch.arange(h, dtype=pred_depth.dtype, device=pred_depth.device)
    sin_phi = torch.sin((rows + 0.5) * math.pi / h)[None, None, :, None]
    weight = sin_phi * mask
    return torch.sum(torch.abs(gt - pred_depth) * weight), torch.sum(weight)


def sin_weighted_depth_l1(
    pred_depth: torch.Tensor,
    gt_depth: torch.Tensor,
    far: torch.Tensor,
    hole_threshold: float = 0.1,
) -> torch.Tensor:
    """sin(phi)-weighted L1 over the hole mask (> 0.1 m) eroded 5x5, with
    holes set to far (depth_l1_terms' arguments)."""
    num, den = depth_l1_terms(pred_depth, gt_depth, far, hole_threshold)
    return num / torch.clamp(den, min=1e-10)
