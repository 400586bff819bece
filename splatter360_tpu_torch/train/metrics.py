"""Evaluation metrics.

Counterpart of splatter360_tpu/train/metrics.py: PSNR with clipping and the
1e-10 MSE floor, SSIM as skimage's structural_similarity(win_size=11,
gaussian_weights=True, sigma=1.5, data_range) computes it ('valid' separable
Gaussian window, sample covariance 121/120), and the masked depth metrics.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_psnr(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """gt, pred [B, H, W, C] in [0, 1] -> [B]."""
    gt = torch.clamp(gt, 0.0, 1.0)
    pred = torch.clamp(pred, 0.0, 1.0)
    mse = torch.mean((gt - pred) ** 2, dim=(-3, -2, -1))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _gaussian_kernel(win: int = 11, sigma: float = 1.5) -> torch.Tensor:
    r = np.arange(win) - win // 2
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def _filter2d_sep(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """'valid' separable filter over the last two axes of [..., H, W]."""
    win = k.shape[0]
    xh = torch.stack([x[..., :, i:x.shape[-1] - win + 1 + i] for i in range(win)])
    x = torch.einsum("k...,k->...", xh, k)
    xv = torch.stack([x[..., i:x.shape[-2] - win + 1 + i, :] for i in range(win)])
    return torch.einsum("k...,k->...", xv, k)


def compute_ssim(gt: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
                 sample_covariance: bool = True) -> torch.Tensor:
    """gt, pred [B, H, W, C] -> [B]."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _gaussian_kernel().to(gt.device)
    win = k.shape[0]
    cov_norm = win**2 / (win**2 - 1.0) if sample_covariance else 1.0
    x = torch.movedim(gt, -1, 1)  # [B, C, H, W]
    y = torch.movedim(pred, -1, 1)
    mu_x = _filter2d_sep(x, k)
    mu_y = _filter2d_sep(y, k)
    mu_xx = _filter2d_sep(x * x, k)
    mu_yy = _filter2d_sep(y * y, k)
    mu_xy = _filter2d_sep(x * y, k)
    vx = cov_norm * (mu_xx - mu_x * mu_x)
    vy = cov_norm * (mu_yy - mu_y * mu_y)
    cxy = cov_norm * (mu_xy - mu_x * mu_y)
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cxy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (vx + vy + c2))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def compute_depth_metrics(gt: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> dict:
    """SimpleRecon's metric set with masked means; gt, pred [..., H, W],
    mask [..., H, W] bool (valid ground truth)."""
    m = mask.to(gt.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)

    def mmean(x):
        return torch.sum(x * m) / n

    one = torch.ones_like(gt)
    gt_s = torch.where(mask, gt, one)
    pred_s = torch.where(mask, pred, one)
    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    abs_diff = torch.abs(gt_s - pred_s)
    log_diff = (torch.log(torch.clamp(pred_s, min=1e-8))
                - torch.log(torch.clamp(gt_s, min=1e-8)))

    def share(limit):
        return mmean((thresh < limit).to(gt.dtype))

    return {
        "abs_diff": mmean(abs_diff),
        "abs_rel": mmean(abs_diff / gt_s),
        "sq_rel": mmean((gt_s - pred_s) ** 2 / gt_s),
        "rmse": torch.sqrt(mmean((gt_s - pred_s) ** 2)),
        "rmse_log": torch.sqrt(mmean(log_diff**2)),
        "a5": share(1.05) * 100.0,
        "a10": share(1.10) * 100.0,
        "a25": share(1.25) * 100.0,
        "a1": share(1.25),
        "a2": share(1.25**2),
        "a3": share(1.25**3),
    }
