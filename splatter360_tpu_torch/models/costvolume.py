"""Spherical-sweep cost volume + depth predictor, NHWC.

Counterpart of splatter360_tpu/models/costvolume.py: log/inverse/linear
depth ladders, a seam-wrapped spherical sweep, dot-product correlation
averaged over the other views, cost-volume U-Net, softmax depth expectation,
x8 upsampling, full-resolution refine U-Net and the Gaussian heads. The
sweep geometry and the depth/disparity math stay float32 under the bf16
compute policy, as in the JAX package: the correlation sums bf16 products in
float32 (XLA's preferred_element_type) and rounds after the view average,
the depth softmax runs in float32, and the raw Gaussian channels leave in
float32 for the adapter.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..geometry.erp import cartesian_to_spherical, erp_ray_directions, spherical_to_erp
from ..geometry.transforms import inverse_se3
from ..ops.resample import bilinear_sample
from .layers import Conv, GroupNorm, bilinear_resize, gelu
from .unet import UNet2D


def depth_candidates(near: torch.Tensor, far: torch.Tensor, num: int,
                     sampling: str) -> torch.Tensor:
    """[...] near/far -> [..., D] candidate radii."""
    t = torch.linspace(0.0, 1.0, num, dtype=near.dtype, device=near.device)
    near = near[..., None]
    far = far[..., None]
    if sampling == "inverse_depth":
        return 1.0 / (1.0 / far + t * (1.0 / near - 1.0 / far))
    if sampling == "log_depth":
        return torch.exp(torch.log(near) + t * (torch.log(far) - torch.log(near)))
    if sampling == "linear_depth":
        return near + t * (far - near)
    raise ValueError(sampling)


def spherical_sweep_warp(features_other: torch.Tensor, rel_pose: torch.Tensor,
                         candidates: torch.Tensor) -> torch.Tensor:
    """Warp the other view's features [h, w, C] onto the reference view at
    each candidate radius; rel_pose maps reference-camera to other-camera
    coordinates. Returns [D, h, w, C]."""
    h, w = features_other.shape[0], features_other.shape[1]
    dirs = erp_ray_directions(h, w, features_other.device)
    pts = dirs[None] * candidates[:, None, None, None]
    pts = torch.einsum("ij,dhwj->dhwi", rel_pose[:3, :3], pts) + rel_pose[:3, 3]
    uv = spherical_to_erp(cartesian_to_spherical(pts), h, w)
    return bilinear_sample(features_other, uv, wrap_x=True)


def build_cost_volume(features: torch.Tensor, extrinsics: torch.Tensor,
                      candidates: torch.Tensor) -> torch.Tensor:
    """features [B, V, h, w, C], c2w [B, V, 4, 4], candidates [B, V, D] ->
    correlation [B, V, h, w, D] averaged over the other views."""
    b, v, h, w, c = features.shape
    w2c = inverse_se3(extrinsics)
    out = []
    for bi in range(b):
        per_ref = []
        for ref in range(v):
            corr_sum = features.new_zeros((h, w, candidates.shape[-1]), dtype=torch.float32)
            for other in range(v):
                if other == ref:
                    continue
                rel = w2c[bi, other] @ extrinsics[bi, ref]
                warped = spherical_sweep_warp(features[bi, other], rel, candidates[bi, ref])
                corr_sum = corr_sum + torch.einsum(
                    "hwc,dhwc->hwd", features[bi, ref].float(), warped.float()) / (c ** 0.5)
            per_ref.append((corr_sum / (v - 1)).to(features.dtype))
        out.append(torch.stack(per_ref))
    return torch.stack(out)


class DepthPredictor360(nn.Module):
    """The cost volume, its refinement, the depth expectation and the
    full-resolution heads, with the ablations wo_cost_volume (the features
    alone), wo_cost_volume_refine (one 3x3 conv, `corr_project`, for the
    U-Net), wo_depth_refine (one 3x3 conv, `refine_conv`, for the refine
    U-Net, and the coarse depth for every Gaussian of a pixel). Unnamed
    submodules are numbered per type in call order, as Flax numbers them, so
    an ablation shifts the numbers of the convs after it."""

    def __init__(self, feature_channels: int = 128, upscale_factor: int = 8,
                 num_depth_candidates: int = 128, costvolume_unet_feat_dim: int = 128,
                 costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1),
                 costvolume_unet_attn_res: Sequence[int] = (4,),
                 gaussian_raw_channels: int = 84, gaussians_per_pixel: int = 1,
                 depth_unet_feat_dim: int = 32, depth_unet_attn_res: Sequence[int] = (16,),
                 depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1),
                 depth_sampling_type: str = "log_depth", wo_depth_refine: bool = False,
                 wo_cost_volume: bool = False, wo_cost_volume_refine: bool = False,
                 use_cross_view_self_attn: bool = True):
        super().__init__()
        c, d = feature_channels, num_depth_candidates
        ch, du, raw = costvolume_unet_feat_dim, depth_unet_feat_dim, gaussian_raw_channels
        gpp = gaussians_per_pixel
        self.upscale_factor = upscale_factor
        self.num_depth_candidates = d
        self.depth_sampling_type = depth_sampling_type
        self.gaussians_per_pixel = gpp
        self.wo_depth_refine, self.wo_cost_volume = wo_depth_refine, wo_cost_volume
        self.wo_cost_volume_refine = wo_cost_volume_refine
        counts: dict[str, int] = {}

        def auto(kind: str, module: nn.Module) -> str:
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, module)
            return name

        cin = c if wo_cost_volume else d + c
        if wo_cost_volume_refine:
            self.corr_project = Conv(cin, ch, 3)
            corr_ch = ch
        else:
            self._corr_in = auto("Conv", Conv(cin, ch, 3))
            self._corr_norm = auto("GroupNorm", GroupNorm(8, ch))
            self.corr_refine_unet = UNet2D(
                ch, ch, ch, 1, tuple(costvolume_unet_attn_res),
                tuple(costvolume_unet_channel_mult), cross_view_attn=use_cross_view_self_attn)
            self._corr_out = auto("Conv", Conv(ch, d, 3))
            self.regressor_residual = Conv(cin, d, 1)
            corr_ch = d
        self._pdf_0 = auto("Conv", Conv(corr_ch, 2 * d, 3))
        self._pdf_1 = auto("Conv", Conv(2 * d, d, 3))
        self.upsampler_conv = Conv(2 * c, c, 3)
        self.proj_feature = Conv(c, du, 3)
        if wo_depth_refine:
            self.refine_conv = Conv(3 + du + 2, du, 3)
        else:
            self._refine_in = auto("Conv", Conv(3 + du + 2, du, 3))
            self._refine_norm = auto("GroupNorm", GroupNorm(4, du))
            self.refine_unet = UNet2D(
                du, du, du, 1, tuple(depth_unet_attn_res), tuple(depth_unet_channel_mult),
                cross_view_attn=use_cross_view_self_attn)
        self._gau_0 = auto("Conv", Conv(du + 3 + c, 2 * raw, 3))
        self._gau_1 = auto("Conv", Conv(2 * raw, raw, 3))
        if not wo_depth_refine:
            self._depth_0 = auto("Conv", Conv(du, 2 * du, 3))
            self._depth_1 = auto("Conv", Conv(2 * du, 2 * gpp, 3))

    def _m(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(self, features, cnn_features, images, extrinsics, near, far):
        """features/cnn_features [B, V, h, w, C], images [B, V, H, W, 3],
        extrinsics [B, V, 4, 4], near/far [B, V] -> (depths, densities
        [B, V, H*W, gpp], raw Gaussian channels [B, V, H*W, raw])."""
        b, v, h, w, c = features.shape
        hh, ww = images.shape[2], images.shape[3]
        d = self.num_depth_candidates
        cand = depth_candidates(near, far, d, self.depth_sampling_type)

        if self.wo_cost_volume:
            x = features.reshape(b * v, h, w, c)
        else:
            corr = build_cost_volume(features, extrinsics, cand)
            x = torch.cat([corr, features], dim=-1).reshape(b * v, h, w, d + c)
        if self.wo_cost_volume_refine:
            raw_corr = self.corr_project(x)
        else:
            y = gelu(self._m(self._corr_norm)(self._m(self._corr_in)(x)))
            y = self.corr_refine_unet(y, num_views=v)
            raw_corr = self._m(self._corr_out)(y) + self.regressor_residual(x)

        y = self._m(self._pdf_1)(gelu(self._m(self._pdf_0)(raw_corr)))
        pdf = torch.softmax(y.float(), dim=-1)
        coarse_depth = (pdf * cand.reshape(b * v, 1, 1, d)).sum(-1, keepdim=True)
        coarse_disp = 1.0 / coarse_depth
        pdf_max = pdf.max(dim=-1, keepdim=True).values
        fullres_disp = bilinear_resize(coarse_disp, hh, ww)
        uf = self.upscale_factor
        pdf_max_full = pdf_max.repeat_interleave(uf, dim=1).repeat_interleave(uf, dim=2)

        feats_cat = torch.cat([features, cnn_features], dim=-1).reshape(b * v, h, w, 2 * c)
        proj_in_fullres = gelu(bilinear_resize(self.upsampler_conv(feats_cat), hh, ww))
        proj_feature = self.proj_feature(proj_in_fullres)

        imgs = images.reshape(b * v, hh, ww, 3)
        dt = features.dtype
        refine_in = torch.cat([imgs, proj_feature, fullres_disp.to(dt), pdf_max_full.to(dt)],
                              dim=-1)
        if self.wo_depth_refine:
            refine_out = self.refine_conv(refine_in)
        else:
            y = gelu(self._m(self._refine_norm)(self._m(self._refine_in)(refine_in)))
            refine_out = self.refine_unet(y, num_views=v)

        gau_in = torch.cat([refine_out, imgs, proj_in_fullres], dim=-1)
        raw_gaussians = self._m(self._gau_1)(gelu(self._m(self._gau_0)(gau_in)))
        raw_gaussians = raw_gaussians.reshape(b, v, hh * ww, -1).float()

        gpp = self.gaussians_per_pixel
        if self.wo_depth_refine:
            # the one coarse surface for each of a pixel's gpp Gaussians
            densities = pdf_max_full.reshape(b, v, hh * ww, 1).expand(b, v, hh * ww, gpp)
            depths = (1.0 / fullres_disp).reshape(b, v, hh * ww, 1).expand(b, v, hh * ww, gpp)
            return depths, densities, raw_gaussians
        y = self._m(self._depth_1)(gelu(self._m(self._depth_0)(refine_out)))
        delta_disp, raw_density = y.chunk(2, dim=-1)
        densities = torch.sigmoid(raw_density.float()).reshape(b, v, hh * ww, gpp)
        lo = (1.0 / far).reshape(b * v, 1, 1, 1)
        hi = (1.0 / near).reshape(b * v, 1, 1, 1)
        fine_disp = torch.minimum(torch.maximum(fullres_disp + delta_disp.float(), lo), hi)
        depths = (1.0 / fine_disp).reshape(b, v, hh * ww, gpp)
        return depths, densities, raw_gaussians
