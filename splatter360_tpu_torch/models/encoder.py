"""EncoderCostVolume360: posed ERP panoramas -> pixel-aligned 3D Gaussians.

Counterpart of splatter360_tpu/models/encoder.py, stages (2)-(6): (2) the
cube branch backbone -> cube_to_erp; (3) the ERP branch backbone; (4) the
branches' fusion (fusion_type cee, concat or biproj), then optionally the
spherical epipolar cross-attention (use_epipolar_trans); (5) the depth
predictor; (6) the Gaussian adapter, gaussians_per_pixel Gaussians a pixel.
The wo_* flags are the reference's Table 3 ablations; without a branch
(wo_cube_encoder, wo_erp_encoder) its backbone is not built and zeros take
its features' place. `apply_encoder` runs it under the config's precision
policy: float32, or with `bf16_compute` the JAX package's bf16 policy. The
mono branch (add_mono_feat) raises NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import torch
from torch import nn

from ..geometry.cubemap import cube_to_erp
from .adapter import GaussianAdapterConfig, adapt_gaussians, map_pdf_to_opacity
from .backbone import BackboneMultiview
from .costvolume import DepthPredictor360
from .epipolar import EpipolarCrossAttention
from .layers import FUSION_LAYERS
from .types import Gaussians


@dataclass(frozen=True)
class OpacityMappingConfig:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    d_feature: int = 128
    num_depth_candidates: int = 128
    num_surfaces: int = 1
    gaussians_per_pixel: int = 1
    downscale_factor: int = 8
    multiview_trans_attn_split: int = 2
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1)
    costvolume_unet_attn_res: Sequence[int] = (4,)
    depth_unet_feat_dim: int = 32
    depth_unet_attn_res: Sequence[int] = (16,)
    depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1)
    gaussian_adapter: GaussianAdapterConfig = field(default_factory=GaussianAdapterConfig)
    opacity_mapping: OpacityMappingConfig = field(default_factory=OpacityMappingConfig)
    depth_sampling_type: str = "log_depth"
    use_cross_view_self_attn: bool = True
    fusion_type: str = "cee"
    # bf16 network compute over float32 master parameters (apply_encoder)
    bf16_compute: bool = False
    wo_depth_refine: bool = False
    wo_cost_volume: bool = False
    wo_backbone_cross_attn: bool = False
    wo_cost_volume_refine: bool = False
    wo_cube_encoder: bool = False
    wo_erp_encoder: bool = False
    add_mono_feat: bool = False
    vit_type: str = "vits"
    use_epipolar_trans: bool = False
    epipolar_num_samples: int = 32


# configs/hm3d.yaml `model:` block, bf16 compute included
HM3D = EncoderConfig(
    bf16_compute=True,
    d_feature=128,
    num_depth_candidates=128,
    downscale_factor=8,
    costvolume_unet_feat_dim=128,
    costvolume_unet_channel_mult=(1, 1, 1),
    costvolume_unet_attn_res=(4,),
    depth_unet_feat_dim=32,
    depth_unet_attn_res=(16,),
    depth_unet_channel_mult=(1, 1, 1, 1, 1),
    depth_sampling_type="log_depth",
    gaussian_adapter=GaussianAdapterConfig(gaussian_scale_min=0.5, gaussian_scale_max=15.0,
                                           sh_degree=4),
    add_mono_feat=False,
    vit_type="vits",
)
# the flagship model in float32, the precision of the port's numbers before
# the bf16 policy was ported
HM3D_F32 = replace(HM3D, bf16_compute=False)

def check_ported(cfg: EncoderConfig) -> None:
    """Raise NotImplementedError for add_mono_feat (not ported yet) and for
    num_surfaces > 1 (the JAX encoder raises too: the depth predictor emits
    one surface)."""
    if cfg.add_mono_feat:
        raise NotImplementedError(
            "model.add_mono_feat=True is not ported (ROADMAP.md Queue 1 item 6)")
    if cfg.num_surfaces != 1:
        raise NotImplementedError(
            "model.num_surfaces > 1: the depth predictor emits one surface (the JAX encoder "
            "raises too)")


class EncoderCostVolume360(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        c, ds = cfg.d_feature, cfg.downscale_factor
        if not cfg.wo_cube_encoder:
            self.backbone_cube = BackboneMultiview(feature_channels=c, downscale_factor=ds,
                                                   no_cross_attn=cfg.wo_backbone_cross_attn)
        if not cfg.wo_erp_encoder:
            self.backbone_erp = BackboneMultiview(feature_channels=c, downscale_factor=ds,
                                                  no_cross_attn=cfg.wo_backbone_cross_attn)
        fusion = FUSION_LAYERS[cfg.fusion_type]
        self.fuse1 = fusion(c)
        self.fuse2 = fusion(c)
        if cfg.use_epipolar_trans:
            self.epipolar_trans = EpipolarCrossAttention(
                c, c, cfg.epipolar_num_samples, cfg.depth_sampling_type)
        ad = cfg.gaussian_adapter
        self.depth_predictor = DepthPredictor360(
            feature_channels=c, upscale_factor=ds,
            num_depth_candidates=cfg.num_depth_candidates,
            costvolume_unet_feat_dim=cfg.costvolume_unet_feat_dim,
            costvolume_unet_channel_mult=tuple(cfg.costvolume_unet_channel_mult),
            costvolume_unet_attn_res=tuple(cfg.costvolume_unet_attn_res),
            gaussian_raw_channels=cfg.num_surfaces * (ad.d_in + 2),
            gaussians_per_pixel=cfg.gaussians_per_pixel,
            depth_unet_feat_dim=cfg.depth_unet_feat_dim,
            depth_unet_attn_res=tuple(cfg.depth_unet_attn_res),
            depth_unet_channel_mult=tuple(cfg.depth_unet_channel_mult),
            depth_sampling_type=cfg.depth_sampling_type,
            wo_depth_refine=cfg.wo_depth_refine, wo_cost_volume=cfg.wo_cost_volume,
            wo_cost_volume_refine=cfg.wo_cost_volume_refine,
            use_cross_view_self_attn=cfg.use_cross_view_self_attn,
        )

    def forward(self, image_sphere, image_cubes, extrinsics_sphere, near, far,
                global_step: int = 0) -> tuple[Gaussians, torch.Tensor]:
        """image_sphere [B, V, H, W, 3], image_cubes [B, V, 6, Hc, Wc, 3]
        (F R B L U D), extrinsics [B, V, 4, 4] c2w, near/far [B, V] ->
        (Gaussians with N = V*H*W*gaussians_per_pixel, predicted ERP depth
        [B, V, H, W])."""
        cfg = self.cfg
        b, v, h, w, _ = image_sphere.shape
        cubes = image_cubes.shape[2]
        ds, c = cfg.downscale_factor, cfg.d_feature
        fh, fw = h // ds, w // ds
        splits = cfg.multiview_trans_attn_split

        if cfg.wo_cube_encoder:
            trans_features = cnn_features = image_sphere.new_zeros((b * v, fh, fw, c))
        else:
            cube_imgs = image_cubes.reshape(b, v * cubes, *image_cubes.shape[3:])
            trans_c, cnn_c = self.backbone_cube(cube_imgs, attn_splits=splits)
            fhc = trans_c.shape[2]

            def c2e_all(x):
                x = x.reshape(b * v, cubes, fhc, fhc, c)
                return torch.stack([cube_to_erp(x[i], fh, fw) for i in range(b * v)])

            trans_features, cnn_features = c2e_all(trans_c), c2e_all(cnn_c)
        if cfg.wo_erp_encoder:
            trans_erp = cnn_erp = image_sphere.new_zeros((b * v, fh, fw, c))
        else:
            trans_e, cnn_e = self.backbone_erp(image_sphere, attn_splits=splits)
            trans_erp, cnn_erp = (x.reshape(b * v, fh, fw, c) for x in (trans_e, cnn_e))
        trans_fused = self.fuse1(trans_erp, trans_features).reshape(b, v, fh, fw, c)
        cnn_fused = self.fuse2(cnn_erp, cnn_features).reshape(b, v, fh, fw, c)
        if cfg.use_epipolar_trans:
            trans_fused = self.epipolar_trans(trans_fused, extrinsics_sphere, near, far)

        depths, densities, raw_gaussians = self.depth_predictor(
            trans_fused, cnn_fused, image_sphere, extrinsics_sphere, near, far)
        om = cfg.opacity_mapping
        gpp = cfg.gaussians_per_pixel
        opacities = map_pdf_to_opacity(densities, global_step, om.initial, om.final,
                                       om.warm_up) / gpp
        depth_map = depths[..., 0].reshape(b, v, h, w)
        raw = raw_gaussians[..., 2:]
        if gpp > 1:
            # a pixel's gpp Gaussians share raw scale, rotation and SH and
            # differ in depth and opacity; flattened with gpp fastest
            n_pix = depths.shape[2]
            depths = depths.reshape(b, v, n_pix * gpp, 1)
            opacities = opacities.reshape(b, v, n_pix * gpp, 1)
            raw = raw.repeat_interleave(gpp, dim=2)
        gaussians = adapt_gaussians(cfg.gaussian_adapter, extrinsics_sphere, depths,
                                    opacities, raw, (h, w))
        return gaussians, depth_map


def apply_encoder(model: EncoderCostVolume360, image_sphere, image_cubes, extrinsics_sphere,
                  near, far, global_step: int = 0) -> tuple[Gaussians, torch.Tensor]:
    """model(...) under its config's precision policy.

    With `bf16_compute`, the JAX package's policy (_mixed_precision_apply,
    splatter360_tpu/train/state.py:108-130), not torch.autocast: every
    float32 parameter and both image inputs are cast to bf16 for this apply
    (torch.func.functional_call), poses and near/far stay float32, and the
    layers keep the JAX package's float32 islands. The casts' backward
    returns float32 gradients to the float32 master parameters. The
    Gaussians and the depth map leave in float32."""
    args = (extrinsics_sphere, near, far, global_step)
    if not model.cfg.bf16_compute:
        return model(image_sphere, image_cubes, *args)
    bf16 = torch.bfloat16
    params = {name: p.to(bf16) if p.dtype == torch.float32 else p
              for name, p in model.named_parameters()}
    return torch.func.functional_call(
        model, params, (image_sphere.to(bf16), image_cubes.to(bf16), *args))
