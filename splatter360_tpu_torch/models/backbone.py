"""CNN backbone + multi-view wrapper (the UniMatch feature stack), NHWC.

Counterpart of splatter360_tpu/models/backbone.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ResidualBlock, instance_norm
from .transformer import MultiViewFeatureTransformer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalise [..., H, W, 3] images in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


class CNNEncoder(nn.Module):
    """7x7 stride-2 stem + 3 residual stages -> [B, H/d, W/d, output_dim]."""

    def __init__(self, output_dim: int = 128, downscale_factor: int = 8):
        super().__init__()
        dims = (64, 96, 128)
        if downscale_factor in (4, 8):
            stride1, stride3 = 1, (2 if downscale_factor == 8 else 1)
        elif downscale_factor == 16:
            stride1, stride3 = 2, 2
        else:
            raise NotImplementedError(downscale_factor)
        self.Conv_0 = Conv(3, dims[0], 7, stride=2, bias=False)
        blocks = [(dims[0], dims[0], stride1), (dims[0], dims[0], 1),
                  (dims[0], dims[1], 2), (dims[1], dims[1], 1),
                  (dims[1], dims[2], stride3), (dims[2], dims[2], 1)]
        for i, (cin, cout, s) in enumerate(blocks):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(cin, cout, s))
        self.Conv_1 = Conv(dims[2], output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(self.Conv_0(x)))
        for i in range(6):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        return self.Conv_1(x)


def sine_position_embedding(h: int, w: int, channels: int, device=None) -> torch.Tensor:
    """2D sine/cosine positional embedding [h, w, channels]."""
    num_feats = channels // 2
    temperature = 10000.0
    scale = 2 * math.pi
    eps = 1e-6
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0)[:, None]
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0)[None, :]
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])],
                        dim=-1).reshape(1, w, num_feats)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])],
                        dim=-1).reshape(h, 1, num_feats)
    return torch.cat([pos_y.expand(h, w, num_feats), pos_x.expand(h, w, num_feats)], dim=-1)


class BackboneMultiview(nn.Module):
    """CNN + windowed sine position embedding + multi-view transformer."""

    def __init__(self, feature_channels: int = 128, num_transformer_layers: int = 6,
                 ffn_dim_expansion: int = 4, downscale_factor: int = 8,
                 no_cross_attn: bool = False):
        super().__init__()
        self.feature_channels = feature_channels
        self.CNNEncoder_0 = CNNEncoder(feature_channels, downscale_factor)
        self.MultiViewFeatureTransformer_0 = MultiViewFeatureTransformer(
            num_transformer_layers, feature_channels, ffn_dim_expansion, no_cross_attn)

    def forward(self, images: torch.Tensor, attn_splits: int = 2):
        """images [B, V, H, W, 3] in [0, 1] -> (transformer features,
        CNN features), each [B, V, h, w, C]."""
        b, v, h, w, _ = images.shape
        feats = self.CNNEncoder_0(normalize_images(images).reshape(b * v, h, w, 3))
        fh, fw = feats.shape[1], feats.shape[2]
        c = self.feature_channels
        cnn_features = feats.reshape(b, v, fh, fw, c)
        if attn_splits > 1:
            pos = sine_position_embedding(fh // attn_splits, fw // attn_splits, c, images.device)
            pos = pos.repeat(attn_splits, attn_splits, 1)
        else:
            pos = sine_position_embedding(fh, fw, c, images.device)
        trans = self.MultiViewFeatureTransformer_0(cnn_features + pos.to(cnn_features.dtype),
                                                   attn_splits=attn_splits)
        return trans, cnn_features
