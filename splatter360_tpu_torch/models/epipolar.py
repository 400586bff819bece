"""Spherical epipolar cross-attention (the `use_epipolar_trans` ablation).

Counterpart of splatter360_tpu/models/epipolar.py. The epipolar curve of an
ERP pixel in another view is sampled by the spherical sweep at D candidate
radii (costvolume.spherical_sweep_warp); each pixel's feature attends, with
one head, over the (V-1)*D samples of the other views, their keys carrying
a learned depth positional encoding `depth_pe` [D, d_model]; then a
residual and a LayerNorm. Softmax and products run in the features' dtype,
as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.transforms import inverse_se3
from .costvolume import depth_candidates, spherical_sweep_warp
from .layers import Dense, LayerNorm, const, softmax


class EpipolarCrossAttention(nn.Module):
    def __init__(self, channels: int, d_model: int = 128, num_samples: int = 32,
                 depth_sampling_type: str = "log_depth"):
        super().__init__()
        self.d_model, self.num_samples = d_model, num_samples
        self.depth_sampling_type = depth_sampling_type
        self.q = Dense(channels, d_model)
        self.k = Dense(channels, d_model)
        self.v = Dense(channels, d_model)
        self.out = Dense(d_model, channels)
        self.depth_pe = nn.Parameter(torch.zeros(num_samples, d_model))
        self.norm = LayerNorm(channels)

    def forward(self, features, extrinsics, near, far):
        """features [B, V, h, w, C], c2w [B, V, 4, 4], near/far [B, V] ->
        [B, V, h, w, C]."""
        b, v = features.shape[:2]
        cand = depth_candidates(near, far, self.num_samples, self.depth_sampling_type)
        w2c = inverse_se3(extrinsics)
        pe = self.depth_pe.repeat(v - 1, 1)
        scale = self.d_model ** 0.5
        outs = []
        for bi in range(b):
            per_ref = []
            for ref in range(v):
                kv = torch.cat([
                    spherical_sweep_warp(features[bi, other], w2c[bi, other] @ extrinsics[bi, ref],
                                         cand[bi, ref])
                    for other in range(v) if other != ref]).permute(1, 2, 0, 3)  # [h, w, S, C]
                q = self.q(features[bi, ref])
                k = self.k(kv) + pe
                attn = softmax((k @ q[..., None])[..., 0] / const(scale, q), dim=-1)  # [h, w, S]
                agg = (attn[..., None, :] @ self.v(kv))[..., 0, :]
                per_ref.append(features[bi, ref] + self.out(agg))
            outs.append(torch.stack(per_ref))
        return self.norm(torch.stack(outs))
