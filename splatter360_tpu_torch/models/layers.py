"""Common building blocks, channels-last (NHWC) like the JAX package.

Counterpart of splatter360_tpu/models/layers.py plus the Flax primitives it
relies on. Submodules carry Flax's names (Conv_0, GroupNorm_1, ...) so that
convert.py maps parameters by path. Where Flax and PyTorch defaults differ,
the Flax behaviour is kept:
  * "SAME" padding on a strided conv is asymmetric ((0, 1) for 3x3 and
    (2, 3) for 7x7 on even sizes), so strided convs pad explicitly;
  * GroupNorm and LayerNorm use eps 1e-6 (PyTorch's default is 1e-5);
  * conv kernels are stored OIHW (Flax: HWIO) and run NCHW-strided views of
    the NHWC tensors, so no layout copy is made around them.
Under the bf16 compute policy (encoder.apply_encoder) the norms keep Flax's
float32 islands: GroupNorm and LayerNorm normalise and apply their
(bf16-rounded) scale and bias in float32 and round the result to the
input's dtype, as flax.linen.normalization._compute_stats/_normalize do;
the instance norm and the SE squeeze take their statistics in float32 and
round them to the input's dtype, as jnp.mean and jnp.var do. In a dtype
other than float32 the layers also round where the JAX package's ops round:
a conv's or a dense layer's bias is added after the product is rounded
(Flax adds it as an op of its own; PyTorch fuses it), gelu, silu and
sigmoid are the chains of ops that JAX and XLA expand them into, the
bilinear resize is jax.image.resize's two contractions, and Python
constants are rounded to the dtype as JAX's weak-typed constants are. On
float32 inputs every cast is a no-op and each layer computes as it did
before the bf16 policy was ported.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@functools.lru_cache(maxsize=64)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def const(value: float, like: torch.Tensor) -> float:
    """A Python constant rounded to `like`'s dtype (a JAX weak-typed constant)."""
    return _rounded(value, like.dtype)


class Conv(nn.Module):
    """Flax nn.Conv counterpart: [..., H, W, Cin] -> [..., H', W', Cout]."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        lead = x.shape[:-3]
        xc = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        fused = self.bias if x.dtype == torch.float32 else None
        if self.stride == 1 and self.k % 2 == 1:
            y = F.conv2d(xc, self.weight, fused, 1, self.k // 2)
        else:
            ph = same_padding(xc.shape[2], self.k, self.stride)
            pw = same_padding(xc.shape[3], self.k, self.stride)
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            y = F.conv2d(xc, self.weight, fused, self.stride, 0)
        y = y.permute(0, 2, 3, 1)
        if fused is None and self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, *y.shape[1:])


class Dense(nn.Linear):
    """Flax nn.Dense counterpart (the bias added as Flax adds it)."""

    def forward(self, x):
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


class GroupNorm(nn.Module):
    """Flax nn.GroupNorm over [..., H, W, C] (eps 1e-6)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.g, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        c = x.shape[-1]
        xg = x.float().reshape(x.shape[0], -1, self.g, c // self.g)
        if x.dtype == torch.float32:
            var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
            y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
            return y * self.weight + self.bias
        # Flax's float32 statistics (E[x^2] - E[x]^2, clipped at 0) and
        # normalisation, rounded to x's dtype at the end
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        scale, bias = (p.float().reshape(self.g, -1) for p in (self.weight, self.bias))
        y = (xg - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        return y.reshape(x.shape).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """Flax nn.LayerNorm counterpart (eps 1e-6), computed in float32."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def layer_norm(channels: int) -> LayerNorm:
    return LayerNorm(channels)


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel spatial normalisation of [B, H, W, C], no affine."""
    var, mean = torch.var_mean(x.float(), dim=(-3, -2), keepdim=True, unbiased=False)
    return (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + const(eps, x))


def gelu(x):
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return (0.5 * x) * torch.erfc(-x * const(math.sqrt(0.5), x))


def sigmoid(x):
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))  # XLA's expansion of lax.logistic


def silu(x):
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


class ResidualBlock(nn.Module):
    """UniMatch residual block: two 3x3 convs + instance norm."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_planes, planes, 3, stride, bias=False)
        self.Conv_1 = Conv(planes, planes, 3, 1, bias=False)
        self.Conv_2 = (Conv(in_planes, planes, 1, stride)
                       if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        y = F.relu(instance_norm(self.Conv_0(x)))
        y = F.relu(instance_norm(self.Conv_1(y)))
        if self.Conv_2 is not None:
            x = instance_norm(self.Conv_2(x))
        return F.relu(x + y)


class SELayer(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(c, max(c // reduction, 1), bias=False)
        self.Dense_1 = nn.Linear(max(c // reduction, 1), c, bias=False)

    def forward(self, x):
        y = x.float().mean(dim=(-3, -2)).to(x.dtype)
        y = sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[..., None, None, :]


class CEELayer(nn.Module):
    """UniFuse CEE fusion of (ERP-branch, cube-branch) features."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.Conv_0 = Conv(2 * c, c, 1, bias=False)
        self.GroupNorm_0 = GroupNorm(8, c)
        self.Conv_1 = Conv(c, c, 3, bias=False)
        self.GroupNorm_1 = GroupNorm(8, c)
        self.SELayer_0 = SELayer(2 * c)
        self.Conv_2 = Conv(2 * c, c, 1, bias=False)

    def forward(self, equi_feat, c2e_feat):
        x = torch.cat([equi_feat, c2e_feat], dim=-1)
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        shortcut = self.GroupNorm_1(self.Conv_1(x))
        x = torch.cat([equi_feat, c2e_feat + shortcut], dim=-1)
        return F.relu(self.Conv_2(self.SELayer_0(x)))


class ConcatFusion(nn.Module):
    """`concat` fusion: a 1x1 conv (no bias) and relu over both branches."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Conv(2 * channels, channels, 1, bias=False)

    def forward(self, equi_feat, c2e_feat):
        return F.relu(self.Conv_0(torch.cat([equi_feat, c2e_feat], dim=-1)))


class BiProjFusion(nn.Module):
    """BiFuse's `biproj` gated residual: each branch a 3x3 conv and relu, a
    sigmoid mask from both gates the cube branch, added to the ERP branch."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv_e2c = Conv(c, c, 3)
        self.conv_c2e = Conv(c, c, 3)
        self.conv_mask = Conv(2 * c, 1, 1)

    def forward(self, equi_feat, c2e_feat):
        e = F.relu(self.conv_e2c(equi_feat))
        c = F.relu(self.conv_c2e(c2e_feat))
        return equi_feat + c * sigmoid(self.conv_mask(torch.cat([e, c], dim=-1)))


# fusion_type -> the fusion block (an unknown type is a KeyError, as in JAX)
FUSION_LAYERS = {"cee": CEELayer, "concat": ConcatFusion, "biproj": BiProjFusion}


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.softmax in x's dtype: outside float32 each op rounds to it,
    the sum is taken in float32 (jnp.sum's upcast) and rounded."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    u = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return u / u.float().sum(dim=dim, keepdim=True).to(x.dtype)


def bilinear_resize(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] with half-pixel centres.

    Only upsampling is ported: jax.image.resize antialiases when it
    downsamples, which F.interpolate(antialias=False) does not."""
    if new_h < x.shape[1] or new_w < x.shape[2]:
        raise NotImplementedError("bilinear_resize: downsampling (antialiased in JAX) is not ported")
    if x.dtype == torch.float32:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1)
    # the width, then the height, each rounded to x's dtype (a bilinear pass
    # at an axis's own size takes weights 1 and 0 there: an exact copy)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(x.shape[1], new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    y = F.interpolate(y, size=(new_h, new_w), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)
