"""DINOv2-style ViT: the frozen monocular feature branch (add_mono_feat).

Counterpart of splatter360_tpu/models/dino.py (`VIT_DIMS`, `ViTBlock`,
`DinoViT`): a patch-14 ViT whose last-layer patch tokens (no CLS token)
become a feature map. Submodules carry Flax's names (patch_embed,
block{i}/LayerNorm_0, MultiHeadDotProductAttention_0/{query,key,value,out},
ls1, LayerNorm_1, Dense_0, Dense_1, ls2, norm), so convert.py maps a JAX
parameter tree by path, and utils/torch_convert.py a DINOv2 state dict.

The token grid is a parameter's shape (pos_embed [1, gh*gw, dim]): Flax
learns it from the sample input of `init`, the port takes it when the model
is built (`grid`, token_grid(face) for cube faces of `face` pixels), and an
input of another grid is refused. In a dtype other than float32 every op
rounds where Flax's does under XLA: the norms are Flax's float32 islands
(E[x^2] - E[x]^2 with sum * (1/n) means), a dense layer's bias is added
after the product is rounded, the query is scaled by 1/sqrt(head_dim)
before its product with the keys, and the softmax is jax.nn.softmax's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv, Dense, gelu, softmax

# vit_type -> (width, heads, blocks); an unknown type is a KeyError, as in JAX
VIT_DIMS = {"vits": (384, 6, 12), "vitb": (768, 12, 12), "vitl": (1024, 16, 24)}
PATCH = 14


def token_grid(face: int) -> int:
    """Tokens along a side of a cube face of `face` pixels: the encoder
    resizes the face down to a multiple of PATCH first."""
    return face // PATCH


class LayerNorm(nn.Module):
    """Flax nn.LayerNorm (eps 1e-6) with its own formula: in float32,
    var = max(E[x^2] - E[x]^2, 0), the means taken as sum * (1/n) as XLA
    computes jnp.mean, then (x - mean) * (rsqrt(var + eps) * scale) + bias,
    rounded to x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        inv_n = 1.0 / x.shape[-1]
        mean = xf.sum(-1, keepdim=True) * inv_n
        var = torch.clamp((xf * xf).sum(-1, keepdim=True) * inv_n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention(num_heads=heads) as
    self-attention: per head softmax(q k^T) v with q scaled by
    1/sqrt(head_dim). Its DenseGeneral projections are [out, in] weights:
    query, key and value map dim -> heads * head_dim (Flax: kernel [dim,
    heads, head_dim], bias [heads, head_dim]), out maps heads * head_dim ->
    dim (Flax: kernel [heads, head_dim, dim])."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (Dense(dim, dim) for _ in range(4))

    def forward(self, x):
        b, t, dim = x.shape
        hd = dim // self.heads

        def split(y):  # [B, T, dim] -> [B, heads, T, head_dim]
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        # Flax divides by sqrt(head_dim), a float32 value rounded to the dtype
        root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype)
        q = split(self.query(x)) / root
        k, v = split(self.key(x)), split(self.value(x))
        w = softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(b, t, dim))


class ViTBlock(nn.Module):
    """Pre-LN attention and MLP (dim -> 4 dim -> dim, exact gelu), each
    residual scaled by its layer scale (ls1, ls2)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x)) * self.ls1
        y = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + y * self.ls2


class DinoViT(nn.Module):
    """Patch-14 ViT of `vit_type` over a `grid` x `grid` token grid:
    images [B, 14 g, 14 g, 3] (ImageNet-normalised) -> tokens [B, g, g, dim]."""

    def __init__(self, vit_type: str = "vits", grid: int = 18):
        super().__init__()
        dim, heads, depth = VIT_DIMS[vit_type]
        self.grid, self.depth = grid, depth
        self.patch_embed = Conv(3, dim, PATCH, PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads))
        self.norm = LayerNorm(dim)

    def forward(self, images):
        b, h, w, _ = images.shape
        gh, gw = h // PATCH, w // PATCH
        if (gh, gw) != (self.grid, self.grid):
            raise ValueError(f"DinoViT: a {h}x{w} input makes a {gh}x{gw} token grid; the model "
                             f"was built for {self.grid}x{self.grid} (token_grid of the cube "
                             f"face it was built with)")
        x = self.patch_embed(images).reshape(b, gh * gw, -1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x).reshape(b, gh, gw, -1)
