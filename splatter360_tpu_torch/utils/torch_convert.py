"""Torch weight files of the reference's pretrained modules -> the port's
parameters.

Counterpart of splatter360_tpu/utils/torch_convert.py (`load_torch_state_dict`,
`convert_dinov2`). A DINOv2 state dict is already in PyTorch's layouts, so
its tensors map onto the port's module names one to one; only the CLS and
mask tokens are dropped and pos_embed is resampled to the model's token
grid. (JAX splits qkv into per-head DenseGeneral kernels; the port's
query/key/value weights are its [dim, dim] thirds, heads major, which is the
same layout flattened.)
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from ..models.layers import bilinear_resize


def load_torch_state_dict(path) -> dict[str, Any]:
    """A torch.save'd state dict, unwrapped from a "model", "state_dict" or
    "params" entry where the file nests it (tensors only: weights_only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "params"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return sd


def resample_pos_embed(pos_embed: torch.Tensor, grid: int) -> torch.Tensor:
    """DINOv2's pos_embed [1, 1 + g*g, dim] (the CLS token's first) -> the
    patch tokens' [1, grid*grid, dim], resampled as an image with
    jax.image.resize's bilinear filter in float32. A non-square checkpoint
    grid is a ValueError."""
    patch = pos_embed[0, 1:].float()
    g = round(math.sqrt(patch.shape[0]))
    if g * g != patch.shape[0]:
        raise ValueError(f"non-square pos_embed grid ({patch.shape[0]} patch tokens)")
    patch = patch.reshape(1, g, g, -1)
    if g != grid:
        patch = bilinear_resize(patch, grid, grid)
    return patch.reshape(1, grid * grid, -1)


def convert_dinov2(sd: Mapping[str, torch.Tensor], grid: int) -> dict[str, torch.Tensor]:
    """DINOv2 state dict (patch_embed.proj, pos_embed, blocks.{i}.{norm1,
    attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma},
    norm; cls_token and mask_token dropped) -> a state dict of the port's
    DinoViT over a `grid` x `grid` token grid."""
    out = {"patch_embed.weight": sd["patch_embed.proj.weight"],
           "patch_embed.bias": sd["patch_embed.proj.bias"],
           "pos_embed": resample_pos_embed(sd["pos_embed"], grid),
           "norm.weight": sd["norm.weight"], "norm.bias": sd["norm.bias"]}
    names = {"norm1": "LayerNorm_0", "norm2": "LayerNorm_1", "mlp.fc1": "Dense_0",
             "mlp.fc2": "Dense_1", "attn.proj": "MultiHeadDotProductAttention_0.out"}
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        src, dst = f"blocks.{i}.", f"block{i}."
        for theirs, ours in names.items():
            for leaf in ("weight", "bias"):
                out[dst + f"{ours}.{leaf}"] = sd[src + f"{theirs}.{leaf}"]
        for leaf in ("weight", "bias"):
            qkv = sd[src + f"attn.qkv.{leaf}"]
            for part, name in zip(qkv.chunk(3), ("query", "key", "value")):
                out[dst + f"MultiHeadDotProductAttention_0.{name}.{leaf}"] = part
        for ls in ("ls1", "ls2"):
            out[dst + ls] = sd[src + f"{ls}.gamma"]
        i += 1
    return {k: v.float() for k, v in out.items()}
