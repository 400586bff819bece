"""Torch weight files of the reference's pretrained modules -> the port's
parameters.

Counterpart of splatter360_tpu/utils/torch_convert.py (`load_torch_state_dict`,
`convert_unimatch_backbone`, `convert_dinov2`). Both weight files are
already in PyTorch's layouts, so their tensors map onto the port's module
names one to one, with no transpose. A UniMatch (gmdepth) file's CNN and
transformer keys go onto BackboneMultiview's names. Of a DINOv2 file only
the CLS and mask tokens are dropped and pos_embed is resampled to the
model's token grid. (JAX splits qkv into per-head DenseGeneral kernels; the
port's query/key/value weights are its [dim, dim] thirds, heads major,
which is the same layout flattened.)
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


def convert_unimatch_backbone(sd: Mapping[str, torch.Tensor],
                              num_layers: int = 6) -> dict[str, torch.Tensor]:
    """UniMatch's backbone (CNNEncoder: backbone.conv1, backbone.layer{1,2,3}.
    {0,1}.{conv1,conv2,downsample.0}, backbone.conv2) and its transformer's
    `num_layers` layers (transformer.layers.{i}.{self_attn,cross_attn_ffn}.
    {q_proj,k_proj,v_proj,merge,norm1,mlp.0,mlp.2,norm2}) -> a state dict of
    the port's BackboneMultiview. Keys may carry a `module.` prefix; a
    downsample conv and the FFN (mlp.0, mlp.2, norm2) are taken where the
    file has them, every other key named here must be there (KeyError), and
    the file's other keys (the upsampler and other heads) are ignored."""
    def has(name):
        return name in sd or f"module.{name}" in sd

    def k(name):
        for cand in (name, f"module.{name}"):
            if cand in sd:
                return sd[cand]
        raise KeyError(name)

    out = {"CNNEncoder_0.Conv_0.weight": k("backbone.conv1.weight")}
    for stage in (1, 2, 3):  # 3 stages of 2 residual blocks: ResidualBlock_0..5
        for sub in (0, 1):
            src = f"backbone.layer{stage}.{sub}."
            dst = f"CNNEncoder_0.ResidualBlock_{2 * stage - 2 + sub}."
            out[dst + "Conv_0.weight"] = k(src + "conv1.weight")
            out[dst + "Conv_1.weight"] = k(src + "conv2.weight")
            if has(src + "downsample.0.weight"):
                out[dst + "Conv_2.weight"] = k(src + "downsample.0.weight")
                out[dst + "Conv_2.bias"] = k(src + "downsample.0.bias")
    out["CNNEncoder_0.Conv_1.weight"] = k("backbone.conv2.weight")
    out["CNNEncoder_0.Conv_1.bias"] = k("backbone.conv2.bias")
    for i in range(num_layers):
        for ours, theirs in (("self", "self_attn"), ("cross", "cross_attn_ffn")):
            src = f"transformer.layers.{i}.{theirs}."
            dst = f"MultiViewFeatureTransformer_0.layer{i}_{ours}."
            for name in ("q_proj.weight", "k_proj.weight", "v_proj.weight", "merge.weight",
                         "norm1.weight", "norm1.bias"):
                out[dst + name] = k(src + name)
            if has(src + "mlp.0.weight"):
                out[dst + "Dense_0.weight"] = k(src + "mlp.0.weight")
                out[dst + "Dense_1.weight"] = k(src + "mlp.2.weight")
                out[dst + "norm2.weight"] = k(src + "norm2.weight")
                out[dst + "norm2.bias"] = k(src + "norm2.bias")
    return out


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
