"""Carry the JAX package's Flax parameters into the port's state_dict.

The port's modules carry Flax's submodule names, so a parameter's path maps
one to one; only the leaf and its layout change:
  conv kernel  HWIO [kh, kw, in, out] -> weight OIHW [out, in, kh, kw]
  Dense kernel [in, out]              -> weight [out, in]
  attention DenseGeneral kernel (the ViT's MultiHeadDotProductAttention):
    query/key/value [dim, heads, hd]  -> weight [heads * hd, dim]
    out [heads, hd, dim]              -> weight [dim, heads * hd]
  norm scale                          -> weight
  bias                                -> bias (a [heads, hd] bias flattened)
  depth_pe (the epipolar block's), the ViT's pos_embed and layer scales
  ls1, ls2                            -> as they are
and Flax's remat wrapper prefix (CheckpointResBlock_i) becomes ResBlock_i.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def torch_state_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays, with or without the top
    'params' collection) -> a state_dict for EncoderCostVolume360."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        mods = [m.replace("CheckpointResBlock_", "ResBlock_") for m in mods]
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3 and mods[-1] == "out":
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim == 3:
                arr = arr.reshape(arr.shape[0], -1).T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf == "bias":
            arr = arr.reshape(-1)
        elif leaf not in ("depth_pe", "pos_embed", "ls1", "ls2"):
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        state[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return state


def lpips_state_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax LPIPS params (splatter360_tpu/train/lpips_jax.py: vgg/conv{s}_{c}
    kernels and biases, lin{i} vectors) -> a state_dict for train.lpips.LPIPS."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        if path[0] == "vgg" and len(path) == 3 and path[2] in ("kernel", "bias"):
            name = f"vgg.{path[1]}.{'weight' if path[2] == 'kernel' else 'bias'}"
            arr = arr.transpose(3, 2, 0, 1) if path[2] == "kernel" else arr
        elif len(path) == 1 and path[0].startswith("lin"):
            name = path[0]
        else:
            raise ValueError(f"unexpected LPIPS parameter {'/'.join(path)}")
        state[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return state
