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


def adam_state_from_optax(opt_state: Mapping, model: torch.nn.Module,
                          step: int | None = None) -> dict:
    """The optax state of the JAX package's make_optimizer (clip_by_global_norm,
    then adam: {"0": None, "1": {"0": {count, mu, nu}, "1": {count}}}, as
    train/orbax_reader.py reads it) -> the "state" of a torch.optim.Adam
    state_dict over `model`'s trainable parameters in their order
    (train/state.create_train_state's Adam): mu and nu become exp_avg and
    exp_avg_sq through torch_state_from_flax's layout rules, and the count
    becomes Adam's step. The schedule's count and `step` (the train state's
    step) must equal it. The frozen parameters' moments (the mono ViT's, which
    JAX keeps at zero) must be all zero and are dropped. Returns {index:
    {"step", "exp_avg", "exp_avg_sq"}}; any other shape of state raises
    ValueError."""
    try:
        clip, (adam, schedule) = opt_state["0"], (opt_state["1"]["0"], opt_state["1"]["1"])
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
        schedule_count = schedule["count"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"not the optax state of make_optimizer (clip, (adam, schedule)): "
                         f"missing {e}") from e
    if clip is not None or set(opt_state) != {"0", "1"} or set(opt_state["1"]) != {"0", "1"}:
        raise ValueError(f"not the optax state of make_optimizer: keys {sorted(opt_state)}")
    if set(adam) != {"count", "mu", "nu"} or set(schedule) != {"count"}:
        raise ValueError(f"not optax's adam state: keys {sorted(adam)}, {sorted(schedule)}")
    count = int(np.asarray(count))
    if int(np.asarray(schedule_count)) != count:
        raise ValueError(f"the schedule's count {int(np.asarray(schedule_count))} != "
                         f"Adam's count {count}")
    if step is not None and int(step) != count:
        raise ValueError(f"the train state's step {int(step)} != Adam's count {count}")
    moments = {"exp_avg": torch_state_from_flax(mu), "exp_avg_sq": torch_state_from_flax(nu)}
    params = dict(model.named_parameters())
    for kind, tree in moments.items():
        unknown = sorted(set(tree) - set(params))
        missing = sorted(n for n, p in params.items() if p.requires_grad and n not in tree)
        if unknown or missing:
            raise ValueError(f"optax {kind} does not fit the model: first missing "
                             f"{missing[:3]}, first unexpected {unknown[:3]}")
        for name, value in tree.items():
            if tuple(value.shape) != tuple(params[name].shape):
                raise ValueError(f"optax {kind} {name}: shape {tuple(value.shape)}, the model's "
                                 f"{tuple(params[name].shape)}")
            if not params[name].requires_grad and bool(torch.any(value != 0)):
                raise ValueError(f"optax {kind} of the frozen parameter {name} is not zero")
    trainable = [n for n, p in params.items() if p.requires_grad]
    return {i: {"step": torch.tensor(float(count)), "exp_avg": moments["exp_avg"][name],
                "exp_avg_sq": moments["exp_avg_sq"][name]}
            for i, name in enumerate(trainable)}
