"""Serving entry points: posed ERP panoramas -> Gaussians -> novel ERP views
or their cube faces.

Counterpart of the JAX Evaluator's encode/decode (splatter360_tpu/train/
evaluator.py: `_encode`, `_decode_erp`, `_decode_cubes`) and `_context_cubes`
(train/state.py):

    model = build_model(HM3D, seed=0)                       # or state_dict=...
    gaussians, depth = encode(model, images, c2w, near, far)
    out = render_erp_views(gaussians, target_c2w, near_t, far_t, (512, 1024))
    faces = render_cube_views(gaussians, target_c2w, near_t, far_t, 256)

Everything runs on the card unless the caller passes device="cpu"; with no
card present the entry points raise. The encoder runs under its config's
precision policy (models/encoder.apply_encoder: float32, or bf16 compute
with the JAX package's float32 islands); the renderer computes in float32,
with TF32 off in matmuls and cuDNN convolutions (device.set_f32_policy).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .device import resolve_device, set_f32_policy
from .geometry.cubemap import erp_to_cube
from .models import decoder
from .models.encoder import EncoderConfig, EncoderCostVolume360, apply_encoder
from .models.types import Gaussians

# Evaluator encodes with the opacity warm-up finished
EVAL_GLOBAL_STEP = 10**9


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights (no checkpoint is shipped): N(0, 1/fan_in) for
    conv and dense kernels, ones for norm scales, zeros for biases. Drawn on
    the CPU in parameter-name order, so every device gets the same weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias"):
                vals = torch.zeros(p.shape)
            elif p.dim() == 1:
                vals = torch.ones(p.shape)
            else:
                fan_in = p[0].numel()
                vals = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
            p.copy_(vals)


def build_model(cfg: EncoderConfig, seed: int = 0, device: str | torch.device = "cuda",
                state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> EncoderCostVolume360:
    """The encoder with `state_dict` (see convert.torch_state_from_flax) or
    seeded random weights, in eval mode on `device`."""
    dev = resolve_device(device)
    model = EncoderCostVolume360(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    return model.to(dev).eval()


def context_cubes(image_sphere: torch.Tensor, face_w: int) -> torch.Tensor:
    """ERP panoramas [B, V, H, W, 3] -> cube faces [B, V, 6, fw, fw, 3]."""
    b, v = image_sphere.shape[:2]
    flat = image_sphere.reshape(b * v, *image_sphere.shape[2:])
    faces = torch.stack([erp_to_cube(x, face_w) for x in flat])
    return faces.reshape(b, v, 6, face_w, face_w, 3)


def _on(dev, *xs):
    return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs]


@torch.no_grad()
def encode(model: EncoderCostVolume360, image_sphere, extrinsics, near, far,
           device: str | torch.device = "cuda") -> tuple[Gaussians, torch.Tensor]:
    """Context panoramas [B, V, H, W, 3] in [0, 1], c2w [B, V, 4, 4] and
    near/far [B, V] -> (Gaussians with N = V*H*W*gaussians_per_pixel, depth map
    [B, V, H, W])."""
    dev = resolve_device(device)
    set_f32_policy()
    image_sphere, extrinsics, near, far = _on(dev, image_sphere, extrinsics, near, far)
    cubes = context_cubes(image_sphere, image_sphere.shape[2] // 2)
    return apply_encoder(model, image_sphere, cubes, extrinsics, near, far, EVAL_GLOBAL_STEP)


@torch.no_grad()
def render_erp_views(gaussians: Gaussians, extrinsics, near, far,
                     image_shape: tuple[int, int], render_depth: bool = False,
                     background=None,
                     device: str | torch.device = "cuda") -> decoder.DecoderOutput:
    """Render target ERP views [B, V] of each batch item's Gaussians, with
    metric depth; all views of an item go through one compositor launch."""
    dev = resolve_device(device)
    gaussians = Gaussians(*_on(dev, *gaussians))
    extrinsics, near, far = _on(dev, extrinsics, near, far)
    if background is not None:
        (background,) = _on(dev, background)
    return decoder.render_erp_views(gaussians, extrinsics, near, far, image_shape,
                                    background=background, render_depth=render_depth)


@torch.no_grad()
def render_cube_views(gaussians: Gaussians, extrinsics, near, far, face_w: int,
                      render_depth: bool = False, background=None,
                      device: str | torch.device = "cuda") -> decoder.DecoderOutput:
    """Render the 6 cube faces (F R B L U D, face_w x face_w pinhole views)
    of target views [B, V]: colour [B, V, 6, fw, fw, 3], depth (camera z)
    and alpha [B, V, 6, fw, fw], dropped [B, V, 6]; all V*6 faces of an
    item go through one compositor launch."""
    dev = resolve_device(device)
    gaussians = Gaussians(*_on(dev, *gaussians))
    extrinsics, near, far = _on(dev, extrinsics, near, far)
    if background is not None:
        (background,) = _on(dev, background)
    return decoder.render_cube_views(gaussians, extrinsics, near, far, (face_w, face_w),
                                     background=background, render_depth=render_depth)
