"""Offline RGB-D panorama dataset generation over procedural worlds.

Counterpart of splatter360_tpu/preprocess/generate.py. Per frame it renders
the panorama with the dense renderer (ops/rasterizer_ref.render_dense),
turns expected depth into ray distance, applies the zero-ratio frame filter
(a trajectory that sees too much void is drawn again) and writes the scene
in the training data contract (data/scene_io.save_scene: ERP RGB u8, ERP
depth in mm u16 with holes at 0, c2w poses).

Two render paths:
  * direct ERP (the default): one equirectangular render a frame;
  * via_cubes=True: the 6 pinhole faces of the cube rig, z-depth to ray
    distance (geometry/cubemap.zdepth_to_distance), colour, distance and
    alpha stitched to ERP with cube_to_erp, the dataflow of the reference's
    Habitat generator.

Rendering runs on `device` (the card unless the caller asks for the CPU);
building the world, the trajectory and the files is host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .scene_builder import build_room_world
from .trajectory import sample_trajectory


def _render_frames(world, poses, image_shape, via_cubes, far, device="cuda"):
    """[(colour [H, W, 3], expected depth [H, W], alpha [H, W])] a pose, as
    float32 numpy arrays."""
    from ..geometry.cubemap import (
        cube_face_extrinsics, cube_face_intrinsics, cube_to_erp, zdepth_to_distance,
    )
    from ..ops.rasterizer_ref import render_dense

    dev = resolve_device(device)
    h, w = image_shape
    g = [torch.as_tensor(a, device=dev) for a in
         (world.means, world.covariances, world.harmonics, world.opacities)]
    intr = cube_face_intrinsics(device=dev)

    def one(c2w):
        if not via_cubes:
            out = render_dense(*g, c2w, image_shape, camera_kind="erp", near=0.05, far=far,
                               render_depth=True)
            return out.color, out.depth, out.alpha
        faces = [render_dense(*g, fc2w, (h // 2, h // 2), camera_kind="pinhole",
                              intrinsics=intr, near=0.05, far=far, render_depth=True)
                 for fc2w in cube_face_extrinsics(c2w)]
        col = torch.stack([f.color for f in faces])
        zd = torch.stack([f.depth for f in faces])
        al = torch.stack([f.alpha for f in faces])
        # expected z-depth -> ray distance per face, then stitch to ERP
        dist = zdepth_to_distance(zd / torch.clamp(al, min=1e-6), 0.5, 0.5, 0.5, 0.5) * al
        return (cube_to_erp(col, h, w), cube_to_erp(dist[..., None], h, w)[..., 0],
                cube_to_erp(al[..., None], h, w)[..., 0])

    frames = []
    with torch.no_grad():
        for pose in poses:
            out = one(torch.as_tensor(pose, device=dev))
            frames.append(tuple(x.cpu().numpy() for x in out))
    return frames


def generate_scene(
    root,
    split: str = "train",
    scene: str = "proc000",
    n_frames: int = 32,
    image_shape: tuple[int, int] = (128, 256),
    seed: int = 0,
    spacing: float = 0.09,
    via_cubes: bool = False,
    max_zero_ratio: float = 0.03,
    far: float = 30.0,
    max_retries: int = 3,
    sh_degree: int = 2,
    n_panels: int = 0,
    scale_jitter: float = 1.0,
    device: str | torch.device = "cuda",
):
    """Build a world, sample a trajectory, render, filter, write one scene.

    Returns an info dict (frame count, rejection count, world size)."""
    from ..data.scene_io import save_scene

    dev = resolve_device(device)
    rejections = 0
    for attempt in range(max_retries):
        s = seed + 1000 * attempt
        world = build_room_world(seed=s, spacing=spacing, sh_degree=sh_degree,
                                 n_panels=n_panels, scale_jitter=scale_jitter)
        poses = sample_trajectory(world, n_frames, seed=s)
        frames = _render_frames(world, poses, image_shape, via_cubes, far, dev)
        zero_ratios = [float((a < 0.5).mean()) for _, _, a in frames]
        if max(zero_ratios) <= max_zero_ratio:
            break
        rejections += 1
    else:
        raise RuntimeError(
            f"scene {scene}: all {max_retries} trajectories failed the "
            f"zero-ratio filter (worst {max(zero_ratios):.3f})"
        )

    rgbs, depths = [], []
    for color, dacc, alpha in frames:
        dep = dacc / np.maximum(alpha, 1e-6)
        dep = np.where(alpha > 0.5, dep, 0.0)  # holes stored as 0 (mm contract)
        rgbs.append((np.clip(color, 0, 1) * 255).astype(np.uint8))
        depths.append((np.clip(dep, 0, 60) * 1000).astype(np.uint16))
    save_scene(root, split, scene, np.stack(rgbs), np.stack(depths), poses)
    return {
        "scene": scene,
        "n_frames": n_frames,
        "image_shape": tuple(image_shape),
        "n_gaussians": int(world.means.shape[0]),
        "rejections": rejections,
        "via_cubes": via_cubes,
    }
