"""Scene storage: one file per scene trajectory plus an index per split.

Counterpart of splatter360_tpu/data/scene_io.py (`save_scene`, `load_scene`,
`list_scenes`, `write_synthetic_scene`), reading and writing the same files:

  root/<split>/index.json         {"scenes": ["scene_a", ...]}
  root/<split>/<scene>.s3z        the native shard (native/loader.cpp), or
  root/<split>/<scene>.npz        rgb [n, H, W, 3] u8, depth_mm [n, H, W] u16,
                                  poses [n, 4, 4] f32 (ERP c2w)

A scene is written as .s3z when the native loader builds and as npz
otherwise; an existing .s3z is read through the loader, which raises when it
cannot be built. `convert_reference_scene` and `export_reference_layout`
convert from and to the reference's on-disk layout of a scene (pano/%05d.png,
pano_depth/%05d.png u16 mm, rotation.npy, translation.npy) with cv2, writing
the same bytes as the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..device import resolve_device


def save_scene(root, split, scene, rgb_u8, depth_mm_u16, poses) -> Path:
    """Write one scene and add it to the split's index; returns the file
    written (<scene>.s3z, or <scene>.npz where the loader does not build)."""
    d = Path(root) / split
    d.mkdir(parents=True, exist_ok=True)
    arrays = (np.asarray(rgb_u8, np.uint8), np.asarray(depth_mm_u16, np.uint16),
              np.asarray(poses, np.float32))
    if native.available():
        path = d / f"{scene}.s3z"
        native.write_shard(path, *arrays)
    else:
        path = d / f"{scene}.npz"
        np.savez_compressed(path, rgb=arrays[0], depth_mm=arrays[1], poses=arrays[2])
    idx_path = d / "index.json"
    idx = json.loads(idx_path.read_text()) if idx_path.exists() else {"scenes": []}
    if scene not in idx["scenes"]:
        idx["scenes"].append(scene)
        idx_path.write_text(json.dumps(idx, indent=1))
    return path


def load_scene(root, split, scene) -> dict[str, np.ndarray]:
    """{"rgb" [n, H, W, 3] u8, "depth_m" [n, H, W] f32, "poses" [n, 4, 4] f32}."""
    s3z = Path(root) / split / f"{scene}.s3z"
    if s3z.exists():
        shard = native.Shard(s3z)
        rgb, depth = shard.decode(list(range(shard.n_frames)))
        poses = shard.poses()
        shard.close()
        return {"rgb": rgb, "depth_m": depth.astype(np.float32) / 1000.0, "poses": poses}
    with np.load(Path(root) / split / f"{scene}.npz") as z:
        return {"rgb": z["rgb"], "depth_m": z["depth_mm"].astype(np.float32) / 1000.0,
                "poses": z["poses"]}


def list_scenes(root, split) -> list[str]:
    idx_path = Path(root) / split / "index.json"
    if not idx_path.exists():
        return []
    return json.loads(idx_path.read_text())["scenes"]


def convert_reference_scene(scene_dir, root, split: str, scene: str) -> Path:
    """Store a scene of the reference's layout (pano/%05d.png RGB,
    pano_depth/%05d.png u16 mm, rotation.npy [n, 3, 3], translation.npy
    [n, 3]) as `scene` of `split`; returns the file written."""
    import cv2

    sd = Path(scene_dir)
    rot = np.load(sd / "rotation.npy")
    trans = np.load(sd / "translation.npy")
    n = rot.shape[0]
    rgbs, depths = [], []
    for i in range(n):
        img = cv2.imread(str(sd / "pano" / f"{i:05d}.png"), cv2.IMREAD_COLOR)
        dep = cv2.imread(str(sd / "pano_depth" / f"{i:05d}.png"), cv2.IMREAD_UNCHANGED)
        if img is None or dep is None:
            raise FileNotFoundError(f"{sd}: frame {i:05d} is missing or unreadable")
        rgbs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        depths.append(dep.astype(np.uint16))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = trans
    return save_scene(root, split, scene, np.stack(rgbs), np.stack(depths), poses)


def export_reference_layout(root, split: str, scene: str, out_dir) -> None:
    """Write a stored scene in the reference's layout (the inverse of
    convert_reference_scene): RGB PNGs, depth PNGs in u16 mm (rounded, not
    truncated: 4.999 m * 1000 can land at 4999.9999 in float32), the
    rotations and translations of its poses."""
    import cv2

    data = load_scene(root, split, scene)
    out = Path(out_dir)
    (out / "pano").mkdir(parents=True, exist_ok=True)
    (out / "pano_depth").mkdir(exist_ok=True)
    depth_mm = np.clip(np.rint(data["depth_m"] * 1000.0), 0, 65535).astype(np.uint16)
    for i in range(data["rgb"].shape[0]):
        cv2.imwrite(str(out / "pano" / f"{i:05d}.png"),
                    cv2.cvtColor(data["rgb"][i], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(out / "pano_depth" / f"{i:05d}.png"), depth_mm[i])
    np.save(out / "rotation.npy", data["poses"][:, :3, :3])
    np.save(out / "translation.npy", data["poses"][:, :3, 3])


def write_synthetic_scene(root, split: str = "train", scene: str = "synth0", n_frames: int = 32,
                          image_shape: tuple[int, int] = (128, 256), n_gaussians: int = 4000,
                          seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Render a random Gaussian world (data/synthetic.py, torch.Generator
    seeded with `seed`) along a smooth trajectory into RGB-D panoramas with
    the dense renderer (ops/rasterizer_ref.render_dense) and save it.
    Returns {"n_frames", "image_shape", "path"}."""
    from ..ops.rasterizer_ref import render_dense
    from .synthetic import random_gaussians

    dev = resolve_device(device)
    g = random_gaussians(torch.Generator().manual_seed(seed), n_gaussians, sh_degree=2,
                         radius_range=(1.0, 8.0), scale_range=(0.05, 0.35))
    # an opaque-ish world, so that depth supervision means something
    g["opacities"] = torch.clamp(g["opacities"] + 0.4, 0.0, 0.98)
    g = {k: v.to(dev) for k, v in g.items()}
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    centers = np.stack([0.6 * np.sin(t), 0.15 * np.sin(2 * t), 0.6 * np.cos(t)], axis=-1)
    rgbs, depths, poses = [], [], []
    for i in range(n_frames):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = centers[i]
        with torch.no_grad():
            out = render_dense(g["means"], g["covariances"], g["harmonics"], g["opacities"],
                               torch.as_tensor(c2w, device=dev), image_shape, camera_kind="erp",
                               near=0.1, far=20.0, render_depth=True)
        color, alpha = out.color.cpu().numpy(), out.alpha.cpu().numpy()
        # expected depth: divide by alpha; background (alpha ~ 0) is a hole (0)
        dep = out.depth.cpu().numpy() / np.maximum(alpha, 1e-6)
        dep = np.where(alpha > 0.5, dep, 0.0)
        rgbs.append((np.clip(color, 0, 1) * 255).astype(np.uint8))
        depths.append((np.clip(dep, 0, 60) * 1000).astype(np.uint16))
        poses.append(c2w)
    path = save_scene(root, split, scene, np.stack(rgbs), np.stack(depths), np.stack(poses))
    return {"n_frames": n_frames, "image_shape": image_shape, "path": path}
