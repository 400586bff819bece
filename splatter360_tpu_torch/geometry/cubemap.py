"""Cubemap face rigs and ERP <-> cubemap resampling (faces in F R B L U D order).

Counterpart of splatter360_tpu/geometry/cubemap.py. The sampling grids are
built once in float64 numpy, cached, and moved to the device as float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.resample import bilinear_sample, bilinear_sample_3d_faces

CUBE_FACE_ORDER_FRBLUD = ("F", "R", "B", "L", "U", "D")

# Face camera -> ERP camera rotation per face; rows are the (image-x,
# image-y, forward) axes in the ERP frame, transposed into columns below.
_FACE_ROTATIONS = np.array(
    [
        [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],   # F
        [[0, 0, -1], [0, -1, 0], [-1, 0, 0]],  # R
        [[1, 0, 0], [0, -1, 0], [0, 0, -1]],   # B
        [[0, 0, 1], [0, -1, 0], [1, 0, 0]],    # L
        [[-1, 0, 0], [0, 0, 1], [0, 1, 0]],    # U
        [[-1, 0, 0], [0, 0, -1], [0, -1, 0]],  # D
    ],
    dtype=np.float64,
).transpose(0, 2, 1)


def cube_face_rotations(dtype=torch.float32, device=None) -> torch.Tensor:
    """[6, 3, 3] rotation (face camera -> ERP camera) in F R B L U D order."""
    return torch.as_tensor(_FACE_ROTATIONS, dtype=dtype, device=device)


def cube_face_extrinsics(c2w_erp: torch.Tensor) -> torch.Tensor:
    """ERP camera-to-world pose [..., 4, 4] -> per-face c2w poses [..., 6, 4, 4]."""
    rots = cube_face_rotations(c2w_erp.dtype, c2w_erp.device)
    face_rot = torch.einsum("...ij,fjk->...fik", c2w_erp[..., :3, :3], rots)
    t = c2w_erp[..., None, :3, 3].expand(*face_rot.shape[:-2], 3)
    top = torch.cat([face_rot, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w_erp.dtype, device=c2w_erp.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def cube_face_intrinsics(dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized 90-degree-FoV pinhole intrinsics shared by all faces: [3, 3]."""
    return torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def _face_dirs(face_w: int) -> np.ndarray:
    """Unit ray directions (ERP frame) of every face pixel, [6, fw, fw, 3]."""
    u = (np.arange(face_w, dtype=np.float64) + 0.5) / face_w - 0.5
    uu, vv = np.meshgrid(u, u, indexing="xy")
    d_cam = np.stack([uu / 0.5, vv / 0.5, np.ones_like(uu)], axis=-1)
    dirs = np.einsum("fij,hwj->fhwi", _FACE_ROTATIONS, d_cam)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=16)
def erp_to_cube_grid(equ_h: int, equ_w: int, face_w: int):
    """ERP pixel coords [6, fw, fw, 2] sampled by each face pixel, and the
    ray-distance -> z-depth factor [6, fw, fw]."""
    dirs = _face_dirs(face_w)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = np.arctan2(x, z)
    phi = np.arctan2(y, np.sqrt(x * x + z * z))
    px = (-theta / (2 * np.pi) + 0.5) * equ_w - 0.5
    py = (-phi / np.pi + 0.5) * equ_h - 0.5
    coords = np.stack([px, py], axis=-1).astype(np.float32)
    cos_factor = np.einsum("fhwi,fi->fhw", dirs, _FACE_ROTATIONS[:, :, 2])
    return coords, cos_factor.astype(np.float32)


@functools.lru_cache(maxsize=16)
def cube_to_erp_grid(face_w: int, equ_h: int, equ_w: int):
    """Per ERP pixel: the face index [H, W] int32 and face pixel coords
    [H, W, 2] float32, picking the face by the largest axis component."""
    xg = np.arange(equ_w, dtype=np.float64)
    yg = np.arange(equ_h, dtype=np.float64)
    xx, yy = np.meshgrid(xg, yg, indexing="xy")
    theta = (0.5 - (xx + 0.5) / equ_w) * 2 * np.pi
    phi = -((yy + 0.5) / equ_h - 0.5) * np.pi
    d = np.stack(
        [np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta)],
        axis=-1,
    )
    d_cam = np.einsum("fji,hwj->fhwi", _FACE_ROTATIONS, d)
    zf = d_cam[..., 2]
    score = np.where(
        zf > 0,
        zf / np.maximum(np.maximum(np.abs(d_cam[..., 0]), np.abs(d_cam[..., 1])), 1e-12),
        -np.inf,
    )
    face_idx = np.argmax(score, axis=0)
    sel = np.take_along_axis(
        d_cam, face_idx[None, :, :, None].repeat(3, axis=-1), axis=0
    )[0]
    px = (sel[..., 0] / sel[..., 2] * 0.5 + 0.5) * face_w - 0.5
    py = (sel[..., 1] / sel[..., 2] * 0.5 + 0.5) * face_w - 0.5
    coords = np.stack([px, py], axis=-1).astype(np.float32)
    return face_idx.astype(np.int32), coords


@functools.lru_cache(maxsize=32)
def _device_grid(kind: str, a: int, b: int, c: int, device: torch.device):
    grid = erp_to_cube_grid(a, b, c) if kind == "e2c" else cube_to_erp_grid(a, b, c)
    return tuple(torch.as_tensor(g, device=device) for g in grid)


def erp_to_cube(erp: torch.Tensor, face_w: int, depth_to_z: bool = False) -> torch.Tensor:
    """ERP image [H, W, C] -> cubemap faces [6, fw, fw, C]."""
    coords, cos_factor = _device_grid("e2c", erp.shape[0], erp.shape[1], face_w, erp.device)
    out = bilinear_sample(erp, coords, wrap_x=True)
    if depth_to_z:
        out = out * cos_factor[..., None]
    return out


def cube_to_erp(faces: torch.Tensor, equ_h: int, equ_w: int) -> torch.Tensor:
    """Cubemap faces [6, fw, fw, C] -> ERP image [equ_h, equ_w, C]."""
    face_idx, coords = _device_grid("c2e", faces.shape[1], equ_h, equ_w, faces.device)
    return bilinear_sample_3d_faces(faces, face_idx, coords)


def erp_distance_to_cube_zdepth_factor(face_w: int, device=None) -> torch.Tensor:
    """[6, face_w, face_w] multiplicative factor: ray distance -> face z-depth."""
    _, cos_factor = erp_to_cube_grid(4 * face_w, 2 * face_w, face_w)
    return torch.as_tensor(cos_factor, device=device)


def zdepth_to_distance(zdepth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pinhole z-depth map [..., h, w] -> euclidean ray-distance map:
    z * |((u - cx) / fx, (v - cy) / fy, 1)| with u, v the normalized pixel
    centres ((col + 0.5) / w along the width, (row + 0.5) / h along the
    height) and normalized intrinsics (the cube rig: 0.5, 0.5, 0.5, 0.5)."""
    h, w = zdepth.shape[-2:]
    u = (torch.arange(w, dtype=zdepth.dtype, device=zdepth.device) + 0.5) / w
    v = (torch.arange(h, dtype=zdepth.dtype, device=zdepth.device) + 0.5) / h
    xn = (u[None, :] - cx) / fx
    yn = (v[:, None] - cy) / fy
    return zdepth * torch.sqrt(1.0 + xn * xn + yn * yn)
