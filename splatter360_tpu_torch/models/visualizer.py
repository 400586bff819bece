"""The encoder's debug sheet: what it predicted for each context view.

Counterpart of splatter360_tpu/models/visualizer.py: per context view, the
image, the encoder's ERP depth, the Gaussians' opacity, their scale (the
mean standard deviation from the covariance's trace) and their SH DC
colour, each labelled, in one row; one row a view. Runs on the host in
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.image_io import add_label, apply_depth_colormap, hcat, vcat

_SH_C0 = 0.28209479177387814


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def visualize_gaussians(gaussians, depth_map, context_images, image_shape) -> np.ndarray:
    """The sheet of batch item 0, an [H', W', 3] float image.

    gaussians: Gaussians with means [b, v*h*w, 3] (pixel-aligned, view-major)
    and covariances in sym6 [b, n, 6] or [b, n, 3, 3]; depth_map [b, v, h, w]
    (or [b, v, h, w, 1]); context_images [b, v, h, w, 3]; image_shape (h, w)."""
    h, w = image_shape
    imgs = _host(context_images[0])
    v = imgs.shape[0]
    opac = _host(gaussians.opacities[0]).reshape(v, h, w)
    cov = _host(gaussians.covariances[0])
    if cov.shape[-1] == 6:
        trace = cov[..., 0] + cov[..., 3] + cov[..., 5]
    else:
        trace = np.trace(cov.reshape(v, h, w, 3, 3), axis1=-2, axis2=-1).reshape(-1)
    scale = np.sqrt(np.maximum(trace.reshape(v, h, w) / 3.0, 0.0))
    dc = _host(gaussians.harmonics[0][..., 0]).reshape(v, h, w, 3)
    dc_rgb = np.clip(dc * _SH_C0 + 0.5, 0.0, 1.0)
    depth = _host(depth_map[0])
    if depth.ndim == 4:
        depth = depth[..., 0]

    rows = []
    for vi in range(v):
        cells = [
            add_label(imgs[vi], f"context {vi}"),
            add_label(apply_depth_colormap(depth[vi]), "encoder depth"),
            add_label(np.repeat(opac[vi][..., None], 3, axis=-1), "opacity"),
            add_label(apply_depth_colormap(np.log10(scale[vi] + 1e-8)), "log10 scale"),
            add_label(dc_rgb[vi], "SH DC color"),
        ]
        rows.append(hcat(*cells, pad=2))
    return vcat(*rows, pad=2)
