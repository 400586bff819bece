"""Gaussians -> binary .ply (the 3DGS layout: DC band, logit opacity, log
scales, wxyz rotation).

Counterpart of splatter360_tpu/utils/ply_export.py, writing the same bytes.
Inputs are numpy arrays or tensors on any device (moved to the host).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def export_ply(
    means,      # [N, 3]
    scales,     # [N, 3]
    rotations,  # [N, 4] xyzw
    harmonics,  # [N, 3, d_sh]
    opacities,  # [N]
    path,
) -> None:
    means, scales, rotations, harmonics, opacities = (
        _host(x) for x in (means, scales, rotations, harmonics, opacities))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = means.shape[0]

    f_dc = harmonics[:, :, 0]  # DC band
    log_scales = np.log(np.clip(scales, 1e-8, None))
    # inverse sigmoid for opacity (3DGS ply convention)
    op = np.clip(opacities, 1e-6, 1 - 1e-6)
    op_logit = np.log(op / (1 - op))
    # xyzw -> wxyz (3DGS ply stores rot_0..rot_3 = w x y z)
    rot = rotations[:, [3, 0, 1, 2]]

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )
    data = np.concatenate(
        [
            np.asarray(means, np.float32),
            np.zeros((n, 3), np.float32),
            f_dc.astype(np.float32),
            op_logit[:, None].astype(np.float32),
            log_scales.astype(np.float32),
            rot.astype(np.float32),
        ],
        axis=1,
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
