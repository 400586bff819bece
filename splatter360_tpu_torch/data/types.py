"""Batch data contract, channels-last.

Counterpart of splatter360_tpu/data/types.py. Per example, context and
target dicts with:
    extrinsics_sphere [v, 4, 4]   ERP c2w (OpenCV-convention world)
    image_sphere      [v, H, W, 3]
    depth_sphere      [v, H, W]   distance along the ray; 0 = hole
    near, far         [v]
    index             [v] int32 frame indices
and `scene`, a str that stays on the host. Cube faces are resampled from
image_sphere on the device (serve.context_cubes).
"""

from __future__ import annotations

from typing import Any, Dict

Example = Dict[str, Any]

CONTEXT_KEYS = (
    "extrinsics_sphere",
    "image_sphere",
    "image_cubes",
    "depth_sphere",
    "near",
    "far",
    "index",
)
