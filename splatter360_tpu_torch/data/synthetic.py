"""Random Gaussian worlds for tests, benchmarks and synthetic scenes.

Counterpart of splatter360_tpu/data/synthetic.py with the same
distributions, drawn from an explicit torch.Generator on the CPU: the
Gaussians differ from the JAX package's jax.random draws by construction
(another generator), not in kind.
"""

from __future__ import annotations

import torch

from ..geometry.transforms import build_covariance_sym6, sym6_to_matrix


def random_gaussians(gen: torch.Generator, n: int, sh_degree: int = 4,
                     radius_range=(0.5, 6.0), scale_range=(0.01, 0.12),
                     inside_out: bool = True) -> dict[str, torch.Tensor]:
    """Random world-space Gaussians around (or in front of) the origin:
    dict(means [N, 3], covariances [N, 3, 3], harmonics [N, 3, d_sh],
    opacities [N], scales [N, 3], rotations [N, 4] xyzw), float32 on the CPU."""
    d_sh = (sh_degree + 1) ** 2

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    if inside_out:
        dirs = torch.randn((n, 3), generator=gen)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        means = dirs * uniform((n, 1), *radius_range)
    else:
        means = uniform((n, 3), -1.0, 1.0)
        means[:, 2] += 3.0
    scales = uniform((n, 3), *scale_range)
    quats = torch.randn((n, 4), generator=gen)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    sh = 0.3 * torch.randn((n, 3, d_sh), generator=gen)
    sh[..., 0] += 0.5  # bias DC so colours are mostly in gamut
    return {
        "means": means,
        "covariances": sym6_to_matrix(build_covariance_sym6(scales, quats)),
        "harmonics": sh,
        "opacities": uniform((n,), 0.3, 0.95),
        "scales": scales,
        "rotations": quats,
    }
