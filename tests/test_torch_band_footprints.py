"""The band-sharded ERP render bins JAX's footprints: tall and wide faint
splats.

JAX's render_erp_sharded (splatter360_tpu/parallel/render_sharding.py)
projects each shard without opacities, so a band bins every splat by its
3-sigma box, with no elliptical cull, where the unsharded render bins the
opacity-tightened box. assign_tiles bins an ERP splat into at most SPAN_H
tile rows, counted from the top of its box clamped to the band, so a splat
whose box inside a band is taller than SPAN_H rows covers other rows under
the two footprints wherever they differ: opacity under e^4.5 / 255 ~ 0.353,
in a band of more than SPAN_H tile rows. At 512 rows 2 bands hold 16 tile
rows each, 4 bands 8.

The scene: tests/test_torch_distributed.scene(n=N_SCENE), and three tall
splats (covariance diag(0.01^2, 0.6^2, 0.01^2), ~9 tile rows in 3 sigma at
512 rows) at OPACITIES, with SH degree 1, DC 2 on one channel each; c2w the
identity, 512 x 256. The port's band render over k emulated ranks against
JAX's on a k-device mesh of the conftest's virtual devices, both with the
scan compositor at SLOTS slots a tile (more than the scene's Gaussians, so
neither cuts a tile's list), and the port's kernels' path (the plain fused
compositor on the CPU) at k = 2. assign_tiles also bins a splat into at
most SPAN_W tile columns from its box's left, so a wide faint splat whose
3-sigma box starts a column left of its tight box covers other columns:
the wide case renders the tall splats and one such splat (covariance
diag(1, 0.01^2, 0.01^2) at WIDE_MEAN, 5 tile columns in 3 sigma, 4 in its
tight box) with N_WIDE of the scene's Gaussians at 512 x 1024, 2 bands.

Bars (tests/test_torch_parallel.py's band bars): colour and alpha 2e-5,
depth 1e-4; the means' and opacities' gradients at atol 3e-6, rtol 2e-4.
Binning the tight footprints, the 2-band render at opacity 0.2 misses them
by ~0.14 in colour, ~0.13 in alpha and ~0.26 in depth.

As a script (PYTHONPATH=. JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=2 python
tests/test_torch_band_footprints.py) it prints, for the wide case, how far
each package's band render lies from its own unsharded render (the
tiling's spans, ROADMAP Queue 3).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter360_tpu.parallel import render_sharding as jrs
from splatter360_tpu.parallel.mesh import create_mesh
from splatter360_tpu_torch.parallel import mesh
from splatter360_tpu_torch.parallel import render_sharding as prs
from test_torch_distributed import scene

torch.set_num_threads(2)
H, W = 512, 256
N_SCENE = 300
SLOTS = 384
OPACITIES = (0.2, 0.9)
RGB_TOL, DEPTH_TOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-6, 2e-4
TALL_MEANS = ((2.0, 0.1, 0.0), (0.0, -0.2, 2.0), (-2.0, 0.3, 0.3))
# the wide case: its image, Gaussians of the scene, slots a tile, the wide
# splat's mean and scales
WIDE_SHAPE, N_WIDE, WIDE_SLOTS = (512, 1024), 40, 128
WIDE_MEAN, WIDE_SCALES = (0.145, 0.05, 2.0), (1.0, 0.01, 0.01)


def tall_scene(opacity, wide=False):
    """The scene's means, covariances, SH and opacities (numpy float32)
    with the three tall splats appended at `opacity`; with `wide`, N_WIDE
    of the scene's Gaussians, the tall splats and the wide one."""
    means, covs, sh, op = scene(n=N_WIDE if wide else N_SCENE)
    centres = TALL_MEANS + ((WIDE_MEAN,) if wide else ())
    n = len(centres)
    extra_sh = np.zeros((n, 3, sh.shape[-1]), np.float32)
    extra_sh[np.arange(n), np.arange(n) % 3, 0] = 2.0
    extra_covs = [np.diag(np.float32([0.01, 0.6, 0.01]) ** 2)] * len(TALL_MEANS)
    extra_covs += [np.diag(np.float32(WIDE_SCALES) ** 2)] * (n - len(TALL_MEANS))
    extra = (np.asarray(centres, np.float32), np.stack(extra_covs), extra_sh,
             np.full(n, opacity, np.float32))
    return [np.concatenate([a, b]).astype(np.float32) for a, b in
            zip((means, covs, sh, op), extra)]


def weighted_loss(color, alpha, depth):
    return color.mean() + alpha.mean() + 1e-2 * depth.mean()


def case(wide):
    """(image shape, slots a tile) of the tall or the wide case."""
    return (WIDE_SHAPE, WIDE_SLOTS) if wide else ((H, W), SLOTS)


@lru_cache(maxsize=None)
def jax_step(k, wide=False):
    """JAX's band render on a k-device mesh, jitted once a case: (outputs,
    the means' and opacities' gradients)."""
    m, (shape, slots) = create_mesh(k), case(wide)

    def loss(means, opac, covs, sh):
        out = jrs.render_erp_sharded(means, covs, sh, opac, jnp.eye(4), shape, m,
                                     render_depth=True, backend="jax", max_per_tile=slots)
        return weighted_loss(out.color, out.alpha, out.depth), (out.color, out.alpha, out.depth)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@lru_cache(maxsize=None)
def jax_render(k, opacity, wide=False):
    g = tall_scene(opacity, wide)
    (_, out), grads = jax_step(k, wide)(*(jnp.asarray(g[i]) for i in (0, 3, 1, 2)))
    return [np.asarray(x) for x in out], [np.asarray(x) for x in grads]


def check(k, opacity, backend, wide=False):
    """The port's band render over k emulated ranks against JAX's: colour,
    alpha, depth and the means' and opacities' gradients."""
    (ref, ref_grads), (shape, slots) = jax_render(k, opacity, wide), case(wide)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in tall_scene(opacity, wide)]
    out = prs.render_erp_sharded(*leaves, torch.eye(4), shape, mesh.Emulated(k),
                                 render_depth=True, backend=backend, max_per_tile=slots)
    weighted_loss(out.color, out.alpha, out.depth).backward()
    assert out.color.shape == (*shape, 3) and int(out.dropped) == 0
    for got, want, tol, name in zip((out.color, out.alpha, out.depth), ref,
                                    (RGB_TOL, RGB_TOL, DEPTH_TOL), ("colour", "alpha", "depth")):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, err_msg=name)
    for got, want, name in zip((leaves[0].grad, leaves[3].grad), ref_grads,
                               ("means", "opacities")):
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("opacity", OPACITIES)
def test_band_render_bins_jax_footprints(k, opacity):
    """The scan compositor on both sides; the 2 bands of 16 tile rows at
    opacity 0.2 are where the tight footprints' rows differ."""
    check(k, opacity, "jax")


def test_band_render_on_the_kernels_path_bins_jax_footprints():
    """Backend "pallas" (the fused compositor's plain version on the CPU)
    over 2 emulated ranks at opacity 0.2, against JAX's scan render."""
    check(2, 0.2, "pallas")


def wide_columns():
    """The wide splat's tile columns in 3 sigma and in its tight box, and
    each box's first column."""
    from splatter360_tpu_torch.ops.projection import project_erp
    from splatter360_tpu_torch.ops.tiling import TILE_W

    means, covs, _, op = (torch.from_numpy(x[-1:]) for x in tall_scene(0.2, wide=True))
    res = []
    for opacities in (None, op):
        p = project_erp(means, covs, torch.eye(4), WIDE_SHAPE, 0.1, opacities=opacities)
        u, rx = float(p.mean2d[0, 0]), float(p.radius[0, 0])
        first = int(np.floor((u - rx) / TILE_W))
        res.append((int(np.floor((u + rx) / TILE_W)) - first + 1, first))
    return res


def test_band_render_bins_jax_footprints_wide():
    """A wide faint splat (5 tile columns in 3 sigma, more than SPAN_W, and
    4 in its tight box, which starts a column further right) with the tall
    ones at opacity 0.2 over 2 bands of 512 x 1024, the scan compositor on
    both sides."""
    from splatter360_tpu_torch.ops.tiling import SPAN_W

    (loose, loose_first), (tight, tight_first) = wide_columns()
    assert loose > SPAN_W >= tight and loose_first < tight_first
    check(2, 0.2, "jax", wide=True)


def band_gaps(tall=True):
    """Max |band - unsharded| of colour, alpha and depth in the wide case
    (without the tall splats unless `tall`): the port over 1 and 2 bands,
    JAX over 2."""
    from splatter360_tpu.models import decoder as jdec
    from splatter360_tpu.models.types import Gaussians as JGaussians
    from splatter360_tpu_torch.models import decoder as pdec
    from splatter360_tpu_torch.models.types import Gaussians

    g, (shape, slots) = tall_scene(0.2, wide=True), case(True)
    if not tall:
        g = [np.delete(x, np.arange(N_WIDE, N_WIDE + len(TALL_MEANS)), axis=0) for x in g]
    kw = dict(render_depth=True, backend="jax", max_per_tile=slots)
    t = [torch.from_numpy(x) for x in g]
    with torch.no_grad():
        ref = pdec.render_erp_views(Gaussians(*(x[None] for x in t)), torch.eye(4)[None, None],
                                    torch.full((1, 1), 0.1), torch.full((1, 1), 10.0), shape, **kw)
        port = {k: prs.render_erp_sharded(*t, torch.eye(4), shape, mesh.Emulated(k), **kw)
                for k in (1, 2)}
    jref = jdec.render_erp_views(JGaussians(*(jnp.asarray(x)[None] for x in g)),
                                 jnp.eye(4)[None, None], jnp.full((1, 1), 0.1),
                                 jnp.full((1, 1), 10.0), shape, **kw)
    jout = jrs.render_erp_sharded(*(jnp.asarray(x) for x in g), jnp.eye(4), shape,
                                  create_mesh(2), **kw)

    def gap(o, r):
        return tuple(float(np.abs(np.asarray(getattr(o, n)) - np.asarray(getattr(r, n)[0, 0])).max())
                     for n in ("color", "alpha", "depth"))

    return {f"port, {k} band(s)": gap(o, ref) for k, o in port.items()} | {
        "JAX, 2 bands": gap(jout, jref)}


if __name__ == "__main__":
    print("the wide splat's tile columns (3 sigma, tight box), each with its first:",
          wide_columns())
    for tall in (False, True):
        for name, (c, a, d) in band_gaps(tall).items():
            print(f"{'tall and wide' if tall else 'wide'} splats, {name} against its unsharded "
                  f"render (colour / alpha / depth): {c:.3e} / {a:.3e} / {d:.3e}")
