"""The port's unfused compositor path and the 3-context-view slice vs the JAX
package.

Past the fused kernels' table budget (N > ~1.47M Gaussians, such as 3
context panoramas of 512x1024) the JAX package composites through
`_forward_kernel`/`_backward_kernel` (`_render_core`); the port takes
`_CompositeUnfused` there (ops/cuda/composite.py). Both sides are forced onto
that path at test sizes by lowering their budgets (`_FUSED_VMEM_BUDGET`,
`FUSED_TABLE_BUDGET`). The JAX side runs its Pallas kernels in interpret
mode; on the CPU the port takes its plain versions. Inputs are made from
seeds with numpy. Bars: rgb/alpha 1e-4, depth 5e-4 and gradients 2e-3 of
max|g|, the bars the JAX package holds its two compositor backends to
(tests/test_pallas_composite.py:44-71); encoder outputs 1e-4 of max|x|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import ATOL_DEPTH, ATOL_RGB, saturating_scene, scene, tt
from test_torch_serve import ENC_KW, assert_bars_but_gate_flips, rand_params, rel_err
from test_torch_train import assert_grads_close, depth_with_holes

import splatter360_tpu.ops.pallas.composite as pc
from splatter360_tpu.ops.rasterizer import render_tiled as j_render
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.rasterizer import render_tiled as t_render

torch.set_num_threads(2)
H, W = 64, 256
N_2VIEW, N_3VIEW = 2 * 512 * 1024, 3 * 512 * 1024


@pytest.fixture
def unfused(monkeypatch):
    """JAX in interpret mode; both packages past their fused budgets."""
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
    monkeypatch.setattr(pc, "_FUSED_VMEM_BUDGET", 1)
    monkeypatch.setattr(tc, "FUSED_TABLE_BUDGET", 0)


def spy(monkeypatch, module, name, calls):
    """Record each call of module.name, (arguments, output), in calls[name]."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        calls.setdefault(name, []).append((a, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("n", [N_2VIEW, N_3VIEW])
def test_use_fused_matches_jax(n):
    """The port chooses the fused or unfused kernels at the JAX threshold:
    2 context panoramas of 512x1024 fused, 3 unfused."""
    assert tc.nsub(n) == pc._nsub(n)
    assert tc.fused_table_bytes(n) == pc._fused_table_bytes(n)
    assert tc.use_fused(n) == pc._use_fused(n) == (n == N_2VIEW)


def leaves(g):
    return [g[k] for k in ("means", "covariances", "harmonics", "opacities")]


def smooth_loss(color, alpha, depth):
    return ((color - 0.5) ** 2).sum() + 0.1 * alpha.sum() + 0.01 * depth.sum()


def planes_loss(planes):
    """smooth_loss of the images of planes [T, 8, 2048] over a black
    background, when the tiles cover the image exactly."""
    return smooth_loss(planes[:, 0:3], 1.0 - planes[:, 4], planes[:, 3])


def random_reference():
    """test_torch_render's random scene at 1,000 Gaussians (up to 4 blocks a
    tile) through JAX's render_tiled on the unfused Pallas path, jitted: the
    images and smooth_loss's gradients to means, covariances, harmonics and
    opacities."""
    shape, g = (H, W), scene(1000)

    def j_loss(*x):
        out = j_render(*x, jnp.eye(4), shape, camera_kind="erp", backend="pallas",
                       render_depth=True)
        return smooth_loss(out.color, out.alpha, out.depth), (out.color, out.alpha, out.depth)

    (_, images), grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in leaves(g)))
    return dict(shape=shape, g=g, images=[np.asarray(x) for x in images],
                grads=[np.asarray(x) for x in grads])


def saturating_reference():
    """test_torch_render's saturating scene through JAX's unfused
    compositor `_render_core` on the attribute table and binning of JAX's
    projection, both jitted: the planes and planes_loss's gradient to the
    table, which the port's compositor then takes too. Compositor level,
    because the scene is ill-conditioned upstream: the last bit of a
    projected centre decides whole weights, and the jitted and eager JAX
    renders differ by ~0.5 in colour (ROADMAP Queue 3)."""
    from splatter360_tpu.ops.projection import project_erp as j_project
    from splatter360_tpu.ops.projection import sh_colors as j_sh_colors
    from splatter360_tpu.ops.tiling import assign_tiles as j_assign

    shape, g = saturating_scene()
    means, covs, sh, op = (jnp.asarray(x) for x in leaves(g))

    @jax.jit
    def inputs(means, covs, sh, op):
        p = j_project(means, covs, jnp.eye(4), shape, 0.1, opacities=op)
        asg = j_assign(p, shape, True)
        colors = j_sh_colors(sh, means, jnp.zeros(3), 2)
        attrs_t = pc._build_attrs_t(p.mean2d, p.conic, colors, op, p.depth, p.radius)  # [16, N]
        return attrs_t, (asg.gaussian_idx, asg.tile_starts, asg.tile_counts, asg.tile_ids)

    attrs_t, seg = inputs(means, covs, sh, op)
    nty, ntx = -(-shape[0] // tc.TILE_H), -(-shape[1] // tc.TILE_W)

    def j_loss(attrs_t):
        acc = pc._render_core(means.shape[0], attrs_t, *seg, nty, ntx, float(shape[1]), True)
        planes = acc.reshape(nty * ntx, 8, tc.N_PIX)
        return planes_loss(planes), planes

    (_, planes), grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(attrs_t)
    return dict(attrs=np.asarray(attrs_t).T, seg=[np.asarray(x)[None] for x in seg],
                nty=nty, ntx=ntx, w=float(shape[1]), planes=np.asarray(planes),
                grad=np.asarray(grad).T)


@pytest.fixture(scope="module", params=["random", "saturating"])
def jax_unfused(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
        mp.setattr(pc, "_FUSED_VMEM_BUDGET", 1)
        ref = random_reference() if request.param == "random" else saturating_reference()
    return dict(ref, kind=request.param)


def port_planes(ref, requires_grad=False):
    """The port's _CompositeUnfused on the saturating reference's table."""
    attrs = torch.tensor(ref["attrs"], requires_grad=requires_grad)
    gidx, starts, counts, tile_ids = (torch.as_tensor(x) for x in ref["seg"])
    planes = tc._CompositeUnfused.apply(attrs[None], gidx, tile_ids, starts, counts, ref["nty"],
                                        ref["ntx"], ref["w"], True)
    return attrs, starts[0].numpy(), counts[0].numpy(), planes[0]


def test_unfused_forward_vs_jax(jax_unfused, unfused, monkeypatch):
    """The port's unfused path (pack + plain forward, never the fused plain
    version) against JAX's unfused path: the random scene's images through
    render_tiled, the saturating scene's planes through the compositor, at
    the compositor bars. n_processed: the Pallas interpreter walks every
    block of a tile (ROADMAP Queue 3), so JAX's plane holds each tile's
    block count; the port's equals it where no tile saturates (random) and
    stops exactly where every pixel's logT fell below log(1e-4)
    (saturating)."""
    ref = jax_unfused
    calls = {}
    spy(monkeypatch, tc, "composite_forward_unfused", calls)
    monkeypatch.setattr(tc, "composite_forward_plain", None)  # the fused path would fail
    if ref["kind"] == "random":
        got = t_render(*(tt(x) for x in leaves(ref["g"])), torch.eye(4), ref["shape"],
                       render_depth=True)
        for name, want, atol in zip(("color", "alpha", "depth"), ref["images"],
                                    (ATOL_RGB, ATOL_RGB, ATOL_DEPTH)):
            np.testing.assert_allclose(getattr(got, name).numpy(), want, atol=atol, err_msg=name)
        ((_, starts, counts, *_), planes), = calls["composite_forward_unfused"]
        starts, counts, planes = starts[0].numpy(), counts[0].numpy(), planes[0].numpy()
    else:
        _, starts, counts, planes = port_planes(ref)
        planes = planes.numpy()
        for plane, atol in ((0, ATOL_RGB), (1, ATOL_RGB), (2, ATOL_RGB), (3, ATOL_DEPTH),
                            (4, ATOL_RGB)):
            np.testing.assert_allclose(planes[:, plane], ref["planes"][:, plane], atol=atol)
        assert len(calls["composite_forward_unfused"]) == 1
    nproc = planes[:, 6, 0]
    n_blocks = (starts + counts + tc.CHUNK - 1) // tc.CHUNK - starts // tc.CHUNK
    if ref["kind"] == "random":
        np.testing.assert_array_equal(nproc, n_blocks)
    else:
        np.testing.assert_array_equal(ref["planes"][:, 6, 0], n_blocks)
        exited = nproc < n_blocks
        assert exited.any(), "the per-tile early exit never fired"
        assert (planes[exited, 5].max(axis=1) < tc._LOG_T_EPS).all()


def test_unfused_backward_smooth_vs_jax(jax_unfused, unfused, monkeypatch):
    """Gradients of a colour MSE + alpha + depth loss through
    _CompositeUnfused (plain backward, map and scatter) against JAX's
    unfused Pallas backward: on the random scene to means, covariances,
    harmonics and opacities through render_tiled, on the saturating scene
    to each row of the attribute table. The [*-random] cotangents are held
    against JAX autograd in tests/test_torch_train.py::
    test_render_backward_vs_jax, which also runs the unfused path."""
    ref = jax_unfused
    calls = {}
    spy(monkeypatch, tc, "scatter_out_blocks", calls)
    if ref["kind"] == "random":
        x = [torch.tensor(a, requires_grad=True) for a in leaves(ref["g"])]
        out = t_render(*x, torch.eye(4), ref["shape"], render_depth=True)
        smooth_loss(out.color, out.alpha, out.depth).backward()
        assert_grads_close(ref["grads"], [a.grad.numpy() for a in x],
                           ["means", "covariances", "harmonics", "opacities"])
    else:
        attrs, _, _, planes = port_planes(ref, requires_grad=True)
        planes_loss(planes).backward()
        rows = "u v a b c o r g b depth".split()
        assert_grads_close(ref["grad"][:, :tc.N_GRAD].T, attrs.grad[:, :tc.N_GRAD].T.numpy(), rows)
        assert not attrs.grad[:, tc.N_GRAD:].any()
    assert len(calls["scatter_out_blocks"]) == 1


def compositor_inputs(kind, views):
    """attrs, gidx, tile_ids, starts, counts (V views) of a scene, built as
    render_batch builds them."""
    from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
    from splatter360_tpu_torch.ops.tiling import assign_tiles

    shape, g = ((H, W), scene(1000)) if kind == "random" else saturating_scene()
    means, covs, sh, op = (tt(x) for x in leaves(g))
    attrs, asg = [], []
    for i in range(views):
        c2w = torch.eye(4)
        c2w[:3, 3] = torch.tensor([0.05 * i, -0.03 * i, 0.0])
        p = project_erp(means, covs, c2w, shape, 0.1, opacities=op)
        asg.append(assign_tiles(p, shape, True))
        attrs.append(tc.build_attrs(p.mean2d, p.conic, sh_colors(sh, means, c2w[:3, 3], 2), op,
                                    p.depth, p.radius))
    stack = lambda f: torch.stack([f(a) for a in asg])  # noqa: E731
    return (torch.stack(attrs), stack(lambda a: a.gaussian_idx), stack(lambda a: a.tile_ids),
            stack(lambda a: a.tile_starts), stack(lambda a: a.tile_counts),
            asg[0].num_tiles_y, asg[0].num_tiles_x, float(shape[1]))


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_unfused_plain_equals_fused(kind):
    """On the same inputs (two views of the random scene, one of the
    saturating one) the plain unfused forward equals the
    plain fused forward exactly; the unfused backward (plain kernel, map,
    scatter) matches the fused one within 1e-6 of max|g| per row (only the
    order of the sums over tiles differs). Each processed block has exactly
    one live out-block, and the out-blocks the kernel never writes (NaN in
    the plain version) stay out of the gradients."""
    attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img = compositor_inputs(
        kind, views=2 if kind == "random" else 1)
    n = attrs.shape[1]
    inst = tc.pack_instances(attrs, gidx, tile_ids, nty * ntx)
    fused = tc.composite_forward(attrs, gidx, starts, counts, nty, ntx, w_img, True)
    planes = tc.composite_forward_unfused(inst, starts, counts, nty, ntx, w_img, True)
    assert torch.equal(planes, fused)
    nproc = planes[:, :, 6, 0].to(torch.int32)
    g_planes = torch.zeros_like(planes)
    gen = torch.Generator().manual_seed(7)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen)
    bwd = (g_planes, planes[:, :, 5].contiguous(), nproc, nty, ntx, w_img, True)
    ref = tc.composite_backward(attrs, gidx, starts, counts, *bwd)
    dout = tc.composite_backward_unfused(inst, starts, counts, *bwd)
    _, live = tc.out_block_map(starts, counts, nproc, dout.shape[1])
    assert int(live.sum()) == int(nproc.sum())
    assert not torch.isnan(dout[live]).any() and torch.isnan(dout[~live]).all()
    got = tc.scatter_out_blocks(dout, gidx, starts, counts, nproc, n)
    assert torch.isfinite(got).all() and not got[..., tc.N_GRAD:].any()
    scale = ref.abs().amax(dim=(0, 1))[: tc.N_GRAD]
    err = (got - ref).abs().amax(dim=(0, 1))[: tc.N_GRAD] / scale
    assert float(err.max()) <= 1e-6, err


V_CTX = 3
# Gaussians the 3-view tests composite, of N = 3 H W = 49,152
N_RENDERED = 2000


def three_view_request(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, V_CTX, H, W, 3)).astype(np.float32)
    ctx = np.tile(np.eye(4, dtype=np.float32), (1, V_CTX, 1, 1))
    ctx[..., :3, 3] = rng.normal(0, 0.2, (1, V_CTX, 3))
    tgt = np.eye(4, dtype=np.float32)[None, None].copy()
    tgt[..., :3, 3] = rng.normal(0, 0.1, (1, 1, 3))
    near = np.full((1, V_CTX), 0.1, np.float32)
    far = np.full((1, V_CTX), 10.0, np.float32)
    return img, ctx, tgt, near, far


@pytest.fixture
def three_view_budgets(monkeypatch):
    """Both packages' budgets at test scale: 2 context views of HxW fused,
    3 unfused, as at 512x1024."""
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
    monkeypatch.setattr(pc, "_FUSED_VMEM_BUDGET", pc._fused_table_bytes(V_CTX * H * W) - 1)
    monkeypatch.setattr(tc, "FUSED_TABLE_BUDGET", tc.fused_table_bytes(V_CTX * H * W) - 1)
    assert tc.use_fused(2 * H * W) and not tc.use_fused(V_CTX * H * W)
    assert pc._use_fused(2 * H * W) and not pc._use_fused(V_CTX * H * W)


def test_three_view_slice_vs_jax(three_view_budgets, monkeypatch):
    """3 context panoramas -> encoder -> N = 3*H*W Gaussians -> the unfused
    render, through the port's entry points and through the JAX encoder +
    render_erp_views with shared params and inputs. The target view's near
    plane keeps the farthest N_RENDERED Gaussians: all N take the CPU ~15 s
    through the plain forward and ~30 s through the Pallas interpreter."""
    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.decoder import render_erp_views as j_render_views
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes
    from splatter360_tpu_torch import serve
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.models.types import Gaussians

    img, ctx, tgt, near, far = three_view_request()
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW))
    cubes = _context_cubes(jnp.asarray(img), H // 2)
    params = rand_params(jm, img, cubes, ctx, near, far, 0)
    t_far = np.full((1, 1), 10.0, np.float32)

    @jax.jit
    def j_slice(params):
        jg, jd = jm.apply(params, img, cubes, ctx, near, far, 10**9)
        # projection keeps the Gaussians farther than 0.2 near
        dist = jnp.linalg.norm(jg.means[0] - tgt[0, 0, :3, 3], axis=-1)
        t_near = jnp.full((1, 1), jnp.sort(dist)[-N_RENDERED] / 0.2)
        out = j_render_views(jg, jnp.asarray(tgt), t_near, t_far, (H, W), render_depth=True,
                             backend="pallas")
        return jg, jd, t_near, out.color, out.alpha, out.depth, out.dropped

    jg, jd, t_near, *jout = j_slice(params)
    assert jg.means.shape[1] == V_CTX * H * W

    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    state = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model = serve.build_model(cfg, state_dict=state, device="cpu")
    tg, td = serve.encode(model, img, ctx, near, far, device="cpu")
    for name, a, b in zip(jg._fields, jg, tg):
        assert rel_err(a, b) <= 1e-4, name
    assert rel_err(jd, td) <= 1e-4

    calls = {}
    spy(monkeypatch, tc, "composite_forward_unfused", calls)
    out = serve.render_erp_views(Gaussians(*(np.asarray(x) for x in jg)), tgt, np.asarray(t_near),
                                 t_far, (H, W), render_depth=True, device="cpu")
    assert len(calls["composite_forward_unfused"]) == 1
    j_color, j_alpha, j_depth, j_dropped = (np.asarray(x) for x in jout)
    np.testing.assert_allclose(out.alpha.numpy(), j_alpha, atol=ATOL_RGB)
    assert float(out.alpha.max()) > 0.5
    assert_bars_but_gate_flips(j_color, out.color, ATOL_RGB, float(np.abs(j_color).max()))
    assert_bars_but_gate_flips(j_depth, out.depth, ATOL_DEPTH, float(t_far.max()))
    np.testing.assert_array_equal(out.dropped.numpy(), j_dropped)


def test_three_view_train_step(three_view_budgets, monkeypatch):
    """One CPU train step of the port with 3 context panoramas through the
    unfused path (one forward, one backward): finite metrics, and every
    parameter moves."""
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    rng = np.random.default_rng(12)
    batch = {}
    # the target's near plane 7.5 keeps the Gaussians past 1.5, ~3% of them
    # with these weights (see test_three_view_slice_vs_jax)
    for part, v, near in (("context", V_CTX, 0.1), ("target", 1, 7.5)):
        pose = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
        pose[..., :3, 3] = rng.normal(0, 0.2, (1, v, 3))
        batch[part] = dict(image_sphere=rng.uniform(0, 1, (1, v, H, W, 3)).astype(np.float32),
                           extrinsics_sphere=pose, depth_sphere=depth_with_holes(rng, (1, v, H, W)),
                           near=np.full((1, v), near, np.float32),
                           far=np.full((1, v), 10.0, np.float32))
    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    state = create_train_state(cfg, TrainConfig(supervision="erp"), seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    calls = {}
    for name in ("composite_forward_unfused", "composite_backward_unfused"):
        spy(monkeypatch, tc, name, calls)
    metrics = train_step(state, batch)
    assert {k: len(v) for k, v in calls.items()} == {"composite_forward_unfused": 1,
                                                     "composite_backward_unfused": 1}
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    still = [k for k, p in state.model.named_parameters() if torch.equal(p, before[k])]
    assert not still, still[:10]


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_unfused.py: the two
    # behaviours of the reference that shaped this file (ROADMAP Queue 3), ~2 min.
    pc.pl.pallas_call = functools.partial(pc.pl.pallas_call, interpret=True)
    pc._FUSED_VMEM_BUDGET = 1
    tc.FUSED_TABLE_BUDGET = 0

    # 1. On the random scene at 2,000 Gaussians the unfused Pallas backward's
    # moment sums stray from JAX autograd of the jax compositor even on the
    # smooth loss; the port's direct sums do not.
    shape, g = (H, W), scene(2000)

    def j_grads(backend):
        def j_loss(*x):
            out = j_render(*x, jnp.eye(4), shape, camera_kind="erp", backend=backend,
                           render_depth=True, max_per_tile=4096)
            return smooth_loss(out.color, out.alpha, out.depth)

        return [np.asarray(x) for x in jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
            *(jnp.asarray(x) for x in leaves(g)))]

    autograd, pallas = j_grads("jax"), j_grads("pallas")
    x = [torch.tensor(a, requires_grad=True) for a in leaves(g)]
    out = t_render(*x, torch.eye(4), shape, render_depth=True)
    smooth_loss(out.color, out.alpha, out.depth).backward()
    for name, a, p, t in zip(("means", "covariances", "harmonics", "opacities"), autograd, pallas,
                             x):
        scale = np.abs(a).max()
        print(f"{name}: distance to JAX autograd in max|g|: unfused Pallas "
              f"{np.abs(p - a).max() / scale:.3e}, port {np.abs(t.grad.numpy() - a).max() / scale:.3e}")

    # 2. The saturating scene's render is not the same function jitted and
    # eager in JAX (both on its jax compositor); the port agrees with eager.
    shape, g = saturating_scene()

    def images(*x):
        out = j_render(*x, jnp.eye(4), shape, camera_kind="erp", backend="jax", render_depth=True,
                       max_per_tile=4096)
        return out.color, out.alpha

    args = [jnp.asarray(x) for x in leaves(g)]
    eager, jitted = images(*args), jax.jit(images)(*args)
    port = t_render(*(tt(x) for x in leaves(g)), torch.eye(4), shape)
    diff = np.abs(np.asarray(eager[0]) - np.asarray(jitted[0])).max(-1)
    print(f"saturating scene, colour: |eager - jitted| max {diff.max():.3e} over "
          f"{int((diff > 1e-3).sum())} pixels; alpha {np.abs(eager[1] - jitted[1]).max():.3e}; "
          f"port vs eager {np.abs(port.color.numpy() - np.asarray(eager[0])).max():.3e}, "
          f"port vs jitted {np.abs(port.color.numpy() - np.asarray(jitted[0])).max():.3e}")
