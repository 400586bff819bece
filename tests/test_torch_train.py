"""The port's training slice vs the JAX package: the compositor's backward,
losses, metrics, LPIPS, the optimizer and one train step.

The JAX side runs its Pallas kernels in interpret mode (patched as in
tests/test_torch_serve.py); on the CPU the port takes its plain compositor
backward. Inputs are made from seeds with numpy and fed to both. Bars:
gradients within 2e-3 of max|g|, the bar the JAX package holds its own two
compositor backends to (tests/test_pallas_composite.py:66-71).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatter360_tpu.ops.pallas.composite as pc
from splatter360_tpu.geometry.transforms import build_covariance_sym6 as j_cov6
from splatter360_tpu.ops.rasterizer import render_tiled as j_render
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.rasterizer import render_tiled as t_render

torch.set_num_threads(2)
GRAD_TOL = 2e-3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))


def random_scene():
    """numpy-seeded counterpart of tests/test_pallas_composite.py's scene
    (random_gaussians(PRNGKey(1), 200, sh_degree=2): radius 0.5-6, scales
    0.01-0.12), at 64x256."""
    n = 200
    rng = np.random.default_rng(1)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.5, 6.0, (n, 1))
    q = rng.normal(size=(n, 4))
    covs = j_cov6(jnp.asarray(rng.uniform(0.01, 0.12, (n, 3)), jnp.float32),
                  jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True), jnp.float32))
    sh = 0.3 * rng.normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    g = (means, np.asarray(covs), sh, rng.uniform(0.3, 0.95, n))
    return (64, 256), [np.asarray(x, np.float32) for x in g]


def saturating_scene():
    """tests/test_pallas_composite.py::_saturating_scene with numpy-seeded SH:
    dense opaque blobs over every pixel of a 32x256 view, so tiles saturate,
    the forward exits early and the backward gate skips blocks."""
    hh, ww = 32, 256
    focal = ww / (2 * math.pi)
    means, scales = [], []
    for d in np.linspace(1.0, 6.0, 40):
        for u in np.arange(6.0, 128.0, 12.0):
            for vv in np.arange(2.5, 32.0, 5.0):
                theta = (0.5 - (u + 0.5) / ww) * 2 * math.pi
                phi = (0.5 - (vv + 0.5) / hh) * math.pi
                means.append(d * np.array([math.cos(phi) * math.sin(theta), math.sin(phi),
                                           math.cos(phi) * math.cos(theta)]))
                scales.append([10.0 * d / focal] * 3)
    n = len(means)
    covs = j_cov6(jnp.asarray(scales, jnp.float32), jnp.tile(jnp.array([0.0, 0, 0, 1]), (n, 1)))
    sh = 0.3 * np.random.default_rng(8).normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    g = (np.array(means), np.asarray(covs), sh, np.full(n, 0.92))
    return (hh, ww), [np.asarray(x, np.float32) for x in g]


def assert_grads_close(ref, got, names, tol=GRAD_TOL):
    for a, b, name in zip(ref, got, names):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all(), f"{name}: non-finite gradient"
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=tol, err_msg=name)


@pytest.mark.parametrize("loss", ["smooth", "random"])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_render_backward_vs_jax(interpret, kind, loss):
    """Gradients of colour, alpha and depth (every cotangent plane non-zero)
    to means, covariances, harmonics and opacities, through the port's
    render_tiled (plain backward on the CPU).

    "smooth": a colour MSE + alpha + depth loss against the fused Pallas
    backward. "random": random weights on every output pixel against JAX
    autograd of its jax compositor, which computes the same function here
    (no alpha reaches the 0.99 cap, where the two JAX backends differ). The
    Pallas backward is not the reference there: it recovers each Gaussian's
    quadratic pixel sums from tile-local moments, which cancel when the
    cotangents change sign. The test also measures how far the Pallas
    backward strays from that autograd, prints it beside the port's
    distance, and holds the port to be the nearer of the two; and it holds
    the port's unfused path (_CompositeUnfused) to the same autograd."""
    shape, g = random_scene() if kind == "random" else saturating_scene()
    rng = np.random.default_rng(3)
    weights = [rng.normal(size=(*shape, 3)), rng.normal(size=shape), 0.1 * rng.normal(size=shape)]
    weights = [w.astype(np.float32) for w in weights]

    def total(color, alpha, depth, as_array):
        if loss == "smooth":
            return ((color - 0.5) ** 2).sum() + 0.1 * alpha.sum() + 0.01 * depth.sum()
        wc, wa, wd = (as_array(w) for w in weights)
        return (color * wc).sum() + (alpha * wa).sum() + (depth * wd).sum()

    def j_grads(backend):
        def j_loss(means, covs, sh, op):
            out = j_render(means, covs, sh, op, jnp.eye(4), shape, camera_kind="erp",
                           backend=backend, render_depth=True, max_per_tile=4096)
            return total(out.color, out.alpha, out.depth, jnp.asarray)

        grads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in g))
        return [np.asarray(x) for x in grads]

    names = ["means", "covariances", "harmonics", "opacities"]
    ref = j_grads("pallas" if loss == "smooth" else "jax")
    leaves = [torch.tensor(x, requires_grad=True) for x in g]
    before = dict(tc.launch_counts)
    out = t_render(*leaves, torch.eye(4), shape, render_depth=True)
    total(out.color, out.alpha, out.depth, torch.from_numpy).backward()
    assert tc.launch_counts == before  # CPU tensors take the plain versions
    got = [x.grad.numpy() for x in leaves]
    assert_grads_close(ref, got, names)
    if loss == "random":
        def dist(grads):
            return [np.abs(a - b).max() / np.abs(b).max() for a, b in zip(grads, ref)]

        port, pallas = dist(got), dist(j_grads("pallas"))
        print(f"{kind}: distance to JAX autograd in max|g| (means, covariances, harmonics, "
              f"opacities): port {[f'{x:.2e}' for x in port]}, "
              f"Pallas {[f'{x:.2e}' for x in pallas]}")
        assert max(port) < max(pallas)

        # the unfused path (_CompositeUnfused, taken past the fused budget)
        # against the same reference
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tc, "FUSED_TABLE_BUDGET", 0)
            unfused = [torch.tensor(x, requires_grad=True) for x in g]
            out = t_render(*unfused, torch.eye(4), shape, render_depth=True)
            total(out.color, out.alpha, out.depth, torch.from_numpy).backward()
        assert_grads_close(ref, [x.grad.numpy() for x in unfused], names)


def close(ref, got, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=0)


def depth_with_holes(rng, shape):
    """Depths in [0.5, 5] with ~8% holes (0) in blobs, as real sensors leave."""
    d = rng.uniform(0.5, 5.0, shape)
    holes = rng.uniform(size=shape) < 0.02
    for axis in (-1, -2):
        holes = holes | np.roll(holes, 1, axis=axis) | np.roll(holes, -1, axis=axis)
    return np.where(holes, 0.0, d).astype(np.float32)


def test_losses_vs_jax():
    """erode, the sin-weighted depth L1 (with holes), the ERP MSE and PSNR:
    float32 on both sides, the same operations; 1e-6 relative. The images
    are 16x64, so the float32 sums (taken in another order than XLA's) stay
    inside that bar."""
    from splatter360_tpu.train import losses as jl
    from splatter360_tpu.train.metrics import compute_psnr as j_psnr
    from splatter360_tpu_torch.train import losses as tl
    from splatter360_tpu_torch.train.metrics import compute_psnr as t_psnr

    rng = np.random.default_rng(4)
    b, v, h, w = 1, 2, 16, 64
    gt_depth = depth_with_holes(rng, (b, v, h, w))
    pred_depth = rng.uniform(0.1, 10.0, (b, v, h, w)).astype(np.float32)
    far = np.full((b, v), 10.0, np.float32)
    mask = (gt_depth > 0.1).astype(np.float32)
    assert 0.02 < 1 - mask.mean() < 0.3
    np.testing.assert_array_equal(tl.erode(torch.from_numpy(mask)).numpy(), np.asarray(jl.erode(mask)))
    close(jl.sin_weighted_depth_l1(pred_depth, gt_depth, far),
          tl.sin_weighted_depth_l1(*(torch.from_numpy(x) for x in (pred_depth, gt_depth, far))), 1e-6)

    pred = rng.uniform(-0.1, 1.1, (b, v, h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32)
    rows = jnp.sin((jnp.arange(h, dtype=jnp.float32) + 0.5) * math.pi / h)[None, None, :, None, None]
    j_mse = jnp.sum(((pred - gt) ** 2) * rows) / (jnp.sum(rows) * b * v * w * 3)  # state.py:267-272
    close(j_mse, tl.sin_weighted_mse(torch.from_numpy(pred), torch.from_numpy(gt)), 1e-6)
    flat_p, flat_g = pred.reshape(-1, h, w, 3), gt.reshape(-1, h, w, 3)
    close(j_psnr(flat_g, flat_p), t_psnr(torch.from_numpy(flat_g), torch.from_numpy(flat_p)), 1e-6)


def test_ssim_and_depth_metrics_vs_jax():
    """skimage-exact SSIM and the masked depth metrics; 1e-5."""
    from splatter360_tpu.train.metrics import compute_depth_metrics as j_depth
    from splatter360_tpu.train.metrics import compute_ssim as j_ssim
    from splatter360_tpu_torch.train.metrics import compute_depth_metrics as t_depth
    from splatter360_tpu_torch.train.metrics import compute_ssim as t_ssim

    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, (2, 40, 48, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(t_ssim(torch.from_numpy(gt), torch.from_numpy(pred)).numpy(),
                               np.asarray(j_ssim(gt, pred)), rtol=1e-5, atol=1e-5)
    d_gt = depth_with_holes(rng, (2, 32, 64))
    d_pred = (d_gt * rng.uniform(0.8, 1.25, d_gt.shape) + 0.05).astype(np.float32)
    m = d_gt > 0.1
    ref = j_depth(d_gt, d_pred, m)
    got = t_depth(torch.from_numpy(d_gt), torch.from_numpy(d_pred), torch.from_numpy(m))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def flax_rand(shapes, rng, lin_scale=1.0):
    """Seeded random values for a Flax param tree: kernels N(0, 1/fan_in),
    biases 0.1 N(0, 1), other vectors (LPIPS lin) uniform(-1, 1) / C, whose
    sign the LPIPS |lin| must drop."""
    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            x = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "bias":
            x = 0.1 * rng.normal(size=s.shape)
        else:
            x = lin_scale * rng.uniform(-1, 1, s.shape) / s.shape[-1]
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lpips_params(seed=6):
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS

    probe = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: JLPIPS().init(jax.random.PRNGKey(0), probe, probe))
    return flax_rand(shapes, np.random.default_rng(seed))


def test_lpips_vs_flax():
    """LPIPS with the same (converted) params on 2x64x64 images; 1e-5
    relative (float32 convolutions in another summation order)."""
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS
    from splatter360_tpu_torch.convert import lpips_state_from_flax
    from splatter360_tpu_torch.train.lpips import LPIPS

    params = lpips_params()
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    ref = np.asarray(jax.jit(JLPIPS().apply)(params, a, b))
    model = LPIPS()
    model.load_state_dict(lpips_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = model(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("max_steps", [2, 7, 100000])
def test_learning_rate_vs_optax(max_steps):
    """The schedule of the JAX make_optimizer (optax cosine_onecycle with
    pct_start max(0.01, 1.001/steps)) at sampled steps; 1e-6 relative."""
    import optax

    from splatter360_tpu_torch.train.state import OptimizerConfig, learning_rate

    steps = max(max_steps, 2)
    sched = optax.cosine_onecycle_schedule(transition_steps=steps, peak_value=2e-4,
                                           pct_start=max(0.01, 1.001 / steps))
    edge = int(max(0.01, 1.001 / steps) * steps)
    counts = sorted({0, 1, edge - 1, edge, edge + 1, steps // 2, steps - 2, steps - 1, steps,
                     steps + 5, *np.random.default_rng(max_steps).integers(0, steps, 20).tolist()})
    cfg = OptimizerConfig(lr=2e-4, max_steps=max_steps)
    for c in (c for c in counts if c >= 0):
        close(sched(jnp.int32(c)), learning_rate(cfg, c), 1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_vs_optax(scale):
    """optax.clip_by_global_norm(0.5), below and above the threshold."""
    import optax

    from splatter360_tpu_torch.train.state import clip_by_global_norm_

    rng = np.random.default_rng(8)
    leaves = [(scale * rng.normal(size=s) / 10).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(x) for x in leaves], None)
    got = [torch.from_numpy(x.copy()) for x in leaves]
    norm = clip_by_global_norm_(got, 0.5)
    close(optax.global_norm([jnp.asarray(x) for x in leaves]), norm, 1e-6)
    assert (float(norm) >= 0.5) == (scale > 1)
    for r, g in zip(ref, got):
        close(r, g, 1e-6)


STEP_H, STEP_W = 64, 256


def step_batch(seed=9):
    """tests/test_models.py::tiny_batch at 64x256 (B = 1, 2 context and 2
    target views), with holes in the context depth."""
    rng = np.random.default_rng(seed)
    ex = {}
    for part, v in (("context", 2), ("target", 2)):
        poses = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
        poses[..., :3, 3] = rng.normal(0, 0.2, (1, v, 3))
        ex[part] = {
            "extrinsics_sphere": poses,
            "image_sphere": rng.uniform(0, 1, (1, v, STEP_H, STEP_W, 3)).astype(np.float32),
            "depth_sphere": depth_with_holes(rng, (1, v, STEP_H, STEP_W)),
            "near": np.full((1, v), 0.1, np.float32),
            "far": np.full((1, v), 10.0, np.float32),
        }
    return ex


def keep_grads(inner):
    """An optax transformation that is `inner` and also keeps each update's
    incoming (unclipped) gradients in its state."""
    import optax

    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


def jax_steps():
    """Two steps of the JAX make_train_step(supervision="erp",
    render_backend="pallas") on the tiny config of tests/test_models.py,
    with seeded random params (encoder and LPIPS), Pallas in interpret
    mode."""
    from test_torch_serve import ENC_KW, rand_params

    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train import state as js
    from splatter360_tpu.train.losses import LossConfig as JLossConfig
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS

    batch = step_batch()
    ctx = batch["context"]
    jcfg = JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW)
    jm = JEncoder(jcfg)
    cubes = js._context_cubes(jnp.asarray(ctx["image_sphere"]), STEP_H // 2)
    params = rand_params(jm, ctx["image_sphere"], cubes, ctx["extrinsics_sphere"], ctx["near"],
                         ctx["far"], 0)
    tcfg = js.TrainConfig(optimizer=js.OptimizerConfig(max_steps=100),
                          loss=JLossConfig(lpips_weight=0.05, depth_weight=0.1),
                          supervision="erp", render_backend="pallas")
    tx = keep_grads(js.make_optimizer(tcfg.optimizer))
    lp = lpips_params()
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          lpips_params=lp, tx=tx, apply_fn=jm.apply, lpips_apply_fn=JLPIPS().apply)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
        step = jax.jit(js.make_train_step(jcfg, tcfg))
        s1, m1 = step(state, batch)
        s2, m2 = step(s1, batch)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(batch=batch, params=to_np(params), lpips=to_np(lp), metrics=[to_np(m1), to_np(m2)],
                grads=[to_np(s1.opt_state[1]), to_np(s2.opt_state[1])], params2=to_np(s2.params),
                lr=tcfg.optimizer.lr)


@pytest.fixture(scope="module")
def jax_two_steps():
    """jax_steps(), built once: compiling the step is the cost."""
    return jax_steps()


def port_state(ref, state_dict=None):
    """The port's train state with the JAX run's config, LPIPS params and
    (unless `state_dict` is given) encoder params, on the CPU."""
    from test_torch_serve import ENC_KW

    from splatter360_tpu_torch.convert import lpips_state_from_flax, torch_state_from_flax
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.losses import LossConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, TrainConfig, create_train_state

    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    tcfg = TrainConfig(optimizer=OptimizerConfig(max_steps=100),
                       loss=LossConfig(lpips_weight=0.05, depth_weight=0.1), supervision="erp")
    return create_train_state(cfg, tcfg, device="cpu",
                              state_dict=state_dict or torch_state_from_flax(ref["params"]),
                              lpips_state=lpips_state_from_flax(ref["lpips"]))


# The step-1 gradient of this tiny step jumps by ~3e-3 of max|g| on a few
# leaves under a 1e-6 relative perturbation of the params (most likely a
# binning or gate decision of the renderer flipping on a Gaussian's last
# bit). JAX and the port sit on
# either side of one such jump on this leaf: their distance there equals the
# jump (ROADMAP Queue 3; running this file as a script measures it).
# It is held at a fixed bar above that one jump; every other leaf at GRAD_TOL.
JUMP_TOL = {"backbone_erp.CNNEncoder_0.ResidualBlock_3.Conv_1.weight": 3.5e-3}


def test_train_step_vs_jax(jax_two_steps):
    """Two train steps of the port (plain compositor on the CPU) from the
    same params and batch as the JAX steps: every metric of both steps at
    1e-4 relative (step 2's also hold update 1, at lr/25); step-1 gradients
    per parameter tensor within 2e-3 of the global max|g| (JUMP_TOL names
    the one exception); the params after two steps within 4 lr; and update
    2 itself: p2 - p0 of both sides within lr/10, on the elements whose
    gradients of both steps are at least 1e-2 of max|g|, where Adam moves
    each by ~lr sign(g) and the gradients' differences cannot turn it. A
    port that skipped, flipped or mis-scaled that update fails."""
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train.state import train_step

    ref = jax_two_steps
    state = port_state(ref)
    p0 = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    grads = {}

    def keep(stage):
        if stage == "backward" and not grads:
            grads.update({k: p.grad.clone() for k, p in state.model.named_parameters()})

    before = dict(tc.launch_counts)
    for i in range(2):
        got = train_step(state, ref["batch"], on_stage=keep)
        assert set(got) == set(ref["metrics"][i])
        for k, v in ref["metrics"][i].items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=f"step {i + 1} {k}")
    assert state.step == 2 and tc.launch_counts == before

    ref_g1, ref_g2 = (torch_state_from_flax(g) for g in ref["grads"])
    assert set(ref_g1) == set(grads)
    scale = max(float(g.abs().max()) for g in ref_g1.values())
    rows = sorted(((float((grads[k] - g).abs().max()) / scale, k) for k, g in ref_g1.items()),
                  reverse=True)
    print("step-1 gradient, leaves farthest from JAX (in max|g|):",
          [(f"{d:.2e}", k) for d, k in rows[:3]])
    for d, k in rows:
        assert d <= JUMP_TOL.get(k, GRAD_TOL), (k, d)

    lr, checked, worst = ref["lr"], 0, 0.0
    now = dict(state.model.named_parameters())
    for k, p2 in torch_state_from_flax(ref["params2"]).items():
        np.testing.assert_allclose(now[k].detach().numpy(), p2.numpy(), atol=4 * lr, err_msg=k)
        firm = (ref_g1[k].abs() >= 1e-2 * scale) & (ref_g2[k].abs() >= 1e-2 * scale)
        diff = ((now[k].detach() - p0[k]) - (p2 - p0[k])).abs()[firm]
        checked += int(firm.sum())
        if diff.numel():
            worst = max(worst, float(diff.max()))
    print(f"update 2: {checked} elements, largest |port - JAX| {worst:.3e} (bar {lr / 10:g})")
    assert checked >= 100_000 and worst <= lr / 10


@pytest.mark.parametrize("step", [0, 1, 5, 10**9])
def test_opacity_warm_up_vs_jax(step):
    """map_pdf_to_opacity on the warm-up branch (initial != final), which the
    train step reaches at its small step counts: float32 fraction and
    exponent as JAX computes them from its int32 step; 1e-6 relative."""
    from splatter360_tpu.models.adapter import map_pdf_to_opacity as j_map
    from splatter360_tpu_torch.models.adapter import map_pdf_to_opacity as t_map

    pdf = np.random.default_rng(11).uniform(1e-4, 1.0, 4096).astype(np.float32)
    ref = j_map(jnp.asarray(pdf), jnp.int32(step), -1.0, 2.0, 7)
    close(ref, t_map(torch.from_numpy(pdf), step, -1.0, 2.0, 7), 1e-6)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train.py: how far the port's
    # step-1 gradient moves per leaf when its params are scaled by
    # 1 + 1e-6 N(0, 1) (two noise seeds), beside each leaf's distance to
    # JAX and the cosine between the two differences (~3 min).
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train.state import compute_losses

    ref = jax_steps()
    params = torch_state_from_flax(ref["params"])
    ref_g = torch_state_from_flax(ref["grads"][0])
    scale = max(float(g.abs().max()) for g in ref_g.values())

    def port_grads(state_dict):
        state = port_state(ref, state_dict)
        compute_losses(state, ref["batch"])[0].backward()
        return {k: p.grad for k, p in state.model.named_parameters()}

    base = port_grads(params)
    to_jax = {k: ref_g[k] - g for k, g in base.items()}
    for seed in (10, 11):
        gen = torch.Generator().manual_seed(seed)
        moved = port_grads({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                            for k, v in params.items()})
        rows = []
        for k, g in base.items():
            jump, dist = moved[k] - g, to_jax[k]
            cos = float((jump * dist).sum() / (jump.norm() * dist.norm()).clamp(min=1e-30))
            rows.append((float(jump.abs().max()) / scale, float(dist.abs().max()) / scale, cos, k))
        print(f"noise seed {seed}, the leaves that move most and those of JUMP_TOL (jump, "
              f"distance to JAX, cosine, in max|g|):")
        rows.sort(reverse=True)
        for jump, dist, cos, k in rows[:4] + [r for r in rows[4:] if r[3] in JUMP_TOL]:
            print(f"  {jump:.3e} {dist:.3e} {cos:+.3f} {k}")
