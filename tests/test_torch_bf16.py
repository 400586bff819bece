"""The port's bf16 compute policy vs the JAX package's (_mixed_precision_apply).

Both sides cast every float32 parameter and the images to bf16 and keep
the same float32 islands; they differ where the two backends round
differently. Each comparison measures, relative to max|JAX f32 output|,
d_port = max|port bf16 - JAX bf16| and d_policy = max|JAX bf16 - JAX f32|
(the size of the policy's own rounding), on the same parameters and inputs.

Layer by layer the port rounds where XLA rounds (the bias after the
product, the gelu/silu/sigmoid chains XLA expands, jax.image.resize's two
contractions, bf16 constants, Flax's float32 norms), so most elements are
bit-equal. What is left are float32 sums taken in another order (conv
windows, norm statistics, softmax), which round a rare element to the other
side of a bf16 step: one such flip at the largest element is 2^-8 of
max|x|, more than d_policy (half a step), so a single layer is held by its
mean |difference| (at most half the policy's) and at most one bf16 step,
2^-7 of max|x|, at any element.

Through the whole random-weight encoder those flips grow until the port's
bf16 outputs are as far from JAX's bf16 outputs as these are from JAX's f32
outputs: on the tiny encoder of test_torch_serve.py d_port/d_policy is
0.60-1.11 over the five outputs, and the mean |difference| is within 6% of
the policy's. So the encoder is held within the policy's own rounding
(d_port <= 1.5 d_policy, 1.25 on the mean), and the port's bf16 and f32
outputs must differ by as much as JAX's do (it computes in bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from splatter360_tpu.models import costvolume as jcv
from splatter360_tpu.models import layers as jl
from splatter360_tpu.models import transformer as jt
from splatter360_tpu.models import unet as ju
from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
from splatter360_tpu.train.state import _context_cubes, _mixed_precision_apply
from splatter360_tpu_torch import serve
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models import costvolume as tcv
from splatter360_tpu_torch.models import layers as tl
from splatter360_tpu_torch.models import transformer as tt
from splatter360_tpu_torch.models import unet as tu
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.encoder import EncoderConfig
from test_torch_encoder import load
from test_torch_encoder import rand_params as layer_params
from test_torch_serve import ENC_KW, H, rand_params, request

torch.set_num_threads(2)
BF16 = jnp.bfloat16
# layer by layer: the port's mean |difference| at most half the policy's,
# and no element more than one bf16 step of max|x| away
LAYER_RATIO, BF16_STEP = 0.5, 2.0**-7
# the whole encoder: within the policy's rounding (max and mean |difference|)
ENCODER_RATIO, ENCODER_MEAN_RATIO = 1.5, 1.25
LEAVES = ("means", "covariances", "harmonics", "opacities", "depth")


def distances(j32, j16, p16):
    """(d_port, d_policy) relative to max|JAX f32|, and the mean-|diff| pair."""
    j32 = np.asarray(j32, np.float32)
    j16 = np.asarray(jnp.asarray(j16).astype(jnp.float32))
    p16 = p16.detach().float().numpy()
    scale = np.abs(j32).max() + 1e-12
    port, policy = np.abs(p16 - j16), np.abs(j16 - j32)
    return (port.max() / scale, policy.max() / scale), (port.mean() / scale, policy.mean() / scale)


def assert_layer_close(name, j32, j16, p16):
    (d_port, d_policy), (m_port, m_policy) = distances(j32, j16, p16)
    print(f"{name}: d_port {d_port:.3e}, d_policy {d_policy:.3e}; mean {m_port:.3e} vs "
          f"{m_policy:.3e}")
    assert m_port <= LAYER_RATIO * m_policy, (m_port, m_policy)
    assert d_port <= BF16_STEP, d_port


def bf16_tree(p):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(BF16), p)


def bf16_module(m):
    for p in m.parameters():
        p.data = p.data.to(torch.bfloat16)
    return m


def tb(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def rng_normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def layer_case(name):
    """(JAX module, port module, numpy inputs, extra call args)."""
    x = rng_normal(1, (2, 16, 32, 16))
    if name == "conv3x3 + bias":
        return fnn.Conv(16, (3, 3)), tl.Conv(16, 16, 3), (x,), ()
    if name == "conv7x7 stride 2":
        return (fnn.Conv(16, (7, 7), strides=(2, 2), use_bias=False),
                tl.Conv(3, 16, 7, 2, bias=False), (x[..., :3],), ())
    if name == "dense + bias":
        return fnn.Dense(24), tl.Dense(16, 24), (x,), ()
    if name == "group norm":
        return fnn.GroupNorm(num_groups=4), tl.GroupNorm(4, 16), (x,), ()
    if name == "layer norm":
        return fnn.LayerNorm(), tl.layer_norm(16), (x,), ()
    if name == "residual block":
        return jl.ResidualBlock(16), tl.ResidualBlock(16, 16), (x,), ()
    if name == "SE layer":
        return jl.SELayer(), tl.SELayer(16), (x,), ()
    if name == "transformer":
        xt = rng_normal(2, (1, 3, 8, 16, 16))
        return (jt.MultiViewFeatureTransformer(num_layers=2, d_model=16),
                tt.MultiViewFeatureTransformer(num_layers=2, d_model=16), (xt,), ())
    if name == "U-Net ResBlock":
        return ju.ResBlock(8), tu.ResBlock(16, 8), (x,), ()
    if name == "U-Net attention":
        return ju.AttentionBlock(8, True), tu.AttentionBlock(16, 8, True), (x,), (2,)
    raise KeyError(name)


LAYERS = ("conv3x3 + bias", "conv7x7 stride 2", "dense + bias", "group norm", "layer norm",
          "residual block", "SE layer", "transformer", "U-Net ResBlock", "U-Net attention")


@pytest.mark.parametrize("name", LAYERS)
def test_bf16_layer_vs_jax(name):
    jm, tm, inputs, extra = layer_case(name)
    p = layer_params(jm, *inputs, *extra)
    j32 = jm.apply(p, *inputs, *extra)
    j16 = jm.apply(bf16_tree(p), *(jnp.asarray(a).astype(BF16) for a in inputs), *extra)
    tm = bf16_module(load(tm, p))
    with torch.no_grad():
        p16 = tm(*(tb(a) for a in inputs), *extra)
    assert p16.dtype == torch.bfloat16
    assert_layer_close(name, j32, j16, p16)


@pytest.mark.parametrize("name", ("gelu", "silu", "sigmoid", "bilinear resize x8",
                                  "cost volume", "cube_to_erp"))
def test_bf16_function_vs_jax(name):
    from splatter360_tpu.geometry.cubemap import cube_to_erp as j_c2e
    from splatter360_tpu.models.layers import bilinear_resize as j_resize
    from splatter360_tpu_torch.geometry.cubemap import cube_to_erp as t_c2e

    x = rng_normal(3, (2, 8, 16, 8)) * 3.0
    if name == "gelu":
        fns = (functools.partial(jax.nn.gelu, approximate=False), tl.gelu)
    elif name == "silu":
        fns = (jax.nn.silu, tl.silu)
    elif name == "sigmoid":
        fns = (jax.nn.sigmoid, tl.sigmoid)
    elif name == "bilinear resize x8":
        fns = (lambda a: j_resize(a, 64, 128), lambda a: tl.bilinear_resize(a, 64, 128))
    elif name == "cube_to_erp":
        x = rng_normal(4, (6, 8, 8, 16))
        fns = (lambda a: j_c2e(a, 16, 32), lambda a: t_c2e(a, 16, 32))
    else:
        b, v, h, w, c, d = 1, 3, 8, 16, 16, 8
        x = rng_normal(5, (b, v, h, w, c))
        ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
        ext[..., :3, 3] = np.random.default_rng(6).normal(0, 0.3, (b, v, 3))
        near, far = np.full((b, v), 0.1, np.float32), np.full((b, v), 10.0, np.float32)
        cand = np.asarray(jcv.depth_candidates(jnp.asarray(near), jnp.asarray(far), d,
                                               "log_depth"))
        fns = (lambda a: jcv.build_cost_volume(a, jnp.asarray(ext), jnp.asarray(cand)),
               lambda a: tcv.build_cost_volume(a, torch.as_tensor(ext), torch.as_tensor(cand)))
    jf, tf = fns
    j32, j16 = jf(jnp.asarray(x)), jf(jnp.asarray(x).astype(BF16))
    p16 = tf(tb(x))
    assert p16.dtype == torch.bfloat16
    assert_layer_close(name, j32, j16, p16)


@pytest.fixture(scope="module")
def encoder_runs():
    """The tiny encoder of test_torch_serve.py in JAX f32, JAX bf16
    (_mixed_precision_apply) and the port (f32 and bf16, serve.encode), on
    the same converted parameters and request."""
    img, ctx, _, near, far = request()
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW))
    cubes = _context_cubes(jnp.asarray(img), H // 2)
    params = rand_params(jm, img, cubes, ctx, near, far, 0)
    args = (img, cubes, ctx, near, far, 10**9)
    j32 = jax.jit(lambda p: jm.apply(p, *args))(params)
    j16 = jax.jit(lambda p: _mixed_precision_apply(jm)(p, *args))(params)
    state = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    port = {}
    for bf16 in (False, True):
        cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), bf16_compute=bf16,
                            **ENC_KW)
        model = serve.build_model(cfg, state_dict=state, device="cpu")
        port[bf16] = serve.encode(model, img, ctx, near, far, device="cpu")
    flat = lambda out: (*out[0], out[1])  # noqa: E731
    return dict(j32=flat(j32), j16=flat(j16), p32=flat(port[False]), p16=flat(port[True]))


@pytest.mark.parametrize("leaf", LEAVES)
def test_bf16_encoder_vs_jax(encoder_runs, leaf):
    i = LEAVES.index(leaf)
    j32, j16, p16, p32 = (encoder_runs[k][i] for k in ("j32", "j16", "p16", "p32"))
    assert p16.dtype == torch.float32  # the Gaussians and the depth map leave in float32
    (d_port, d_policy), (m_port, m_policy) = distances(j32, j16, p16)
    (_, _), (m_own, _) = distances(j32, p32, p16)
    print(f"{leaf}: d_port {d_port:.3e}, d_policy {d_policy:.3e}; mean {m_port:.3e} vs "
          f"{m_policy:.3e}; port bf16 vs port f32 mean {m_own:.3e}")
    assert np.isfinite(p16.numpy()).all()
    assert d_port <= ENCODER_RATIO * d_policy, (d_port, d_policy)
    assert m_port <= ENCODER_MEAN_RATIO * m_policy, (m_port, m_policy)
    # the port computes in bf16: its own bf16 and f32 outputs differ as JAX's do
    assert m_own >= 0.5 * m_policy, (m_own, m_policy)


def test_bf16_train_steps_within_5pct_of_f32():
    """The JAX package's own bar for the policy (tests/test_models.py,
    test_bf16_compute_parity): the loss after 2 train steps with bf16
    compute within 5% (+1e-3) of the f32 loss; the master parameters, their
    gradients and the Adam moments stay float32."""
    from splatter360_tpu_torch.train.losses import LossConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, TrainConfig, create_train_state
    from splatter360_tpu_torch.train.state import train_step

    from test_torch_train import step_batch

    batch = step_batch()
    tcfg = TrainConfig(optimizer=OptimizerConfig(max_steps=100),
                       loss=LossConfig(lpips_weight=0.0, depth_weight=0.1), supervision="erp")
    losses = {}
    for bf16 in (False, True):
        cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), bf16_compute=bf16,
                            **ENC_KW)
        state = create_train_state(cfg, tcfg, seed=0, device="cpu")
        for _ in range(2):
            metrics = train_step(state, batch)
        losses[bf16] = float(metrics["loss"])
        assert np.isfinite(losses[bf16])
        for name, p in state.model.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
            for moment in state.optimizer.state[p].values():
                assert moment.dtype == torch.float32, name
    print(f"loss after 2 steps: f32 {losses[False]:.6f}, bf16 {losses[True]:.6f}")
    assert abs(losses[True] - losses[False]) < 0.05 * abs(losses[False]) + 1e-3
