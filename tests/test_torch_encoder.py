"""PyTorch port vs the JAX package: encoder layers and EncoderCostVolume360.

Flax modules get seeded random parameters (every kernel, scale and bias
random, so zero-initialised layers are exercised too), carried into the port
with torch_state_from_flax; inputs are numpy-seeded and fed to both. The
comparisons are relative to max|JAX output|: both sides compute in float32
and differ only in summation order, so single layers agree to ~1e-6 and the
deep stacks to ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from splatter360_tpu.models import backbone as jb
from splatter360_tpu.models import costvolume as jcv
from splatter360_tpu.models import layers as jl
from splatter360_tpu.models import transformer as jt
from splatter360_tpu.models import unet as ju
from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
from splatter360_tpu.models.adapter import adapt_gaussians as j_adapt
from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
from splatter360_tpu.train.state import _context_cubes
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models import backbone as tb
from splatter360_tpu_torch.models import costvolume as tcv
from splatter360_tpu_torch.models import layers as tl
from splatter360_tpu_torch.models import transformer as tt
from splatter360_tpu_torch.models import unet as tu
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.adapter import adapt_gaussians as t_adapt
from splatter360_tpu_torch.models.dino import token_grid
from splatter360_tpu_torch.models.encoder import EncoderConfig, EncoderCostVolume360
from splatter360_tpu_torch.serve import build_model, context_cubes

torch.set_num_threads(2)

# single layer: f32 on both sides, different summation order
TOL_LAYER = 1e-5
# deep stacks (6-layer transformers, U-Nets, the whole encoder)
TOL_DEEP = 1e-4


def rand_params(module, *args, seed=0):
    """Seeded random Flax params: kernels N(0, 1/fan_in), scales 1 + N(0, 0.1),
    biases N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "bias":
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(torch_module, params):
    torch_module.load_state_dict(
        torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return torch_module.eval()


def assert_close(ref, got, tol, name=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    err = np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12)
    assert err <= tol, f"{name}: max|diff|/max|ref| = {err:.2e} > {tol:.0e}"


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("size", [16, 15])
def test_strided_same_conv(k, size):
    """Flax "SAME" on a stride-2 conv pads (0,1) for 3x3 and (2,3) for 7x7 on
    even sizes; torch's symmetric padding=k//2 would shift every output."""
    x = np.random.default_rng(k + size).normal(size=(2, size, size, 4)).astype(np.float32)
    jm = fnn.Conv(8, (k, k), strides=(2, 2))
    p = rand_params(jm, x)
    tm = tl.Conv(4, 8, k, stride=2)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        tm.bias.copy_(t(p["params"]["bias"]))
        assert_close(jm.apply(p, x), tm(t(x)), TOL_LAYER, "conv")


@pytest.mark.parametrize("kind", ["group", "layer"])
def test_norm_eps(kind):
    """Flax GroupNorm/LayerNorm use eps 1e-6 (torch 1e-5): a low-variance
    input makes the difference visible."""
    x = (1e-3 * np.random.default_rng(3).normal(size=(2, 4, 5, 16))).astype(np.float32)
    if kind == "group":
        jm, tm = fnn.GroupNorm(num_groups=4), tl.GroupNorm(4, 16)
    else:
        jm, tm = fnn.LayerNorm(), tl.layer_norm(16)
    p = rand_params(jm, x)
    with torch.no_grad():
        tm.weight.copy_(t(p["params"]["scale"]))
        tm.bias.copy_(t(p["params"]["bias"]))
        assert_close(jm.apply(p, x), tm(t(x)), 1e-4, kind)


def test_residual_block_and_cee():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    jm = jl.ResidualBlock(12, stride=2)
    p = rand_params(jm, x)
    with torch.no_grad():
        assert_close(jm.apply(p, x), load(tl.ResidualBlock(8, 12, 2), p)(t(x)), TOL_LAYER, "resblock")
    e, c = (rng.normal(size=(2, 6, 12, 16)).astype(np.float32) for _ in range(2))
    jm = jl.CEELayer(16)
    p = rand_params(jm, e, c)
    with torch.no_grad():
        assert_close(jm.apply(p, e, c), load(tl.CEELayer(16), p)(t(e), t(c)), TOL_LAYER, "cee")


def test_bilinear_resize_upsample():
    """x8 upsampling (the serving path's): half-pixel centres, edge clamp,
    no antialiasing on either side; and the antialiased downsample JAX
    takes when an axis shrinks (tests/test_torch_mono.py holds it at the
    mono branch's shapes)."""
    x = np.random.default_rng(5).normal(size=(2, 4, 8, 3)).astype(np.float32)
    ref = jl.bilinear_resize(jnp.asarray(x), 32, 64)
    assert_close(ref, tl.bilinear_resize(t(x), 32, 64), TOL_LAYER, "resize")
    ref = jl.bilinear_resize(jnp.asarray(x), 2, 4)
    assert_close(ref, tl.bilinear_resize(t(x), 2, 4), TOL_LAYER, "downsample")


def test_transformer():
    x = np.random.default_rng(6).normal(size=(1, 3, 8, 16, 16)).astype(np.float32)
    jm = jt.MultiViewFeatureTransformer(num_layers=2, d_model=16)
    p = rand_params(jm, x)
    tm = load(tt.MultiViewFeatureTransformer(num_layers=2, d_model=16), p)
    with torch.no_grad():
        assert_close(jm.apply(p, x), tm(t(x)), TOL_DEEP, "transformer")


def test_backbone():
    """7x7 stride-2 stem, residual stages, position embedding, transformer."""
    x = np.random.default_rng(7).uniform(size=(1, 2, 32, 64, 3)).astype(np.float32)
    jm = jb.BackboneMultiview(feature_channels=16, num_transformer_layers=2)
    p = rand_params(jm, x)
    tm = load(tb.BackboneMultiview(feature_channels=16, num_transformer_layers=2), p)
    ref = jm.apply(p, x)
    with torch.no_grad():
        got = tm(t(x))
    assert_close(ref[1], got[1], TOL_LAYER * 10, "cnn features")
    assert_close(ref[0], got[0], TOL_DEEP, "transformer features")
    assert_close(jb.sine_position_embedding(6, 10, 16), tb.sine_position_embedding(6, 10, 16),
                 TOL_LAYER, "pos")


def test_unet():
    """Stride-2 SAME downsample, GroupNorm min(32, c) eps 1e-6, cross-view
    attention, nearest upsample."""
    x = np.random.default_rng(8).normal(size=(2, 16, 16, 8)).astype(np.float32)
    kw = dict(num_res_blocks=1, attn_resolutions=(2,), channel_mult=(1, 1, 2))
    jm = ju.UNet2D(model_channels=8, out_channels=8, **kw)
    p = rand_params(jm, x, 2)
    tm = load(tu.UNet2D(8, 8, 8, **kw), p)
    with torch.no_grad():
        assert_close(jm.apply(p, x, 2), tm(t(x), num_views=2), TOL_DEEP, "unet")


def test_costvolume_and_depth_predictor():
    rng = np.random.default_rng(9)
    b, v, h, w, c, d = 1, 2, 8, 16, 16, 8
    feats = rng.normal(size=(b, v, h, w, c)).astype(np.float32)
    cnn = rng.normal(size=(b, v, h, w, c)).astype(np.float32)
    imgs = rng.uniform(size=(b, v, 8 * h, 8 * w, 3)).astype(np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ext[..., :3, 3] = rng.normal(0, 0.3, (b, v, 3))
    near = np.full((b, v), 0.1, np.float32)
    far = np.full((b, v), 10.0, np.float32)
    cand = jcv.depth_candidates(jnp.asarray(near), jnp.asarray(far), d, "log_depth")
    assert_close(cand, tcv.depth_candidates(t(near), t(far), d, "log_depth"), TOL_LAYER, "cand")
    assert_close(jcv.build_cost_volume(jnp.asarray(feats), jnp.asarray(ext), cand),
                 tcv.build_cost_volume(t(feats), t(ext), t(cand)), TOL_LAYER, "cost volume")

    kw = dict(feature_channels=c, num_depth_candidates=d, costvolume_unet_feat_dim=16,
              costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
              gaussian_raw_channels=23, depth_unet_feat_dim=8, depth_unet_attn_res=(8,),
              depth_unet_channel_mult=(1, 1, 1, 1))
    jm = jcv.DepthPredictor360(**kw)
    args = (feats, cnn, imgs, ext, near, far)
    p = rand_params(jm, *args)
    ref = jm.apply(p, *args)
    tm = load(tcv.DepthPredictor360(**kw), p)
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    for name, a, g in zip(("depths", "densities", "raw"), ref, got):
        assert_close(a, g, TOL_DEEP, name)


def test_adapter():
    rng = np.random.default_rng(10)
    b, v, h, w = 1, 2, 8, 16
    cfg = (2, JAdapterConfig(sh_degree=2), GaussianAdapterConfig(sh_degree=2))
    ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    ext[0, 1, :3, :3] = q * np.sign(np.linalg.det(q))
    ext[..., :3, 3] = rng.normal(0, 0.3, (b, v, 3))
    depths = rng.uniform(0.5, 5, (b, v, h * w, 1)).astype(np.float32)
    opac = rng.uniform(0, 1, (b, v, h * w, 1)).astype(np.float32)
    raw = rng.normal(size=(b, v, h * w, 7 + 3 * 9)).astype(np.float32)
    ref = j_adapt(cfg[1], jnp.asarray(ext), depths, opac, raw, (h, w))
    got = t_adapt(cfg[2], t(ext), t(depths), t(opac), t(raw), (h, w))
    for name, a, g in zip(ref._fields, ref, got):
        assert_close(a, g, TOL_LAYER * 10, name)


ENC_KW = dict(
    d_feature=32, num_depth_candidates=16, downscale_factor=8,
    costvolume_unet_feat_dim=32, costvolume_unet_channel_mult=(1, 1),
    costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(8,),
    depth_unet_channel_mult=(1, 1, 1, 1),
)


def encoder_inputs(h=64, w=256, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, h, w, 3)).astype(np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ext[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    return img, ext, np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)


def test_encoder_tiny():
    """The whole encoder at 64x256 (wide enough for the kernel's ERP route)."""
    img, ext, near, far = encoder_inputs()
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW))
    cubes = _context_cubes(jnp.asarray(img), img.shape[2] // 2)
    p = rand_params(jm, img, cubes, ext, near, far, 0)
    # Shrink the random disparity-delta head (Conv_8) by 10x: at full scale
    # it pushes the fine disparity onto its 1/far clip, where depth = 1/disp
    # magnifies f32 rounding by up to far^2 and the test would measure that
    # conditioning instead of the port.
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.1 if "Conv_8" in jax.tree_util.keystr(path) else x, p)
    jg, jd = jax.jit(lambda p: jm.apply(p, img, cubes, ext, near, far, 10**9))(p)
    tm = load(EncoderCostVolume360(
        EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)), p)
    with torch.no_grad():
        tc = context_cubes(t(img), img.shape[2] // 2)
        assert_close(cubes, tc, TOL_LAYER, "cubes")
        tg, td = tm(t(img), tc, t(ext), t(near), t(far), 10**9)
    for name, a, g in zip(jg._fields, jg, tg):
        assert_close(a, g, TOL_DEEP, name)
    assert_close(jd, td, TOL_DEEP, "depth map")


@pytest.mark.parametrize("flag", ["add_mono_feat", "use_epipolar_trans", "wo_depth_refine",
                                  "wo_cost_volume", "wo_cube_encoder", "fusion_type",
                                  "num_surfaces"])
def test_unported_flags_raise(flag):
    """num_surfaces > 1 raises when the model is built (the JAX encoder
    raises too); the other options, the mono branch (vits, a 1x1 token grid
    on 16x16 faces) among them, build and run (tests/test_torch_ablations.py
    and tests/test_torch_mono.py hold them to JAX)."""
    kw = {"fusion_type": "concat", "num_surfaces": 2}.get(flag, True)
    model_kw = {flag: kw}
    if flag == "num_surfaces":
        with pytest.raises(NotImplementedError, match=flag):
            EncoderCostVolume360(EncoderConfig(**ENC_KW, **model_kw))
        return
    if flag == "use_epipolar_trans":
        model_kw["epipolar_num_samples"] = 4
    img, ext, near, far = (t(x) for x in encoder_inputs(32, 64))
    model = build_model(EncoderConfig(**ENC_KW, **model_kw), device="cpu",
                        mono_grid=token_grid(16))
    with torch.no_grad():
        g, d = model(img, context_cubes(img, 16), ext, near, far, 0)
    assert g.means.shape == (1, 2 * 32 * 64, 3) and d.shape == (1, 2, 32, 64)
    assert all(torch.isfinite(x).all() for x in (*g, d))
