"""The port's serving slice vs the JAX package, and the port's boundaries.

Serving slice: context panoramas -> encoder -> Gaussians -> ERP render of
target views, through the port's entry points (serve.py, device="cpu") and
through the JAX encoder + render_erp_views(backend="pallas") with the Pallas
kernels in interpret mode. The JAX Gaussians are also fed to the port's
renderer, so an encoder difference at the 1e-6 level cannot flip a binning
decision and hide a renderer fault.
"""

import contextlib
import functools
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import splatter360_tpu.ops.pallas.composite as pc
from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
from splatter360_tpu.models.decoder import render_erp_views as j_render_views
from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
from splatter360_tpu.train.state import _context_cubes
from splatter360_tpu_torch import serve
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.encoder import HM3D, EncoderConfig
from splatter360_tpu_torch.models.types import Gaussians

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
H, W = 64, 256
# Gaussians/depth: relative to max|JAX|, float32 on both sides through a
# deep random network (see test_torch_encoder.py)
TOL_ENCODER = 1e-4
# rendered views from the same Gaussians: the compositor bars of
# tests/test_pallas_composite.py:47-49
ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4
ENC_KW = dict(
    d_feature=32, num_depth_candidates=16, downscale_factor=8,
    costvolume_unet_feat_dim=32, costvolume_unet_channel_mult=(1, 1),
    costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(8,),
    depth_unet_channel_mult=(1, 1, 1, 1),
)


def rand_params(module, *args, seed=0):
    """Seeded random Flax params: kernels N(0, 1/fan_in), scales 1 + N(0, 0.1),
    biases N(0, 0.1); the disparity-delta head shrunk 10x so the fine depth
    stays off its 1/far clip (where 1/disparity magnifies rounding)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "bias":
            x = 0.1 * rng.normal(size=s.shape)
        elif leaf == "scale":
            x = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            x = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if "Conv_8" in jax.tree_util.keystr(path):
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@contextlib.contextmanager
def zero_init(like):
    """Within it the JAX encoder's init gives zeros shaped as `like` (a tree
    of rand_params). Flax's init runs the encoder eagerly, one op at a time
    (~1,000 ops, 30-40 s on a loaded host), and the tests that build a JAX
    train state replace every value it draws: with the seeded tree, or with
    a checkpoint of it (where a restore that failed would leave zeros)."""
    zeros = jax.tree_util.tree_map(jnp.zeros_like, like)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEncoder, "init", lambda self, *args, **kwargs: zeros)
        yield


def request(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, H, W, 3)).astype(np.float32)
    ctx = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ctx[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    tgt = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    tgt[..., :3, 3] = rng.normal(0, 0.1, (1, 2, 3))
    near = np.full((1, 2), 0.1, np.float32)
    far = np.full((1, 2), 10.0, np.float32)
    return img, ctx, tgt, near, far


def assert_bars_but_gate_flips(ref, got, atol, scale):
    """Within `atol` except where the compositor's weight gate
    T_i (1 - alpha) >= 1e-4 flipped: the port's projection differs from
    XLA's in the last bit (atan2, exp), which can move one contribution of
    w = alpha T_i ~ 1e-4 alpha / (1 - alpha) <= 1e-2 (times the colour or
    depth `scale`) in or out. Such flips must stay rare (<= 1e-4 of the
    values). Alpha has no such term: logT carries the unmasked sum."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert (diff > atol).mean() <= 1e-4, (diff > atol).sum()
    assert diff.max() <= 1e-2 * scale, diff.max()


def rel_err(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - got.numpy()).max() / (np.abs(ref).max() + 1e-12)


def test_serving_slice_vs_jax(monkeypatch):
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
    img, ctx, tgt, near, far = request()
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW))
    cubes = _context_cubes(jnp.asarray(img), H // 2)
    params = rand_params(jm, img, cubes, ctx, near, far, 0)
    jg, jd = jax.jit(lambda p: jm.apply(p, img, cubes, ctx, near, far, 10**9))(params)
    jout = j_render_views(jg, jnp.asarray(tgt), near, far, (H, W), render_depth=True,
                          backend="pallas")

    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    state = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model = serve.build_model(cfg, state_dict=state, device="cpu")
    tg, td = serve.encode(model, img, ctx, near, far, device="cpu")
    for name, a, b in zip(jg._fields, jg, tg):
        assert rel_err(a, b) <= TOL_ENCODER, name
    assert rel_err(jd, td) <= TOL_ENCODER

    # the port's renderer on the JAX Gaussians: the compositor bars (the
    # compositor alone meets them exactly on the JAX projection, see
    # test_torch_render.py::test_plain_compositor_vs_pallas_fused)
    out = serve.render_erp_views(Gaussians(*(np.asarray(x) for x in jg)), tgt, near, far, (H, W),
                                 render_depth=True, device="cpu")
    np.testing.assert_allclose(out.alpha.numpy(), np.asarray(jout.alpha), atol=ATOL_RGB)
    assert_bars_but_gate_flips(jout.color, out.color, ATOL_RGB, float(np.abs(jout.color).max()))
    assert_bars_but_gate_flips(jout.depth, out.depth, ATOL_DEPTH, float(far.max()))
    np.testing.assert_array_equal(out.dropped.numpy(), np.asarray(jout.dropped))

    # the whole port chain: Gaussians differ at ~1e-5, which may flip a few
    # radius/binning decisions at their thresholds, so the images are held
    # by their mean error and a per-pixel bound
    full = serve.render_erp_views(tg, tgt, near, far, (H, W), render_depth=True, device="cpu")
    diff = np.abs(full.color.numpy() - np.asarray(jout.color))
    assert diff.mean() < 1e-5 and diff.max() < 1e-2
    assert np.isfinite(full.depth.numpy()).all()


def test_import_leaves_jax_out():
    """The port imports neither JAX/Flax nor the JAX package, and its
    trainer needs no TensorBoard package (utils/tb_events.py writes the
    events); every module is imported, the trainer's by name."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import splatter360_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'splatter360_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'splatter360_tpu', 'tensorboard', 'tensorboardX'))\n"
        "assert not bad, bad\n"
        "new = ['train.trainer', 'utils.step_tracker', 'utils.tb_events', 'models.visualizer',\n"
        "       'models.epipolar', 'ops.composite_scan', 'models.dino',\n"
        "       'utils.torch_convert', 'train.checkpoint', 'train.evaluator',\n"
        "       'geometry.transforms']\n"
        "missing = [m for m in new if 'splatter360_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_need_the_card_unless_told(monkeypatch):
    """Without device="cpu" the entry points go to the card, and raise when
    there is none; they never fall back to the host on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, ctx, tgt, near, far = request()
    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_model(cfg)
    model = serve.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.encode(model, img, ctx, near, far)
    g = Gaussians(np.zeros((1, 4, 3), np.float32), np.zeros((1, 4, 6), np.float32),
                  np.zeros((1, 4, 3, 4), np.float32), np.zeros((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.render_erp_views(g, tgt, near, far, (H, W))


def test_hm3d_preset_matches_yaml():
    """HM3D carries configs/hm3d.yaml's model block in full, bf16_compute
    included."""
    model = yaml.safe_load((REPO / "configs" / "hm3d.yaml").read_text())["model"]
    preset = asdict(HM3D)
    for key, value in model.items():
        got = preset[key]
        if isinstance(value, list):
            got, value = list(got), list(value)
        assert got == value, key
    assert HM3D.gaussian_adapter.d_sh == 25
