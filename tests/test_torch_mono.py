"""The mono branch (model.add_mono_feat), the port against the JAX package.

Its modules one by one, then the encoder with the branch, then the DINOv2
weights loader:
  * the antialiased bilinear downsample (layers.bilinear_resize, JAX's
    jax.image.resize) at the path's shapes, 256 -> 252 cube faces and the
    37 -> 18 pos_embed grid: float32 within 1e-6 of max|x|, bf16 at
    test_torch_bf16.py's layer bars;
  * ViTBlock (one and two heads) and DinoViT (a tiny ViT, `test` dims of
    64 wide, 1 head, 2 blocks, and `test2`, 128 wide with 2 heads): float32
    within 1e-4 of max|x|, bf16 at the layer bars;
  * the tiny encoder of test_torch_serve.py (ENC_KW, its backbones cut to 1
    transformer layer on both sides, as tests/test_torch_ablations.py cuts
    them to 2) with add_mono_feat at 64x128: 32x32 cube faces, resized to 28x28,
    a 2x2 token grid. Float32 outputs within 1e-4 of max|x|; the gradient
    of a fixed scalar loss within 2e-3 of the global max|g| in every
    trainable parameter, JAX's gradient of every ViT leaf exactly 0 and the
    port's absent (frozen); bf16 outputs within the policy's rounding (1.5x
    by max, 1.25x by mean);
  * convert.torch_state_from_flax on the JAX add_mono_feat tree, loaded
    with strict=True; warm_start_mono on one torch.save'd file in DINOv2's
    layout (its real key names and shapes at tiny widths) on both sides: the
    same leaf count, pos_embed within 1e-6 and every other leaf bit for bit,
    and the same ValueErrors; the port's CLI mode=train with the file.
Flax initialises the layer scales ls1/ls2 to 1e-5, where a block adds ~1e-5
of its input and a wrong head split would hide under any bar; every
parameter of the module and encoder tests is drawn with the layer scales of
order 1. The JAX programs are jitted in this process, each compiled once.
"""

import functools
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatter360_tpu.models.dino as jdino
import splatter360_tpu.models.encoder as jenc
from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
from splatter360_tpu.models.backbone import BackboneMultiview as JBackbone
from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
from splatter360_tpu.models.layers import bilinear_resize as j_resize
from splatter360_tpu.train import checkpoint as jckpt
from splatter360_tpu.train.state import _context_cubes, _mixed_precision_apply
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models import dino as tdino
from splatter360_tpu_torch.models import encoder as tenc
from splatter360_tpu_torch.models import layers as tl
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.backbone import BackboneMultiview
from splatter360_tpu_torch.models.encoder import EncoderConfig, EncoderCostVolume360, apply_encoder
from splatter360_tpu_torch.serve import context_cubes
from splatter360_tpu_torch.train import checkpoint as ckpt
from test_torch_bf16 import (BF16, ENCODER_MEAN_RATIO, ENCODER_RATIO, assert_layer_close,
                             bf16_module, bf16_tree, distances, tb)
from test_torch_serve import ENC_KW
from test_torch_ablations import flax_params
from test_torch_train import GRAD_TOL

from chip_smoke import dinov2_state

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
# tiny ViTs, registered in both packages' VIT_DIMS: (width, heads, blocks)
TINY_VITS = {"test": (64, 1, 2), "test2": (128, 2, 2)}
for _name, _dims in TINY_VITS.items():
    jdino.VIT_DIMS.setdefault(_name, _dims)
    tdino.VIT_DIMS.setdefault(_name, _dims)
H, W = 64, 128  # cube faces of 32: resized to 28, a 2x2 token grid
GRID = tdino.token_grid(H // 2)
LAYERS = 1  # transformer layers of each backbone (6 in the model)
STEP = 10**9  # past the opacity warm-up
OUTPUTS = ("means", "covariances", "harmonics", "opacities", "depth")
TOL_DEEP, TOL_RESIZE = 1e-4, 1e-6


def rand_params(module, *args, seed=0):
    """Seeded random Flax params: kernels N(0, 1/fan_in) (the fan-in of an
    attention projection is its input width), scales 1 + N(0, 0.1), biases
    N(0, 0.1), pos_embed N(0, 1), the layer scales ls1/ls2 U(0.5, 1.5);
    the encoder's disparity-delta head (Conv_8) shrunk 10x, as
    test_torch_serve.rand_params does."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        leaf = keys[-1]
        if leaf in ("ls1", "ls2"):
            x = rng.uniform(0.5, 1.5, s.shape)
        elif leaf == "pos_embed":
            x = rng.normal(size=s.shape)
        elif leaf == "bias":
            x = 0.1 * rng.normal(size=s.shape)
        elif leaf == "scale":
            x = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            fan_in = s.shape[0] if keys[-2] in ("query", "key", "value") else np.prod(s.shape[:-1])
            x = rng.normal(size=s.shape) / np.sqrt(fan_in)
        if "Conv_8" in keys:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, params):
    module.load_state_dict(torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                           strict=True)
    return module.eval()


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


@pytest.mark.parametrize("shape, size", [((12, 256, 256, 3), 252), ((1, 37, 37, 384), 18)],
                         ids=["cube faces 256 to 252", "pos_embed grid 37 to 18"])
def test_downsample_vs_jax(shape, size):
    """jax.image.resize's antialiased bilinear downsample at the mono
    path's shapes, in float32 and bf16."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    j32 = j_resize(jnp.asarray(x), size, size)
    p32 = tl.bilinear_resize(torch.from_numpy(x), size, size)
    err = np.abs(np.asarray(j32) - p32.numpy()).max() / np.abs(x).max()
    print(f"float32: {err:.2e} of max|x|")
    assert err <= TOL_RESIZE
    j16 = j_resize(jnp.asarray(x).astype(BF16), size, size)
    p16 = tl.bilinear_resize(tb(x), size, size)
    assert p16.dtype == torch.bfloat16
    assert_layer_close("bf16 downsample", j32, j16, p16)


def block_case(kind):
    """(JAX module, port module, input): a ViTBlock with `kind` heads or a
    DinoViT of the TINY_VITS entry `kind`."""
    rng = np.random.default_rng(2)
    if kind in TINY_VITS:
        x = rng.uniform(-2, 2, (2, 14 * GRID, 14 * GRID, 3)).astype(np.float32)
        return jdino.DinoViT(kind), tdino.DinoViT(kind, GRID), x
    heads = int(kind.split()[0])
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    return jdino.ViTBlock(64, heads), tdino.ViTBlock(64, heads), x


@pytest.mark.parametrize("kind", ["1 head", "2 heads", *TINY_VITS])
def test_vit_vs_jax(kind):
    """ViTBlock and DinoViT against JAX applied op by op, as
    test_torch_bf16.py holds the other layers (each op rounds to bf16 where
    XLA's op does): float32 (jitted) within 1e-4 of max|x|, bf16 at the
    layer bars.
    The jitted program, whose fusions keep excess precision, is the
    reference of the encoder tests below."""
    jm, tm, x = block_case(kind)
    p = rand_params(jm, x)
    j32 = jax.jit(jm.apply)(p, x)
    j16 = jm.apply(bf16_tree(p), jnp.asarray(x).astype(BF16))
    tm = load(tm, p)
    with torch.no_grad():
        p32 = tm(torch.from_numpy(x))
        assert rel(j32, p32) <= TOL_DEEP, rel(j32, p32)
        p16 = bf16_module(tm)(tb(x))
    assert p16.dtype == torch.bfloat16
    assert_layer_close(f"{kind} bf16", j32, j16, p16)


@pytest.fixture(scope="module")
def cut_backbones():
    """Both packages' encoders build their backbones with LAYERS layers for
    this module's tests, and get their 6-layer backbones back after it."""
    saved = jenc.BackboneMultiview, tenc.BackboneMultiview
    jenc.BackboneMultiview = functools.partial(JBackbone, num_transformer_layers=LAYERS)
    tenc.BackboneMultiview = functools.partial(BackboneMultiview, num_transformer_layers=LAYERS)
    yield
    jenc.BackboneMultiview, tenc.BackboneMultiview = saved


def request(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, H, W, 3)).astype(np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ext[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    return img, ext, np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)


def probe_weights(shape) -> np.ndarray:
    """The fixed weights of the scalar loss sum(out * w) for one output."""
    n = int(np.prod(shape))
    return (np.cos(0.37 * np.arange(n)) / n).reshape(shape).astype(np.float32)


MONO_KW = dict(ENC_KW, add_mono_feat=True, vit_type="test")


@pytest.fixture(scope="module")
def mono_runs(cut_backbones):
    """The tiny mono encoder on one request: JAX's jitted float32 outputs
    and gradients of the probe loss, its jitted bf16 outputs
    (_mixed_precision_apply), and the port's on the converted parameters."""
    img, ext, near, far = request()
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **MONO_KW))
    cubes = _context_cubes(jnp.asarray(img), H // 2)
    args = (img, cubes, ext, near, far, STEP)
    # the Flax tree in the port's module names (the ViT's from its own Flax
    # init): JAX's apply refuses a missing or misshapen leaf, the port's
    # strict load any other difference
    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **MONO_KW)
    params = flax_params(EncoderCostVolume360(cfg, mono_grid=GRID), MONO_KW)
    params["params"]["dino"] = rand_params(
        jdino.DinoViT(MONO_KW["vit_type"]), np.zeros((1, 14 * GRID, 14 * GRID, 3), np.float32),
        seed=1)["params"]

    def loss(p):
        g, d = jm.apply(p, *args)
        outs = (*g, d)
        return sum(jnp.sum(x * probe_weights(x.shape)) for x in outs), outs

    (_, j32), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    j16 = jax.jit(lambda p: _mixed_precision_apply(jm)(p, *args))(params)
    state = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    port = {}
    for bf16 in (False, True):
        model = EncoderCostVolume360(replace(cfg, bf16_compute=bf16), mono_grid=GRID)
        model.load_state_dict(state, strict=True)
        model.eval()
        timg = torch.from_numpy(img)
        with torch.set_grad_enabled(not bf16):
            g, d = apply_encoder(model, timg, context_cubes(timg, H // 2), torch.from_numpy(ext),
                                 torch.from_numpy(near), torch.from_numpy(far), STEP)
            outs = (*g, d)
            if not bf16:
                sum(torch.sum(x * torch.from_numpy(probe_weights(tuple(x.shape)))) for x in outs
                    ).backward()
                grads = {k: p.grad for k, p in model.named_parameters()}
        port[bf16] = [x.detach() for x in outs]
    return dict(j32=[np.asarray(x) for x in j32],
                j16=[np.asarray(jnp.asarray(x).astype(jnp.float32)) for x in (*j16[0], j16[1])],
                jgrads=torch_state_from_flax(jax.tree_util.tree_map(np.asarray, jgrads)),
                p32=port[False], p16=port[True], grads=grads)


def test_mono_encoder_f32_vs_jax(mono_runs):
    """Outputs within 1e-4 of max|x|; every trainable parameter's gradient
    within 2e-3 of the global max|g|; the ViT's gradient 0 in JAX (its
    stop_gradient) and none in the port (frozen, built under no_grad)."""
    for name, a, b in zip(OUTPUTS, mono_runs["j32"], mono_runs["p32"]):
        assert rel(a, b) <= TOL_DEEP, (name, rel(a, b))
    jg, pg = mono_runs["jgrads"], mono_runs["grads"]
    assert set(jg) == set(pg)
    vit = [k for k in jg if k.startswith("dino.")]
    assert len(vit) == 5 + 18 * TINY_VITS["test"][2]
    for k in vit:
        assert not jg[k].any() and pg[k] is None, k
    scale = max(float(g.abs().max()) for g in jg.values())
    for k in sorted(set(jg) - set(vit)):
        d = float((pg[k] - jg[k]).abs().max()) / scale
        assert d <= GRAD_TOL, (k, d)
    assert any(float(pg[k].abs().max()) > 0 for k in pg if k.startswith("rgbd_fusion_"))


def test_mono_encoder_bf16_vs_jax(mono_runs):
    """Each output within the policy's rounding: max |port - JAX bf16| at
    most 1.5 times max |JAX bf16 - JAX f32|, and 1.25 times by mean."""
    for name, j32, j16, p16 in zip(OUTPUTS, mono_runs["j32"], mono_runs["j16"],
                                   mono_runs["p16"]):
        assert p16.dtype == torch.float32 and torch.isfinite(p16).all(), name
        (d_port, d_policy), (m_port, m_policy) = distances(j32, j16, p16)
        print(f"{name}: d_port {d_port:.3e}, d_policy {d_policy:.3e}; mean {m_port:.3e} vs "
              f"{m_policy:.3e}")
        assert d_port <= ENCODER_RATIO * d_policy, name
        assert m_port <= ENCODER_MEAN_RATIO * m_policy, (name, m_port, m_policy)


def fake_dinov2(vit_type: str, seed: int = 5, grid: int = 37) -> dict:
    """chip_smoke.py's seeded state dict in DINOv2's layout (torch.hub
    dinov2_vit*14: the real key names, a pos_embed of 1 + 37*37 tokens, cls
    and mask tokens) at the width and depth of VIT_DIMS[vit_type]."""
    dim, _, depth = tdino.VIT_DIMS[vit_type]
    return dinov2_state(seed, dim, depth, grid)


def jax_dino_tree(vit_type: str, grid: int = GRID) -> dict:
    """A JAX parameter tree holding a `dino` module of `vit_type` at a
    `grid` x `grid` token grid (zeros: warm_start_mono replaces its leaves)."""
    shapes = jax.eval_shape(lambda: jdino.DinoViT(vit_type).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 14 * grid, 14 * grid, 3))))
    dino = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    return {"params": {"dino": dino}}


def holder(vit_type: str) -> torch.nn.Module:
    """A module with the port's `dino` ViT, as the mono encoder holds it."""
    m = torch.nn.Module()
    m.dino = tdino.DinoViT(vit_type, GRID)
    return m


@pytest.mark.parametrize("vit_type", list(TINY_VITS))
def test_warm_start_mono_vs_jax(tmp_path, vit_type):
    """One torch.save'd DINOv2 file into both packages' ViT: the same leaf
    count, and JAX's converted tree (convert_dinov2's per-head kernels
    through torch_state_from_flax) equal to the port's, pos_embed within
    1e-6 and every other leaf bit for bit."""
    path = tmp_path / "dinov2.pth"
    torch.save(fake_dinov2(vit_type), path)
    merged, n_jax = jckpt.warm_start_mono(jax_dino_tree(vit_type), str(path))
    model = holder(vit_type)
    n_port = ckpt.warm_start_mono(model, path)
    _, _, depth = TINY_VITS[vit_type]
    assert n_port == n_jax == 5 + 18 * depth
    ref = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, merged["params"]["dino"]))
    got = model.dino.state_dict()
    assert set(ref) == set(got)
    for k, v in ref.items():
        if k == "pos_embed":
            assert float((got[k] - v).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(got[k], v), k


def test_mono_errors_as_in_jax(tmp_path):
    """warm_start_mono's ValueErrors on both sides: no dino module
    (add_mono_feat off), no leaf matched (a 128-wide file into a 64-wide
    ViT), and a checkpoint whose pos_embed is no square grid. The port's
    own: the ViT refuses an input of another token grid than it was built
    for, and the mono encoder needs that grid; an unknown vit_type is a
    KeyError, as in JAX."""
    vit = tdino.DinoViT("test", GRID)
    with pytest.raises(ValueError, match="token grid"):
        vit(torch.zeros(1, 14 * (GRID + 1), 14 * (GRID + 1), 3))
    with pytest.raises(KeyError):
        tdino.DinoViT("vitz", GRID)
    with pytest.raises(KeyError):
        jdino.DinoViT("vitz").init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))
    with pytest.raises(ValueError, match="mono_grid"):
        EncoderCostVolume360(EncoderConfig(**ENC_KW, add_mono_feat=True))
    path = tmp_path / "dinov2.pth"
    torch.save(fake_dinov2("test"), path)
    with pytest.raises(ValueError, match="add_mono_feat"):
        jckpt.warm_start_mono({"params": {}}, str(path))
    with pytest.raises(ValueError, match="add_mono_feat"):
        ckpt.warm_start_mono(torch.nn.Module(), path)
    wide = tmp_path / "wide.pth"
    torch.save(fake_dinov2("test2"), wide)
    with pytest.raises(ValueError, match="0 parameter leaves"):
        jckpt.warm_start_mono(jax_dino_tree("test"), str(wide))
    with pytest.raises(ValueError, match="0 parameter leaves"):
        ckpt.warm_start_mono(holder("test"), wide)
    odd = tmp_path / "odd.pth"
    torch.save(fake_dinov2("test", grid=1) | {"pos_embed": torch.zeros(1, 1 + 12, 64)}, odd)
    with pytest.raises(ValueError):
        jckpt.warm_start_mono(jax_dino_tree("test"), str(odd))
    with pytest.raises(ValueError, match="non-square"):
        ckpt.warm_start_mono(holder("test"), odd)


CLI_H, CLI_W = 32, 64  # cube faces of 16: resized to 14, a 1x1 token grid


def test_cli_train_with_pretrained_mono(tmp_path, capsys):
    """The port's CLI, mode=train for 1 step on the CPU, synthetic_smoke.yaml
    at 32x64 with model.add_mono_feat=true, the tiny ViT and
    checkpointing.pretrained_mono: it prints JAX's leaf count for the file,
    and the ViT in the step's checkpoint is the file's, bit for bit."""
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.utils.torch_convert import convert_dinov2, load_torch_state_dict
    from test_torch_eval import OVERRIDES

    data, out, path = tmp_path / "data", tmp_path / "out", tmp_path / "dinov2.pth"
    write_synthetic_scene(data, "train", "s0", n_frames=12, image_shape=(CLI_H, CLI_W),
                          n_gaussians=300, seed=3, device="cpu")
    torch.save({"model": fake_dinov2("test")}, path)
    tiny = [o for o in OVERRIDES if not o.startswith(("mode=", "test.", "dataset.image_shape"))]
    main([str(REPO / "configs" / "synthetic_smoke.yaml"), "mode=train", *tiny,
          f"dataset.roots=[{data}]", f"dataset.image_shape=[{CLI_H},{CLI_W}]",
          "model.bf16_compute=false", "model.add_mono_feat=true", "model.vit_type=test",
          f"checkpointing.pretrained_mono={path}",
          f"output_dir={out}", "trainer.batch_size=1", "trainer.max_steps=1",
          "trainer.num_sanity_val_steps=0", "trainer.val_check_interval=0",
          "dataset.view_sampler.num_target_views=1", "train.loss.lpips_weight=0"], device="cpu")
    printed = capsys.readouterr().out
    grid = tdino.token_grid(CLI_H // 2)
    _, n_jax = jckpt.warm_start_mono(jax_dino_tree("test", grid), str(path))
    assert f"warm-started the mono branch from pretrained_mono ({n_jax} leaves)" in printed
    assert "step 1:" in printed
    saved = torch.load(out / "checkpoints" / "1" / ckpt.FILE, map_location="cpu",
                       weights_only=True)
    ref = convert_dinov2(load_torch_state_dict(path), grid)
    for k, v in ref.items():
        assert torch.equal(saved["params"][f"dino.{k}"], v), k
    # the optimizer holds the trainable parameters only
    n_trainable = sum(1 for k in saved["params"] if not k.startswith("dino."))
    assert len(saved["opt_state"]["param_groups"][0]["params"]) == n_trainable
