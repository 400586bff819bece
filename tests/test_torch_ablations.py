"""The encoder's Table 3 options, the port against the JAX package.

The option groups are chip_smoke.py's OPTION_GROUPS (every flag in one of them):
fusion_type concat; biproj with use_epipolar_trans; wo_cost_volume with
wo_depth_refine; wo_cost_volume_refine with wo_backbone_cross_attn;
wo_cube_encoder; wo_erp_encoder; gaussians_per_pixel 2, alone and with
wo_depth_refine. Each group's tiny encoder (test_torch_encoder.ENC_KW at
32x64, 16x16 cube faces, the backbones cut to 2 transformer layers on both
sides) gets seeded random Flax parameters in the tree of the port's module
names; the Flax tree JAX's init builds must be that tree, and
torch_state_from_flax loads it into the port with strict=True. Bars:
  * float32: every output within 1e-4 of max|x| (TOL_DEEP), and the
    gradient of a fixed scalar loss of the outputs within 2e-3 of the
    global max|g| in every parameter (GRAD_TOL);
  * bf16 (apply_encoder against _mixed_precision_apply, jitted as
    test_torch_bf16.py jits it): each output within the policy's rounding,
    d_port <= 1.5 d_policy by max and 1.25 by mean (ENCODER_RATIO,
    ENCODER_MEAN_RATIO).
The JAX side of each group (its init tree, the jitted float32 value and
gradient, the jitted bf16 outputs) is computed in WORKERS spawned
processes started when the module's first test asks for them, so that the
compiles run side by side and beside the port's own runs.
"""

import functools
import os
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter360_tpu.config import config_to_dict as j_config_to_dict
from splatter360_tpu.config import load_config as j_load_config
from splatter360_tpu_torch.config import config_to_dict, load_config
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models import encoder as tenc
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.backbone import BackboneMultiview
from splatter360_tpu_torch.models.encoder import EncoderConfig, EncoderCostVolume360, apply_encoder
from splatter360_tpu_torch.serve import context_cubes
from test_torch_bf16 import ENCODER_MEAN_RATIO, ENCODER_RATIO, distances
from test_torch_encoder import ENC_KW, TOL_DEEP, encoder_inputs
from test_torch_train import GRAD_TOL

from chip_smoke import OPTION_GROUPS as GROUPS

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
H, W = 32, 64
LAYERS = 2  # transformer layers of each backbone (6 in the model)
NOISE_SEEDS = 20  # script mode: 1e-6 perturbations per bf16 miss
STEP = 10**9  # past the opacity warm-up
OUTPUTS = ("means", "covariances", "harmonics", "opacities", "depth")
# Gradient leaves held at a bar of their own: each is one jump of the
# function. One ReLU input of the ERP backbone's CNN (residual block 0,
# |x| = 1.45e-7 on the port) lies on the other side of 0 in JAX, and a
# 1e-6 perturbation of the parameters moves the port's gradient of the
# leaf by the whole JAX - port distance at cosine +0.9995 or more (the
# measurements below; `python tests/test_torch_ablations.py` prints them;
# ROADMAP Queue 3). Every other leaf is held at GRAD_TOL.
GRAD_JUMPS = {  # (group, leaf): bar  # measured distance = jump
    ("concat", "backbone_erp.CNNEncoder_0.ResidualBlock_1.Conv_0.weight"): 3.5e-3,  # 2.783e-3
    ("wo_cost_volume+wo_depth_refine",
     "backbone_erp.CNNEncoder_0.ResidualBlock_0.Conv_0.weight"): 3.5e-3,  # 2.126e-3
    ("wo_cost_volume+wo_depth_refine",
     "backbone_erp.CNNEncoder_0.ResidualBlock_1.Conv_0.weight"): 1.3e-2,  # 1.116e-2
    ("wo_cube_encoder", "backbone_erp.CNNEncoder_0.ResidualBlock_0.Conv_0.weight"): 3.5e-3,
    # 2.694e-3
    ("gpp2+wo_depth_refine",
     "backbone_erp.CNNEncoder_0.ResidualBlock_1.Conv_0.weight"): 5.5e-3,  # 4.537e-3
}
# bf16 outputs held at a max ratio of their own (the mean bar is kept):
# in each, the elements past 1.5 d_policy are one pixel's, and that pixel's
# bf16 value moves by the whole port - JAX distance under a 1e-6
# perturbation of the float32 master parameters (some of them then round
# to another bf16 value): concat's pixel 2281 (its depth 5.59 on the port,
# 5.83 in JAX's bf16, 5.69 in f32) by up to 1.09-1.17 of its distance over
# 20 perturbation seeds, gpp2+wo_depth_refine's pixel 3260 by up to 1.06
# over 80 seeds (script mode; ROADMAP Queue 3).
BF16_JUMPS = {  # (group, output): max ratio  # measured d_port / d_policy
    ("concat", "means"): 2.0,  # 1.78
    ("concat", "covariances"): 2.0,  # 1.72
    ("concat", "depth"): 2.0,  # 1.78
    ("gpp2+wo_depth_refine", "harmonics"): 1.8,  # 1.61
}
# the tiny encoders' keyword arguments: the epipolar block gathers 8
# samples a candidate ray (32 in the model)
TINY_KW = dict(ENC_KW, epipolar_num_samples=8)
# JAX's side of the groups runs in WORKERS processes beside the rest of the
# suite: at most half the host's cores and 4 (each holds ~0.9 GB)
WORKERS = max(1, min(4, (os.cpu_count() or 2) // 2))
# the longest a test waits for its group's JAX side (~20-40 s a group alone;
# a worker that hangs or dies fails the test in bounded time, not the suite)
RESULT_TIMEOUT = 900


def _cut_backbones():
    """Both packages' encoders build their backbones with LAYERS layers."""
    import splatter360_tpu.models.encoder as jenc
    from splatter360_tpu.models.backbone import BackboneMultiview as JBackbone

    jenc.BackboneMultiview = functools.partial(JBackbone, num_transformer_layers=LAYERS)
    tenc.BackboneMultiview = functools.partial(BackboneMultiview, num_transformer_layers=LAYERS)


def _worker_setup():
    """A worker's JAX: the suite's settings (conftest.py: the CPU, float32
    matmuls at full precision, the compile cache) and the cut backbones."""
    import conftest  # noqa: F401

    _cut_backbones()


def port_encoder(kw: dict, bf16: bool = False) -> EncoderCostVolume360:
    return EncoderCostVolume360(EncoderConfig(
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1), bf16_compute=bf16, **TINY_KW,
        **kw))


def flax_params(model: EncoderCostVolume360, kw: dict, seed: int = 0) -> dict:
    """Seeded random Flax params in the tree of the port's `model` (Flax's
    leaf names and layouts): kernels N(0, 1/fan_in), scales 1 + N(0, 0.1),
    biases N(0, 0.1), depth_pe N(0, 1/D); the disparity-delta head (the
    depth predictor's last conv, whose number shifts with the ablations)
    shrunk 10x so the fine depth stays off its 1/far clip, where
    1/disparity magnifies rounding."""
    convs = [k.split(".")[1] for k in model.state_dict() if k.startswith("depth_predictor.Conv_")]
    head = None if kw.get("wo_depth_refine") else max(convs, key=lambda k: int(k[5:]))
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, w in sorted(model.state_dict().items()):
        *mods, leaf = name.replace("ResBlock_", "CheckpointResBlock_").split(".")
        shape = tuple(w.shape)
        if leaf == "bias":
            x = 0.1 * rng.normal(size=shape)
        elif leaf == "depth_pe":
            x = rng.normal(size=shape) / np.sqrt(shape[0])
        elif len(shape) == 1:
            leaf, x = "scale", 1.0 + 0.1 * rng.normal(size=shape)
        else:
            shape = shape[::-1] if len(shape) == 2 else (*shape[2:], shape[1], shape[0])
            leaf, x = "kernel", rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        if mods[:2] == ["depth_predictor", head]:
            x = 0.1 * x
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = x.astype(np.float32)
    return {"params": tree}


def probe_weights(shape) -> np.ndarray:
    """The fixed weights of the scalar loss sum(out * w) for one output."""
    n = int(np.prod(shape))
    return (np.cos(0.37 * np.arange(n)) / n).reshape(shape).astype(np.float32)


def _tree_shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def jax_reference(group: str) -> dict:
    """One group in a worker: JAX's init tree against the port's, the
    jitted float32 outputs and parameter gradients, the jitted bf16 outputs."""
    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes, _mixed_precision_apply

    kw = GROUPS[group]
    img, ext, near, far = encoder_inputs(H, W)
    jm = JEncoder(JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **TINY_KW, **kw))
    args = (img, _context_cubes(jnp.asarray(img), H // 2), ext, near, far, STEP)
    params = flax_params(port_encoder(kw), kw)
    init_tree = _tree_shapes(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args[:5])))

    def loss(p):
        g, d = jm.apply(p, *args)
        outs = (*g, d)
        return sum(jnp.sum(x * probe_weights(x.shape)) for x in outs), outs

    (_, f32), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    bf16 = jax.jit(lambda p: _mixed_precision_apply(jm)(p, *args))(params)
    flat = jax.tree_util.tree_map(np.asarray, grads)
    return dict(tree_match=init_tree == _tree_shapes(params), f32=[np.asarray(x) for x in f32],
                bf16=[np.asarray(jnp.asarray(x).astype(jnp.float32)) for x in (*bf16[0], bf16[1])],
                grads=torch_state_from_flax(flat))


@pytest.fixture(scope="module")
def cut_backbones():
    """_cut_backbones for this module's tests; both packages' encoders get
    their 6-layer backbones back after it (later modules of the process)."""
    import splatter360_tpu.models.encoder as jenc

    saved = jenc.BackboneMultiview, tenc.BackboneMultiview
    _cut_backbones()
    yield
    jenc.BackboneMultiview, tenc.BackboneMultiview = saved


@pytest.fixture(scope="module")
def jax_refs(cut_backbones):
    """{group: Future of jax_reference(group)}, computed WORKERS at a time."""
    pool = ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_worker_setup)
    yield {g: pool.submit(jax_reference, g) for g in GROUPS}
    pool.shutdown(cancel_futures=True)


def port_run(kw: dict, bf16: bool):
    """The port's outputs (and, in float32, the gradients of the probe loss)
    on the group's parameters."""
    img, ext, near, far = (torch.from_numpy(a) for a in encoder_inputs(H, W))
    model = port_encoder(kw, bf16)
    model.load_state_dict(torch_state_from_flax(flax_params(model, kw)), strict=True)
    model.eval()
    with torch.set_grad_enabled(not bf16):
        g, d = apply_encoder(model, img, context_cubes(img, H // 2), ext, near, far, STEP)
        outs = (*g, d)
        if not bf16:
            sum(torch.sum(x * torch.from_numpy(probe_weights(tuple(x.shape)))) for x in outs
                ).backward()
    return [x.detach() for x in outs], {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("group", list(GROUPS))
def test_option_loads_as_in_jax(group):
    """The group's overrides on hm3d.yaml load to the JAX package's config."""
    ov = [f"model.{k}={str(v).lower() if isinstance(v, bool) else v}"
          for k, v in GROUPS[group].items()]
    hm3d = str(REPO / "configs" / "hm3d.yaml")
    assert config_to_dict(load_config(hm3d, ov)) == j_config_to_dict(j_load_config(hm3d, ov))


@pytest.mark.parametrize("group", list(GROUPS))
def test_option_f32_vs_jax(jax_refs, group):
    """Outputs at 1e-4 of max|x| and every parameter's gradient at 2e-3 of
    the global max|g|; JAX's init tree is the port's."""
    kw = GROUPS[group]
    outs, grads = port_run(kw, bf16=False)
    ref = jax_refs[group].result(timeout=RESULT_TIMEOUT)
    assert ref["tree_match"], "JAX's parameter tree is not the port's"
    n = 2 * H * W * kw.get("gaussians_per_pixel", 1)
    assert outs[0].shape == (1, n, 3)
    for name, a, b in zip(OUTPUTS, ref["f32"], outs):
        assert a.shape == tuple(b.shape), (name, a.shape, b.shape)
        err = np.abs(a - b.numpy()).max() / (np.abs(a).max() + 1e-12)
        assert err <= TOL_DEEP, f"{group} {name}: {err:.2e}"
    assert set(grads) == set(ref["grads"])
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        d = float((grads[k] - g).abs().max()) / scale
        assert d <= GRAD_JUMPS.get((group, k), GRAD_TOL), (k, d)


@pytest.mark.parametrize("group", list(GROUPS))
def test_option_bf16_vs_jax(jax_refs, group):
    """Each output within the policy's own rounding: d_port <= 1.5 d_policy
    (max) and <= 1.25 (mean), d_policy being JAX bf16 against JAX f32."""
    outs, _ = port_run(GROUPS[group], bf16=True)
    ref = jax_refs[group].result(timeout=RESULT_TIMEOUT)
    for name, j32, j16, p16 in zip(OUTPUTS, ref["f32"], ref["bf16"], outs):
        assert p16.dtype == torch.float32 and torch.isfinite(p16).all(), name
        (d_port, d_policy), (m_port, m_policy) = distances(j32, j16, p16)
        print(f"{group} {name}: d_port {d_port:.3e}, d_policy {d_policy:.3e}; mean "
              f"{m_port:.3e} vs {m_policy:.3e}")
        assert d_port <= BF16_JUMPS.get((group, name), ENCODER_RATIO) * d_policy, name
        assert m_port <= ENCODER_MEAN_RATIO * m_policy, (name, m_port, m_policy)


def test_num_surfaces_2_raises_on_both_sides():
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes

    kw = dict(ENC_KW, num_surfaces=2)
    with pytest.raises(NotImplementedError, match="num_surfaces"):
        load_config(str(REPO / "configs" / "hm3d.yaml"), ["model.num_surfaces=2"])
    with pytest.raises(NotImplementedError, match="num_surfaces"):
        EncoderCostVolume360(EncoderConfig(**kw))
    img, ext, near, far = encoder_inputs(H, W)
    jm = JEncoder(JEncoderConfig(**kw))
    with pytest.raises(NotImplementedError, match="num_surfaces"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img,
                                       _context_cubes(jnp.asarray(img), H // 2), ext, near, far))


def test_unknown_fusion_type_is_a_key_error():
    """FUSION_LAYERS[fusion_type], as in the JAX encoder."""
    with pytest.raises(KeyError):
        EncoderCostVolume360(EncoderConfig(**ENC_KW, fusion_type="sum"))



if __name__ == "__main__":
    # Script mode (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ablations.py
    # [group ...]): for each group, the float32 gradient leaves past GRAD_TOL
    # with their distance to JAX, how far the port's own gradient of that
    # leaf moves when its parameters are scaled by 1 + 1e-6 noise, and the
    # cosine of that move with the JAX - port difference; and the bf16
    # outputs past a bar, with their worst element's depth on each side.
    import sys

    import conftest  # noqa: F401

    _cut_backbones()
    for group in sys.argv[1:] or list(GROUPS):
        kw = GROUPS[group]
        ref = jax_reference(group)
        outs, grads = port_run(kw, bf16=False)
        scale = max(float(g.abs().max()) for g in ref["grads"].values())
        img, ext, near, far = (torch.from_numpy(a) for a in encoder_inputs(H, W))
        gen = torch.Generator().manual_seed(10)
        model = port_encoder(kw)
        state = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                 for k, v in torch_state_from_flax(flax_params(model, kw)).items()}
        model.load_state_dict(state)
        model.eval()
        g, d = apply_encoder(model, img, context_cubes(img, H // 2), ext, near, far, STEP)
        sum(torch.sum(x * torch.from_numpy(probe_weights(tuple(x.shape)))) for x in (*g, d)
            ).backward()
        for k, gj in ref["grads"].items():
            gap = (gj - grads[k]).flatten()
            if float(gap.abs().max()) / scale > GRAD_TOL:
                jump = (dict(model.named_parameters())[k].grad - grads[k]).flatten()
                cos = float(gap @ jump / (gap.norm() * jump.norm() + 1e-30))
                print(f"{group} {k}: JAX - port {float(gap.abs().max()) / scale:.3e}, port's "
                      f"jump {float(jump.abs().max()) / scale:.3e} of max|g|, cosine {cos:+.4f}")
        p16, _ = port_run(kw, bf16=True)
        for name, j32, j16, p in zip(OUTPUTS, ref["f32"], ref["bf16"], p16):
            (d_port, d_policy), (m_port, m_policy) = distances(j32, j16, p)
            if d_port > ENCODER_RATIO * d_policy or m_port > ENCODER_MEAN_RATIO * m_policy:
                diff = np.abs(p.numpy() - j16).reshape(-1, *p.shape[2:]) if name != "depth" \
                    else np.abs(p.numpy() - j16).reshape(-1)
                i = np.unravel_index(np.argmax(diff), diff.shape)[0]
                gpp = kw.get("gaussians_per_pixel", 1)
                pix = i // gpp if name != "depth" else i
                dep = [np.asarray(x).reshape(-1)[pix] for x in (ref["f32"][4], ref["bf16"][4],
                                                                  p16[4])]
                n_over = int((np.abs(p.numpy() - j16) > 1.5 * d_policy * np.abs(j32).max()).sum())
                print(f"{group} {name}: d_port/d_policy {d_port / d_policy:.2f}, mean "
                      f"{m_port / m_policy:.2f}; {n_over} elements past 1.5 d_policy; worst "
                      f"at Gaussian {i} (pixel {pix}): depth JAX f32 {dep[0]:.4f}, JAX bf16 "
                      f"{dep[1]:.4f}, port bf16 {dep[2]:.4f} (far 10)")
                # the worst element's move when the float32 master parameters are
                # scaled by 1 + 1e-6 noise (a few hundred of them round to
                # another bf16 value), relative to max|JAX f32|
                moves = []
                for seed in range(10, 10 + NOISE_SEEDS):
                    gen = torch.Generator().manual_seed(seed)
                    m16 = port_encoder(kw, bf16=True)
                    m16.load_state_dict({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                                         for k, v in torch_state_from_flax(
                                             flax_params(m16, kw)).items()})
                    with torch.no_grad():
                        gq, dq = apply_encoder(m16.eval(), img, context_cubes(img, H // 2), ext,
                                               near, far, STEP)
                    q = (*gq, dq)[OUTPUTS.index(name)].numpy()
                    move = np.abs(q - p.numpy()).reshape(diff.shape)
                    moves.append(move[i].max() / diff[i].max())
                gap = diff[i].max() / np.abs(j32).max()
                print(f"  under 1e-6 noise ({NOISE_SEEDS} seeds) the worst element moves by "
                      f"{min(moves):.2f}-{max(moves):.2f} of its gap ({gap:.3e} of max|x|)")
