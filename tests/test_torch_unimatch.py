"""The UniMatch backbone warm start (checkpointing.pretrained_backbone), the
port against the JAX package.

One torch.save'd file in UniMatch gmdepth's layout (chip_smoke.unimatch_state:
the 115 keys and shapes of tests/data/unimatch_state_dict_keys.json, seeded,
with random LayerNorm weights and biases, so a scale swapped with its bias
shows) goes into an encoder at d_feature 128 with 6-layer backbones and tiny
depth heads on both sides:
  * the port's warm_start_backbones against JAX's warm_start_backbones
    followed by convert.torch_state_from_flax: every parameter bit for bit
    and the same count, for the default model and the options that leave a
    backbone (wo_cube_encoder) or its cross-attention (wo_backbone_cross_attn)
    out, with the file's keys bare and under `module.` in {"model": ...};
  * every key of the map consumed, and a ValueError on both sides when no
    parameter matches;
  * the warm-started backbone's forward against JAX's at 1e-4 of max|x|: a
    transposed square kernel ([128, 128] q/k/v/merge) passes every shape and
    count check and shows only here;
  * the port's CLI, mode=train with the file, prints JAX's count.
The JAX tree is flax_params of the port's model (tests/test_torch_ablations.py
holds it equal to JAX's init tree for every option); its backbones are held
to JAX's BackboneMultiview init tree here too.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter360_tpu.models.backbone import BackboneMultiview as JBackbone
from splatter360_tpu.train import checkpoint as jckpt
from splatter360_tpu_torch.convert import torch_state_from_flax
from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
from splatter360_tpu_torch.models.encoder import EncoderConfig, EncoderCostVolume360
from splatter360_tpu_torch.train import checkpoint as ckpt
from splatter360_tpu_torch.utils.torch_convert import convert_unimatch_backbone
from test_torch_ablations import _tree_shapes, flax_params
from test_torch_serve import ENC_KW

from chip_smoke import UNIMATCH_KEYS, unimatch_state

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
KW = dict(ENC_KW, d_feature=128)  # the gmdepth file's width
N_KEYS = 115
OPTIONS = {"default": {}, "wo_cube_encoder": {"wo_cube_encoder": True},
           "wo_backbone_cross_attn": {"wo_backbone_cross_attn": True}}
# parameters copied: 115 a backbone (19 CNN, 6 layers of 6 self + 10 cross);
# without cross-attention 19 + 6 * 6 (the self layer's FFN is not in the file)
COUNTS = {"default": 2 * N_KEYS, "wo_cube_encoder": N_KEYS, "wo_backbone_cross_attn": 2 * 55}
TOL_DEEP = 1e-4


def port_encoder(kw: dict) -> EncoderCostVolume360:
    return EncoderCostVolume360(EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
                                              **KW, **kw)).eval()


def save(sd: dict, path: Path, wrapped: bool) -> Path:
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}} if wrapped else sd, path)
    return path


@pytest.fixture(scope="module")
def gmdepth(tmp_path_factory):
    """The seeded state dict, and the file written bare and wrapped."""
    root = tmp_path_factory.mktemp("gmdepth")
    sd = unimatch_state(7)
    return dict(sd=sd, bare=save(sd, root / "bare.pth", False),
                wrapped=save(sd, root / "wrapped.pth", True))


def test_the_file_is_the_key_map(gmdepth):
    """115 keys with the map's shapes; the converter takes every one of them
    (each file tensor lands in exactly one backbone parameter)."""
    keys = json.loads(UNIMATCH_KEYS.read_text())
    sd = gmdepth["sd"]
    assert len(keys) == N_KEYS and {k: list(v.shape) for k, v in sd.items()} == keys
    out = convert_unimatch_backbone(sd)
    assert sorted(id(v) for v in out.values()) == sorted(id(v) for v in sd.values())
    shapes = {k: tuple(p.shape) for k, p in port_encoder({}).backbone_cube.named_parameters()}
    assert all(shapes[k] == tuple(v.shape) for k, v in out.items())


@pytest.mark.parametrize("layout", ["bare", "wrapped"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_warm_start_backbones_vs_jax(gmdepth, option, layout):
    """The port's warm start equals JAX's, converted, on every parameter of
    the encoder, with the same count, each backbone the model has taking
    its share; the backbones' trees are JAX's."""
    kw = OPTIONS[option]
    model = port_encoder(kw)
    tree = flax_params(model, kw)
    present = [n for n in ("backbone_cube", "backbone_erp") if n in tree["params"]]
    jb = JBackbone(feature_channels=128, no_cross_attn=kw.get("wo_backbone_cross_attn", False))
    init = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 128, 3))))
    for name in present:
        assert _tree_shapes(init["params"]) == _tree_shapes(tree["params"][name]), name
    model.load_state_dict(torch_state_from_flax(tree), strict=True)
    merged, n_jax = jckpt.warm_start_backbones(tree, str(gmdepth[layout]))
    n_port = ckpt.warm_start_backbones(model, gmdepth[layout])
    assert n_port == n_jax == COUNTS[option]
    ref = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, merged))
    got = model.state_dict()
    assert set(ref) == set(got)
    assert [k for k in ref if not torch.equal(got[k], ref[k])] == []
    donor = convert_unimatch_backbone(gmdepth["sd"])
    for name in present:
        params = dict(getattr(model, name).named_parameters())
        copied = [k for k, v in donor.items() if k in params and torch.equal(params[k], v)]
        assert len(copied) == COUNTS[option] // len(present), name


def test_zero_leaves_raise_on_both_sides(gmdepth, tmp_path):
    """ValueError naming pretrained_backbone on both sides when no parameter
    matches: a model without backbones, and a file whose tensors fit no
    parameter's shape (each one row longer); KeyError on both sides
    for a file without a key the converter needs."""
    with pytest.raises(ValueError, match="pretrained_backbone.*0 parameter leaves"):
        jckpt.warm_start_backbones({"params": {}}, str(gmdepth["bare"]))
    with pytest.raises(ValueError, match="pretrained_backbone.*0 parameter leaves"):
        ckpt.warm_start_backbones(torch.nn.Module(), gmdepth["bare"])
    wide = save({k: torch.zeros(v.shape[0] + 1, *v.shape[1:]) for k, v in gmdepth["sd"].items()},
                tmp_path / "wide.pth", False)
    model = port_encoder({})
    tree = flax_params(model, {})
    with pytest.raises(ValueError, match="0 parameter leaves"):
        jckpt.warm_start_backbones(tree, str(wide))
    with pytest.raises(ValueError, match="0 parameter leaves"):
        ckpt.warm_start_backbones(model, wide)
    short = save({k: v for k, v in gmdepth["sd"].items() if "merge" not in k},
                 tmp_path / "short.pth", False)
    with pytest.raises(KeyError):
        jckpt.warm_start_backbones(tree, str(short))
    with pytest.raises(KeyError):
        ckpt.warm_start_backbones(model, short)


def test_warm_started_backbone_forward_vs_jax(gmdepth):
    """BackboneMultiview warm-started from the file, on 2 seeded 64x128
    views (8x16 features, 2x2 windows of 4x8 tokens): both outputs within
    1e-4 of max|x| of JAX's jitted forward on JAX's warm-started tree."""
    model = port_encoder({})
    tree = flax_params(model, {})
    model.load_state_dict(torch_state_from_flax(tree), strict=True)
    merged, _ = jckpt.warm_start_backbones(tree, str(gmdepth["bare"]))
    ckpt.warm_start_backbones(model, gmdepth["bare"])
    img = np.random.default_rng(3).uniform(0, 1, (1, 2, 64, 128, 3)).astype(np.float32)
    ref = jax.jit(JBackbone(feature_channels=128).apply)(
        {"params": merged["params"]["backbone_cube"]}, img)
    with torch.no_grad():
        got = model.backbone_cube(torch.from_numpy(img))
    for name, a, b in zip(("transformer", "cnn"), ref, got):
        a = np.asarray(a)
        err = float(np.abs(a - b.numpy()).max() / np.abs(a).max())
        print(f"{name} features: {err:.2e} of max|x|")
        assert err <= TOL_DEEP, (name, err)


def test_cli_train_with_pretrained_backbone(gmdepth, tmp_path, capsys):
    """The port's CLI, mode=train for 1 step on the CPU, synthetic_smoke.yaml
    at 32x64 with d_feature 128 and checkpointing.pretrained_backbone: it
    prints the count JAX's warm start gives on JAX's init tree of the same
    config, and the step's checkpoint holds the file's weights after one
    step."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.main import main
    from test_torch_eval import OVERRIDES

    h, w = 32, 64
    data, out = tmp_path / "data", tmp_path / "out"
    write_synthetic_scene(data, "train", "s0", n_frames=12, image_shape=(h, w),
                          n_gaussians=300, seed=3, device="cpu")
    tiny = [o for o in OVERRIDES if not o.startswith(("mode=", "test.", "dataset.image_shape"))]
    argv = [*tiny, f"dataset.roots=[{data}]", f"dataset.image_shape=[{h},{w}]",
            "model.d_feature=128", f"checkpointing.pretrained_backbone={gmdepth['wrapped']}"]
    config = str(REPO / "configs" / "synthetic_smoke.yaml")
    jcfg = j_load_config(config, argv)
    img = np.zeros((1, 2, h, w, 3), np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    nf = np.ones((1, 2), np.float32)
    init = jax.eval_shape(lambda: JEncoder(jcfg.model).init(
        jax.random.PRNGKey(0), img, _context_cubes(jnp.asarray(img), h // 2), ext, nf, nf))
    _, n_jax = jckpt.warm_start_backbones(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), init),
        str(gmdepth["wrapped"]))
    assert n_jax == 2 * N_KEYS
    main([config, "mode=train", *argv, "model.bf16_compute=false", f"output_dir={out}",
          "trainer.batch_size=1", "trainer.max_steps=1", "trainer.num_sanity_val_steps=0",
          "trainer.val_check_interval=0", "dataset.view_sampler.num_target_views=1"],
         device="cpu")
    printed = capsys.readouterr().out
    assert f"warm-started both backbones from pretrained_backbone ({n_jax} leaves)" in printed
    assert "step 1:" in printed
    saved = torch.load(out / "checkpoints" / "1" / ckpt.FILE, map_location="cpu",
                       weights_only=True)["params"]
    # one Adam step (lr 2e-4 at most) from the file's weights
    for name in ("backbone_cube", "backbone_erp"):
        for k, v in convert_unimatch_backbone(gmdepth["sd"]).items():
            assert float((saved[f"{name}.{k}"] - v).abs().max()) < 1e-2, (name, k)
