"""The port's harness modules against the JAX package's: the config tree and
YAML loading, view samplers, scene shards, the dataset, the evaluation
index, checkpoints, image IO and offline metrics. No JAX compile: seconds.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from splatter360_tpu import config as jconfig
from splatter360_tpu.data import dataset as jdataset
from splatter360_tpu.data import scene_io as jscene_io
from splatter360_tpu.data import view_sampler as jsampler
from splatter360_tpu_torch import config as pconfig
from splatter360_tpu_torch import native
from splatter360_tpu_torch.data import dataset as pdataset
from splatter360_tpu_torch.data import scene_io as pscene_io
from splatter360_tpu_torch.data import view_sampler as psampler
from splatter360_tpu_torch.utils import image_io
from splatter360_tpu_torch.utils.yaml_subset import safe_load

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("hm3d.yaml", "replica.yaml", "synthetic_smoke.yaml")
OVERRIDE_VALUES = ("true", "false", "off", "3", "-7", "2.0e-4", "1e-4", ".5", "[/tmp/x]",
                   "[64,256]", "[1, 1, 1]", "[]", "test", "configs/hm3d.yaml", "wandb://run:v3",
                   "null", "~", "", "'quoted # x'", "[a, 'b c', 2.5]", "{}", "1_000")


def tree(cls) -> dict:
    """{field: default, or the nested config's tree} of a config dataclass."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif dataclasses.is_dataclass(f.default_factory):
            out[f.name] = tree(f.default_factory)
        else:
            out[f.name] = f.default_factory()
    return out


def test_config_tree_equals_jax():
    """Every key of the JAX tree, with its default, recursively (and no other)."""
    assert tree(pconfig.RootConfig) == tree(jconfig.RootConfig)
    assert pconfig.config_to_dict(pconfig.RootConfig()) == jconfig.config_to_dict(
        jconfig.RootConfig())


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configs_load_alike(name):
    """The committed configs load to the same tree in both packages, and the
    YAML subset reader gives yaml.safe_load's dict."""
    text = (REPO / "configs" / name).read_text()
    assert safe_load(text) == yaml.safe_load(text)
    got = pconfig.config_to_dict(pconfig.load_config(str(REPO / "configs" / name)))
    assert got == jconfig.config_to_dict(jconfig.load_config(str(REPO / "configs" / name)))


def test_yaml_subset_without_pyyaml(monkeypatch):
    """Without PyYAML (the card's machine) load_config reads the same trees."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **kw)

    for value in OVERRIDE_VALUES:
        got, ref = safe_load(value), yaml.safe_load(value)
        assert got == ref and type(got) is type(ref), value
    with monkeypatch.context() as mp:
        mp.setattr(builtins, "__import__", no_yaml)
        got = pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"),
                                  ["mode=test", "test.eval_depth=true"])
    ref = pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"), ["mode=test",
                                                                     "test.eval_depth=true"])
    assert got == ref and got.model.bf16_compute and got.test.eval_depth


@pytest.mark.parametrize("text", ("0x1f", "010", "1:30", "2024-01-01", "&a x", "*a", "!tag x",
                                  "|", "- a", "[[1]]", "{a: 1}", "a: [1, [2]]", '"esc\\n"',
                                  "a:\n- 1", "a:\n\tb: 1", "---\na: 1", "a: 1\na: 2"))
def test_yaml_subset_refuses_the_rest(text):
    with pytest.raises(ValueError):
        safe_load(text)


def test_overrides_and_unknown_keys():
    cfg = pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"),
                              ["mode=test", "dataset.roots=[a,b]", "train.optimizer.lr=1e-4",
                               "model.gaussian_adapter.sh_degree=2", "test.eval_on_cubes=true"])
    assert cfg.mode == "test" and cfg.dataset.roots == ("a", "b")
    assert cfg.train.optimizer.lr == 1e-4 and isinstance(cfg.train.optimizer.lr, float)
    assert cfg.model.gaussian_adapter.sh_degree == 2 and cfg.test.eval_on_cubes
    with pytest.raises(KeyError, match="EncoderConfig.not_a_key"):
        pconfig.load_config(None, ["model.not_a_key=1"])


@pytest.mark.parametrize("override", [
    "train.optimizer.cosine_lr=false", "train.loss.lpips_weights=w.pth",
    "train.loss.depth_smoothness_weight=0.1", "train.render_backend=jax",
    "model.add_mono_feat=true", "model.add_mono_feat=true checkpointing.pretrained_mono=x.pth",
    "test.save_video=true", "checkpointing.pretrained_backbone=x.pth"])
def test_values_ported_for_training_load(override):
    """The linear warm-up schedule, LPIPS weights, the depth smoothness
    weight, the scan compositor, the mono branch with its DINOv2 warm
    start, trajectory videos and the UniMatch backbone warm start load as
    in the JAX package (tests/test_torch_trainer.py trains with the first
    three against JAX, tests/test_torch_scan.py holds the scan compositor
    to composite_jax, tests/test_torch_mono.py the mono branch and its
    loader, tests/test_torch_video.py the videos, tests/test_torch_unimatch.py
    the UniMatch loader)."""
    ov = override.split()
    assert pconfig.config_to_dict(pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"), ov)) \
        == jconfig.config_to_dict(jconfig.load_config(str(REPO / "configs" / "hm3d.yaml"), ov))


def test_hm3d_model_block_is_the_preset():
    from splatter360_tpu_torch.models.encoder import HM3D

    cfg = pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"))
    assert cfg.model == dataclasses.replace(HM3D, costvolume_unet_channel_mult=[1, 1, 1],
                                            costvolume_unet_attn_res=[4], depth_unet_attn_res=[16],
                                            depth_unet_channel_mult=[1, 1, 1, 1, 1])


@pytest.mark.parametrize("stage, step", [("train", 0), ("train", 20), ("train", 10**6),
                                         ("test", 0)])
@pytest.mark.parametrize("n_ctx", [2, 3])
def test_bounded_sampler_same_frames(stage, step, n_ctx):
    kw = dict(num_context_views=n_ctx, num_target_views=4, min_distance_between_context_views=8,
              max_distance_between_context_views=30, warm_up_steps=40,
              initial_min_distance_between_context_views=3,
              initial_max_distance_between_context_views=6)
    j = jsampler.ViewSamplerBounded(jsampler.BoundedSamplerConfig(**kw), stage=stage)
    p = psampler.ViewSamplerBounded(psampler.BoundedSamplerConfig(**kw), stage=stage)
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    for n in (12, 60, 200):
        for _ in range(5):
            a, b = j.sample(n, rj, step), p.sample(n, rp, step)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    if stage == "test":
        assert p.sample(200, rp)[0][0] == 40  # the test stage's frame-40 start


def test_evaluation_sampler(tmp_path):
    path = tmp_path / "index.json"
    path.write_text(json.dumps({"s": {"context": [1, 9], "target": [3, 4, 5]}}))
    a = jsampler.ViewSamplerEvaluation(str(path)).sample("s")
    b = psampler.ViewSamplerEvaluation(str(path)).sample("s")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert psampler.ViewSamplerEvaluation(str(path)).sample("other") is None


def scene_arrays(seed, n=5, h=8, w=16):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    return (rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
            rng.integers(0, 60000, (n, h, w), dtype=np.uint16), poses)


def assert_scene_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shards", [True, False])
def test_scenes_round_trip_across_packages(tmp_path, monkeypatch, shards):
    """.s3z (native loader) or npz, written by either package and read by
    both, bit for bit."""
    assert native.available(), native.build_error()
    if not shards:
        monkeypatch.setattr(native, "available", lambda: False)
        from splatter360_tpu import native as jnative
        monkeypatch.setattr(jnative, "available", lambda: False)
    arrays = scene_arrays(0)
    path = pscene_io.save_scene(tmp_path / "p", "test", "s", *arrays)
    assert path.suffix == (".s3z" if shards else ".npz")
    jscene_io.save_scene(str(tmp_path / "j"), "test", "s", *arrays)
    assert (tmp_path / "j" / "test" / path.name).is_file()
    for root in ("p", "j"):
        ref = jscene_io.load_scene(str(tmp_path / root), "test", "s")
        assert_scene_equal(ref, pscene_io.load_scene(tmp_path / root, "test", "s"))
        np.testing.assert_array_equal(ref["rgb"], arrays[0])
    assert pscene_io.list_scenes(tmp_path / "p", "test") == ["s"]


def test_shard_without_loader_raises(tmp_path, monkeypatch):
    pscene_io.save_scene(tmp_path, "test", "s", *scene_arrays(1))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", "the scene-shard loader needs g++, which is not on PATH")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pscene_io.load_scene(tmp_path, "test", "s")
    # without the loader, writing falls to npz and says so
    assert pscene_io.save_scene(tmp_path, "test", "t", *scene_arrays(2)).suffix == ".npz"


def test_write_synthetic_scene(tmp_path):
    info = pscene_io.write_synthetic_scene(tmp_path, "test", "s", n_frames=3, image_shape=(16, 64),
                                           n_gaussians=200, seed=1, device="cpu")
    data = pscene_io.load_scene(tmp_path, "test", "s")
    assert data["rgb"].shape == (3, 16, 64, 3) and info["path"].exists()
    assert data["rgb"].std() > 0 and (data["depth_m"] > 0).mean() > 0.2


def write_scenes(root, n_scenes=3, n=14):
    for i in range(n_scenes):
        jscene_io.save_scene(str(root), "test", f"s{i}", *scene_arrays(10 + i, n=n))


@pytest.mark.parametrize("stage", ["train", "test"])
def test_scene_dataset_same_examples(tmp_path, stage):
    write_scenes(tmp_path)
    kw = dict(roots=(str(tmp_path),), image_shape=(8, 16))
    vs = dict(max_distance_between_context_views=6, min_distance_between_context_views=2)
    jd = jdataset.SceneDataset(jdataset.DatasetConfig(
        **kw, view_sampler=jsampler.BoundedSamplerConfig(**vs)), split="test", stage=stage, seed=3)
    pd = pdataset.SceneDataset(pdataset.DatasetConfig(
        **kw, view_sampler=psampler.BoundedSamplerConfig(**vs)), split="test", stage=stage, seed=3)
    n = 6 if stage == "train" else 3
    for a, b in zip([x for _, x in zip(range(n), jd)], [x for _, x in zip(range(n), pd)]):
        assert a["scene"] == b["scene"]
        for part in ("context", "target"):
            assert_scene_equal(a[part], b[part])
    ja = jdataset.batch_examples([next(iter(jd))] * 2)
    pa = pdataset.batch_examples([next(iter(pd))] * 2)
    assert ja["scene"] == pa["scene"]
    for part in ("context", "target"):
        assert_scene_equal(ja[part], pa[part])


def test_generate_index_same_json(tmp_path):
    from splatter360_tpu.evaluation.index_generator import IndexGeneratorConfig as JIC
    from splatter360_tpu.evaluation.index_generator import generate_index as j_generate
    from splatter360_tpu_torch.evaluation.index_generator import IndexGeneratorConfig
    from splatter360_tpu_torch.evaluation.index_generator import generate_index

    write_scenes(tmp_path / "data", n=60)
    for n_ctx in (2, 3):
        j_generate([str(tmp_path / "data")], "test", str(tmp_path / "j.json"),
                   JIC(frame_interval=20, num_context_views=n_ctx))
        generate_index([str(tmp_path / "data")], "test", str(tmp_path / "p.json"),
                       IndexGeneratorConfig(frame_interval=20, num_context_views=n_ctx))
        assert (tmp_path / "j.json").read_text() == (tmp_path / "p.json").read_text()


def test_generate_index_mode(tmp_path):
    from splatter360_tpu_torch.main import main

    write_scenes(tmp_path / "data", n_scenes=2, n=60)
    index = main([f"dataset.roots=[{tmp_path / 'data'}]", "mode=generate_index", "--device",
                  "cpu", f"output_dir={tmp_path / 'out'}"])
    assert json.loads((tmp_path / "out" / "evaluation_index.json").read_text()) == index
    assert sorted(index) == ["s0", "s1"]


def tiny_state(seed):
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, TrainConfig, create_train_state
    from test_torch_serve import ENC_KW

    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    return create_train_state(cfg, TrainConfig(optimizer=OptimizerConfig(max_steps=10)),
                              seed=seed, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    from splatter360_tpu_torch.train import checkpoint as ckpt

    state = tiny_state(0)
    for p in state.model.parameters():  # an Adam state to save
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.step = 7
    assert ckpt.latest_step(tmp_path) is None
    ckpt.save_checkpoint(tmp_path, 3, state)
    ckpt.save_checkpoint(tmp_path, 7, state, max_to_keep=1)
    assert ckpt.latest_step(tmp_path) == 7 and not (tmp_path / "3").exists()

    fresh = tiny_state(1)
    weights_only, ok = ckpt.restore_weights_only(tmp_path, tiny_state(1))
    assert ok and weights_only.step == 0 and not weights_only.optimizer.state
    full, ok = ckpt.restore_checkpoint(tmp_path, fresh)
    assert ok and full.step == 7
    for (name, a), b, c in zip(state.model.named_parameters(), full.model.parameters(),
                               weights_only.model.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c), name
        for k, v in state.optimizer.state[a].items():
            assert torch.equal(v, full.optimizer.state[b][k]), (name, k)
    assert ckpt.restore_weights_only(tmp_path / "missing", tiny_state(1))[1] is False


def test_wandb_uri_local_store(tmp_path, monkeypatch):
    from splatter360_tpu_torch.train.checkpoint import resolve_checkpoint_uri

    for v in ("v1", "v10", "v2"):
        (tmp_path / "ent_proj_run" / v).mkdir(parents=True)
    monkeypatch.setenv("SPLAT360_WANDB_ARTIFACTS", str(tmp_path))
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    assert resolve_checkpoint_uri("wandb://ent/proj/run") == str(tmp_path / "ent_proj_run" / "v10")
    assert resolve_checkpoint_uri("wandb://ent/proj/run:v2") == str(
        tmp_path / "ent_proj_run" / "v2")
    assert resolve_checkpoint_uri("/a/dir") == "/a/dir"
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_uri("wandb://other")


@pytest.mark.parametrize("shape", [(19, 23, 3), (11, 7, 4), (9, 13)])
def test_png_against_imageio(tmp_path, shape):
    import imageio.v2 as imageio

    x = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    if len(shape) == 3 and shape[-1] == 3:
        image_io.save_image(x, tmp_path / "p.png")
        np.testing.assert_array_equal(imageio.imread(tmp_path / "p.png"), x)
        f = x.astype(np.float32) / 255.0
        np.testing.assert_array_equal(image_io.load_image(tmp_path / "p.png"), f)
    imageio.imwrite(tmp_path / "i.png", x)
    got = image_io.decode_png((tmp_path / "i.png").read_bytes())
    np.testing.assert_array_equal(got.reshape(x.shape), x)


def test_png_row_filters(tmp_path):
    """Rows filtered with each PNG filter (Pillow's optimizer mixes them)."""
    from PIL import Image

    rng = np.random.default_rng(5)
    x = np.clip(np.cumsum(rng.normal(size=(40, 50, 3)), axis=1) * 9 + 128, 0, 255).astype(np.uint8)
    Image.fromarray(x).save(tmp_path / "o.png", optimize=True)
    np.testing.assert_array_equal(image_io.decode_png((tmp_path / "o.png").read_bytes()), x)
    # every filter type by hand (average and Paeth depend on the bytes to the left)
    import struct
    import zlib

    rows, prev = [], np.zeros(50 * 3, np.int64)
    for y in range(40):
        line = x[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(3, np.int64), line[:-3]])
        up_left = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        kind = y % 5
        pred = [0, left, prev, (left + prev) // 2, paeth][kind]
        rows.append(bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prev = line
    data = b"\x89PNG\r\n\x1a\n"
    for tag, body in ((b"IHDR", struct.pack(">IIBBBBB", 50, 40, 8, 2, 0, 0, 0)),
                      (b"IDAT", zlib.compress(b"".join(rows))), (b"IEND", b"")):
        data += struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
    np.testing.assert_array_equal(image_io.decode_png(data), x)


def test_inferno_against_matplotlib():
    import matplotlib

    from splatter360_tpu.utils.image_io import apply_depth_colormap as j_colormap

    table = matplotlib.colormaps["inferno"](np.arange(256))[:, :3]
    np.testing.assert_array_equal(np.asarray(image_io.INFERNO), table)
    d = np.random.default_rng(2).uniform(0.1, 9.0, (30, 40)).astype(np.float32)
    for near, far in ((None, None), (0.0, 0.5), (1.0, 4.0)):
        np.testing.assert_array_equal(image_io.apply_depth_colormap(d, near, far),
                                      j_colormap(d, near, far))


def test_hcat_vcat_as_jax():
    from splatter360_tpu.utils import image_io as j_io

    a = np.random.default_rng(3).uniform(size=(5, 7, 3)).astype(np.float32)
    b = np.random.default_rng(4).uniform(size=(3, 4, 3)).astype(np.float32)
    for fn in ("hcat", "vcat"):
        for pad in (0, 2):
            np.testing.assert_array_equal(getattr(image_io, fn)(a, b, pad=pad),
                                          getattr(j_io, fn)(a, b, pad=pad))


def test_compute_metrics_offline_vs_jax(tmp_path):
    from splatter360_tpu.evaluation.metric_computer import compute_metrics_offline as j_offline
    from splatter360_tpu_torch.main import main

    rng = np.random.default_rng(8)
    base = tmp_path / "run"
    for i in range(3):
        gt = rng.uniform(size=(24, 40, 3))
        image_io.save_image(gt, base / "gt" / f"{i:04d}.png")
        for m, noise in (("a", 0.05), ("b", 0.2)):
            pred = np.clip(gt + noise * rng.normal(size=gt.shape), 0, 1)
            image_io.save_image(pred, base / "methods" / m / f"{i:04d}.png")
    ref = j_offline(str(base / "gt"), {m: str(base / "methods" / m) for m in "ab"},
                    str(tmp_path / "jax"))
    got = main([f"output_dir={base}", "mode=compute_metrics"], device="cpu")
    assert sorted(got) == sorted(ref) == ["a", "b"]
    for m in ref:
        assert got[m]["n"] == ref[m]["n"] == 3 and got[m]["lpips"] is ref[m]["lpips"] is None
        assert abs(got[m]["psnr"] - ref[m]["psnr"]) < 1e-4
        assert abs(got[m]["ssim"] - ref[m]["ssim"]) < 1e-5
    assert (base / "metrics" / "sheets" / "a" / "0000.png").is_file()


def test_benchmarker_keys(tmp_path):
    from splatter360_tpu.utils.benchmarker import Benchmarker as JBenchmarker
    from splatter360_tpu_torch.utils.benchmarker import Benchmarker

    b, jb = Benchmarker("cpu"), JBenchmarker()
    for bench in (b, jb):
        with bench.time("decoder", num_calls=4):
            pass
    assert len(b.execution_times["decoder"]) == 4 and b.summarize().keys() == jb.summarize().keys()
    b.dump_memory(tmp_path / "m.json")
    jb.dump_memory(tmp_path / "j.json")  # CPU devices report no memory stats
    assert json.loads((tmp_path / "m.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text()) == {}


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    """main, the Evaluator's tools and the data writer go to the card unless
    told otherwise, and raise when there is none."""
    from splatter360_tpu_torch.evaluation.metric_computer import compute_metrics_offline
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.train.lpips import make_lpips_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_scenes(tmp_path / "data", n_scenes=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"dataset.roots=[{tmp_path / 'data'}]", "mode=test"])
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_metrics_offline(str(tmp_path), {}, str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pscene_io.write_synthetic_scene(tmp_path, "test", "x", n_frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lpips_fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["mode=train"])


SHARD_H, SHARD_W = 32, 64


@pytest.mark.parametrize("flag", ["shard_render", "shard_faces"])
def test_shard_flags_run_as_off_on_one_device(tmp_path, flag):
    """train.shard_render and train.shard_faces load, and on one device run
    as off, as the JAX package's do (it shards only across several devices;
    its sharded renders equal the unsharded ones, tests/test_render_sharding.py):
    one tiny train step (cube supervision for shard_faces, which JAX applies
    only there) and one Evaluator run on the CPU, bit-equal to the same with
    the flag unset."""
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.train.evaluator import Evaluator
    from splatter360_tpu_torch.train.state import create_train_state, train_step
    from test_torch_eval import OVERRIDES
    from test_torch_train import step_batch

    write_synthetic_scene(tmp_path / "data", "test", "t0", n_frames=12,
                          image_shape=(SHARD_H, SHARD_W), n_gaussians=200, seed=4, device="cpu")
    tiny = [o for o in OVERRIDES if not o.startswith("dataset.image_shape")]
    base = [*tiny, f"dataset.roots=[{tmp_path / 'data'}]",
            f"dataset.image_shape=[{SHARD_H},{SHARD_W}]", "model.bf16_compute=false",
            "train.loss.lpips_weight=0", "test.save_image=false"]
    if flag == "shard_faces":
        base.append("train.supervision=cubes")
    batch = step_batch()
    for part in batch.values():
        for k in ("image_sphere", "depth_sphere"):
            part[k] = part[k][:, :, :SHARD_H, :SHARD_W]
    runs = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for on in (False, True):
            cfg = pconfig.load_config(str(REPO / "configs" / "hm3d.yaml"), [
                *base, f"train.{flag}={str(on).lower()}", f"test.output_path={tmp_path / str(on)}"])
            assert getattr(cfg.train, flag) is on
            state = create_train_state(cfg.model, cfg.train, seed=0, device="cpu")
            metrics = train_step(state, batch)
            scores = Evaluator(cfg, state, device="cpu").run()
            runs[on] = (metrics, scores, state.model.state_dict())
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (m0, s0, p0), (m1, s1, p1) = runs[False], runs[True]
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert s0 == s1 and s0
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_make_eval_step_is_compute_losses_without_gradients():
    from splatter360_tpu_torch.train.losses import LossConfig
    from splatter360_tpu_torch.train.state import TrainConfig, compute_losses, make_eval_step
    from test_torch_train import step_batch

    state = tiny_state(0)
    state.step = 3
    tcfg = TrainConfig(loss=LossConfig(lpips_weight=0.0), supervision="erp")
    metrics = make_eval_step(tcfg)(state, step_batch())
    assert state.step == 3 and all(p.grad is None for p in state.model.parameters())
    assert not any(v.requires_grad for v in metrics.values())
    _, ref = compute_losses(dataclasses.replace(state, train_cfg=tcfg), step_batch())
    assert metrics.keys() == ref.keys() == {"psnr", "loss_mse", "dropped", "loss_depth", "loss"}
    for k in ref:
        assert torch.equal(metrics[k], ref[k].detach()), k
