"""The port's reading of what the JAX package writes: its orbax checkpoints
(train/orbax_reader.py over utils/zstd.py, train/checkpoint.py, the Adam
state through convert.adam_state_from_optax) and its scene files (the
reference-layout converters of data/scene_io.py).

Every checkpoint read here is written by the JAX package's
splatter360_tpu.train.checkpoint.save_checkpoint (orbax, OCDBT + zarr v2),
and the reader is held to the installed tensorstore (the OCDBT key-value
store, key for key and byte for byte) and to JAX's restore_checkpoint (bit
for bit). tests/data/torch_orbax_hm3d/ holds configs/hm3d.yaml's whole train
state at step 1234 with periodic values (each leaf repeats one seeded table
of 251 float32 values, so that zstd keeps ~1 KB a tensor), and expected.json
beside it: per key path, its shape, dtype and the sha256 of its bytes. It is
written by this file run as a script:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_orbax.py

and test_fixture_matches_a_fresh_save holds it to a fresh save of the same
tree and to the shapes of JAX's hm3d.yaml train state, so that it cannot
fall out of date unnoticed.
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))

from test_torch_serve import rand_params  # noqa: E402

torch.set_num_threads(2)
FIXTURE = REPO / "tests" / "data" / "torch_orbax_hm3d"
FIXTURE_STEP = 1234
TABLE = 251
SMOKE = str(REPO / "configs" / "synthetic_smoke.yaml")
TINY = [
    "dataset.image_shape=[64,128]", "model.d_feature=32", "model.num_depth_candidates=16",
    "model.costvolume_unet_feat_dim=32", "model.costvolume_unet_channel_mult=[1,1]",
    "model.costvolume_unet_attn_res=[2]", "model.depth_unet_feat_dim=8",
    "model.depth_unet_attn_res=[8]", "model.depth_unet_channel_mult=[1,1,1,1]",
    "model.gaussian_adapter.sh_degree=1", "train.loss.lpips_weight=0",
]
H, W = 64, 128
# test (f): one update after a restore, against optax, relative to max|p|
# (parameters) and to the moment's max (moments)
UPDATE_TOL = 1e-6
# the tiny ViT of tests/test_torch_mono.py: (width, heads, blocks)
TINY_VIT = ("test", (64, 1, 2))


# --- trees and states ----------------------------------------------------------

def key_str(entry) -> str:
    """A jax key-path entry as orbax names it (dict key, index, field)."""
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def flat(tree) -> dict:
    """{dotted key path: leaf} of a JAX tree (None leaves dropped)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(key_str(k) for k in path): leaf for path, leaf in leaves}


def flat_read(tree: dict, prefix: str = "") -> dict:
    """{dotted key path: leaf} of the reader's nested dicts (None dropped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_read(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = v
    return out


def periodic_state(shapes, step: int, seed: int = 0):
    """The train state `shapes` (a jax.eval_shape of one) filled with one
    seeded table of TABLE float32 values repeated: parameters x0.02, Adam's
    mu x1e-3, nu |.|x1e-6, every count and the step at `step`."""
    table = np.random.default_rng(seed).normal(size=TABLE).astype(np.float32)

    def fill(path, s):
        keys = [key_str(k) for k in path]
        if np.issubdtype(s.dtype, np.integer):
            return jnp.full(s.shape, step, s.dtype)
        x = np.resize(table, s.shape)
        if "mu" in keys:
            x = x * np.float32(1e-3)
        elif "nu" in keys:
            x = np.abs(x) * np.float32(1e-6)
        else:
            x = x * np.float32(0.02)
        return jnp.asarray(x.astype(np.float32), s.dtype)

    tree = {"params": shapes.params, "opt_state": shapes.opt_state, "step": shapes.step}
    filled = jax.tree_util.tree_map_with_path(fill, tree)
    return SimpleNamespace(**filled)


def hm3d_state_shapes():
    """jax.eval_shape of the JAX package's create_train_state on
    configs/hm3d.yaml as written (512 x 1024, 2 context views)."""
    from splatter360_tpu.config import load_config
    from splatter360_tpu.train.state import create_train_state

    cfg = load_config(str(REPO / "configs" / "hm3d.yaml"), [])
    h, w = cfg.dataset.image_shape
    v = cfg.dataset.view_sampler.num_context_views
    f32 = jnp.float32
    batch = {"context": {"image_sphere": jax.ShapeDtypeStruct((1, v, h, w, 3), f32),
                         "extrinsics_sphere": jax.ShapeDtypeStruct((1, v, 4, 4), f32),
                         "near": jax.ShapeDtypeStruct((1, v), f32),
                         "far": jax.ShapeDtypeStruct((1, v), f32)}}
    return jax.eval_shape(
        lambda b: create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train, b), batch)


def leaf_record(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def write_fixture(directory: Path) -> None:
    """configs/hm3d.yaml's train state at FIXTURE_STEP, periodic values,
    saved by the JAX package's save_checkpoint into `directory`, and
    expected.json beside its step directory."""
    from splatter360_tpu.train.checkpoint import save_checkpoint

    if directory.exists():
        shutil.rmtree(directory)
    state = periodic_state(hm3d_state_shapes(), FIXTURE_STEP)
    save_checkpoint(str(directory), FIXTURE_STEP, state)
    tree = {"params": state.params, "opt_state": state.opt_state, "step": state.step}
    expected = {k: leaf_record(np.asarray(v)) for k, v in sorted(flat(tree).items())}
    (directory / "expected.json").write_text(json.dumps(expected, indent=0, sort_keys=True))


def tiny_tree_state(big: bool, seed: int = 0):
    """A small train state with float32, bfloat16 and int32 leaves (and, with
    `big`, a 2.4 MB leaf that OCDBT stores out of line), the optax state of
    make_optimizer over it with nonzero moments, and step 7."""
    from splatter360_tpu.train.state import OptimizerConfig, make_optimizer

    rng = np.random.default_rng(seed)
    params = {"params": {
        "dense": {"kernel": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32),
                  "bias": jnp.asarray(rng.normal(size=(5,)), jnp.float32)},
        "half": jnp.asarray(rng.normal(size=(7, 2)), jnp.bfloat16),
        "index": jnp.asarray(rng.integers(-9, 9, size=(4,)), jnp.int32),
    }}
    if big:
        params["params"]["big"] = jnp.asarray(rng.normal(size=(600, 1000)), jnp.float32)
    floats = {k: v for k, v in params["params"].items() if k != "index"}
    tx = make_optimizer(OptimizerConfig())
    opt = tx.init({"params": floats})
    opt = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape), x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating) else x + 7, opt)
    return SimpleNamespace(params=params, opt_state=opt, step=jnp.asarray(7, jnp.int32))


def ocdbt_store(step_dir: Path):
    """tensorstore's OCDBT key-value store over a step's database."""
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{step_dir / 'default'}/"}
    return ts.KvStore.open(spec).result()


def jax_save(directory: Path, step: int, state) -> Path:
    from splatter360_tpu.train.checkpoint import save_checkpoint

    save_checkpoint(str(directory), step, state)
    return directory / str(step)


# --- (a) the zstd binding ------------------------------------------------------

@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("kind", ["random", "periodic", "empty"])
def test_zstd_against_zstandard(kind, content_size):
    import zstandard

    from splatter360_tpu_torch.utils import zstd

    rng = np.random.default_rng(1)
    data = {"random": rng.bytes(300_000), "periodic": np.resize(
        rng.normal(size=251).astype(np.float32), 700_000).tobytes(), "empty": b""}[kind]
    frame = zstandard.ZstdCompressor(level=1, write_content_size=content_size).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, len(data)) == data
    if data:
        with pytest.raises(RuntimeError, match="zstd"):
            zstd.decompress(frame[:-8])


def test_zstd_missing_library_names_it(monkeypatch):
    from splatter360_tpu_torch.utils import zstd

    monkeypatch.setattr(zstd, "_LIB", None)
    monkeypatch.setattr(zstd, "_find", lambda: ["libzstd_absent.so.99"])
    with pytest.raises(RuntimeError, match=r"libzstd\.so\.1"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")


# --- (b), (c) the reader against tensorstore and JAX ---------------------------

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Two JAX checkpoints: small values only (inline in the B+tree), and
    one with a leaf over 1 MB (out of line in a data file)."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for big in (False, True):
        state = tiny_tree_state(big)
        out[big] = (jax_save(root / f"big{int(big)}", 7, state), state)
    return out


@pytest.mark.parametrize("big", [False, True])
def test_reader_against_tensorstore(saved, big):
    from splatter360_tpu_torch.train import orbax_reader

    step_dir, _ = saved[big]
    kv = ocdbt_store(step_dir)
    keys = sorted(k.decode() for k in kv.list().result())
    got = orbax_reader.read_database(step_dir / "default")
    assert sorted(got) == keys
    for k in keys:
        assert got[k] == kv.read(k).result().value, k
    sizes = {k: len(v) for k, v in got.items()}
    assert (max(sizes.values()) > 1 << 20) == big


@pytest.mark.parametrize("big", [False, True])
def test_reader_against_jax_restore(saved, big):
    from splatter360_tpu.train import checkpoint as jckpt
    from splatter360_tpu.train.state import TrainState
    from splatter360_tpu_torch.train import orbax_reader

    step_dir, state = saved[big]
    template = TrainState(step=jnp.zeros((), jnp.int32), params=state.params,
                          opt_state=state.opt_state)
    restored, ok = jckpt.restore_checkpoint(str(step_dir.parent), template)
    assert ok
    ref = flat({"params": restored.params, "opt_state": restored.opt_state,
                "step": restored.step})
    got = flat_read(orbax_reader.read_checkpoint(step_dir))
    assert sorted(got) == sorted(ref)
    kinds = set()
    for k, r in ref.items():
        r = np.asarray(r)
        g = got[k]
        if r.dtype == jnp.bfloat16:
            kinds.add("bfloat16")
            assert g.dtype == np.float32, k
            assert np.array_equal(g.view(np.uint32) >> 16, r.view(np.uint16)), k
            assert not (g.view(np.uint32) & 0xFFFF).any(), k
        else:
            kinds.add(str(r.dtype))
            assert g.dtype == r.dtype and g.shape == r.shape, k
            assert g.tobytes() == r.tobytes(), k
    assert kinds == {"float32", "bfloat16", "int32"}
    assert int(got["step"]) == 7


# --- (d) which steps count -----------------------------------------------------

def test_latest_step_across_kinds(saved, tmp_path):
    from splatter360_tpu.train import checkpoint as jckpt
    from splatter360_tpu_torch.train import checkpoint as ckpt

    step_dir, _ = saved[False]
    d = tmp_path / "ck"
    for s in (3, 5):
        shutil.copytree(step_dir, d / str(s))
    shutil.copytree(step_dir, d / "9.orbax-checkpoint-tmp-1792326132")
    assert jckpt.latest_step(str(d)) == ckpt.latest_step(d) == 5
    (d / "11").mkdir()  # a port step whose file was never written: no step
    assert ckpt.latest_step(d) == 5
    assert "orbax checkpoint at step 5" in ckpt.describe(d)
    (d / "4").mkdir()
    torch.save({"step": 4}, d / "4" / ckpt.FILE)
    assert ckpt.latest_step(d) == 5
    (d / "6").mkdir()
    torch.save({"step": 6}, d / "6" / ckpt.FILE)
    assert ckpt.latest_step(d) == 6 and "checkpoint.pt at step 6" in ckpt.describe(d)
    assert jckpt.latest_step(str(tmp_path / "none")) is ckpt.latest_step(tmp_path / "none")


# --- (e) the committed full-width fixture --------------------------------------

@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory):
    """The committed fixture, copied elsewhere on disk, and its reading."""
    from splatter360_tpu_torch.train import orbax_reader

    d = tmp_path_factory.mktemp("fixture") / "ckpt"
    shutil.copytree(FIXTURE, d)
    return d, orbax_reader.read_checkpoint(d / str(FIXTURE_STEP))


def test_fixture_sha256(fixture_copy):
    _, tree = fixture_copy
    expected = json.loads((FIXTURE / "expected.json").read_text())
    got = flat_read(tree)
    assert sorted(got) == sorted(expected)
    for k, rec in expected.items():
        assert leaf_record(got[k]) == rec, k
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 3 << 20, size


def test_fixture_loads_into_the_hm3d_model(fixture_copy):
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.convert import adam_state_from_optax, torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    d, tree = fixture_copy
    cfg = load_config(str(REPO / "configs" / "hm3d.yaml"), ["train.loss.lpips_weight=0"])
    state = create_train_state(cfg.model, cfg.train, seed=3, device="cpu")
    state, ok = ckpt.restore_checkpoint(d, state)
    assert ok and state.step == FIXTURE_STEP
    params = torch_state_from_flax(tree["params"])
    own = state.model.state_dict()
    assert sorted(own) == sorted(params) and len(own) == 616
    assert sum(v.numel() for v in own.values()) == 16_671_350
    for k, v in own.items():
        assert torch.equal(v, params[k]), k
    adam = adam_state_from_optax(tree["opt_state"], state.model, FIXTURE_STEP)
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(adam) == 616
    for i, entry in adam.items():
        assert float(opt[i]["step"]) == FIXTURE_STEP
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[i][k], entry[k]), (i, k)


def test_fixture_matches_a_fresh_save(fixture_copy, tmp_path):
    """The committed tree equals a fresh JAX save of periodic_state, key for
    key, and its shapes and dtypes are those of JAX's hm3d.yaml state."""
    from splatter360_tpu.train.checkpoint import save_checkpoint
    from splatter360_tpu_torch.train import orbax_reader

    _, tree = fixture_copy
    shapes = hm3d_state_shapes()
    state = periodic_state(shapes, FIXTURE_STEP)
    save_checkpoint(str(tmp_path / "fresh"), FIXTURE_STEP, state)
    fresh = flat_read(orbax_reader.read_checkpoint(tmp_path / "fresh" / str(FIXTURE_STEP)))
    got = flat_read(tree)
    assert sorted(fresh) == sorted(got)
    for k, v in fresh.items():
        assert v.dtype == got[k].dtype and v.tobytes() == got[k].tobytes(), k
    ref = flat({"params": shapes.params, "opt_state": shapes.opt_state, "step": shapes.step})
    assert sorted(ref) == sorted(got)
    for k, s in ref.items():
        assert tuple(s.shape) == got[k].shape and np.dtype(s.dtype) == got[k].dtype, k


# --- (f), (g) the optimizer state ----------------------------------------------

def tiny_jax_state(overrides: list, step: int, seed: int = 0, frozen: str | None = None):
    """The tiny encoder's JAX parameters (rand_params), the optax state of
    make_optimizer with seeded nonzero moments (zero under `frozen`), every
    count and the step at `step`; and the JAX config."""
    from splatter360_tpu.config import load_config
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes, make_optimizer

    cfg = load_config(SMOKE, ["dataset.roots=[x]", *TINY, *overrides])
    rng = np.random.default_rng(seed)
    img = np.zeros((1, 2, H, W, 3), np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    near, far = np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)
    params = rand_params(JEncoder(cfg.model), img, _context_cubes(jnp.asarray(img), H // 2),
                         ext, near, far, 0, seed=seed)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = make_optimizer(cfg.train.optimizer)

    def moment(path, x):
        keys = [key_str(k) for k in path]
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(np.full(x.shape, step, x.dtype))
        r = rng.normal(size=x.shape).astype(np.float32)
        if frozen is not None and frozen in keys:
            r = 0 * r
        return jnp.asarray(np.abs(r) * 1e-4 if "nu" in keys else r * 1e-2)

    opt = jax.tree_util.tree_map_with_path(moment, jax.eval_shape(tx.init, params))
    state = SimpleNamespace(params=params, opt_state=opt, step=jnp.asarray(step, jnp.int32))
    return state, tx, cfg


def port_state(overrides: list):
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.models.dino import token_grid
    from splatter360_tpu_torch.train.state import create_train_state

    cfg = load_config(SMOKE, ["dataset.roots=[x]", *TINY, *overrides])
    return create_train_state(cfg.model, cfg.train, seed=9, device="cpu",
                              mono_grid=token_grid(H // 2)), cfg


MONO = ["model.add_mono_feat=true", f"model.vit_type={TINY_VIT[0]}"]
COUNT = 5


@pytest.fixture(scope="module")
def mono_ckpt(tmp_path_factory):
    """The tiny mono encoder's JAX train state at step COUNT (the frozen
    ViT's moments zero, as JAX's stop_gradient leaves them), saved by the
    JAX package: (checkpoint directory, state, optax transform)."""
    from splatter360_tpu.models import dino as jdino
    from splatter360_tpu_torch.models import dino as tdino

    jdino.VIT_DIMS.setdefault(*TINY_VIT)
    tdino.VIT_DIMS.setdefault(*TINY_VIT)
    jstate, tx, _ = tiny_jax_state(MONO, COUNT, frozen="dino")
    d = tmp_path_factory.mktemp("mono") / "ck"
    jax_save(d, COUNT, jstate)
    return d, jstate, tx


def test_update_after_restore_matches_optax(mono_ckpt):
    """One update after a restore: the seeded gradient (zero on the frozen
    ViT, as JAX's stop_gradient makes it) through optax's make_optimizer
    and through the port's clip and Adam at learning_rate(cfg, COUNT)."""
    import optax
    from jax.flatten_util import ravel_pytree

    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import clip_by_global_norm_, learning_rate

    directory, jstate, tx = mono_ckpt
    state, cfg = port_state(MONO)
    state, ok = ckpt.restore_checkpoint(directory, state)
    assert ok and state.step == COUNT

    rng = np.random.default_rng(4)

    def seeded(path, p):
        g = rng.normal(size=p.shape).astype(np.float32) * np.float32(0.05)
        return jnp.asarray(0 * g if "dino" in [key_str(k) for k in path] else g)

    grads = jax.tree_util.tree_map_with_path(seeded, jstate.params)

    # optax's update of the raveled trees: the same elementwise Adam and
    # global norm, one traced program of a few ops instead of ~700 leaves'
    flat_p, unravel = ravel_pytree(jstate.params)
    adam, schedule = jstate.opt_state[1]
    flat_opt = (jstate.opt_state[0], (adam._replace(mu=ravel_pytree(adam.mu)[0],
                                                    nu=ravel_pytree(adam.nu)[0]), schedule))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    new_p, opt = update(ravel_pytree(grads)[0], flat_opt, flat_p)
    ref_params, ref_m, ref_v = (
        torch_state_from_flax(jax.tree_util.tree_map(np.asarray, unravel(x)))
        for x in (new_p, opt[1][0].mu, opt[1][0].nu))

    tgrads = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(state.model.named_parameters())
    for name, p in named.items():
        if p.requires_grad:
            p.grad = tgrads[name].clone()
    norm = clip_by_global_norm_([p.grad for p in named.values() if p.grad is not None],
                                cfg.train.optimizer.grad_clip)
    assert float(norm) > cfg.train.optimizer.grad_clip  # the clip acts
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(cfg.train.optimizer, state.step)
    state.optimizer.step()

    p_max = max(float(v.abs().max()) for v in ref_params.values())
    worst = max(float((named[n].detach() - v).abs().max()) for n, v in ref_params.items())
    print(f"parameters: max |port - optax| {worst:.3g}, max|p| {p_max:.3g}")
    assert worst <= UPDATE_TOL * p_max
    opt_state = state.optimizer.state
    for key, ref in (("exp_avg", ref_m), ("exp_avg_sq", ref_v)):
        top = max(float(v.abs().max()) for v in ref.values())
        gap = max(float((opt_state[named[n]][key] - v).abs().max())
                  for n, v in ref.items() if named[n].requires_grad)
        print(f"{key}: max gap {gap:.3g} of max {top:.3g}")
        assert gap <= UPDATE_TOL * top, key
    assert all(float(opt_state[p]["step"]) == COUNT + 1
               for p in named.values() if p.requires_grad)


def test_mono_tree_drops_the_frozen_vit(mono_ckpt):
    from splatter360_tpu_torch.convert import adam_state_from_optax, torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt

    directory, jstate, _ = mono_ckpt
    assert "dino" in jstate.params["params"]
    state, _ = port_state(MONO)
    state, ok = ckpt.restore_checkpoint(directory, state)
    assert ok and state.step == COUNT
    params = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    n_vit = sum(1 for k in params if k.startswith("dino."))
    assert n_vit > 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    trainable = [n for n, p in state.model.named_parameters() if p.requires_grad]
    assert len(state.optimizer.state_dict()["state"]) == len(trainable) == len(params) - n_vit
    assert not any(n.startswith("dino.") for n in trainable)

    # a frozen leaf with a moment that is not zero is refused
    adam, schedule = jstate.opt_state[1]
    mu = jax.tree_util.tree_map(np.array, adam.mu)
    jax.tree_util.tree_leaves(mu["params"]["dino"])[0][...] = 1.0
    tree = {"0": None, "1": {"0": {"count": np.asarray(adam.count), "mu": mu,
                                   "nu": jax.tree_util.tree_map(np.asarray, adam.nu)},
                             "1": {"count": np.asarray(schedule.count)}}}
    with pytest.raises(ValueError, match="frozen"):
        adam_state_from_optax(tree, state.model, COUNT)


# --- (h) what cannot be read raises --------------------------------------------

def test_truncated_and_unknown_raise(saved, tmp_path):
    from splatter360_tpu_torch.train import orbax_reader

    step_dir, _ = saved[True]
    bad = tmp_path / "trunc" / "7"
    shutil.copytree(step_dir, bad)
    data = max((p for p in (bad / "default").rglob("*") if p.is_file()),
               key=lambda p: p.stat().st_size)
    data.write_bytes(data.read_bytes()[:-100_000])
    with pytest.raises(orbax_reader.OrbaxFormatError, match=data.name):
        orbax_reader.read_checkpoint(bad)

    other = tmp_path / "blosc" / "7"
    shutil.copytree(step_dir, other)
    kv = ocdbt_store(other)
    key = "params.params.dense.kernel/.zarray"
    meta = json.loads(kv.read(key).result().value)
    meta["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
    kv.write(key, json.dumps(meta).encode()).result()
    with pytest.raises(orbax_reader.OrbaxFormatError, match="params.params.dense.kernel.*blosc"):
        orbax_reader.read_checkpoint(other)


def test_cli_refuses_what_it_cannot_read(saved, tmp_path, capsys):
    """mode=test on an unreadable orbax step, or one of another model,
    raises (the process exits non-zero) and never evaluates random weights."""
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.train import orbax_reader

    write_synthetic_scene(tmp_path / "data", "test", "t0", n_frames=4, image_shape=(H, W),
                          n_gaussians=200, seed=1, device="cpu")
    step_dir, _ = saved[True]
    trunc = tmp_path / "trunc"
    shutil.copytree(step_dir, trunc / "7")
    node = max((trunc / "7" / "default").rglob("*"), key=lambda p: p.stat().st_size)
    node.write_bytes(node.read_bytes()[:1000])
    argv = [SMOKE, "mode=test", f"dataset.roots=[{tmp_path / 'data'}]", *TINY,
            "dataset.view_sampler.max_distance_between_context_views=3",
            f"test.output_path={tmp_path / 'out'}"]
    with pytest.raises(orbax_reader.OrbaxFormatError):
        main([*argv, f"checkpointing.load={trunc}"], device="cpu")
    with pytest.raises(ValueError, match="does not fit the model.*first"):
        main([*argv, f"checkpointing.load={FIXTURE}"], device="cpu")  # hm3d.yaml's
    assert "random weights" not in capsys.readouterr().out
    assert not (tmp_path / "out").exists()


# --- (i) the reference-layout converters ---------------------------------------

def test_reference_layout_converters(tmp_path):
    from splatter360_tpu.data import scene_io as jio
    from splatter360_tpu_torch import native
    from splatter360_tpu_torch.data import scene_io as pio

    rng = np.random.default_rng(7)
    n, h, w = 3, 16, 32
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 60000, (n, h, w), dtype=np.uint16)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = rng.normal(size=(n, 3, 3))
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    jio.save_scene(str(tmp_path / "store"), "test", "s", rgb, depth, poses)

    ref_dir, got_dir = tmp_path / "ref_jax", tmp_path / "ref_port"
    jio.export_reference_layout(str(tmp_path / "store"), "test", "s", str(ref_dir))
    pio.export_reference_layout(tmp_path / "store", "test", "s", got_dir)
    files = sorted(p.relative_to(ref_dir) for p in ref_dir.rglob("*") if p.is_file())
    assert len(files) == 2 * n + 2
    assert files == sorted(p.relative_to(got_dir) for p in got_dir.rglob("*") if p.is_file())
    for f in files:
        assert (ref_dir / f).read_bytes() == (got_dir / f).read_bytes(), f

    jio.convert_reference_scene(str(ref_dir), str(tmp_path / "conv_jax"), "train", "s")
    written = pio.convert_reference_scene(ref_dir, tmp_path / "conv_port", "train", "s")
    assert written.suffix == (".s3z" if native.available() else ".npz")
    a = jio.load_scene(str(tmp_path / "conv_jax"), "train", "s")
    b = pio.load_scene(tmp_path / "conv_port", "train", "s")
    for k in ("rgb", "depth_m", "poses"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_array_equal(b["rgb"], rgb)
    np.testing.assert_array_equal(b["depth_m"], depth.astype(np.float32) / 1000.0)
    jfile = next((tmp_path / "conv_jax" / "train").glob("s.*"))
    if jfile.suffix == written.suffix:
        assert jfile.read_bytes() == written.read_bytes()


if __name__ == "__main__":
    write_fixture(FIXTURE)
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"wrote {FIXTURE}: {size} bytes")
