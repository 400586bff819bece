"""`mode=train` of the port's CLI against the JAX package's, and the
trainer's parts: resume, the StepTracker, the Prefetcher, the linear
warm-up schedule and the LPIPS weights loader.

Both CLIs train 3 steps on the same two seeded train scenes (64x256,
written by the JAX package's write_synthetic_scene), from the same weights:
seeded random Flax parameters saved by each package's save_checkpoint (the
port's through convert.torch_state_from_flax), given to both as
`checkpointing.pretrained_model`. Both load the same LPIPS weights file
(a torch state dict this test writes), and both run with the values the
port used to refuse: the linear warm-up schedule (`cosine_lr=false`, over 2
steps: learning rates 0, lr/2, lr), a depth smoothness weight and
`lpips_weights`. The JAX render runs its Pallas kernels in interpret mode,
the port its plain compositor on the CPU.

Bars: every logged scalar of every step within 1e-4 relative (the train
step's bar, tests/test_torch_train.py); each parameter leaf's change over
the run and its Adam moments within 5e-2 of JAX's in relative L2
(check_updates); the same checkpoint steps; event files with the same tags and steps, both read back
by tensorboard's EventAccumulator (the port's own writer through its CRC
check).
"""

import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import OVERRIDES as EVAL_OVERRIDES
from test_torch_serve import rand_params, zero_init

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "synthetic_smoke.yaml")
H, W = 64, 256
STEPS = 3
SCALAR_RTOL = 1e-4
# check_updates: the change and the Adam moments of each leaf, relative L2;
# the worst measured are 1.45e-2 (change), 9.4e-3 (first moment), 1.1e-2
# (second). Adam's first update is about lr·sign(g), so an element whose
# gradient is near 0 may move the other way: no per-element bar holds.
UPDATE_RTOL = 5e-2
# a leaf with |first moment| <= STILL_M of the largest has no gradient but
# rounding (measured <= 1e-9 against >= 1.1e-5 for every other leaf); both
# runs move it by at most 0.023 lr
STILL_M, STILL_LR = 1e-7, 0.1
# the tiny encoder of test_torch_eval.py; mode=test and its depth flag left out
TINY = [o for o in EVAL_OVERRIDES if not o.startswith(("mode=", "test."))]
TRAIN = ["mode=train", f"trainer.max_steps={STEPS}", "trainer.print_log_every_n_steps=1",
         "checkpointing.every_n_train_steps=2", "trainer.val_check_interval=0",
         "trainer.num_sanity_val_steps=0", "train.optimizer.cosine_lr=false",
         "train.optimizer.warm_up_steps=2", "train.loss.lpips_weight=0.05",
         "train.loss.depth_smoothness_weight=0.1"]


def torch_lpips_state(seed: int, layout: str) -> dict:
    """A torch LPIPS(net='vgg') state dict of seeded random weights: the
    lpips package's keys (net.slice{s}.{i}.*, lins.{i}.model.1.weight) or
    torchvision's vgg16 (features.{i}.*, no lin weights)."""
    rng = np.random.default_rng(seed)
    idx = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
    chans = [(64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)]
    sd, cin = {}, 3
    for si, (ids, chs) in enumerate(zip(idx, chans)):
        for ti, ch in zip(ids, chs):
            prefix = f"net.slice{si + 1}.{ti}." if layout == "lpips" else f"features.{ti}."
            sd[prefix + "weight"] = torch.from_numpy(
                (rng.normal(size=(ch, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
            sd[prefix + "bias"] = torch.from_numpy((0.05 * rng.normal(size=ch)).astype(np.float32))
            cin = ch
        if layout == "lpips":
            lin = np.abs(rng.normal(size=(1, chs[-1], 1, 1))) / chs[-1]
            sd[f"lins.{si}.model.1.weight"] = torch.from_numpy(lin.astype(np.float32))
    return sd


def write_inputs(root: Path) -> dict:
    """Two train scenes, the LPIPS weights file, and the same seeded
    weights in each package's checkpoint."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.data.dataset import SceneDataset, batch_examples
    from splatter360_tpu.data.scene_io import write_synthetic_scene
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train import checkpoint as jckpt
    from splatter360_tpu.train.state import _context_cubes
    from splatter360_tpu.train.state import create_train_state as j_create_train_state
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    data = root / "data"
    for i in range(2):
        write_synthetic_scene(str(data), "train", f"s{i}", n_frames=12, image_shape=(H, W),
                              n_gaussians=1500, seed=21 + i)
    torch.save(torch_lpips_state(4, "lpips"), root / "lpips.pth")
    overrides = [f"dataset.roots=[{data}]", *TINY, *TRAIN,
                 f"train.loss.lpips_weights={root / 'lpips.pth'}"]
    cfg = j_load_config(CONFIG, overrides)
    batch = batch_examples([next(iter(SceneDataset(cfg.dataset, split="train", stage="train")))])
    ctx = batch["context"]
    cubes = _context_cubes(jnp.asarray(ctx["image_sphere"]), H // 2)
    params = rand_params(JEncoder(cfg.model), ctx["image_sphere"], cubes,
                         ctx["extrinsics_sphere"], ctx["near"], ctx["far"], 0, seed=3)
    with zero_init(params):
        jstate = j_create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train,
                                      {k: v for k, v in batch.items() if k != "scene"})
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jckpt.save_checkpoint(str(root / "ckpt_jax"), 1, jstate)

    pcfg = load_config(CONFIG, overrides)
    state = create_train_state(pcfg.model, pcfg.train, device="cpu",
                               state_dict=torch_state_from_flax(
                                   jax.tree_util.tree_map(np.asarray, params)))
    ckpt.save_checkpoint(root / "ckpt_port", 1, state)
    return dict(overrides=overrides, jstate=jstate, cfg=pcfg)


def port_argv(root: Path, inputs: dict, out: Path) -> list:
    return [CONFIG, *inputs["overrides"], f"output_dir={out}",
            f"checkpointing.pretrained_model={root / 'ckpt_port'}"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' 3-step runs; returns (root, inputs, out_jax, out_port)."""
    import splatter360_tpu.main as jmain
    import splatter360_tpu.train.trainer as jtrainer
    import splatter360_tpu_torch.main as pmain

    root = tmp_path_factory.mktemp("train_cli")
    inputs = write_inputs(root)
    out_j, out_p = root / "out_jax", root / "out_port"
    fit = jtrainer.Trainer.fit

    def fit_and_close(self):
        """The JAX trainer leaves its tensorboardX writer open (it flushes
        every 120 s): close it so that its events are on disk."""
        try:
            return fit(self)
        finally:
            if self.writer is not None:
                self.writer.close()

    with pytest.MonkeyPatch.context() as mp, zero_init(inputs["jstate"].params):
        mp.setenv("SPLAT360_PALLAS_INTERPRET", "1")
        mp.setattr(jtrainer.Trainer, "fit", fit_and_close)
        jmain.main([CONFIG, *inputs["overrides"], f"output_dir={out_j}",
                    f"checkpointing.pretrained_model={root / 'ckpt_jax'}"])
    pmain.main(port_argv(root, inputs, out_p), device="cpu")
    return root, inputs, out_j, out_p


def scalars(out: Path) -> dict:
    """{tag: {step: value}} of the run's event files, through tensorboard."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    got: dict = {}
    files = sorted((out / "tb").glob("events.out.tfevents.*"))
    assert files, f"no event file under {out / 'tb'}"
    for path in files:
        acc = EventAccumulator(str(path))
        acc.Reload()
        for tag in acc.Tags()["scalars"]:
            got.setdefault(tag, {}).update({e.step: e.value for e in acc.Scalars(tag)})
    return got


def test_cli_train_mode_vs_jax(runs):
    from splatter360_tpu.train import checkpoint as jckpt
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    root, inputs, out_j, out_p = runs
    ref, got = scalars(out_j), scalars(out_p)
    assert sorted(got) == sorted(ref) and "train/loss_lpips" in ref and "train/loss" in ref
    for tag, by_step in ref.items():
        assert sorted(got[tag]) == sorted(by_step) == list(range(1, STEPS + 1)), tag
        for step, v in by_step.items():
            print(f"{tag} step {step}: jax {v:.6g} port {got[tag][step]:.6g}")
            np.testing.assert_allclose(got[tag][step], v, rtol=SCALAR_RTOL, err_msg=f"{tag} {step}")

    steps_j = sorted(int(p.name) for p in (out_j / "checkpoints").iterdir() if p.name.isdigit())
    steps_p = sorted(int(p.name) for p in (out_p / "checkpoints").iterdir() if p.name.isdigit())
    assert steps_j == steps_p == [2, STEPS]

    jstate, ok = jckpt.restore_checkpoint(str(out_j / "checkpoints"), inputs["jstate"])
    assert ok and int(jstate.step) == STEPS
    final = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    saved = torch.load(out_p / "checkpoints" / str(STEPS) / ckpt.FILE, weights_only=True)
    assert saved["step"] == STEPS
    cfg = inputs["cfg"]
    names = [n for n, _ in create_train_state(cfg.model, cfg.train, device="cpu")
             .model.named_parameters()]
    assert saved["opt_state"]["param_groups"][0]["params"] == list(range(len(names)))
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    start = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, inputs["jstate"].params))
    ref = {"update": {n: final[n] - start[n] for n in names},
           "exp_avg": torch_state_from_flax(jax.tree_util.tree_map(np.asarray, adam.mu)),
           "exp_avg_sq": torch_state_from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))}
    got = {"update": {n: saved["params"][n] - start[n] for n in names}}
    for key in ("exp_avg", "exp_avg_sq"):
        got[key] = {n: saved["opt_state"]["state"][i][key] for i, n in enumerate(names)}
    assert set(saved["params"]) == set(final) and set(names) <= set(final)
    check_updates(ref, got, cfg.train.optimizer.lr)


def check_updates(ref: dict, got: dict, lr: float) -> None:
    """The port's parameter change over the run and its Adam moments, leaf
    by leaf, against JAX's. A leaf whose first moment in JAX is within
    STILL_M of the largest one has a gradient that is zero but for rounding
    (a bias followed by a GroupNorm): Adam moves it by noise, so it is held
    only to stay still in the port too (|change| <= STILL_LR * lr, |first
    moment| <= STILL_M of the largest). Every other leaf: |got - ref|_2 <=
    UPDATE_RTOL |ref|_2 for the change and both moments."""
    m_max = max(float(v.abs().max()) for v in ref["exp_avg"].values())
    still = {n for n, v in ref["exp_avg"].items() if float(v.abs().max()) <= STILL_M * m_max}
    worst, moved = {}, 0
    for n in ref["update"]:
        if n in still:
            assert float(got["update"][n].abs().max()) <= STILL_LR * lr, n
            assert float(got["exp_avg"][n].abs().max()) <= STILL_M * m_max, n
            continue
        moved += ref["update"][n].numel()
        for key in ref:
            r, g = ref[key][n].double(), got[key][n].double()
            gap = float((g - r).norm() / r.norm())
            worst[key] = max(worst.get(key, (0.0, "")), (gap, n))
    total = sum(v.numel() for v in ref["update"].values())
    print(f"{len(still)} still leaves; relative L2 gaps of the others: {worst} "
          f"(bar {UPDATE_RTOL})")
    assert moved >= 0.99 * total, (moved, total)
    for key, (gap, n) in worst.items():
        assert gap <= UPDATE_RTOL, (key, n, gap)


def test_resume_takes_the_step_train_step_takes(runs):
    """A port run resumed from its step-2 checkpoint: its one step equals
    train_step on the restored state and the dataset's first batch (the data
    starts again from its seed), bit for bit on the CPU. Both run under
    torch.use_deterministic_algorithms: by default a scatter-add of the CPU
    backward sums in a varying order, so two runs of one step differ in the
    last bits (~4e-8 in a gradient)."""
    from splatter360_tpu_torch.data.dataset import SceneDataset, batches
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state, train_step

    root, inputs, _, out_p = runs
    out_r = root / "out_resumed"
    shutil.copytree(out_p / "checkpoints", out_r / "checkpoints")
    shutil.rmtree(out_r / "checkpoints" / str(STEPS))
    cfg = inputs["cfg"]
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        main(port_argv(root, inputs, out_r), device="cpu")
        state = create_train_state(cfg.model, cfg.train, seed=cfg.trainer.seed, device="cpu")
        state, ok = ckpt.restore_checkpoint(out_p / "checkpoints", state, step=2)
        assert ok and state.step == 2
        dataset = SceneDataset(cfg.dataset, split="train", stage="train", seed=cfg.trainer.seed)
        batch = next(batches(dataset, cfg.trainer.batch_size))
        metrics = train_step(state, batch)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    resumed = torch.load(out_r / "checkpoints" / str(STEPS) / ckpt.FILE, weights_only=True)
    assert resumed["step"] == state.step == STEPS
    for k, v in state.model.state_dict().items():
        assert torch.equal(resumed["params"][k], v), k
    ref_opt = state.optimizer.state_dict()["state"]
    for i, entry in resumed["opt_state"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(v, ref_opt[i][k]), (i, k)
    logged = scalars(out_r)
    for k, v in metrics.items():
        assert logged[f"train/{k}"][STEPS] == np.float32(float(v)), k


def test_resume_from_a_jax_step(runs, capsys):
    """checkpoints/ holding the JAX package's orbax step 2 (its run's): the
    port resumes from it, says so, and takes step 3 with Adam's count of 2
    carried over."""
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.train import checkpoint as ckpt

    root, inputs, out_j, _ = runs
    out_x = root / "out_resumed_from_jax"
    shutil.copytree(out_j / "checkpoints" / "2", out_x / "checkpoints" / "2")
    main(port_argv(root, inputs, out_x), device="cpu")
    printed = capsys.readouterr().out
    assert "resumed from step 2 (the JAX package's orbax checkpoint at step 2)" in printed
    assert f"step {STEPS}: " in printed
    saved = torch.load(out_x / "checkpoints" / str(STEPS) / ckpt.FILE, weights_only=True)
    assert saved["step"] == STEPS == ckpt.latest_step(out_x / "checkpoints")
    assert {float(e["step"]) for e in saved["opt_state"]["state"].values()} == {STEPS}


def test_step_tracker_drives_the_bounded_sampler(tmp_path):
    """The dataset reads the sampler's step from the tracker at each draw:
    its examples equal those of a dataset whose step is fixed there, and the
    context gap widens from the initial range to the final one."""
    from splatter360_tpu_torch.data.dataset import DatasetConfig, SceneDataset
    from splatter360_tpu_torch.data.view_sampler import BoundedSamplerConfig
    from splatter360_tpu_torch.utils.step_tracker import StepTracker
    from test_torch_harness import write_scenes

    write_scenes(tmp_path, n_scenes=2, n=60)
    cfg = DatasetConfig(roots=(str(tmp_path),), image_shape=(8, 16),
                        view_sampler=BoundedSamplerConfig(
                            num_target_views=2, min_distance_between_context_views=40,
                            max_distance_between_context_views=50, warm_up_steps=100,
                            initial_min_distance_between_context_views=5,
                            initial_max_distance_between_context_views=8))
    tracker = StepTracker()
    live = iter(SceneDataset(cfg, split="test", stage="train", seed=5, step_fn=tracker.get_step))
    for step, (lo, hi) in ((0, (5, 8)), (50, (22, 29)), (100, (40, 50)), (10**6, (40, 50))):
        tracker.set_step(step)
        for _ in range(6):
            a = next(live)
            gap = int(a["context"]["index"][-1] - a["context"]["index"][0])
            assert lo <= gap <= hi, (step, gap)
    for step in (0, 50, 100):
        tracker.set_step(step)
        live = iter(SceneDataset(cfg, split="test", stage="train", seed=9,
                                 step_fn=tracker.get_step))
        fixed = iter(SceneDataset(cfg, split="test", stage="train", seed=9,
                                  step_fn=lambda s=step: s))
        for _ in range(4):
            a, b = next(live), next(fixed)
            for part in ("context", "target"):
                np.testing.assert_array_equal(a[part]["index"], b[part]["index"])


def test_prefetcher_order_and_end():
    from splatter360_tpu_torch.train.trainer import Prefetcher

    pf = Prefetcher(iter(range(25)), depth=2)
    assert list(pf) == list(range(25))
    pf.thread.join(10)
    assert not pf.thread.is_alive()

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert [next(it) for _ in range(7)] == list(range(7))
    pf.close()
    assert not pf.thread.is_alive() and pf.queue.qsize() <= 2


def test_prefetcher_raises_what_the_stream_raises():
    """An error of the data stream reaches the training loop by its own
    type and message, after the items drawn before it."""
    from splatter360_tpu_torch.train.trainer import Prefetcher

    def broken():
        yield from range(3)
        raise OSError("shard 7 is truncated")

    pf = Prefetcher(broken(), depth=2)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(OSError, match="shard 7 is truncated"):
        next(it)
    pf.thread.join(10)
    assert not pf.thread.is_alive()


def test_tb_events_round_trip(tmp_path):
    """The port's event writer and reader: scalars read back as written (the
    value in float32), the CRC32C of the check string, tensorboard's reader
    on the same file."""
    from splatter360_tpu_torch.utils.tb_events import SummaryWriter, crc32c, read_scalars

    assert crc32c(b"123456789") == 0xE3069283
    writer = SummaryWriter(tmp_path)
    written = [(0, "a/x", 1.5), (1, "a/x", -2.25), (7, "b", 1e-3), (300, "a/x", float("inf"))]
    for step, tag, value in written:
        writer.add_scalar(tag, value, step)
    writer.close()
    got = read_scalars(writer.path)
    assert [(s, t, v) for s, t, v, _ in got] == [(s, t, float(np.float32(v)))
                                                 for s, t, v in written]
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(writer.path))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["a/x", "b"]
    assert [(e.step, e.value) for e in acc.Scalars("a/x")] == [
        (s, float(np.float32(v))) for s, t, v in written if t == "a/x"]


@pytest.mark.parametrize("damage", ["length_crc", "payload", "cut"])
def test_tb_events_reader_refuses_a_damaged_file(tmp_path, damage):
    from splatter360_tpu_torch.utils.tb_events import SummaryWriter, read_scalars

    writer = SummaryWriter(tmp_path)
    writer.add_scalar("train/loss", 0.5, 1)
    writer.close()
    data = bytearray(writer.path.read_bytes())
    first = 16 + int.from_bytes(data[:8], "little")  # the file_version record
    if damage == "length_crc":
        data[first + 9] ^= 1
    elif damage == "payload":
        data[-6] ^= 1
    else:
        del data[-3:]
    writer.path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match={"length_crc": "bad length CRC",
                                          "payload": "bad payload CRC",
                                          "cut": "record cut"}[damage]):
        read_scalars(writer.path)


@pytest.mark.parametrize("warm_up", [0, 1, 7, 2000])
def test_linear_schedule_vs_optax(warm_up):
    import optax

    from splatter360_tpu.train.state import OptimizerConfig as JOptimizerConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, learning_rate

    kw = dict(lr=2e-4, warm_up_steps=warm_up, cosine_lr=False)
    sched = optax.linear_schedule(init_value=kw["lr"] / max(warm_up, 1) * 0, end_value=kw["lr"],
                                  transition_steps=warm_up)
    assert dataclass_fields(JOptimizerConfig) == dataclass_fields(OptimizerConfig)
    for count in (0, 1, 2, 3, 6, 7, 8, 999, 1000, 1999, 2000, 2001, 10**5):
        ref = float(sched(jnp.int32(count)))
        got = learning_rate(OptimizerConfig(**kw), count)
        assert abs(got - ref) <= 1e-6 * abs(ref), (count, got, ref)


def dataclass_fields(cls) -> list:
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_load_lpips_torch_weights_vs_jax(tmp_path, layout):
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS
    from splatter360_tpu.train.lpips_jax import load_lpips_torch_weights as j_load
    from splatter360_tpu_torch.train.lpips import LPIPS, load_lpips_torch_weights

    path = tmp_path / "w.pth"
    torch.save(torch_lpips_state(7, layout), path)
    probe = jnp.zeros((1, 64, 64, 3))
    jparams = j_load(JLPIPS().init(jax.random.PRNGKey(0), probe, probe), str(path))
    model = load_lpips_torch_weights(LPIPS(), path)
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(2))
    ref = np.asarray(JLPIPS().apply(jparams, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    if layout == "torchvision":  # no lin weights in the file: 1/C, flax's initial value
        assert torch.equal(model.lin0, torch.full((64,), 1 / 64))


def test_mode_train_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without a card and without device="cpu", the trainer and mode=train
    raise naming CUDA before touching any data."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.main import main
    from splatter360_tpu_torch.train.trainer import Trainer, Validator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [CONFIG, "mode=train", f"dataset.roots=[{tmp_path}]", f"output_dir={tmp_path / 'out'}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    cfg = load_config(CONFIG, argv[1:])
    for make in (functools.partial(Trainer, cfg), functools.partial(Validator, cfg, tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(SystemExit, match="no train scenes"):
        main(argv, device="cpu")
