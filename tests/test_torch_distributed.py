"""The port across ranks: spawned gloo ranks on the CPU against the emulated
ranks, the port's single-process step and JAX's meshed step.

One spawn for the whole file (the module fixture `ranks`): four processes
(torch.multiprocessing, a file store under tmp_path) that
  1. render band-sharded ERP views over all four ranks and over two pairs of
     two, and face-sharded cube views on a (2, 2) (data, face) rank grid,
     each against the same render on emulated ranks (parallel/mesh.Emulated)
     in the same process;
  2. take one face-sharded cube train step (train.shard_faces) on a (2, 2)
     grid, a global batch of 2;
then ranks 0 and 1, in a new two-rank group,
  3. take one data-parallel train step, each on its half of a global batch
     of 2, held against the port's single-process step on the whole batch
     and against JAX's make_train_step(mesh=create_mesh(2)) on it, and one
     face-sharded cube step on a (1, 2) grid, a global batch of 1; each
     face-sharded step held against the port's single-process cube step on
     its global batch and against JAX's
     make_train_step(mesh=create_mesh_2d(n_data, n_face)) on it;
  4. run the CLI: mode=train for 2 steps with cube supervision on a 1 x 2
     (data, face) grid (train.shard_faces) and a band-sharded validation
     (train.shard_render), a checkpoint, then resumed for a third step; and
     mode=test with train.shard_render, held against the same mode=test on
     one process.
While the ranks run, the parent computes JAX's meshed steps and the port's
single-process steps. The workers import neither JAX nor the JAX package.

The train step is the tiny encoder of tests/test_torch_serve.py with four
Table 3 ablations (wo_cube_encoder, wo_depth_refine, wo_cost_volume_refine,
wo_backbone_cross_attn) and the scan compositor (render_backend "jax",
max_per_tile 256) on both sides, at 32x256 with one target view, no LPIPS
and a depth L1 over holes (whose global weight sum is the one cross-rank
term of the loss): what makes JAX's step cheap enough to compile here.
The cube steps take the same model with supervision "cubes" (one target
view: 6 faces of 16x16, 3 a face rank).

Bars, stated before the runs:
  * sharded renders across ranks against emulated ranks: outputs bit-equal
    (the same table and the same per-band arithmetic); gradients within
    1e-6 of max|g| (the ranks' cotangents are summed in gloo's order,
    autograd's in band order);
  * the data-parallel step against the single-process step: metrics at
    1e-5 relative, the all-reduced gradients within 1e-5 of max|g| (float32
    reassociation: (g0 + g1) / 2 against one backward of the batch), the
    parameters after the step within lr / 10 (Adam's first update moves an
    element by lr g / (|g| + 1e-8), which the last bits of a gradient near
    1e-8 turn by a good share of lr); the two ranks' parameters bit-equal;
  * against JAX's meshed step: tests/test_torch_train.py's bars, metrics at
    1e-4 relative and every leaf's gradient within 2e-3 of max|g|;
  * the face-sharded cube steps: every rank's parameters bit-equal; against
    the single-process cube step, the data-parallel step's bars above; and
    against JAX's meshed step, its bars;
  * the sharded mode=test against one process: tests/test_torch_eval.py's
    score bars (PSNR 1e-2 dB; SSIM 1e-4; MSE 1e-5; depth metrics 5e-4
    relative).
"""

import contextlib
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
# the render checks: a numpy-seeded scene of N Gaussians (sh degree 1)
N = 600
# the band renders across ranks: (ranks, image height); 96 rows split
# unequally over 4 bands (2, 1, 1, 2 tile rows), 48 over 2 (1, 2)
BAND_CASES = ((4, 96), (2, 48))
W = 256
# the train step and the CLI
H = 32
ABLATIONS = dict(wo_cube_encoder=True, wo_depth_refine=True, wo_cost_volume_refine=True,
                 wo_backbone_cross_attn=True)
ENC_KW = dict(d_feature=32, num_depth_candidates=16, downscale_factor=8,
              costvolume_unet_feat_dim=32, costvolume_unet_channel_mult=(1, 1),
              costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(8,),
              depth_unet_channel_mult=(1, 1, 1, 1))
MAX_PER_TILE = 256
# the face-sharded cube steps: (n_data, n_face) rank grids, whose global
# batch is n_data examples
FACE_GRIDS = ((2, 2), (1, 2))
TIMEOUT_S = 400
GRAD_TOL = 2e-3
CLI_TINY = ["dataset.view_sampler.max_distance_between_context_views=5",
            "model.d_feature=32", "model.num_depth_candidates=16",
            "model.costvolume_unet_feat_dim=32", "model.costvolume_unet_channel_mult=[1,1]",
            "model.costvolume_unet_attn_res=[2]", "model.depth_unet_feat_dim=8",
            "model.depth_unet_attn_res=[8]", "model.depth_unet_channel_mult=[1,1,1,1]",
            "model.gaussian_adapter.sh_degree=1", "model.bf16_compute=false",
            "train.loss.lpips_weight=0", "train.render_backend=pallas",
            "dataset.view_sampler.num_target_views=1", f"dataset.image_shape=[{H},{W}]"]


# ---------------------------------------------------------------- inputs


def scene(seed=3, n=N):
    """Gaussians around the origin (radius 0.5-6, scales 0.01-0.12), full
    3x3 covariances, SH degree 1."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.5, 6.0, (n, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                    2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                   -1).reshape(n, 3, 3)
    s = rng.uniform(0.01, 0.12, (n, 3))
    covs = rot @ (s[:, :, None] ** 2 * np.transpose(rot, (0, 2, 1)))
    sh = 0.3 * rng.normal(size=(n, 3, 4))
    sh[..., 0] += 0.5
    return [np.asarray(a, np.float32) for a in (means, covs, sh, rng.uniform(0.3, 0.95, n))]


def cube_scene(n=N):
    """Two examples (the scene, and a scaled, fainter copy) and their target
    poses: tests/test_render_sharding.py's face-sharded inputs."""
    m, c, s, o = scene(n=n)
    g = [np.stack([x, x * 0.95 + 0.01]) for x in (m, c, s)]
    g.append(np.stack([o, np.clip(o * 0.9, 0, 1)]))
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4)).copy()
    extr[:, 1, :3, 3] = [0.2, 0.0, -0.1]
    return g, extr


def global_batch(seed=9, b=2):
    """A global batch of b examples at H x W: 2 context views, 1 target,
    context depth with ~8% holes in blobs (so the examples' depth weight
    sums differ)."""
    rng = np.random.default_rng(seed)
    ex = {}
    for part, v in (("context", 2), ("target", 1)):
        poses = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
        poses[..., :3, 3] = rng.normal(0, 0.2, (b, v, 3))
        d = rng.uniform(0.5, 5.0, (b, v, H, W))
        holes = rng.uniform(size=d.shape) < 0.02
        for axis in (-1, -2):
            holes = holes | np.roll(holes, 1, axis=axis) | np.roll(holes, -1, axis=axis)
        ex[part] = {"extrinsics_sphere": poses,
                    "image_sphere": rng.uniform(0, 1, (b, v, H, W, 3)).astype(np.float32),
                    "depth_sphere": np.where(holes, 0.0, d).astype(np.float32),
                    "near": np.full((b, v), 0.1, np.float32),
                    "far": np.full((b, v), 10.0, np.float32)}
    return ex


def part_of(batch, i):
    return {p: {k: v[i:i + 1] for k, v in batch[p].items()} for p in batch}


def port_configs(cubes=False):
    """The encoder and train configs of the steps: ERP supervision, or with
    `cubes` cube supervision under train.shard_faces."""
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.losses import LossConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, TrainConfig

    return (EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW,
                          **ABLATIONS),
            TrainConfig(optimizer=OptimizerConfig(max_steps=100),
                        loss=LossConfig(lpips_weight=0.0, depth_weight=0.1),
                        supervision="cubes" if cubes else "erp", shard_faces=cubes,
                        render_backend="jax", max_per_tile=MAX_PER_TILE))


def port_step(params, batch, grid=None, cubes=False):
    """One port train step from `params` (port_configs(cubes)): (metrics,
    the gradients the optimizer took, the parameters after it)."""
    from splatter360_tpu_torch.train.state import create_train_state, train_step

    cfg, tcfg = port_configs(cubes)
    state = create_train_state(cfg, tcfg, device="cpu", state_dict=params)
    grads = {}

    def keep(stage):
        if stage == "backward":
            grads.update({k: p.grad.clone() for k, p in state.model.named_parameters()
                          if p.grad is not None})

    metrics = train_step(state, batch, on_stage=keep, grid=grid)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.detach().clone() for k, v in state.model.state_dict().items()})


def face_batch(batch, n_data):
    """The global batch of a face grid with n_data data ranks: its first
    n_data examples."""
    return {p: {k: v[:n_data] for k, v in batch[p].items()} for p in batch}


def cli_argv(data: Path, *extra):
    return [str(REPO / "configs" / "hm3d.yaml"), *CLI_TINY, f"dataset.roots=[{data}]", *extra,
            "--device", "cpu"]


# ---------------------------------------------------------------- ranks


def _grads_over(comm, leaves):
    """The leaves' gradients summed over the ranks of `comm` (each rank
    holds its own shard's part)."""
    return [g.clone() for g in comm.all_reduce([x.grad for x in leaves])]


def _render_checks(rank: int) -> dict:
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.parallel.mesh import Emulated, Group, create_rank_grid
    from splatter360_tpu_torch.parallel.render_sharding import (
        render_cube_views_face_sharded, render_erp_sharded)

    res = {}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    rng = np.random.default_rng(5)
    for k, h in BAND_CASES:
        comm = Group() if k == 4 else Group(pairs[rank // 2])
        weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((h, W, 3), (h, W), (h, W))]
        outs = {}
        for name, c in (("ranks", comm), ("emulated", Emulated(k))):
            leaves = [torch.from_numpy(x).requires_grad_(True) for x in scene()]
            out = render_erp_sharded(*leaves, torch.eye(4), (h, W), c, render_depth=True)
            loss = sum((x * wt).sum() for x, wt in zip((out.color, out.alpha, out.depth), weights))
            loss.backward()
            grads = _grads_over(comm, leaves) if name == "ranks" else [x.grad for x in leaves]
            outs[name] = ([out.color, out.alpha, out.depth, out.dropped], grads)
        (o_r, g_r), (o_e, g_e) = outs["ranks"], outs["emulated"]
        res[f"band{k}"] = dict(
            out_diff=max(float((a - b).abs().max()) for a, b in zip(o_r, o_e)),
            grad_diff=max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_r, g_e)))

    grid = create_rank_grid(2, 2)
    g, extr = cube_scene()
    d = grid.data_index
    kw = dict(render_depth=True, backend="jax", max_per_tile=512)
    outs = {}
    for name, c in (("ranks", grid.face), ("emulated", Emulated(2))):
        leaves = [torch.from_numpy(x[d:d + 1]).requires_grad_(True) for x in g]
        out = render_cube_views_face_sharded(
            Gaussians(*leaves), torch.from_numpy(extr[d:d + 1]), torch.full((1, 2), 0.1),
            torch.full((1, 2), 100.0), (32, 32), c, **kw)
        (torch.mean(out.color ** 2) + 0.1 * torch.mean(out.alpha)).backward()
        outs[name] = ([out.color, out.depth, out.alpha, out.dropped], [x.grad for x in leaves])
    (o_r, g_r), (o_e, g_e) = outs["ranks"], outs["emulated"]
    res["faces"] = dict(
        out_diff=max(float((a - b).abs().max()) for a, b in zip(o_r, o_e)),
        grad_diff=max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_r, g_e)))
    return res


def _train_check(rank: int, params: dict, batch: dict) -> dict:
    from splatter360_tpu_torch.parallel.mesh import create_rank_grid

    metrics, grads, after = port_step(params, part_of(batch, rank), grid=create_rank_grid(2, 1))
    return dict(metrics=metrics, grads=grads, params=after)


def _face_step(params: dict, batch: dict, n_data: int, n_face: int) -> dict:
    """One face-sharded cube step on an (n_data, n_face) grid over all the
    ranks of the process group, each on its data index's example."""
    from splatter360_tpu_torch.parallel.mesh import create_rank_grid

    grid = create_rank_grid(n_data, n_face)
    metrics, grads, after = port_step(params, part_of(batch, grid.data_index), grid=grid,
                                      cubes=True)
    return dict(metrics=metrics, grads=grads, params=after)


def _cli_checks(rank: int, data: Path, out: Path) -> dict:
    from splatter360_tpu_torch.main import main

    train = ["mode=train", "trainer.batch_size=1", "train.supervision=cubes",
             "train.shard_faces=true", "train.shard_render=true",
             "trainer.print_log_every_n_steps=1", "checkpointing.every_n_train_steps=2",
             "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=0",
             f"output_dir={out}"]
    res, printed = {}, io.StringIO()
    with contextlib.redirect_stdout(printed):
        state = main(cli_argv(data, *train, "trainer.max_steps=2"))
        state = main(cli_argv(data, *train, "trainer.max_steps=3"))
        res["test_scores"] = main(cli_argv(
            data, "mode=test", "train.shard_render=true", "test.eval_depth=true",
            f"checkpointing.load={out / 'checkpoints'}", f"test.output_path={out / 'test'}"))
    res["printed"] = printed.getvalue()
    res["step"] = state.step
    res["params"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return res


def _rank_main(rank: int, root: str, t_spawn: float):
    torch.set_num_threads(2)
    started = time.time() - t_spawn
    out = Path(root)
    store, data = out / "store", out / "data"
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{store}/four", rank=rank, world_size=4)
    try:
        res = _render_checks(rank)
        res["seconds"] = {"start": started, "renders": time.perf_counter() - t0}
        # the parent writes the scenes, then the inputs, while the renders run
        inputs = out / "inputs.pt"
        while not inputs.is_file():
            assert time.time() - t_spawn < TIMEOUT_S, "no inputs.pt from the parent"
            time.sleep(0.1)
        params, batch = torch.load(inputs, weights_only=False)
        t0 = time.perf_counter()
        res["faces2x2"] = _face_step(params, face_batch(batch, 2), 2, 2)
        res["seconds"]["2x2 cube step"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{store}/two", rank=rank,
                                world_size=2)
        try:
            t0 = time.perf_counter()
            res["train"] = _train_check(rank, params, batch)
            res["seconds"]["train step"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["faces1x2"] = _face_step(params, face_batch(batch, 1), 1, 2)
            res["seconds"]["1x2 cube step"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["cli"] = _cli_checks(rank, data, out / "cli")
            res["seconds"]["cli"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    torch.save(res, out / f"rank{rank}.pt")


# ---------------------------------------------------------------- parent


def jax_meshed_step(params_flax, batch, face_grid=None):
    """JAX's make_train_step on the global batch: the ERP step on
    create_mesh(2), or with `face_grid` (n_data, n_face) the cube step under
    shard_faces on create_mesh_2d(n_data, n_face); the metrics and the
    step's (unclipped) gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.parallel.mesh import create_mesh, create_mesh_2d, replicate, shard_batch
    from splatter360_tpu.train import state as js
    from splatter360_tpu.train.losses import LossConfig as JLossConfig

    cubes = face_grid is not None
    jcfg = JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW, **ABLATIONS)
    tcfg = js.TrainConfig(optimizer=js.OptimizerConfig(max_steps=100),
                          loss=JLossConfig(lpips_weight=0.0, depth_weight=0.1),
                          supervision="cubes" if cubes else "erp", shard_faces=cubes,
                          render_backend="jax", max_per_tile=MAX_PER_TILE)
    inner = js.make_optimizer(tcfg.optimizer)

    def update(grads, opt_state, params=None):
        # the optimizer also keeps the step's incoming gradients in its state
        updates, inner_state = inner.update(grads, opt_state[0], params)
        return updates, (inner_state, grads)

    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)), update)
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=params_flax,
                          opt_state=tx.init(params_flax), tx=tx,
                          apply_fn=JEncoder(jcfg).apply)
    mesh = create_mesh_2d(*face_grid) if cubes else create_mesh(2)
    step = jax.jit(js.make_train_step(jcfg, tcfg, mesh=mesh))
    s1, m1 = step(replicate(mesh, state), shard_batch(mesh, batch))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {k: float(v) for k, v in m1.items()}, to_np(s1.opt_state[1])


def flax_params(batch):
    import jax
    import jax.numpy as jnp

    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes
    from test_torch_serve import rand_params

    ctx = part_of(batch, 0)["context"]
    jcfg = JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW, **ABLATIONS)
    cubes = _context_cubes(jnp.asarray(ctx["image_sphere"]), H // 2)
    return jax.tree_util.tree_map(np.asarray, rand_params(
        JEncoder(jcfg), ctx["image_sphere"], cubes, ctx["extrinsics_sphere"], ctx["near"],
        ctx["far"], 0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene

    root = tmp_path_factory.mktemp("ranks")
    (root / "store").mkdir()
    # the ranks start with the renders, which need nothing of the parent's;
    # the step and the CLI wait for inputs.pt (passed through a file: spawn
    # would pickle it into each rank in turn, and start them one by one)
    ctx = tmp.start_processes(_rank_main, args=(str(root), time.time()), nprocs=4, join=False,
                              start_method="spawn")
    data = root / "data"
    try:
        for split, name, seed in (("train", "s0", 0), ("train", "s1", 1), ("val", "v0", 2),
                                  ("test", "t0", 3)):
            write_synthetic_scene(data, split, name, n_frames=12, image_shape=(H, W),
                                  n_gaussians=200, seed=seed, device="cpu")
        batch = global_batch()
        params_flax = flax_params(batch)
        params = torch_state_from_flax(params_flax)
        torch.save((params, batch), root / "inputs.part")
        (root / "inputs.part").rename(root / "inputs.pt")
        t0 = time.perf_counter()
        jax_metrics, jax_grads = jax_meshed_step(params_flax, batch)
        t1 = time.perf_counter()
        single = port_step(params, batch)
        t2 = time.perf_counter()
        faces = {}
        for grid in FACE_GRIDS:
            fb = face_batch(batch, grid[0])
            j_metrics, j_grads = jax_meshed_step(params_flax, fb, face_grid=grid)
            faces[grid] = dict(jax=(j_metrics, torch_state_from_flax(j_grads)),
                               single=port_step(params, fb, cubes=True))
        print(f"parent: JAX's meshed step {t1 - t0:.1f} s, the port's step {t2 - t1:.1f} s, "
              f"the cube steps (JAX's and the port's) {time.perf_counter() - t2:.1f} s")
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            assert time.monotonic() < deadline, f"the ranks did not end within {TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    from splatter360_tpu_torch.main import main

    one = main(cli_argv(data, "mode=test", "test.eval_depth=true",
                        f"checkpointing.load={root / 'cli' / 'checkpoints'}",
                        f"test.output_path={root / 'one'}"))
    res = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]
    print("ranks' seconds:", [{k: round(v, 1) for k, v in r["seconds"].items()} for r in res])
    return dict(res=res, single=single, jax=(jax_metrics, torch_state_from_flax(jax_grads)),
                faces=faces, one=one, root=root)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("case", [f"band{k}" for k, _ in BAND_CASES] + ["faces"])
def test_sharded_renders_across_ranks_match_emulated(ranks, case):
    """Band-sharded ERP (4 ranks at 96x256, pairs of 2 at 48x256) and
    face-sharded cube views ((2, 2) grid, 12 faces of 32x32 an example):
    every rank's outputs bit-equal to the emulated ranks', its gradients
    (summed over the ranks) within 1e-6 of max|g|."""
    for r, res in enumerate(ranks["res"]):
        got = res[case]
        print(f"rank {r} {case}: {got}")
        assert got["out_diff"] == 0.0, (r, got)
        assert got["grad_diff"] <= 1e-6, (r, got)


def check_ranks_agree(got):
    """The ranks' steps end with the same metrics and parameters bit for bit."""
    for other in got[1:]:
        assert other["metrics"] == got[0]["metrics"]
        assert all(torch.equal(got[0]["params"][k], other["params"][k]) for k in other["params"])


def check_against_single(got, single):
    """A step across ranks against one process's step on the whole batch:
    metrics at 1e-5 relative, gradients within 1e-5 of max|g|, parameters
    within lr / 10."""
    metrics, grads, params = single
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    scale = max(float(g.abs().max()) for g in grads.values())
    worst = max(float((got["grads"][k] - g).abs().max()) / scale for k, g in grads.items())
    assert set(got["grads"]) == set(grads) and worst <= 1e-5, worst
    lr = 2e-4 / 25  # the cosine one-cycle schedule's first rate
    moved = max(float((got["params"][k] - p).abs().max()) for k, p in params.items())
    print(f"gradients {worst:.2e} of max|g|; parameters {moved:.2e} ({moved / lr:.2e} lr)")
    assert moved <= lr / 10


def check_against_jax(got, jax_step):
    """A step across ranks against JAX's meshed step on the same global
    batch: metrics at 1e-4 relative, every leaf's gradient within GRAD_TOL
    of max|g|."""
    jax_metrics, jax_grads = jax_step
    assert set(got["metrics"]) == set(jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    scale = max(float(g.abs().max()) for g in jax_grads.values())
    rows = sorted(((float((got["grads"][k] - g).abs().max()) / scale, k)
                   for k, g in jax_grads.items()), reverse=True)
    print("leaves farthest from JAX (in max|g|):", [(f"{d:.2e}", k) for d, k in rows[:3]])
    assert set(got["grads"]) == set(jax_grads)
    assert rows[0][0] <= GRAD_TOL, rows[0]


def test_data_parallel_step_matches_single_process(ranks):
    """A train step on 2 ranks (one example each) against one process's step
    on both examples; the ranks end with the same parameters bit for bit."""
    got = [ranks["res"][r]["train"] for r in range(2)]
    check_ranks_agree(got)
    check_against_single(got[0], ranks["single"])


def test_data_parallel_step_matches_jax_meshed_step(ranks):
    """The 2-rank step against JAX's step over a 2-device data mesh on the
    same global batch (tests/test_torch_train.py's bars)."""
    check_against_jax(ranks["res"][0]["train"], ranks["jax"])


@pytest.mark.parametrize("grid", FACE_GRIDS, ids=[f"{d}x{f}" for d, f in FACE_GRIDS])
def test_face_sharded_cube_step_matches_jax(ranks, grid):
    """A cube train step under train.shard_faces on an (n_data, n_face) gloo
    grid (6 faces an example, 3 a face rank; the depth L1 over holes, whose
    global weight sum crosses the ranks): every rank's parameters bit-equal;
    against the port's single-process cube step on the global batch; and
    against JAX's make_train_step(mesh=create_mesh_2d(n_data, n_face))."""
    key = f"faces{grid[0]}x{grid[1]}"
    got = [res[key] for res in ranks["res"] if key in res]
    assert len(got) == grid[0] * grid[1]
    check_ranks_agree(got)
    check_against_single(got[0], ranks["faces"][grid]["single"])
    check_against_jax(got[0], ranks["faces"][grid]["jax"])


def test_cli_trains_checkpoints_and_resumes_on_two_ranks(ranks):
    """mode=train on 2 ranks (one target view: 6 faces, 3 a rank), a 1 x 2
    (data, face) grid with a band-sharded
    validation: checkpoints at steps 2 and 3, one validation written, the
    resumed run from step 2, rank 0 alone printing; the ranks' final
    parameters bit-equal."""
    from splatter360_tpu_torch.utils.tb_events import read_scalars

    r0, r1 = ranks["res"][0]["cli"], ranks["res"][1]["cli"]
    out = ranks["root"] / "cli"
    assert r0["step"] == r1["step"] == 3
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["2", "3"]
    assert (out / "val" / "00000002" / "comparison.png").is_file()
    assert "(data, face) rank grid: 1x2" in r0["printed"]
    assert "resumed from step 2" in r0["printed"] and "val step 2" in r0["printed"]
    assert r1["printed"] == ""
    steps = sorted(step for f in (out / "tb").glob("events.out.tfevents.*")
                   for step, tag, _, _ in read_scalars(f) if tag == "train/loss")
    assert steps == [1, 2, 3]


def test_cli_test_mode_band_sharded_on_two_ranks(ranks):
    """mode=test with train.shard_render on 2 ranks: rank 0 scores and
    writes, rank 1 returns nothing; the scores those of one process."""
    r0, r1 = ranks["res"][0]["cli"], ranks["res"][1]["cli"]
    assert r1["test_scores"] == {} and r0["test_scores"].keys() == ranks["one"].keys()
    got, ref = r0["test_scores"]["t0"], ranks["one"]["t0"]
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        tol = {"psnr": 1e-2, "ssim": 1e-4, "mse": 1e-5}.get(k, 5e-4 * max(abs(v), 1e-12))
        assert abs(got[k] - v) <= tol, (k, got[k], v)
    out = ranks["root"] / "cli" / "test"
    assert json.loads((out / "scores_all_avg.json").read_text()).keys() == got.keys()
    assert os.path.isfile(out / "t0" / "compare.png")
