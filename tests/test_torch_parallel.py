"""The port's parallel/ package in one process, against the JAX package's.

The JAX references run on the conftest's 8 virtual CPU devices, as
tests/test_render_sharding.py runs them (backend "jax", the scan
compositor: composite_tiles_jax); the port runs the same ranks one after
another in this process (parallel/mesh.Emulated) through the same code as
across ranks (tests/test_torch_distributed.py holds the two together), with
its scan compositor against JAX's and with the kernels' path (the plain
compositor on the CPU) against its own unsharded render.

Bars (tests/test_render_sharding.py's, which hold JAX's sharded renders to
its unsharded one): colour and alpha 2e-5, depth 1e-4; the band render's
means and opacities gradients at atol 3e-6, rtol 2e-4; the face-sharded
render's every Gaussian gradient within 1e-5 of max|g|. The mesh helpers,
_band_partition and the dataset's shards: equal, warnings and errors
included.
"""

import multiprocessing
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatter360_tpu.parallel.mesh as jmesh
from splatter360_tpu.parallel import render_sharding as jrs
from splatter360_tpu_torch.models.types import Gaussians
from splatter360_tpu_torch.parallel import mesh
from splatter360_tpu_torch.parallel import render_sharding as prs
from test_torch_distributed import cube_scene, scene

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
W = 256
RGB_TOL, DEPTH_TOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-6, 2e-4
FACE_GRAD_TOL = 1e-5
# (name, image height, bands): 4 equal bands; 48 rows padded to 8 bands, 5
# of them empty; 160 rows in 4 unequal bands (3, 2, 2, 3 tile rows)
BAND_CASES = [("k4", 64, 4), ("pad", 48, 8), ("unequal", 160, 4)]
N = 1500  # Gaussians of the scenes held to JAX (tests/test_render_sharding.py's)
# the scan compositor's slots a tile in the band renders held to JAX: all of
# every tile's instances. Both packages' band renders bin the 3-sigma boxes
# with no elliptical cull (parallel/render_sharding.py), so their tile lists
# are the same, and no tile's list is cut here
BAND_MAX_PER_TILE = 4096


def caught(fn, *args):
    """(result or None, the ValueError's message or None, warning messages)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out, err = fn(*args), None
        except ValueError as e:
            out, err = None, str(e)
    return out, err, [str(w.message) for w in rec]


def test_mesh_helpers_match_jax(monkeypatch):
    """data_mesh_size, face_mesh_split and local_batch_size on a table of
    cases: the same sizes, the same warnings, the same errors."""
    for b in (1, 2, 3, 4, 6, 8, 12):
        for n in (1, 2, 3, 4, 6, 8):
            assert caught(mesh.data_mesh_size, b, n) == caught(jmesh.data_mesh_size, b, n)
            for faces in (6, 12, 24):
                assert (caught(mesh.face_mesh_split, b, faces, n)
                        == caught(jmesh.face_mesh_split, b, faces, n))
            monkeypatch.setattr(jmesh.jax, "process_count", lambda n=n: n)
            assert caught(mesh.local_batch_size, b, n) == caught(jmesh.local_batch_size, b)
    assert caught(mesh.local_batch_size, 3, 2)[1].startswith("trainer.batch_size=3 must")
    assert caught(mesh.face_mesh_split, 1, 12, 8) == ((1, 6), None, [
        "shard_faces: batch 1 x 12 faces maps to a 1x6 (data, face) mesh on 8 devices "
        "(2 IDLE). Batch x face-count divisibility sets the mesh."])


def test_backend_rule_and_the_one_rank_grid(monkeypatch):
    """NCCL only where each local rank has a card of its own; without
    torchrun's environment nothing starts and the grid is one rank whose
    collectives are the identity; a grid that leaves a rank out raises."""
    assert mesh.choose_backend("cuda", 4, 4) == "nccl"
    assert mesh.choose_backend("cuda", 1, 1) == "nccl"
    assert mesh.choose_backend("cuda", 2, 1) == "gloo"  # two ranks on one card
    assert mesh.choose_backend("cpu", 2, 0) == "gloo"
    assert mesh.choose_backend("cpu", 1, 8) == "gloo"
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and mesh.world_size() == 1
    grid = mesh.create_rank_grid()
    assert (grid.n_data, grid.n_face, grid.rank, grid.is_main) == (1, 1, 0, True)
    x = [torch.arange(3.0)]
    assert grid.world.all_reduce(x, mean=True) is x and grid.share_batch(x) is x
    with pytest.raises(ValueError, match="every rank must take part"):
        mesh.create_rank_grid(1, 2)


def test_band_partition_matches_jax():
    """_band_partition bit for bit: n_rows 1-64, 1-8 bands, h 48, 64, 512."""
    for h in (48, 64, 512):
        for n_rows in range(1, 65):
            for n_dev in range(1, 9):
                starts, rows = jrs._band_partition(n_rows, n_dev, h)
                assert prs._band_partition(n_rows, n_dev, h) == (tuple(starts), tuple(rows)), (
                    h, n_rows, n_dev)


def weighted_loss(color, alpha, depth):
    return color.mean() + alpha.mean() + 1e-2 * depth.mean()


@pytest.mark.parametrize("name,h,k", BAND_CASES)
def test_band_render_matches_jax(name, h, k):
    """The emulated band render against JAX's render_erp_sharded on a
    k-device mesh (N = 1500, sh degree 1, 256 wide, backend "jax" with
    BAND_MAX_PER_TILE slots): colour,
    alpha, depth, and the gradients of a loss of all three to the means and
    opacities."""
    from splatter360_tpu.parallel.mesh import create_mesh

    g = scene(n=N)
    m = create_mesh(k)

    def j_loss(means, opac, covs, sh):
        out = jrs.render_erp_sharded(means, covs, sh, opac, jnp.eye(4), (h, W), m,
                                     render_depth=True, backend="jax",
                                     max_per_tile=BAND_MAX_PER_TILE)
        return weighted_loss(out.color, out.alpha, out.depth), (out.color, out.alpha, out.depth)

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(g[0]), jnp.asarray(g[3]), jnp.asarray(g[1]), jnp.asarray(g[2]))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in g]
    out = prs.render_erp_sharded(*leaves, torch.eye(4), (h, W), mesh.Emulated(k),
                                 render_depth=True, backend="jax",
                                 max_per_tile=BAND_MAX_PER_TILE)
    weighted_loss(out.color, out.alpha, out.depth).backward()
    assert out.color.shape == (h, W, 3)
    for got, ref, tol in zip((out.color, out.alpha, out.depth), j_out,
                             (RGB_TOL, RGB_TOL, DEPTH_TOL)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol)
    for got, ref in zip((leaves[0].grad, leaves[3].grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_band_render_on_the_kernels_path_matches_unsharded():
    """Backend "pallas" (the kernels' plain versions on the CPU): the band
    render over 2, 4 and 8 emulated ranks, and render_erp_views_sharded,
    against the port's unsharded render, outputs and every gradient (the
    bands cut tiles into other spans: the render is equal within span
    reassociation, ROADMAP Queue 3)."""
    from splatter360_tpu_torch.models.decoder import render_erp_views
    from splatter360_tpu_torch.ops.rasterizer import render_batch

    g = scene()
    for h, k in ((64, 2), (64, 4), (48, 8)):
        ref_leaves = [torch.from_numpy(x).requires_grad_(True) for x in g]
        ref = render_batch(*ref_leaves, torch.eye(4)[None], (h, W), 0.1, 100.0)
        weighted_loss(ref.color, ref.alpha, ref.depth).backward()
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in g]
        out = prs.render_erp_sharded(*leaves, torch.eye(4), (h, W), mesh.Emulated(k),
                                     render_depth=True)
        weighted_loss(out.color, out.alpha, out.depth).backward()
        for got, want, tol in ((out.color, ref.color[0], RGB_TOL),
                               (out.alpha, ref.alpha[0], RGB_TOL),
                               (out.depth, ref.depth[0], DEPTH_TOL)):
            np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=tol)
        for got, want in zip(leaves, ref_leaves):
            np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL)

    gs = Gaussians(*(torch.from_numpy(x)[None] for x in g))
    extr = torch.eye(4).repeat(1, 2, 1, 1)
    extr[0, 1, :3, 3] = torch.tensor([0.2, 0.0, -0.1])
    near, far = torch.full((1, 2), 0.1), torch.full((1, 2), 100.0)
    ref = render_erp_views(gs, extr, near, far, (64, W), render_depth=True)
    out = prs.render_erp_views_sharded(gs, extr, near, far, (64, W), mesh.Emulated(4),
                                       render_depth=True)
    assert out.color.shape == ref.color.shape and out.dropped is None
    np.testing.assert_allclose(out.color.numpy(), ref.color.numpy(), atol=RGB_TOL)
    np.testing.assert_allclose(out.depth.numpy(), ref.depth.numpy(), atol=DEPTH_TOL)


def face_loss(color, alpha):
    return (color ** 2).mean() + 0.1 * alpha.mean()


def port_faces(g, extr, comm_size, **kw):
    """The emulated (2, comm_size) grid: each example's faces over
    comm_size emulated face ranks; (outputs, the Gaussians' leaves)."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in g]
    outs = [prs.render_cube_views_face_sharded(
        Gaussians(*(x[d:d + 1] for x in leaves)), torch.from_numpy(extr[d:d + 1]),
        torch.full((1, 2), 0.1), torch.full((1, 2), 100.0), (32, 32), mesh.Emulated(comm_size),
        render_depth=True, **kw) for d in range(2)]
    return [torch.cat(x) for x in zip(*outs)], leaves


def test_face_sharded_render_matches_jax():
    """On a (2, 2) grid against JAX's render_cube_views_face_sharded
    (tests/test_render_sharding.py's inputs: 2 examples, 2 views, 12 faces
    of 32x32): colour, alpha and depth, and every Gaussian gradient."""
    from splatter360_tpu.models.types import Gaussians as JGaussians
    from splatter360_tpu.parallel.mesh import create_mesh_2d

    g, extr = cube_scene(N)
    m = create_mesh_2d(2, 2)
    kw = dict(backend="jax", max_per_tile=512)

    def j_loss(gg):
        r = jrs.render_cube_views_face_sharded(gg, jnp.asarray(extr), jnp.full((2, 2), 0.1),
                                               jnp.full((2, 2), 100.0), (32, 32), m,
                                               render_depth=True, **kw)
        return face_loss(r.color, r.alpha), (r.color, r.alpha, r.depth)

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        JGaussians(*(jnp.asarray(x) for x in g)))
    (color, depth, alpha, _), leaves = port_faces(g, extr, 2, **kw)
    face_loss(color, alpha).backward()
    assert color.shape == (2, 2, 6, 32, 32, 3)
    for got, ref, tol in zip((color, alpha, depth), j_out, (RGB_TOL, RGB_TOL, DEPTH_TOL)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol)
    for got, ref, name in zip(leaves, j_grads, Gaussians._fields):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.grad.numpy() / scale, ref / scale, atol=FACE_GRAD_TOL,
                                   err_msg=name)


def test_face_sharded_render_on_the_kernels_path_matches_unsharded():
    """Backend "pallas", with and without remat_faces, over 3 and 4 face
    ranks (slices of 4 and 3 faces: a slice of 4 crosses a view), against
    the port's render_cube_views: outputs and every Gaussian gradient."""
    from splatter360_tpu_torch.models.decoder import render_cube_views

    g, extr = cube_scene()
    ref_leaves = [torch.from_numpy(x).requires_grad_(True) for x in g]
    ref = render_cube_views(Gaussians(*ref_leaves), torch.from_numpy(extr),
                            torch.full((2, 2), 0.1), torch.full((2, 2), 100.0), (32, 32),
                            render_depth=True)
    face_loss(ref.color, ref.alpha).backward()
    for k, remat in ((3, False), (4, True)):
        (color, depth, alpha, dropped), leaves = port_faces(g, extr, k, remat_faces=remat)
        face_loss(color, alpha).backward()
        assert torch.equal(dropped, ref.dropped)
        for got, want, tol in ((color, ref.color, RGB_TOL), (alpha, ref.alpha, RGB_TOL),
                               (depth, ref.depth, DEPTH_TOL)):
            np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=tol)
        for got, want, name in zip(leaves, ref_leaves, Gaussians._fields):
            scale = float(want.grad.abs().max())
            np.testing.assert_allclose(got.grad.numpy() / scale, want.grad.numpy() / scale,
                                       atol=FACE_GRAD_TOL, err_msg=f"{k} ranks: {name}")


def test_dataset_shards_match_jax(tmp_path):
    """The trainer's per-rank dataset, SceneDataset(seed=seed + r,
    shard_index=r, num_shards=K), yields JAX's batches on every rank."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.data.dataset import SceneDataset as JSceneDataset
    from splatter360_tpu.data.dataset import batches as j_batches
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.data.dataset import SceneDataset, batches
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene

    for i in range(5):
        write_synthetic_scene(tmp_path, "train", f"s{i}", n_frames=12, image_shape=(32, 64),
                              n_gaussians=100, seed=i, device="cpu")
    overrides = [f"dataset.roots=[{tmp_path}]", "dataset.image_shape=[32,64]",
                 "dataset.view_sampler.max_distance_between_context_views=5"]
    cfg = load_config(str(REPO / "configs" / "hm3d.yaml"), overrides)
    jcfg = j_load_config(str(REPO / "configs" / "hm3d.yaml"), overrides)
    seed = cfg.trainer.seed
    for k in (2, 3):
        for r in range(k):
            got = batches(SceneDataset(cfg.dataset, split="train", stage="train", seed=seed + r,
                                       shard_index=r, num_shards=k), 1)
            ref = j_batches(JSceneDataset(jcfg.dataset, split="train", stage="train",
                                          seed=seed + r, shard_index=r, num_shards=k), 1)
            for _ in range(3):
                a, b = next(got), next(ref)
                for part in ("context", "target"):
                    assert a[part].keys() == b[part].keys()
                    for key in a[part]:
                        np.testing.assert_array_equal(a[part][key], b[part][key],
                                                      err_msg=f"{k} {r} {part}.{key}")


def test_step_tracker_across_processes():
    """StepTracker(multiprocess=True): a step set in another process is read
    here (the JAX tracker's option)."""
    from splatter360_tpu_torch.utils.step_tracker import StepTracker

    tracker = StepTracker(multiprocess=True)
    child = multiprocessing.get_context("spawn").Process(target=tracker.set_step, args=(7,))
    child.start()
    child.join(timeout=60)
    assert not child.is_alive() and child.exitcode == 0
    assert tracker.get_step() == 7
    threads = StepTracker()
    threads.set_step(3)
    assert threads.get_step() == 3


def test_validation_errors_around_collective_decodes(monkeypatch, capsys):
    """Under train.shard_render over more than one rank the decodes are
    collectives: a failure in them (the video's frames included) propagates
    from Validator.decode and Trainer._validate, and only the main rank's
    report is caught; on one rank the whole validation is caught, and a
    failed video render is kept for the report, as in JAX."""
    from types import SimpleNamespace

    from splatter360_tpu_torch.train import trainer as tr

    # Validator.decode: the example, encoder and decoder stubbed; the second
    # decode (the video's first frame) fails
    def validator(comm):
        cfg = SimpleNamespace(train=SimpleNamespace(shard_render=True))
        v = tr.Validator.__new__(tr.Validator)
        v.cfg, v.comm, v.sharded, v.face, v.device = cfg, comm, prs.shards_erp(cfg, comm), 8, "cpu"
        v._load_example = lambda: {}
        decodes = []

        def decode(*a, **kw):
            decodes.append(1)
            if len(decodes) == 2:
                raise RuntimeError("a frame's decode failed")
            return "views"

        v._decode = decode
        return v

    views = {"context": {"image_sphere": None, "extrinsics_sphere": torch.eye(4)[None, None],
                         "near": None, "far": None},
             "target": {"extrinsics_sphere": None, "near": torch.ones(1, 1),
                        "far": torch.ones(1, 1)}}
    monkeypatch.setattr(tr, "_on_device", lambda batch, dev: views)
    monkeypatch.setattr(tr, "context_cubes", lambda img, face: None)
    monkeypatch.setattr(tr, "apply_encoder", lambda *a: ("gaussians", None))
    with pytest.raises(RuntimeError, match="a frame's decode failed"):
        validator(mesh.Emulated(2)).decode(SimpleNamespace(model=None), 1)
    one = validator(mesh.Emulated(1))
    assert not one.sharded
    decoded = one.decode(SimpleNamespace(model=None), 1)
    assert decoded["out"] == "views" and isinstance(decoded["video_error"], RuntimeError)

    # Trainer._validate on a one-rank grid (its barrier a no-op)
    class Stub:
        def __init__(self, sharded, fail):
            self.sharded, self.fail, self.calls = sharded, fail, []

        def decode(self, state, step):
            self.calls.append("decode")
            if self.fail == "decode":
                raise RuntimeError("decode")
            return {}

        def report(self, decoded, step, writer=None):
            self.calls.append("report")
            if self.fail == "report":
                raise RuntimeError("report")

        def run(self, state, step, writer=None):
            self.report(self.decode(state, step), step, writer)

    trainer = tr.Trainer.__new__(tr.Trainer)
    trainer.is_main, trainer.grid = True, mesh.create_rank_grid()
    with pytest.raises(RuntimeError, match="decode"):
        trainer._validate(Stub(True, "decode"), None, 2, None)
    for sharded, fail in ((True, "report"), (False, "decode"), (False, "report")):
        stub = Stub(sharded, fail)
        trainer._validate(stub, None, 2, None)
        assert f"warning: validation failed at step 2: {fail}" in capsys.readouterr().out
        with pytest.raises(RuntimeError, match=fail):
            trainer._validate(Stub(sharded, fail), None, 0, None, catch=False)
    ok = Stub(True, None)
    trainer._validate(ok, None, 2, None)
    assert ok.calls == ["decode", "report"]
