"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends in a non-zero exit and no result line):
  1. print the card's name and power limit; build every CUDA kernel (one
     nvcc per source, all at once);
  2. hold the forward compositor kernel against its plain PyTorch version at
     the flagship render shapes (512x1024 ERP, N = 2*512*1024 Gaussians), at
     the default span and at span 1, all 8 planes bit for bit, with the
     threshold's floor off so that tiles are cut into spans, and
     (2b) the backward kernel against its plain version there, with a seeded
     cotangent, at the default span and at span 1 (every block its own work
     item), the plain version at the same span;
  2c. hold the unfused forward kernel (the path past the fused kernels'
     table budget) against its plain version and against the fused kernel
     at the 3-view flagship shapes (N = 3*512*1024, one view), at both spans,
     and both forward kernels at span 1 against one span a tile, all bit for
     bit; (2d) the
     unfused backward kernel, with the block map and scatter, against its
     plain version and against the fused backward there, at both spans; at
     span 1 its blocks equal those of one span a tile bit for bit (both sum
     across blocks in walk order);
  2e. the same checks at wrap_x=False on the 6 pinhole cube faces (256x256)
     of one pose: the fused pair on the 2-view flagship scene, the unfused
     pair on the 3-view one; and one 512x1024 pinhole view binned with the
     wrap, composited at wrap_x=True and False, which must differ at both
     side edges (the flag reaches the kernel);
  3. serve N_REQUESTS HM3D-width requests through the port's entry points
     (2 context panoramas -> encode -> N Gaussians -> 4 target ERP views with
     depth), counting kernel launches, and (3b) compare the GPU serving path
     with the CPU path on a small input;
  3c. take N_STEPS HM3D-width train steps (ERP supervision, LPIPS, depth L1,
     clip + Adam) through train.state's entry points, counting kernel calls
     and timing each stage; hold the backward kernel against its plain
     version on the last step's Gaussians (4 target views); (3d) compare a
     GPU train step with a CPU one on a small input;
  3e-3g. the same with 3 context panoramas, where N = 3*512*1024 takes the
     unfused kernels: serving (3e), train steps (3f), GPU vs CPU train step
     on a small input with both on the unfused path (3g);
  3h-3j. the cube-face path: serving (encode -> serve.render_cube_views, the
     6 faces of N_TGT views, 2 then 3 context panoramas, each request one
     forward launch for all 24 faces), train steps with cube supervision
     (TrainConfig(supervision="cubes"), remat_faces off, N_STEPS with 2
     context panoramas and N_STEPS - 1 with 3; the backward kernel against
     its plain version on the last step's face inputs), and a GPU against a
     CPU cube train step on a small input, fused then unfused;
  3l. the CLI's evaluation mode (python -m splatter360_tpu_torch.main
     configs/hm3d.yaml mode=test ...) on 2 seeded 512x1024 test scenes with a
     saved checkpoint of the flagship model, bf16 compute from the file: 2
     context panoramas scored on ERP, then on cube faces, then 3 context
     panoramas; every artefact written, finite scores, the weights restored,
     the fused forward kernel launched on the 2-view runs and the unfused one
     on the 3-view run; bf16 against f32 encoder time on the same requests;
     a GPU against a CPU bf16 encoder at 64x256;
  3m. the CLI's training mode (main ... configs/hm3d.yaml mode=train) on 3
     seeded 512x1024 train scenes of 24 frames and a val scene, bf16 compute
     at B = 1: (a) 4 steps with a sanity validation and validations at
     steps 2 and 4 (every artefact), checkpoints at 2 and 4, TensorBoard
     scalars read back, a torch.profiler trace of step 3; the same command
     resumed to step 6 (parameters and Adam moments restored as saved);
     (b) 2 steps with 3 context panoramas (the unfused pair); (c) the tiny
     f32 model at 64x256 through mode=train on the card and with --device
     cpu from one checkpoint, the logged losses at 1e-3 relative; with
     launches, step ms, prefetch waits, validation and checkpoint seconds
     and peak memory;
  3n. the encoder's Table 3 options and render_backend "jax": (a) per option
     group (OPTION_GROUPS: fusion concat, biproj with the epipolar block,
     the six wo_* ablations, 2 Gaussians a pixel alone and without depth
     refinement) hm3d.yaml's model block in bf16 at HM3D width, an encode +
     render and 2 ERP train steps, the fused pair launched for one
     Gaussian a pixel and the unfused pair for 2 (N = 2,097,152), with
     encoder ms, step ms and peak memory; the epipolar block's own memory;
     (b) each group's tiny f32 encoder and train step on the card against
     the CPU (3b's and 3d's bars; a leaf past them only as one jump), the
     CPU steps in worker processes started before (a); (c) the
     CLI, mode=train then mode=test, on hm3d.yaml with biproj, the
     epipolar block and 2 Gaussians a pixel; (d) configs/synthetic_smoke.yaml
     as written (render_backend jax) through mode=train and mode=test, every
     render the scan compositor's, and one card render against the CPU's; (e)
     a 64x128 ERP view with backend "pallas" through the scan compositor;
  3o. the mono branch (add_mono_feat, the frozen DINOv2 ViT-S/14):
     (a-b) hm3d.yaml's model with it, bf16 at HM3D width, warm-started from
     a seeded file in DINOv2's layout, one served request and 2 ERP train
     steps through the fused pair, the ViT bit-equal across the steps, the
     encoder's ms with and without the branch and the ViT's own; (c) the
     CLI, mode=train (checkpointing.pretrained_mono) then mode=test; (d)
     the tiny f32 mono encoder and train step, the card against the CPU;
  3p. the UniMatch backbone warm start and trajectory videos: (a)
     hm3d.yaml's model in bf16 warm-started from a seeded file in gmdepth's
     layout (every key of tests/data/unimatch_state_dict_keys.json into both
     backbones, bit for bit), a served request and 2 ERP train steps
     through the fused pair; (b) the CLI, mode=train with
     checkpointing.pretrained_backbone, then mode=test with
     test.save_video: 60 fused forward launches a scene for its video,
     mp4 or PNG frames written; (c) interpolate, wobble and spin through
     Evaluator.render_video on (a)'s Gaussians, 60 launches each, frame 0
     bit-equal to a direct render, a spin frame's kernel bit-equal to its
     plain version, ms a frame and a video;
  3q. the JAX package's checkpoints and scene shards: (a) the libzstd.so.1
     that utils/zstd.py loads and the native loader built against it
     without zstd's headers, a 512x1024 scene written as .s3z and read back
     equal; (b) tests/data/torch_orbax_hm3d (hm3d.yaml's train state at step
     1234, written by the JAX package's orbax save_checkpoint) read by
     train/orbax_reader.py, every leaf's sha256 against expected.json; (c)
     mode=test on hm3d.yaml with checkpointing.load at it, 2 scenes, the
     weights bit-equal to the converted tree, one fused forward launch a
     scene; (d) mode=train resumed from it, 2 bf16 steps at B = 1 from step
     1234 (Adam's moments and count restored, the learning rate
     learning_rate(cfg, 1234)) through the fused pair, then the port's own
     step 1236 the latest; (e) checkpointing.pretrained_model at it: weights
     only, step 0;
  3s. generated scenes (preprocess/): (a) the batched dense compositor
     (ops/rasterizer_ref.composite_dense) on a 32x64 frame of a small room
     and a 512x1024 frame of a default one, bit-equal to the walk over one
     Gaussian at a time it replaced on the card, and at 32x64 within
     DENSE_ULPS of it on the CPU, the walk without the transmittance cut
     past that bar; at 512x1024 walk_chunks_in_order (each chunk's
     Gaussians in order, no move of the live ones to the front) bit-equal
     and timed beside it; (b) python -m
     splatter360_tpu_torch.preprocess at HM3D width, 2 train and 1 test
     scenes of 12 512x1024 frames at the default spacing (~19k Gaussians a
     room) with --validate, ms a frame, s a scene, retries, peak memory, and
     one frame through the cube rig against the direct frame; (c)
     hm3d.yaml's mode=train (2 steps, the fused pair) on the generated train
     scenes, then mode=test (the fused forward) of its checkpoint on the test
     scene; (d) render_projections of the test scene's room at 256x256, the
     card against the CPU;
  3r. training and evaluation across ranks (parallel/), after phase 4 and
     with the earlier phases' tensors released, (c)'s and (d)'s ranks
     started first and waiting for their go while (a) and (b) run: (a) a
     flagship view band-sharded over 2 and 8 emulated ranks against
     render_erp_views (colour and depth at the JAX package's bars, alpha
     within the kernels' exit, 1e-4), then the encoder's Gaussians
     of one HM3D-width request into 4 target views band-sharded over 2 and
     8 emulated ranks (render_erp_sharded with Emulated(k)), one fused
     forward launch a band and view, the views against render_erp_views,
     every band of one view (the lightest) bit-equal to the plain version,
     the kernel's ms a band and their balance; (b) a cube-supervision step's render and loss
     with the faces over 2 and 4 emulated face ranks, outputs and Gaussian
     gradients against render_cube_views; (c) two torchrun ranks sharing the
     card over gloo (chip_smoke.py --rank-run): hm3d.yaml's mode=train at
     batch 2 on a data grid 2x1 with a band-sharded validation, the
     all-reduced step-1 gradients against single-process B = 2 steps taken
     first in this process, then cube supervision with train.shard_faces at
     batch 1 on a (data, face) grid 1x2; each rank's ms a step and peak
     memory; (d) one torchrun rank over NCCL: mode=train with both shard
     flags, mode=test, a band-sharded view over the one-rank group;
  4. time each kernel and its plain version with CUDA events, the unfused
     path's pack and scatter apart, the fused kernels on the 3-view inputs,
     and the serving render stage by stage; both backward kernels at their
     training shapes, on the last step's Gaussians, and both forward
     kernels on the flagship scene, the serving inputs and the same train
     steps' Gaussians, for each span of SPANS in turns (None:
     one span a tile), with the blocks each tile walks (forward: in its
     segment and processed), the warps' visits per block, the time with
     every tile capped at 64 blocks, and the blocks the forward's first pass
     sums past a tile's exit; each kernel (ms, bound, plain ms) on the cube
     inputs (2e, 3h, 3i) and the forwards on all the train steps' inputs.
It prints a JSON line of the CLI evaluation (3l), one of the CLI training
(3m), one of the options and the scan compositor (3n), one of the mono
branch (3o), one of the warm start and the videos (3p), one of the JAX
package's checkpoints and shards (3q), one of the generated scenes (3s),
one of the ranks (3r), one of per-kernel numbers (the ERP path's, the cube
path's under cube_*, and the launches of 3m's, 3n's, 3o's, 3p's, 3q's, 3s's
and 3r's runs), the nvidia-smi
line, and as its last
line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

H, W = 512, 1024
N_CTX, N_TGT = 2, 4
# context panoramas of the unfused path: N = 3*H*W is past the fused budget
N_CTX3 = 3
# requests and steps of the serving and training phases (3 until phase 3s
# was added; 2 keeps the script inside its time limit)
N_REQUESTS = 2
N_STEPS = 2
# the cube faces of HM3D width (TrainConfig.cube_face_size None: H // 2)
FACE = H // 2
# compositor tolerances: the bars the JAX package holds its two compositor
# backends to (tests/test_pallas_composite.py:47-49)
ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4
# H100 SXM data-sheet peaks (dense): FP32 outside the tensor cores, HBM3
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# compositor operations these inputs need: a 6-op radius-box cull per
# (instance, tile) of a processed block, and the alpha/transmittance/
# accumulate chain (20 flops + 3 transcendentals) per (pixel, instance) pair
# that passes the gate; pairs outside an instance's box need no work
OPS_BOX_TEST, OPS_LIVE_PAIR = 6, 23
# backward, per (pixel, instance) pair that passes the gate, counted once:
# in a walked block that fails the tile-wide gate, the alpha chain (13 flops
# + exp), log1p and the add into the block's sum; in a block that passes it,
# also the transmittance, gamma, psi, g_alpha and the ten per-pixel gradient
# terms (59 ops). The kernel's second alpha chain is its design, not work
# the function needs.
OPS_BWD_SUM, OPS_BWD_GATED = 16, 59
# bytes of an instance the compositor must read: rows u v a b c o r g b depth
# rx ry of the 16-row layout (rows 12-15 are padding), and of its gradient
# the backward must write: rows 0-9
INST_READ_BYTES, GRAD_WRITE_BYTES = 12 * 4, 10 * 4
# the backward bar: 2e-3 of max|g| per row of g_attrs, the bar between the JAX
# package's two compositor backends (tests/test_pallas_composite.py:66-71)
GRAD_TOL = 2e-3
# and, per row, |g_kernel - g_plain|_2 / |g_plain|_2: a kernel right only on
# the few largest gradients fails it, float atomics (~2e-8 of max|g|) do not
L2_TOL = 1e-5
# with gaussians_per_pixel 2 and wo_depth_refine each pixel's two Gaussians
# coincide, and the backward of such a pair is ill-conditioned in float32:
# the two terms of g_alpha cancel by up to 1 / (1 - alpha) = 100 at the
# alpha cap, so two float32 orders of summation (the kernel's, the plain
# version's) differ past L2_TOL in rows u and a, each as far from the
# float64 function as the other (phase 3n (a) prints it). There L2_TOL
# holds the unfused kernel against the fused one, and GRAD_TOL against the
# plain version in float32; against the plain version in float64 each row is
# held to max(GRAD_TOL, F64_RATIO x the float32 plain version's own distance
# to it): one run measured row u of kernel and float32 plain version alike at
# 2.31e-4 L2 from float64, so a fixed bar there tests float32, not the kernel
# (ROADMAP Queue 3).
F64_RATIO = 1.25
# the one gradient leaf of phase 3j's small cube steps past GRAD_TOL, at a
# fixed bound: the CPU step's own gradient of it jumps by 2.12e-3 of max|g|
# under a 1e-6 perturbation of the params (ROADMAP Queue 3), as
# tests/test_torch_train.py's JUMP_TOL leaf does for the ERP step
CUBE_JUMP_TOL = {"backbone_erp.CNNEncoder_0.ResidualBlock_1.Conv_1.weight": 3.5e-3}
# the spans timed in phase 4 (blocks of a heavy tile's segment or walk one
# work item takes; None: one span a tile): the default and one span a tile.
# Spans 1, 4 and 64, timed in earlier runs (PERF.md §6), are left out to keep
# the script's time with phases 3q and 3s added
SPANS = (16, None)
# phase 3l: the CLI's test scenes (frames each) and the bf16 encoder's bars
# against the CPU (tests/test_torch_bf16.py's: through the whole random
# encoder, rounding flips of another backend grow to the policy's own size)
CLI_SCENES, CLI_FRAMES = 2, 12
BF16_RATIO, BF16_MEAN_RATIO = 1.5, 1.25
# phase 3m: the CLI's train scenes (24 frames let hm3d.yaml's initial context
# gaps of 10-20 frames apply unclamped) and its runs' last steps
TRAIN_SCENES, TRAIN_FRAMES = 3, 24
CLI_TRAIN_STEPS, CLI_RESUME_STEPS = 4, 6
# 3m (c): the card's step-2 checkpoint against the CPU's, leaf by leaf: the
# parameter change and both Adam moments within UPDATE_RTOL in relative L2
# (tests/test_torch_trainer.py's bar, port against JAX); a leaf whose first
# moment on the CPU is within STILL_M of the largest (its gradient is zero
# but for rounding) is held only to move by at most STILL_LR * lr on the card
UPDATE_RTOL, STILL_M, STILL_LR = 5e-2, 1e-7, 0.1
CONFIG = Path(__file__).resolve().parent / "configs" / "hm3d.yaml"
# phase 3n: the encoder's Table 3 option groups (tests/test_torch_ablations.py's;
# every flag is in one of them), on hm3d.yaml's model block
OPTION_GROUPS = {
    "concat": {"fusion_type": "concat"},
    "biproj+epipolar": {"fusion_type": "biproj", "use_epipolar_trans": True},
    "wo_cost_volume+wo_depth_refine": {"wo_cost_volume": True, "wo_depth_refine": True},
    "wo_cost_volume_refine+wo_backbone_cross_attn": {"wo_cost_volume_refine": True,
                                                     "wo_backbone_cross_attn": True},
    "wo_cube_encoder": {"wo_cube_encoder": True},
    "wo_erp_encoder": {"wo_erp_encoder": True},
    "gpp2": {"gaussians_per_pixel": 2},
    "gpp2+wo_depth_refine": {"gaussians_per_pixel": 2, "wo_depth_refine": True},
}
# 3n (b): a gradient leaf of the small option steps past GRAD_TOL passes
# only where it is one jump of the function, measured in the same run: a
# conv weight of a backbone's CNN (a few ReLU inputs of its random-init
# layers lie within ~1e-6 of 0, and the card's rounding puts them on the
# other side), whose card - CPU distance is at most JUMP_RATIO times the
# CPU step's own move under a 1e-6 perturbation of the parameters, at a
# cosine of at least JUMP_COS with that move (ROADMAP Queue 3). At seed 0
# on an NVIDIA H100 80GB HBM3 at 700 W, 25 leaves in 3 groups jumped, by
# 0.91-1.08 of the move at cosine 0.85-1.00.
JUMP_LEAVES = ("backbone_cube.CNNEncoder_0.", "backbone_erp.CNNEncoder_0.")
JUMP_RATIO, JUMP_COS, JUMP_NOISE_SEED = 1.2, 0.8, 10
# 3n (b): the CPU halves of the groups' tiny train steps, then the 1e-6
# noise steps jump_gaps may ask for, run in OPTION_WORKERS processes of
# OPTION_THREADS threads each, started before 3n (a) so that they run while
# the card takes 3n (a)'s HM3D-width steps (run in 3n (b) itself they saved
# nothing: the host's cores were the limit). 3n (a)'s host-clock times are
# taken beside them.
OPTION_WORKERS, OPTION_THREADS = 3, 2
# 3n (c): the CLI's option overrides on hm3d.yaml
CLI_OPTIONS = ["model.fusion_type=biproj", "model.use_epipolar_trans=true",
               "model.gaussians_per_pixel=2"]
# 3n (d): the repo's minimum end-to-end config, as written (render_backend jax)
SMOKE_CONFIG = CONFIG.parent / "synthetic_smoke.yaml"
SMOKE_STEPS = 1
# phase 3o: the mono branch (hm3d.yaml's model with add_mono_feat, ViT-S/14):
# its token grid on the 256x256 faces (resized to 252), and the DINOv2
# parameters a warm start copies: patch_embed (2), pos_embed, norm (2), and
# 18 a block (2 norms, query/key/value/out, the MLP: 2 each; ls1, ls2)
MONO_GRID = FACE // 14
MONO_LEAVES = 5 + 18 * 12
# phase 3p: the real gmdepth key -> shape map (hm3d.yaml's backbone, d_feature
# 128, downscale 8), every key of which a warm start copies into both
# backbones; the frames of a trajectory video (Evaluator.render_video)
UNIMATCH_KEYS = CONFIG.parent.parent / "tests" / "data" / "unimatch_state_dict_keys.json"
VIDEO_FRAMES = 60

failures: list[str] = []


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
                return out
            except Exception:
                traceback.print_exc()
                failures.append(name)
                print(f"== {name}: FAILED", flush=True)
                return None
        return run
    return wrap


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_scene(seed: int, n: int, sh_degree: int = 4):
    """numpy-seeded copy of bench.py's scene: Gaussians around the origin,
    radius 0.5-8, scales 0.004-0.03, sym6 covariances."""
    from splatter360_tpu_torch.geometry.transforms import build_covariance_sym6

    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    means = dirs * rng.uniform(0.5, 8.0, (n, 1)).astype(np.float32)
    scales = rng.uniform(0.004, 0.03, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = (0.3 * rng.normal(size=(n, 3, (sh_degree + 1) ** 2))).astype(np.float32)
    sh[..., 0] += 0.5
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    dev = torch.device("cuda")
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         dict(means=means, scales=scales, quats=quats, sh=sh, opac=opac).items()}
    covs = build_covariance_sym6(t["scales"], t["quats"])
    return t["means"], covs, t["sh"], t["opac"]


def view_batch(means, c2ws, near, face=None):
    """batch_inputs' arguments for the ERP views c2ws or, with `face`, the 6
    cube faces of each (decoder.cube_face_batch): (c2w, image shape, near,
    far, keywords)."""
    from splatter360_tpu_torch.models.decoder import cube_face_batch

    c2w = torch.stack(list(c2ws))
    near = torch.full((c2w.shape[0],), near, device=means.device)
    if face is None:
        return c2w, (H, W), near, 10 * near, {}
    c2w, nr, fr, kw = cube_face_batch(c2w, near, 10 * near, means.shape[0])
    return c2w, (face, face), nr, fr, kw


def render_inputs(means, covs, sh, opac, c2ws, near, face=None):
    """attrs [V, N, 16], gidx, starts, counts and the tiling of the ERP views
    c2ws or, with `face`, of the 6 cube faces of each, as render_batch
    builds them (batch_inputs)."""
    from splatter360_tpu_torch.ops.rasterizer import batch_inputs

    c2w, shape, nr, fr, kw = view_batch(means, c2ws, near, face)
    with torch.no_grad():
        attrs, asg, wrap = batch_inputs(means, covs, sh, opac, c2w, shape, nr, fr, **kw)
    return dict(
        attrs=attrs,
        gidx=torch.stack([a.gaussian_idx for a in asg]),
        tile_ids=torch.stack([a.tile_ids for a in asg]),
        starts=torch.stack([a.tile_starts for a in asg]),
        counts=torch.stack([a.tile_counts for a in asg]),
        nty=asg[0].num_tiles_y, ntx=asg[0].num_tiles_x, shape=shape, wrap=wrap,
        dropped=[int(a.dropped) for a in asg],
    )


def with_inst(inp):
    """inp with the unfused path's instance blocks (pack_instances)."""
    from splatter360_tpu_torch.ops.cuda.composite import pack_instances

    return dict(inp, inst=pack_instances(inp["attrs"], inp["gidx"], inp["tile_ids"],
                                         inp["nty"] * inp["ntx"]))


def fwd_calls(inp, unfused=False):
    """(kernel, plain) forward calls on inp, each taking span=... (default
    FWD_SPAN): the fused ones on attrs + gidx, the unfused ones on
    inp["inst"]."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    seg = (inp["starts"], inp["counts"], inp["nty"], inp["ntx"], float(inp["shape"][1]),
           inp["wrap"])
    if unfused:
        return (lambda **kw: comp.composite_forward_unfused(inp["inst"], *seg, **kw),
                lambda **kw: comp.composite_forward_unfused_plain(inp["inst"], *seg, **kw))
    return (lambda **kw: comp.composite_forward(inp["attrs"], inp["gidx"], *seg, **kw),
            lambda **kw: comp.composite_forward_plain(inp["attrs"], inp["gidx"], *seg, **kw))


@contextlib.contextmanager
def slots_rule_only():
    """The forward's threshold without its floor over the mean segment. No
    tile of the flagship scenes holds FWD_HEAVY_OVER_MEAN times the mean,
    so the forward cuts none of them; without the floor it cuts every tile
    past the call's segment blocks over the slots, most of which exit
    early, and the checks run its spans, scan and combine there."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    over_mean = comp.FWD_HEAVY_OVER_MEAN
    comp.FWD_HEAVY_OVER_MEAN = 0
    try:
        yield
    finally:
        comp.FWD_HEAVY_OVER_MEAN = over_mean


def tiles_cut(inp, span):
    """The tiles the forward cuts into several spans of `span` on inp."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    nseg = comp.segment_blocks(inp["starts"], inp["counts"])
    _, heavy = comp.span_item_end(nseg, span, comp.FWD_HEAVY_OVER_MEAN)
    return int(((nseg > heavy) & (nseg > (span or 1 << 30))).sum())


def compare_kernel_plain(inp, label, unfused=False, span=None, exact=False):
    """Kernel vs plain planes on the same inputs, both at `span` (None:
    FWD_SPAN); with `exact`, all 8 planes must be equal bit for bit.
    Returns (max_abs_err, stats), stats holding the plain version's work
    counts and its ms."""
    from splatter360_tpu_torch.ops.cuda.composite import FWD_SPAN, compose_planes

    span = FWD_SPAN if span is None else span
    kernel, plain = fwd_calls(inp, unfused)
    pk = kernel(span=span)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = plain(stats=stats, span=span)
    torch.cuda.synchronize()
    stats["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    bg = torch.zeros(3, device="cuda")
    rk, ak, dk = compose_planes(pk, inp["shape"], inp["nty"], inp["ntx"], bg)
    rp, ap, dp = compose_planes(pp, inp["shape"], inp["nty"], inp["ntx"], bg)
    err_rgb = float((rk - rp).abs().max())
    err_a = float((ak - ap).abs().max())
    err_d = float((dk - dp).abs().max())
    nk, npl = pk[:, :, 6, 0], pp[:, :, 6, 0]
    diff = (nk != npl).nonzero().tolist()
    per_tile = nk.flatten().sort(descending=True).values
    top = per_tile[: max(1, per_tile.numel() // 100)]
    same = torch.equal(pk, pp)
    print(f"[{label}] span {span} ({tiles_cut(inp, span)} tiles cut): views={pk.shape[0]} "
          f"max|rgb| err={err_rgb:.3e} alpha err={err_a:.3e} "
          f"depth err={err_d:.3e}; tiles with differing n_processed: {diff[:20]} "
          f"({len(diff)} total); blocks processed {int(nk.sum())} of "
          f"{int(((inp['starts'] + inp['counts'] + 127) // 128 - inp['starts'] // 128).sum())}; "
          f"per tile: max {int(per_tile[0])}, median {int(per_tile.median())}, "
          f"top 1% of tiles hold {float(top.sum() / per_tile.sum().clamp(min=1)):.1%}; "
          f"all 8 planes bit-equal {same}")
    ok = (err_rgb <= ATOL_RGB and err_a <= ATOL_RGB and err_d <= ATOL_DEPTH and not diff
          and bool(torch.isfinite(pk).all()) and (same or not exact))
    if not ok:
        raise AssertionError(f"[{label}] kernel disagrees with the plain version")
    stats["blocks_processed"] = int(nk.sum())
    return max(err_rgb, err_a, err_d), stats


def bound_ms(inp, stats, unfused=False):
    """Least time for the compositor on these inputs: the larger of
    operations over FP32 peak and bytes over HBM peak. Returns
    (bound ms, what sets it, ms of operations, ms of bytes)."""
    blocks = stats["blocks_processed"]
    ops = blocks * 128 * OPS_BOX_TEST + stats["pairs_alive"] * OPS_LIVE_PAIR
    v, t = inp["starts"].shape
    row_bytes = INST_READ_BYTES + (0 if unfused else 4)  # + gidx when gathered
    nbytes = (blocks * 128 * row_bytes
              + v * t * 8 * 2048 * 4          # output planes
              + 2 * v * t * 4)                # starts, counts
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def bwd_args(inp, seed):
    """The backward's inputs for `inp`: the kernel's forward planes (equal to
    the plain version's) and a seeded normal cotangent on planes 0-4."""
    planes = fwd_calls(inp)[0]()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device="cuda")
    return (inp["attrs"], inp["gidx"], inp["starts"], inp["counts"], g_planes,
            planes[:, :, 5].contiguous(), planes[:, :, 6, 0].to(torch.int32),
            inp["nty"], inp["ntx"], float(inp["shape"][1]), inp["wrap"])


def compare_bwd_plain(inp, label, seed, span):
    """Backward kernel (twice) vs plain on the same inputs, both with spans
    of `span` blocks: per-row error relative to the row's max|g| against
    GRAD_TOL, the largest absolute error, the largest difference between the
    two kernel runs (atomics), the plain version's ms and its work counts."""
    from splatter360_tpu_torch.ops.cuda.composite import (
        N_GRAD, composite_backward, composite_backward_plain)

    args = bwd_args(inp, seed)
    gk = composite_backward(*args, span=span)
    gk2 = composite_backward(*args, span=span)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = composite_backward_plain(*args, stats=stats, span=span)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    rel, l2 = row_errors(gk, gp)
    rows_p = gp[..., :N_GRAD].reshape(-1, N_GRAD)
    scale = rows_p.abs().amax(dim=0)
    touched = rows_p != 0
    median = [float(rows_p[touched[:, i], i].abs().median()) if bool(touched[:, i].any()) else 0.0
              for i in range(N_GRAD)]
    err = float((gk - gp).abs().max())
    repeat = float((gk - gk2).abs().max())
    repeat_rel, _ = row_errors(gk2, gk)
    print(f"[{label}] backward, span {span}: views={gk.shape[0]}, per row (u v a b c o r g b "
          f"depth): max|kernel-plain|/max|plain| {[f'{x:.2e}' for x in rel]} (bar {GRAD_TOL:g}); "
          f"|kernel-plain|_2/|plain|_2 {[f'{x:.2e}' for x in l2]} (bar {L2_TOL:g}); "
          f"max|plain| {[f'{x:.3e}' for x in scale.tolist()]}; median |plain| over the "
          f"instances it touches {[f'{x:.3e}' for x in median]}; max abs err {err:.3e}; two "
          f"kernel runs differ by {repeat:.3e}, per row /max|g| "
          f"{[f'{x:.2e}' for x in repeat_rel]}; plain {plain_ms:.1f} ms; {stats}")
    ok = (max(rel) <= GRAD_TOL and max(l2) <= L2_TOL and bool(torch.isfinite(gk).all())
          and not bool(gk[..., N_GRAD:].any()))
    if not ok:
        raise AssertionError(f"[{label}] backward kernel disagrees with the plain version")
    return dict(args=args, err=err, rel=max(rel), l2=max(l2), repeat=repeat, plain_ms=plain_ms,
                stats=stats)


def bwd_bound_ms(inp, st, unfused=False):
    """Least time for the backward on these inputs (see bound_ms): one box
    cull per instance and tile of the walked blocks, OPS_BWD_SUM per gated
    pair of a walked block that fails the tile-wide gate and OPS_BWD_GATED
    per gated pair of one that passes it; bytes: the cotangent planes 0-4
    and logT, the segments, and either (fused) the gathered rows and gidx of
    the walked blocks and one gradient write per (instance, tile) of a gated
    block, or (unfused) the instance rows read and the gradient rows written
    per walked block, and obase."""
    ops = (st["blocks_walked"] * 128 * OPS_BOX_TEST
           + (st["pairs_walked"] - st["pairs_gated"]) * OPS_BWD_SUM
           + st["pairs_gated"] * OPS_BWD_GATED)
    v, t = inp["starts"].shape
    nbytes = v * t * 6 * 2048 * 4 + 3 * v * t * 4
    if unfused:
        nbytes += st["blocks_walked"] * 128 * (INST_READ_BYTES + GRAD_WRITE_BYTES) + v * t * 4
    else:
        nbytes += (st["blocks_walked"] * 128 * (INST_READ_BYTES + 4)
                   + st["rows_written"] * GRAD_WRITE_BYTES)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def unfused_bwd_args(inp, seed):
    """The unfused backward's inputs for with_inst(inp): the unfused
    kernel's forward planes (equal to the plain version's) and a seeded
    normal cotangent on planes 0-4."""
    seg = (inp["starts"], inp["counts"])
    planes = fwd_calls(inp, unfused=True)[0]()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device="cuda")
    return (inp["inst"], *seg, g_planes, planes[:, :, 5].contiguous(),
            planes[:, :, 6, 0].to(torch.int32), inp["nty"], inp["ntx"], float(inp["shape"][1]),
            inp["wrap"])


def row_errors(got, ref):
    """Per row of g_attrs (u v a b c o r g b depth): max|got-ref|/max|ref|
    and |got-ref|_2/|ref|_2."""
    from splatter360_tpu_torch.ops.cuda.composite import N_GRAD

    rows_g, rows_r = got[..., :N_GRAD].reshape(-1, N_GRAD), ref[..., :N_GRAD].reshape(-1, N_GRAD)
    rel = ((rows_g - rows_r).abs().amax(dim=0) / rows_r.abs().amax(dim=0).clamp(min=1e-30)).tolist()
    l2 = ((rows_g - rows_r).norm(dim=0) / rows_r.norm(dim=0).clamp(min=1e-30)).tolist()
    return rel, l2


def compare_unfused_bwd_plain(inp, label, seed, span, duplicates=False):
    """The unfused backward (kernel, block map, scatter; twice) against its
    plain version through the same map and scatter, and against the fused
    backward kernel on the same inputs, all with spans of `span` blocks: per
    row against GRAD_TOL and L2_TOL. With `duplicates` (each pixel's
    Gaussians coincide; see L2_TOL), L2_TOL holds against the fused
    kernel only, and each row's max distance to the plain version run in
    float64 must be within max(GRAD_TOL, F64_RATIO x the float32 plain
    version's own distance to it): the float32 conditioning of such rows
    sets the float32 plain version as far off as the kernel (2.31e-4 L2
    for both on one run of row u). Returns the largest absolute error, the repeat differences of
    the kernel's blocks and of the scattered gradients, the plain version's
    ms and its work counts."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    args = unfused_bwd_args(inp, seed)
    inst, starts, counts, g_planes, lt, nproc = args[:6]
    n = inp["attrs"].shape[1]

    def scatter(dout):
        return comp.scatter_out_blocks(dout, inp["gidx"], starts, counts, nproc, n)

    dk = comp.composite_backward_unfused(*args, span=span)
    dk2 = comp.composite_backward_unfused(*args, span=span)
    gk, gk2 = scatter(dk), scatter(dk2)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = comp.composite_backward_unfused_plain(*args, stats=stats, span=span)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    gp = scatter(dp)
    gf = comp.composite_backward(inp["attrs"], inp["gidx"], starts, counts, *args[3:], span=span)
    _, live = comp.out_block_map(starts, counts, nproc, dk.shape[1])
    blocks_repeat = float((dk[live] - dk2[live]).abs().max())
    repeat = float((gk - gk2).abs().max())
    repeat_rel, _ = row_errors(gk2, gk)
    rel, l2 = row_errors(gk, gp)
    rel_f, l2_f = row_errors(gk, gf)
    err = float((gk - gp).abs().max())
    scale = gp[..., :comp.N_GRAD].reshape(-1, comp.N_GRAD).abs().amax(dim=0)
    print(f"[{label}] unfused backward, span {span}: views={gk.shape[0]}, per row (u v a b c o r g "
          f"b depth) against the plain version: max|kernel-plain|/max|plain| "
          f"{[f'{x:.2e}' for x in rel]} "
          f"(bar {GRAD_TOL:g}), L2 {[f'{x:.2e}' for x in l2]} (bar {L2_TOL:g}); against the fused "
          f"backward kernel: {[f'{x:.2e}' for x in rel_f]}, L2 {[f'{x:.2e}' for x in l2_f]}; "
          f"max|plain| {[f'{x:.3e}' for x in scale.tolist()]}; max abs err {err:.3e}; two runs: "
          f"live out-blocks differ by {blocks_repeat:.3e}, scattered gradients by {repeat:.3e}, "
          f"per row /max|g| {[f'{x:.2e}' for x in repeat_rel]}; live out-blocks "
          f"{int(live.sum())} of {live.numel()}; plain {plain_ms:.1f} ms; {stats}")
    l2_held = l2_f if duplicates else l2 + l2_f
    rel_held = rel + rel_f
    if duplicates:
        # the function itself, free of float32 rounding: the plain version in
        # float64 on the same inputs
        a64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                    for x in args)
        g64 = scatter(comp.composite_backward_unfused_plain(*a64, span=span))
        rel_d, l2_d = row_errors(gk.double(), g64)
        rel_pd, l2_pd = row_errors(gp.double(), g64)
        bar_d = [max(GRAD_TOL, F64_RATIO * x) for x in rel_pd]
        f64_ok = all(d <= b for d, b in zip(rel_d, bar_d))
        print(f"[{label}] duplicated Gaussians: against the plain version in float64, the "
              f"kernel per row {[f'{x:.2e}' for x in rel_d]} (bars max(GRAD_TOL, {F64_RATIO:g} x "
              f"the float32 plain version's) {[f'{x:.2e}' for x in bar_d]}: "
              f"{'held' if f64_ok else 'MISSED'}), L2 {[f'{x:.2e}' for x in l2_d]}; the float32 "
              f"plain version per row {[f'{x:.2e}' for x in rel_pd]}, L2 "
              f"{[f'{x:.2e}' for x in l2_pd]}")
        del g64
    else:
        f64_ok = True
    ok = (max(rel_held) <= GRAD_TOL and max(l2_held) <= L2_TOL and f64_ok
          and bool(torch.isfinite(gk).all()) and not bool(gk[..., comp.N_GRAD:].any())
          and blocks_repeat == 0.0)
    if not ok:
        raise AssertionError(f"[{label}] unfused backward disagrees with the plain version, "
                             f"the fused backward, or itself")
    return dict(args=args, err=err, rel=max(rel), l2=max(l2), repeat=repeat,
                blocks_repeat=blocks_repeat, plain_ms=plain_ms, stats=stats, dout=dk, live=live)


def nproc_report(nproc, label, what="walked"):
    """Blocks per (view, tile) (the backward's walk: the forward's
    n_processed): their max, p99 and mean, the tiles above 64."""
    flat = nproc.flatten().float()
    rep = dict(max=int(flat.max()), p99=float(torch.quantile(flat, 0.99)), mean=float(flat.mean()),
               above_64=int((flat > 64).sum()), tiles=flat.numel(), blocks=int(flat.sum()))
    print(f"[{label}] blocks {what} per (view, tile): {rep}")
    return rep


def capped_counts(inp, cap=64):
    """counts cut so that no tile's segment spans more than `cap` blocks."""
    return torch.minimum(inp["counts"], cap * 128 - inp["starts"] % 128)


def pass1_blocks(inp, nproc, span):
    """(blocks, of them past the tile's exit): the segment blocks the
    forward's first pass sums at `span`, every span of a cut tile but its
    last, and those at or past the block where the tile stops (nproc)."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    nseg = comp.segment_blocks(inp["starts"], inp["counts"])
    _, heavy = comp.span_item_end(nseg, span, comp.FWD_HEAVY_OVER_MEAN)
    n = nseg.reshape(-1).long()
    length = torch.where(n > heavy.long(), torch.full_like(n, span or 1 << 30), n.clamp(min=1))
    n_spans = (n + length - 1) // length
    summed = torch.where(n_spans > 1, torch.minimum(n, (n_spans - 1) * length), 0)
    past = (summed - nproc.reshape(-1).long()).clamp(min=0)
    return int(summed.sum()), int(past.sum())


def fwd_report(inp, label, unfused, iters=3):
    """The forward on inp: blocks per (view, tile) in the segment and
    processed, the warps' visits per processed block, the kernel for each
    span of SPANS in turns, and at one span a tile and the default span with
    every tile capped at 64 segment blocks (an input to this timing only),
    with the blocks the first pass sums, past the exit too, and at the
    default span by the threshold's floor over the mean segment."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.ops.cuda.composite import FWD_SPAN

    kernel = fwd_calls(inp, unfused)[0]
    nproc = kernel()[:, :, 6, 0].to(torch.int32)
    nproc_report(comp.segment_blocks(inp["starts"], inp["counts"]), label, "in the segment")
    rep = nproc_report(nproc, label, "processed")
    region_visits(inp, nproc, label)
    sweep = span_sweep(kernel, (), label, iters)
    # the threshold's floor over the mean segment, timed at the default span
    # in turns (0: the slots alone)
    over_mean = comp.FWD_HEAVY_OVER_MEAN
    floor_ms = {k: [] for k in (0, 2, 3, 4)}
    try:
        for order in (list(floor_ms), list(floor_ms)[::-1]):
            for k in order:
                comp.FWD_HEAVY_OVER_MEAN = k
                floor_ms[k].append(time_cuda(kernel, iters=iters))
    finally:
        comp.FWD_HEAVY_OVER_MEAN = over_mean
    print(f"[{label}] by the threshold's floor over the mean segment at span {FWD_SPAN} (ms, "
          f"in turns): " + ", ".join(f"{k}: {v[0]:.3f} / {v[1]:.3f}" for k, v in floor_ms.items()))
    capped = fwd_calls(dict(inp, counts=capped_counts(inp)), unfused)[0]
    capped_ms = {span: time_cuda(lambda: capped(span=span), iters=iters)
                 for span in (None, FWD_SPAN)}
    print(f"[{label}] one span a tile: {1e3 * np.mean(sweep[None]) / max(rep['max'], 1):.3f} us "
          f"per processed block of the heaviest tile; every tile capped at 64 blocks: "
          + ", ".join(f"span {k} {v:.3f} ms" for k, v in capped_ms.items())
          + "; blocks the first pass sums (past the exit): "
          + ", ".join(f"span {k} %d (%d)" % pass1_blocks(inp, nproc, k) for k in SPANS))


def region_visits(inp, nproc, label):
    """How evenly a walked block's work falls on the backward kernel's 16
    warps: per walked block, the instances whose radius box (widened by a
    pixel) touches each 32x4 region (each a warp's visit), summed over the
    regions and at the busiest region; printed as means over the blocks."""
    v, t = nproc.shape
    seg = torch.arange(v * t, device=nproc.device).repeat_interleave(nproc.reshape(-1).long())
    j = torch.arange(seg.numel(), device=nproc.device)
    first = torch.cumsum(nproc.reshape(-1).long(), 0) - nproc.reshape(-1).long()
    j = j - first[seg]
    view, tile = seg // t, seg % t
    start = inp["starts"].reshape(-1).long()[seg]
    end = start + inp["counts"].reshape(-1).long()[seg]
    idx = ((start // 128 + j) * 128)[:, None] + torch.arange(128, device=nproc.device)
    ok = (idx >= start[:, None]) & (idx < end[:, None])
    g = inp["gidx"][view[:, None], idx.clamp(max=inp["gidx"].shape[1] - 1)].long()
    row = inp["attrs"][view[:, None], g]  # [B, 128, 16]
    x0 = ((tile % inp["ntx"]) * 128).float()[:, None]
    y0 = ((tile // inp["ntx"]) * 16).float()[:, None]
    w_img = inp["shape"][1]
    u = row[..., 0]
    if inp["wrap"]:
        u = u + w_img * torch.round((x0 + 64.0 - u) / w_img)
    du, dv, rx, ry = u - x0, row[..., 1] - y0, row[..., 10], row[..., 11]
    hit = ok & (du + rx + 1 >= 0) & (du - rx - 1 <= 127) & (dv + ry + 1 >= 0) & (dv - ry - 1 <= 15)
    xa = ((du - rx - 1).clamp(min=0).floor() / 32).floor()
    xb = ((du + rx + 1).clamp(max=127).floor() / 32).floor()
    ya = ((dv - ry - 1).clamp(min=0).floor() / 4).floor()
    yb = ((dv + ry + 1).clamp(max=15).floor() / 4).floor()
    r = torch.arange(16, device=nproc.device).float()
    rc, rr = (r % 4)[None, None], (r // 4)[None, None]
    member = (hit[..., None] & (xa[..., None] <= rc) & (rc <= xb[..., None])
              & (ya[..., None] <= rr) & (rr <= yb[..., None]))
    per_region = member.sum(dim=1).float()  # [B, 16]
    total, busiest = per_region.sum(dim=1), per_region.max(dim=1).values
    print(f"[{label}] warp visits per walked block: {float(total.mean()):.1f} over 16 regions, "
          f"{float(busiest.mean()):.1f} at the busiest (an even share would be "
          f"{float(total.mean()) / 16:.1f}); instances a block "
          f"{float(ok.sum(1).float().mean()):.1f}")


def span_sweep(fn, args, label, iters=5):
    """fn(*args, span=S) (a kernel's wrapper) for each S of SPANS, timed in
    turns: SPANS in order, then reversed. Returns {S: [ms, ms]}."""
    ms = {span: [] for span in SPANS}
    for order in (SPANS, SPANS[::-1]):
        for span in order:
            ms[span].append(time_cuda(lambda: fn(*args, span=span), iters=iters))
    print(f"[{label}] by span (ms, in turns): "
          + ", ".join(f"{k}: {v[0]:.3f} / {v[1]:.3f}" for k, v in ms.items()))
    return ms


def time_cuda(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("1. build kernels")
def phase_build():
    from splatter360_tpu_torch.ops.cuda.build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s")


@phase("2. compositor kernel vs plain at flagship shapes, default span and span 1")
def phase_kernel_check(seed):
    means, covs, sh, opac = bench_scene(seed, N_CTX * H * W)
    inp = render_inputs(means, covs, sh, opac, [torch.eye(4, device="cuda")], 0.1)
    print(f"N={means.shape[0]} K={inp['gidx'].shape[1]} dropped={inp['dropped']}")
    with slots_rule_only():
        err, stats = compare_kernel_plain(inp, "bench scene, 1 view", exact=True)
        err1, _ = compare_kernel_plain(inp, "bench scene, 1 view", span=1, exact=True)
    return dict(inp=inp, err=max(err, err1), stats=stats)


def at_spans(compare, spans):
    """compare(span) at each span; the first span's result, with the
    largest error of all."""
    res = [compare(span) for span in spans]
    return dict(res[0], err=max(r["err"] for r in res), by_span=dict(zip(spans, res)))


@phase("2b. backward kernel vs plain at flagship shapes, default span and span 1")
def phase_bwd_check(check, seed):
    from splatter360_tpu_torch.ops.cuda.composite import BWD_SPAN

    return dict(inp=check["inp"], **at_spans(
        lambda span: compare_bwd_plain(check["inp"], "bench scene, 1 view", seed + 2, span),
        (BWD_SPAN, 1)))


@phase("2c. unfused forward kernel vs plain and vs the fused kernel, 3-view flagship shapes, "
       "default span and span 1")
def phase_unfused_check(seed):
    from splatter360_tpu_torch.ops.cuda.composite import use_fused

    means, covs, sh, opac = bench_scene(seed, N_CTX3 * H * W)
    if use_fused(means.shape[0]):
        raise AssertionError(f"N={means.shape[0]} should be past the fused budget")
    inp = with_inst(render_inputs(means, covs, sh, opac, [torch.eye(4, device="cuda")], 0.1))
    print(f"N={means.shape[0]} K={inp['gidx'].shape[1]} dropped={inp['dropped']}")
    label = "3-view bench scene, 1 view"
    with slots_rule_only():
        err, stats = compare_kernel_plain(inp, f"{label}, unfused", unfused=True, exact=True)
        err1, _ = compare_kernel_plain(inp, f"{label}, unfused", unfused=True, span=1,
                                       exact=True)
        fused_vs_unfused = max(max_fused_difference(inp, label, span) for span in (None, 1))
        span_one_vs_whole(inp, label)
    return dict(inp=inp, err=max(err, err1), stats=stats, fused_vs_unfused=fused_vs_unfused)


def max_fused_difference(inp, label, span=None):
    """The unfused forward kernel against the fused one on the same
    instances, both at `span` (None: FWD_SPAN): both walk each pixel's
    instances in order with -fmad=false, so they must agree bit for bit."""
    from splatter360_tpu_torch.ops.cuda.composite import FWD_SPAN

    span = FWD_SPAN if span is None else span
    unfused = fwd_calls(inp, unfused=True)[0](span=span)
    fused = fwd_calls(inp)[0](span=span)
    diff = float((unfused - fused).abs().max())
    print(f"[{label}] span {span}: unfused vs fused forward kernel: max difference {diff:.3e}, "
          f"bit-equal {torch.equal(unfused, fused)}")
    if not torch.equal(unfused, fused):
        raise AssertionError(f"[{label}] the unfused and fused forward kernels differ")
    return diff


def span_one_vs_whole(inp, label):
    """Both forward kernels at span 1 against one span a tile: spans of one
    block add across blocks in walk order, as one span a tile does, so all
    8 planes must agree bit for bit."""
    for unfused in (False, True):
        kernel = fwd_calls(inp, unfused)[0]
        same = torch.equal(kernel(span=1), kernel(span=None))
        print(f"[{label}] {'unfused' if unfused else 'fused'} forward kernel, span 1 vs one span "
              f"a tile: bit-equal {same}")
        if not same:
            raise AssertionError(f"[{label}] the forward at span 1 differs from one span a tile")


@phase("2d. unfused backward (kernel, map, scatter) vs plain and vs the fused backward, "
       "default span and span 1")
def phase_unfused_bwd_check(check, seed):
    from splatter360_tpu_torch.ops.cuda.composite import BWD_SPAN, composite_backward_unfused

    res = at_spans(lambda span: compare_unfused_bwd_plain(
        check["inp"], "3-view bench scene, 1 view", seed + 2, span), (BWD_SPAN, 1))
    # spans of one block add across blocks in walk order, as one span a tile
    # does: the same bits
    one = res["by_span"][1]
    whole = composite_backward_unfused(*one["args"], span=None)
    live = one["live"]
    same = torch.equal(one["dout"][live], whole[live])
    print(f"[3-view bench scene, 1 view] unfused backward, span 1 vs one span a tile: live "
          f"out-blocks bit-equal {same}")
    if not same:
        raise AssertionError("the unfused backward at span 1 differs from one span a tile")
    return dict(inp=check["inp"], **res)


@phase("2e. both kernel pairs at wrap_x=False on the 6 cube faces of the flagship scenes, "
       "default span and span 1; the wrap flag on a 512x1024 pinhole view")
def phase_pinhole_check(seed):
    """The flagship scenes (2 and 3 context panoramas' N) rendered to the 6
    256x256 faces of one pose: the fused pair on the first, the unfused pair
    on the second, each forward bit for bit against its plain version with
    the threshold's floor off, each backward per row, at the default span
    and at span 1 (the unfused forward also bit-equal to the fused one)."""
    from splatter360_tpu_torch.ops.cuda.composite import BWD_SPAN

    res = {}
    for n_ctx in (N_CTX, N_CTX3):
        means, covs, sh, opac = bench_scene(seed, n_ctx * H * W)
        unfused = n_ctx == N_CTX3
        inp = render_inputs(means, covs, sh, opac, [torch.eye(4, device="cuda")], 0.1, FACE)
        inp = with_inst(inp) if unfused else inp
        label = f"{n_ctx}-view bench scene, 6 faces{', unfused' if unfused else ''}"
        print(f"[{label}] N={means.shape[0]} K={inp['gidx'].shape[1]} dropped={inp['dropped']}")
        with slots_rule_only():
            fwd = [compare_kernel_plain(inp, label, unfused=unfused, span=span, exact=True)
                   for span in (None, 1)]
            if unfused:
                for span in (None, 1):
                    max_fused_difference(inp, label, span)
        compare = compare_unfused_bwd_plain if unfused else compare_bwd_plain
        bwd = dict(inp=inp, **at_spans(lambda span: compare(inp, label, seed + 2, span),
                                       (BWD_SPAN, 1)))
        for r in (bwd, *bwd["by_span"].values()):
            r.pop("dout", None)
        res[n_ctx] = dict(inp=inp, stats=fwd[0][1], bwd=bwd, err=max(fwd[0][0], fwd[1][0]))
    res["wrap"] = wrap_flag_check(seed)
    return moved(res, "cpu")


def wrap_flag_check(seed):
    """One launch of a 512x1024 pinhole view (square pixels, fx = W / 2) of
    the flagship scene, binned with the wrap so that a splat on a side edge
    is listed in both edge tiles, at wrap_x=True and at wrap_x=False: the
    alphas must differ near both side edges (the flag reaches the kernel).
    Splats just past the near plane span the whole width, so the middle
    may differ too; printed, not held."""
    from splatter360_tpu_torch.ops import rasterizer as rz
    from splatter360_tpu_torch.ops.cuda.composite import compose_planes, composite_forward

    means, covs, sh, opac = bench_scene(seed, N_CTX * H * W)
    c2w = torch.eye(4, device="cuda")[None]
    near = torch.full((1,), 0.1, device="cuda")
    intr = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5 * W / H, 0.5], [0.0, 0.0, 1.0]],
                        device="cuda")
    projs = rz.project_views(means, covs, opac, c2w, (H, W), near, "pinhole", intr)
    (asg,) = rz.bin_views(projs, (H, W), wrap_x=True)
    attrs = rz.view_attrs(projs, rz.view_colors(sh, means, c2w, 4), opac, near, 10 * near)
    seg = (asg.gaussian_idx[None], asg.tile_starts[None], asg.tile_counts[None],
           asg.num_tiles_y, asg.num_tiles_x, float(W))
    bg = torch.zeros(3, device="cuda")
    alpha = {flag: compose_planes(composite_forward(attrs, *seg, flag), (H, W), asg.num_tiles_y,
                                  asg.num_tiles_x, bg)[1][0] for flag in (False, True)}
    diff = (alpha[True] - alpha[False]).abs().amax(dim=0)
    left, right = float(diff[:16].max()), float(diff[-16:].max())
    middle = float(diff[W // 4: 3 * W // 4].max())
    print(f"[pinhole {H}x{W}, 1 view] wrap_x True vs False, max |alpha difference| per column: "
          f"left 16 columns {left:.3e}, right 16 {right:.3e}, middle half {middle:.3e}; "
          f"columns that differ {int((diff > 0).sum())} of {W}")
    if not (left > 1e-3 and right > 1e-3):
        raise AssertionError("the wrap flag does not reach the kernel as it should")
    return dict(left=left, right=right, middle=middle)


def request_data(gen, near=0.1, far=10.0, n_ctx=N_CTX):
    """One request: n_ctx seeded panoramas with poses, N_TGT target poses."""
    dev = torch.device("cuda")
    img = torch.rand((1, n_ctx, H // 8, W // 8, 3), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(
        img[0].permute(0, 3, 1, 2), size=(H, W), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)[None].contiguous()

    def poses(n, spread):
        p = torch.eye(4, device=dev).repeat(1, n, 1, 1)
        p[..., :3, 3] = spread * torch.randn((1, n, 3), generator=gen, device=dev)
        return p

    return dict(
        image=img, ctx_pose=poses(n_ctx, 0.3), tgt_pose=poses(N_TGT, 0.2),
        near=torch.full((1, n_ctx), near, device=dev), far=torch.full((1, n_ctx), far, device=dev),
        tgt_near=torch.full((1, N_TGT), near, device=dev), tgt_far=torch.full((1, N_TGT), far, device=dev),
    )


def path_kernels(n):
    """The forward and backward kernel names N Gaussians take."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    if comp.use_fused(n):
        return comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    return comp.UNFUSED_KERNEL_NAME, comp.UNFUSED_BWD_KERNEL_NAME


def serve_requests(seed, n_ctx, face=None):
    """N_REQUESTS requests of n_ctx context panoramas through the serving
    entry points, rendering N_TGT ERP views or, with `face`, their 6 cube
    faces each (render_cube_views); each must launch exactly one forward
    kernel, of the path its N takes. Returns the launch counts over the run
    and the last request's Gaussians and target poses."""
    from splatter360_tpu_torch.models.encoder import HM3D_F32
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import build_model, encode, render_cube_views, render_erp_views

    fwd_name, _ = path_kernels(n_ctx * H * W)
    model = build_model(HM3D_F32, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    reqs = [request_data(gen, n_ctx=n_ctx) for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()

    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    gaussians = out = None
    times = []
    for i, r in enumerate(reqs):
        before = dict(comp.launch_counts)
        t0 = time.perf_counter()
        gaussians, depth_map = encode(model, r["image"], r["ctx_pose"], r["near"], r["far"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if face is None:
            out = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"],
                                   (H, W), render_depth=True)
        else:
            out = render_cube_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"], face,
                                    render_depth=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        delta = {k: comp.launch_counts[k] - before[k] for k in before}
        n = gaussians.means.shape[1]
        times.append((1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        what = f"{N_TGT} views" if face is None else f"{N_TGT} views x 6 faces of {face}x{face}"
        print(f"request {i}: {n_ctx} context panoramas, encoder {times[-1][0]:.1f} ms, render "
              f"{what} {times[-1][1]:.1f} ms, N={n}, dropped={out.dropped.tolist()}, "
              f"kernel launches {delta}")
        if n != n_ctx * H * W:
            raise AssertionError(f"expected {n_ctx * H * W} Gaussians, got {n}")
        if delta != {k: int(k == fwd_name) for k in delta}:
            raise AssertionError(f"expected 1 {fwd_name} launch for {what}, got {delta}")
        check_outputs(gaussians, depth_map, out, r, face)
    launches = dict(comp.launch_counts)
    print(f"launch counts over the serving run: {launches}")
    return dict(launches=launches, gaussians=gaussians, tgt_pose=reqs[-1]["tgt_pose"][0],
                times=times)


def target_inputs(gaussians, tgt_pose, face=None):
    """render_inputs of one item's Gaussians into its target views (or
    their cube faces)."""
    return render_inputs(gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0],
                         gaussians.opacities[0], list(tgt_pose), 0.1, face)


@phase("3. serve HM3D-width requests")
def phase_serve(seed):
    res = serve_requests(seed, N_CTX)
    # the encoder's own Gaussians through the kernel and the plain version
    inp = target_inputs(res["gaussians"], res["tgt_pose"])
    one = {k: (v[:1] if torch.is_tensor(v) and v.dim() > 1 else v) for k, v in inp.items()}
    err1, _ = compare_kernel_plain(one, "encoder Gaussians, view 0")
    err4, stats = compare_kernel_plain(inp, f"encoder Gaussians, {N_TGT} views")
    return dict(res, inp=inp, err=max(err1, err4), stats=stats)


@phase("3e. serve HM3D-width requests with 3 context panoramas (unfused path)")
def phase_serve3(seed):
    res = serve_requests(seed, N_CTX3)
    inp = with_inst(target_inputs(res["gaussians"], res["tgt_pose"]))
    err, stats = compare_kernel_plain(inp, f"3-view encoder Gaussians, {N_TGT} views, unfused",
                                      unfused=True)
    return dict(res, inp=inp, err=err, stats=stats)


def moved(x, device):
    """x with every tensor in it (through dicts, lists, tuples) on `device`:
    the phases park the inputs phase 4 times on the host, so that the train
    steps' peaks hold only their own memory and the earlier ERP phases'."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: moved(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(moved(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, device) for v in x)
    return x


def render_breakdown(gaussians, c2ws, iters=3, face=None):
    """The render of N_TGT views (or, with `face`, their 6 cube faces each)
    stage by stage, through the stages batch_inputs runs: median ms per
    stage over `iters` runs (CUDA events)."""
    from splatter360_tpu_torch.ops import rasterizer as rz
    from splatter360_tpu_torch.ops.cuda.composite import composite_tiles

    means, covs, sh, opac = (x[0] for x in gaussians)
    bg = torch.zeros(3, device="cuda")
    c2w, shape, nr, fr, kw = view_batch(means, c2ws, 0.1, face)
    wrap = face is None
    stages = ("projection", "SH colours", "binning (assign_tiles)", "attribute table",
              "compositor (kernel + compose)")
    times = {s: [] for s in stages}
    for _ in range(iters + 1):  # the first run warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        projs = rz.project_views(means, covs, opac, c2w, shape, nr, kw.get("camera_kind", "erp"),
                                 kw.get("intrinsics"))
        ev[1].record()
        colors = rz.view_colors(sh, means, c2w, 4, kw.get("views_per_position", 1))
        ev[2].record()
        asg = rz.bin_views(projs, shape, wrap, kw.get("instance_cap"))
        ev[3].record()
        attrs = rz.view_attrs(projs, colors, opac, nr, fr)
        ev[4].record()
        composite_tiles(asg, attrs, shape, bg, wrap_x=wrap)
        ev[5].record()
        torch.cuda.synchronize()
        for i, s in enumerate(stages):
            times[s].append(ev[i].elapsed_time(ev[i + 1]))
    return {s: float(np.median(t[1:])) for s, t in times.items()}


def check_outputs(gaussians, depth_map, out, r, face=None):
    near, far = float(r["near"].min()), float(r["far"].max())
    for name, x in (("means", gaussians.means), ("covariances", gaussians.covariances),
                    ("harmonics", gaussians.harmonics), ("opacities", gaussians.opacities),
                    ("depth_map", depth_map), ("color", out.color), ("alpha", out.alpha),
                    ("depth", out.depth)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    image = (H, W) if face is None else (6, face, face)
    assert tuple(out.color.shape) == (1, N_TGT, *image, 3), out.color.shape
    assert tuple(out.dropped.shape) == (1, N_TGT, *image[:-2]), out.dropped.shape
    assert tuple(depth_map.shape) == (1, r["image"].shape[1], H, W), depth_map.shape
    assert float(depth_map.min()) >= near - 1e-5 and float(depth_map.max()) <= far + 1e-4
    assert float(out.alpha.min()) >= -1e-6 and float(out.alpha.max()) <= 1.0 + 1e-6


@phase("3b. GPU serving path vs CPU serving path, small input")
def phase_small_reference(seed):
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.serve import build_model, encode, render_erp_views

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
    )
    rng = np.random.default_rng(seed)
    h, w = 64, 256
    img = rng.uniform(0, 1, (1, 2, h, w, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    tgt = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    tgt[..., :3, 3] = rng.normal(0, 0.1, (1, 2, 3))
    nf = (np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32))
    enc, views = {}, {}
    for dev in ("cpu", "cuda"):
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        model = build_model(cfg, seed=seed, device=dev)
        enc[dev] = encode(model, t(img), t(pose), t(nf[0]), t(nf[1]), device=dev)
        views[dev] = render_erp_views(enc[dev][0], t(tgt), t(nf[0]), t(nf[1]), (h, w),
                                      render_depth=True, device=dev)
    # the CPU Gaussians rendered on the card: the renderer alone, on equal inputs
    views["cuda_from_cpu"] = render_erp_views(enc["cpu"][0], tgt, nf[0], nf[1], (h, w),
                                              render_depth=True, device="cuda")

    # encoder: float32 on both sides with TF32 off; cuDNN's convolution
    # algorithms sum in another order than the CPU's, ~1e-4 of max|x| after
    # the deep random network (the port meets 1e-4 against JAX on the CPU)
    (g_cpu, d_cpu), (g_gpu, d_gpu) = enc["cpu"], enc["cuda"]
    for name, a, b in zip(("means", "covariances", "harmonics", "opacities", "depth_map"),
                          (*g_cpu, d_cpu), (*g_gpu, d_gpu)):
        rel = float((a - b.cpu()).abs().max()) / (float(a.abs().max()) + 1e-12)
        print(f"  encoder {name}: max|cpu-gpu|/max|cpu| = {rel:.2e}")
        if rel > 1e-3:
            raise AssertionError(f"encoder {name}: GPU differs from the CPU path ({rel:.2e})")

    # renderer on the same Gaussians: the compositor bars, except where the
    # weight gate T (1 - alpha) >= 1e-4 flips on a last-bit difference of the
    # card's atan2/exp in the projection (one weight of at most ~1e-2)
    ref, got = views["cpu"], views["cuda_from_cpu"]
    for name, atol in (("color", ATOL_RGB), ("alpha", ATOL_RGB), ("depth", ATOL_DEPTH)):
        a, b = getattr(ref, name), getattr(got, name).cpu()
        diff = (a - b).abs()
        share = float((diff > atol).float().mean())
        scale = float(a.abs().max())
        print(f"  render {name}: max|cpu-gpu| = {float(diff.max()):.2e}, share over {atol:g} = {share:.2e}")
        if share > 1e-3 or float(diff.max()) > 1e-2 * max(scale, 1.0):
            raise AssertionError(f"render {name}: GPU renderer differs from the CPU path")

    # the whole chain: ~1e-4 differences in the Gaussians move a few radius
    # and binning decisions, so the images are held by their mean error
    for name in ("color", "alpha", "depth"):
        a, b = getattr(views["cpu"], name), getattr(views["cuda"], name).cpu()
        mean = float((a - b).abs().mean()) / (float(a.abs().max()) + 1e-12)
        print(f"  chain {name}: mean|cpu-gpu|/max|cpu| = {mean:.2e}")
        if mean > 1e-3:
            raise AssertionError(f"chain {name}: GPU serving path differs from the CPU path")


def train_batch(gen, near=0.1, far=10.0, n_ctx=N_CTX):
    """One train batch: request_data's context panoramas and poses, target
    panoramas made the same way, and context depth in [0.5, 5] with ~8%
    holes (0), all seeded."""
    r = request_data(gen, near, far, n_ctx)
    tgt = torch.rand((N_TGT, H // 8, W // 8, 3), generator=gen, device="cuda")
    tgt = torch.nn.functional.interpolate(tgt.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)[None]
    depth = 0.5 + 4.5 * torch.rand((1, n_ctx, H, W), generator=gen, device="cuda")
    holes = torch.rand((1, n_ctx, H // 16, W // 16), generator=gen, device="cuda") < 0.08
    holes = holes.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    return dict(
        context=dict(image_sphere=r["image"], extrinsics_sphere=r["ctx_pose"],
                     depth_sphere=torch.where(holes, torch.zeros_like(depth), depth),
                     near=r["near"], far=r["far"]),
        target=dict(image_sphere=tgt.contiguous(), extrinsics_sphere=r["tgt_pose"],
                    near=r["tgt_near"], far=r["tgt_far"]),
    )


STAGES = ("encoder", "render", "losses", "backward", "optimizer")


def train_steps(seed, n_ctx, face=None, n_steps=N_STEPS, remat=False):
    """n_steps HM3D-width train steps with n_ctx context panoramas, ERP
    supervision or, with `face`, cube supervision (faces of face x face,
    remat_faces off, as configs/hm3d.yaml sets it; with `remat`, the
    default TrainConfig(): cube supervision with remat_faces): per-step
    metrics, CUDA-event stage times (and the backward kernel's, and on the
    unfused path the scatter's, inside the backward), kernel calls (exactly
    one forward and one backward of the path N takes; under remat_faces one
    launch of each per target view and the forwards again in the backward)
    and peak memory; then the backward kernel against its plain version on
    the last step's Gaussians rendered into its N_TGT target views (or their
    faces; under remat_faces the 6 faces of one view, one checkpointed
    launch)."""
    from splatter360_tpu_torch.models.encoder import HM3D_F32
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    fwd_name, bwd_name = path_kernels(n_ctx * H * W)
    unfused = fwd_name == comp.UNFUSED_KERNEL_NAME
    if face is None:
        cfg = TrainConfig(supervision="erp")
    elif remat:
        cfg = TrainConfig()
        assert cfg.supervision == "cubes" and cfg.remat_faces and cfg.cube_face_size is None
    else:
        cfg = TrainConfig(supervision="cubes", remat_faces=False)
    n_fwd, n_bwd = (2 * N_TGT, N_TGT) if remat else (1, 1)
    state = create_train_state(HM3D_F32, cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    batches = [train_batch(gen, n_ctx=n_ctx) for _ in range(n_steps)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30

    # CUDA events around the backward kernel's calls (and the scatter's)
    # inside each step
    kernel_events = {"backward kernel": [], "scatter": []}
    timed = {"backward kernel": "composite_backward_unfused" if unfused else "composite_backward"}
    if unfused:
        timed["scatter"] = "scatter_out_blocks"
    originals = {label: getattr(comp, name) for label, name in timed.items()}

    def timing(label, fn):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            kernel_events[label].append(ev)
            return out
        return run

    for label, name in timed.items():
        setattr(comp, name, timing(label, originals[label]))
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    steps = []
    try:
        for i, batch in enumerate(batches):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            calls = dict(comp.launch_counts)
            for evs in kernel_events.values():
                evs.clear()
            torch.cuda.reset_peak_memory_stats()
            events = {"start": torch.cuda.Event(enable_timing=True)}

            def mark(stage):
                events[stage] = torch.cuda.Event(enable_timing=True)
                events[stage].record()

            t0 = time.perf_counter()
            events["start"].record()
            metrics = train_step(state, batch, on_stage=mark)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            ms, prev = {}, "start"
            for stage in STAGES:
                ms[stage] = events[prev].elapsed_time(events[stage])
                prev = stage
            for label in timed:
                ms[label] = sum(a.elapsed_time(b) for a, b in kernel_events[label])
            delta = {k: comp.launch_counts[k] - calls[k] for k in calls}
            vals = {k: float(v) for k, v in metrics.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"step {i} ({n_ctx} context panoramas, {cfg.supervision} supervision): "
                  + ", ".join(f"{k} {v:.6g}" for k, v in sorted(vals.items()))
                  + f"; {wall:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + f"; kernel calls {delta}; peak memory {peak:.2f} GiB ({held:.2f} GiB held "
                  f"by earlier phases)", flush=True)
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"step {i}: non-finite metrics {vals}")
            if delta != {k: n_fwd if k == fwd_name else n_bwd if k == bwd_name else 0
                         for k in delta}:
                raise AssertionError(f"step {i}: expected {n_fwd} {fwd_name} and {n_bwd} "
                                     f"{bwd_name} calls, got {delta}")
            still = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
            if still:
                raise AssertionError(f"step {i}: parameters unchanged: {still[:10]}")
            if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
                raise AssertionError(f"step {i}: non-finite parameters")
            steps.append(dict(wall=wall, ms=ms, peak_gib=peak, held_gib=held, **vals))
    finally:
        for label, name in timed.items():
            setattr(comp, name, originals[label])
    launches = dict(comp.launch_counts)
    print(f"launch counts over the training run: {launches}")

    # the last step's Gaussians, rendered into its target views: backward
    # kernel vs plain at the training shapes
    views = 1 if remat else N_TGT
    inp = step_inputs(state, batches[-1], unfused, face, views)
    del state
    label = f"train-step Gaussians ({n_ctx} context panoramas), {views} views"
    if face is not None:
        label += " x 6 faces" + (", one checkpointed launch" if remat else "")
    if unfused:
        res = compare_unfused_bwd_plain(inp, label, seed + 4, comp.BWD_SPAN)
    else:
        res = compare_bwd_plain(inp, label, seed + 4, comp.BWD_SPAN)
    return dict(steps=steps, launches=launches, inp=inp, **res)


def step_inputs(state, batch, unfused, face=None, views=N_TGT):
    """render_inputs of the Gaussians state's model makes from the batch's
    context, into the batch's first `views` target views or their faces
    (with_inst on the unfused path)."""
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.serve import context_cubes

    ctx, tgt = batch["context"], batch["target"]
    with torch.no_grad():
        g, _ = state.model(ctx["image_sphere"], context_cubes(ctx["image_sphere"], H // 2),
                           ctx["extrinsics_sphere"], ctx["near"], ctx["far"], state.step)
    g = Gaussians(*(x[0] for x in g))
    inp = render_inputs(g.means, g.covariances, g.harmonics, g.opacities,
                        list(tgt["extrinsics_sphere"][0, :views]), 0.1, face)
    return with_inst(inp) if unfused else inp


@phase("3c. HM3D-width train steps")
def phase_train(seed):
    return train_steps(seed, N_CTX)


@phase("3f. HM3D-width train steps with 3 context panoramas (unfused path)")
def phase_train3(seed):
    torch.cuda.empty_cache()
    return train_steps(seed, N_CTX3)


def small_config(options=None):
    """The tiny f32 encoder of phases 3b/3d, with encoder `options`."""
    from dataclasses import replace

    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
    )
    return replace(cfg, **(options or {}))


def small_batch(seed, n_ctx, h=64, w=256):
    """A seeded train batch of n_ctx context and 2 target panoramas."""
    rng = np.random.default_rng(seed)
    batch = {}
    for part, v in (("context", n_ctx), ("target", 2)):
        pose = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
        pose[..., :3, 3] = rng.normal(0, 0.2, (1, v, 3))
        depth = rng.uniform(0.5, 5.0, (1, v, h, w))
        depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
        batch[part] = dict(image_sphere=rng.uniform(0, 1, (1, v, h, w, 3)), extrinsics_sphere=pose,
                           depth_sphere=depth, near=np.full((1, v), 0.1), far=np.full((1, v), 10.0))
    return batch


def step_grads(cfg, tcfg, batch, seed, device, noise_seed=None):
    """One train step of the seeded model on `device`: (metrics, each
    leaf's gradient on the CPU, the kernel launches); with `noise_seed`,
    the parameters first scaled by 1 + 1e-6 noise."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train.state import create_train_state, mono_grid, train_step

    state = create_train_state(cfg, tcfg, seed=seed, device=device,
                               mono_grid=mono_grid(tcfg, batch["context"]["image_sphere"].shape[2]))
    if noise_seed is not None:
        gen = torch.Generator().manual_seed(noise_seed)
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen).to(p.device))
    grads = {}

    def keep(stage):
        if stage == "backward":  # the frozen mono ViT has none
            grads.update({k: p.grad.detach().cpu().clone()
                          for k, p in state.model.named_parameters() if p.grad is not None})

    calls = dict(comp.launch_counts)
    metrics = train_step(state, batch, on_stage=keep)
    delta = {k: comp.launch_counts[k] - calls[k] for k in calls}
    return {k: float(v) for k, v in metrics.items()}, grads, delta


def small_train(seed, n_ctx, supervision="erp", options=None, cpu_step=None):
    """A GPU and a CPU train step at 64x256 with n_ctx context panoramas
    from the same seeded weights and batch, ERP or cube supervision (32x32
    faces), the tiny encoder with the encoder `options` (phase 3n): the
    loss at 1e-3 relative, each leaf's gradient within GRAD_TOL of the
    global max|g|, the leaf CUBE_JUMP_TOL names (cube supervision only)
    within its bound; with `options`, a leaf past GRAD_TOL passes where
    jump_gaps finds it to be one jump. `cpu_step(noise_seed)`, where given,
    returns the CPU step's (metrics, gradients) from elsewhere (a worker
    process of phase 3n (b))."""
    from splatter360_tpu_torch.train.state import TrainConfig

    cfg = small_config(options)
    fwd_name, bwd_name = path_kernels(n_ctx * 64 * 256 * cfg.gaussians_per_pixel)
    batch = small_batch(seed, n_ctx)
    tcfg = TrainConfig(supervision=supervision, remat_faces=False)
    if cpu_step is None:
        cpu_step = lambda noise_seed: step_grads(  # noqa: E731
            cfg, tcfg, batch, seed, "cpu", noise_seed)[:2]
    metrics, grads, delta = step_grads(cfg, tcfg, batch, seed, "cuda")
    if delta != {k: int(k in (fwd_name, bwd_name)) for k in delta}:
        raise AssertionError(f"GPU step: expected 1 {fwd_name} and 1 {bwd_name} call, "
                             f"got {delta}")
    out = {"cpu": cpu_step(None), "cuda": (metrics, grads)}
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    print(f"  {n_ctx} context panoramas, {supervision} supervision, kernels {fwd_name}, "
          f"{bwd_name}; metrics cpu / gpu: "
          + ", ".join(f"{k} {m_cpu[k]:.6g} / {m_gpu[k]:.6g}" for k in sorted(m_cpu)))
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    worst = max((float((g_gpu[k] - g).abs().max()) / scale, k) for k, g in g_cpu.items())
    rel_loss = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    print(f"  loss: |gpu-cpu|/|cpu| = {rel_loss:.2e}; gradients: worst leaf {worst[1]} at "
          f"{worst[0]:.2e} of max|g| (bar {GRAD_TOL:g})")
    # cuDNN sums in another order than the CPU (~1e-4 of max|x| in the
    # encoder, phase 3b): the loss is held at 1e-3 relative, each leaf's
    # gradient within 2e-3 of the global max|g|
    bars = CUBE_JUMP_TOL if supervision == "cubes" else {}
    stray = {k: float((g_gpu[k] - g).abs().max()) / scale for k, g in g_cpu.items()}
    for k in bars:
        print(f"  leaf {k}: {stray[k]:.2e} of max|g| (bar {bars[k]:g})")
    stray = {k: d for k, d in stray.items() if d > bars.get(k, GRAD_TOL)}
    if options is not None and stray:
        stray = jump_gaps(cpu_step, g_cpu, g_gpu, scale, stray)
    if rel_loss > 1e-3 or stray:
        raise AssertionError(f"GPU train step differs from the CPU one: {stray}")


def jump_gaps(cpu_step, g_cpu, g_gpu, scale, stray):
    """The leaves of `stray` (card - CPU past GRAD_TOL, of max|g|) that are
    not one jump: the CPU step again (`cpu_step(JUMP_NOISE_SEED)`) with the
    parameters scaled by 1 + 1e-6 noise, and a leaf passes if it is a conv
    weight of a backbone's CNN (JUMP_LEAVES) whose card - CPU distance is at
    most JUMP_RATIO times the noisy step's move of it, at cosine >= JUMP_COS
    with that move."""
    _, g_noise = cpu_step(JUMP_NOISE_SEED)
    left = {}
    for k, d in sorted(stray.items(), key=lambda x: -x[1]):
        gap, move = (g_gpu[k] - g_cpu[k]).flatten(), (g_noise[k] - g_cpu[k]).flatten()
        jump = float(move.abs().max()) / scale
        cos = float(gap @ move / (gap.norm() * move.norm() + 1e-30))
        ok = k.startswith(JUMP_LEAVES) and d <= JUMP_RATIO * jump and cos >= JUMP_COS
        print(f"  leaf {k}: card - CPU {d:.3e} of max|g|; the CPU step's move under 1e-6 "
              f"noise {jump:.3e} (ratio {d / max(jump, 1e-30):.3f}), cosine {cos:+.4f}: "
              f"{'one jump' if ok else 'NOT a jump'}", flush=True)
        if not ok:
            left[k] = d
    return left


@phase("3d. GPU train step vs CPU train step, small input")
def phase_small_train(seed):
    small_train(seed, N_CTX)


@phase("3g. GPU train step vs CPU train step, small input, 3 context panoramas (unfused path)")
def phase_small_train3(seed):
    from splatter360_tpu_torch.ops.cuda import composite as comp

    # the fused budget at this scale: 2 context panoramas of 64x256 fused, 3 unfused
    budget = comp.FUSED_TABLE_BUDGET
    comp.FUSED_TABLE_BUDGET = comp.fused_table_bytes(N_CTX3 * 64 * 256) - 1
    try:
        small_train(seed, N_CTX3)
    finally:
        comp.FUSED_TABLE_BUDGET = budget


@phase("3h. serve HM3D-width requests to cube faces: 2 context panoramas, then 3 (unfused)")
def phase_serve_cubes(seed):
    """N_REQUESTS requests of each: encode -> serve.render_cube_views, the 6
    256x256 faces of 4 target views with depth; the kernel against its
    plain version on the last request's face inputs."""
    out = {}
    for n_ctx in (N_CTX, N_CTX3):
        res = serve_requests(seed, n_ctx, FACE)
        unfused = n_ctx == N_CTX3
        inp = target_inputs(res["gaussians"], res["tgt_pose"], FACE)
        inp = with_inst(inp) if unfused else inp
        err, stats = compare_kernel_plain(
            inp, f"{n_ctx}-view encoder Gaussians, {N_TGT} views x 6 faces", unfused=unfused)
        out[n_ctx] = moved(dict(res, inp=inp, err=err, stats=stats), "cpu")
    return out


@phase("3i. HM3D-width train steps with cube supervision: 2 context panoramas, then 3 (unfused)")
def phase_train_cubes(seed):
    out = {}
    for n_ctx, n_steps in ((N_CTX, N_STEPS), (N_CTX3, N_STEPS - 1)):
        torch.cuda.empty_cache()
        res = train_steps(seed, n_ctx, FACE, n_steps)
        res.pop("dout", None)
        out[n_ctx] = moved(res, "cpu")
    return out


@phase("3k. HM3D-width cube train steps with the default TrainConfig() (remat_faces), "
       "2 context panoramas")
def phase_train_remat(seed, ctrain):
    """The train step TrainConfig() names: cube supervision with
    remat_faces, one checkpointed compositor launch per target view. Its
    peak, less what earlier phases hold, must stay below that of phase 3i's
    step on the same path, which renders all 24 faces in one launch."""
    torch.cuda.empty_cache()
    res = train_steps(seed, N_CTX, FACE, N_STEPS - 1, remat=True)
    res.pop("dout", None)
    own = max(st["peak_gib"] - st["held_gib"] for st in res["steps"])
    print(f"remat_faces: peak {own:.2f} GiB over what earlier phases hold", end="")
    if ctrain.get(N_CTX) is not None:
        whole = max(st["peak_gib"] - st["held_gib"] for st in ctrain[N_CTX]["steps"])
        print(f"; one launch of 24 faces (phase 3i): {whole:.2f} GiB")
        if not own < whole:
            raise AssertionError("remat_faces does not lower the cube step's peak")
    print(flush=True)
    return moved(res, "cpu")


@phase("3j. GPU cube train step vs CPU cube train step, small input, fused then unfused path")
def phase_small_train_cubes(seed):
    from splatter360_tpu_torch.ops.cuda import composite as comp

    small_train(seed, N_CTX, "cubes")
    budget = comp.FUSED_TABLE_BUDGET
    comp.FUSED_TABLE_BUDGET = comp.fused_table_bytes(N_CTX3 * 64 * 256) - 1
    try:
        small_train(seed, N_CTX3, "cubes")
    finally:
        comp.FUSED_TABLE_BUDGET = budget


def cli_scenes(root: Path, seed: int, split: str = "test", n_scenes: int = CLI_SCENES,
               n_frames: int = CLI_FRAMES, shape: tuple | None = None) -> str:
    """n_scenes `split` scenes of n_frames frames of `shape` (default H x
    W): random RGB, depth in [0.5, 5] m, poses 10 cm apart on a line, each
    read back through load_scene equal to what was written. Returns the
    format written (.s3z or .npz)."""
    from splatter360_tpu_torch.data.scene_io import load_scene, save_scene

    shape = shape or (H, W)
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        rgb = rng.integers(0, 256, (n_frames, *shape, 3), dtype=np.uint8)
        depth = (rng.uniform(0.5, 5.0, (n_frames, *shape)) * 1000).astype(np.uint16)
        poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
        poses[:, 0, 3] = 0.1 * np.arange(n_frames)
        path = save_scene(root, split, f"{split}{i}", rgb, depth, poses)
        back = load_scene(root, split, f"{split}{i}")
        if not (np.array_equal(back["rgb"], rgb) and np.array_equal(back["poses"], poses)
                and np.array_equal(back["depth_m"], depth.astype(np.float32) / 1000.0)):
            raise AssertionError(f"{path}: the scene read back differs from what was written")
    return path.suffix


def cli_run(label, argv, fwd_name, saved):
    """One `main(argv)` run: launch counts over it, its artefacts checked,
    the restored weights held against `saved`."""
    import splatter360_tpu_torch.train.checkpoint as ckpt
    from splatter360_tpu_torch.main import main as cli_main
    from splatter360_tpu_torch.ops.cuda import composite as comp

    restore = ckpt.restore_weights_only
    restored = {}

    def checked_restore(directory, state, step=None):
        state, ok = restore(directory, state, step)
        restored["ok"] = ok and all(torch.equal(v.cpu(), saved[k])
                                    for k, v in state.model.state_dict().items())
        return state, ok

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    ckpt.restore_weights_only = checked_restore
    t0 = time.perf_counter()
    try:
        scores = cli_main(argv)
    finally:
        ckpt.restore_weights_only = restore
    wall = time.perf_counter() - t0
    launches = dict(comp.launch_counts)
    out = Path(next(a for a in argv if a.startswith("test.output_path=")).split("=", 1)[1])
    if not restored.get("ok"):
        raise AssertionError(f"{label}: the checkpoint's weights were not restored as saved")
    if launches.get(fwd_name, 0) == 0:
        raise AssertionError(f"{label}: {fwd_name} never launched ({launches})")
    metrics = sorted(next(iter(scores.values())))
    for name in ["scores_all_avg.json", "mse_dict.json", "benchmark.json", "peak_memory.json",
                 *(f"scores_{m}_all.json" for m in metrics)]:
        if not (out / name).is_file():
            raise AssertionError(f"{label}: {name} missing")
    for scene, entry in scores.items():
        if not all(math.isfinite(v) for v in entry.values()):
            raise AssertionError(f"{label}: non-finite score in {scene}: {entry}")
        for sub in ("color", "gt", "err", "depth"):
            if not any((out / scene / sub).glob("*.png")):
                raise AssertionError(f"{label}: no {scene}/{sub} images")
        if not (out / scene / "compare.png").is_file():
            raise AssertionError(f"{label}: no {scene}/compare.png")
    if not {"psnr", "ssim", "mse", "lpips", "depth_abs_rel"} <= set(metrics):
        raise AssertionError(f"{label}: scores {metrics}")
    bench = json.loads((out / "benchmark.json").read_text())
    mem = json.loads((out / "peak_memory.json").read_text())["device_0"]
    avg = json.loads((out / "scores_all_avg.json").read_text())
    print(f"{label}: {wall:.1f} s, {len(scores)} scenes; benchmark.json encoder "
          f"{1e3 * bench['encoder']['mean_s']:.1f} ms, decoder "
          f"{1e3 * bench['decoder']['mean_s']:.1f} ms a view (means past the first scene); "
          f"peak {mem['peak_bytes_in_use'] / 2**30:.2f} GiB allocated, "
          f"{mem['peak_bytes_reserved'] / 2**30:.2f} GiB reserved; launches {launches}; "
          f"psnr {avg['psnr']:.3f} ssim {avg['ssim']:.4f} lpips {avg['lpips']:.4f} "
          f"depth abs_rel {avg['depth_abs_rel']:.4f}", flush=True)
    return dict(launches=launches, benchmark=bench, memory=mem, scores=avg, wall_s=wall)


def encoder_times(seed, iters=3):
    """Median ms of the bf16 (HM3D) and f32 (HM3D_F32) encoders on the same
    requests, 2 and 3 context panoramas, after a warm-up encode."""
    from splatter360_tpu_torch.models.encoder import HM3D, HM3D_F32
    from splatter360_tpu_torch.serve import build_model, encode

    out = {}
    for n_ctx in (N_CTX, N_CTX3):
        r = request_data(torch.Generator(device="cuda").manual_seed(seed + 5), n_ctx=n_ctx)
        for name, cfg in (("bf16", HM3D), ("f32", HM3D_F32)):
            model = build_model(cfg, seed=seed, device="cuda")
            times = []
            for _ in range(iters + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g, _ = encode(model, r["image"], r["ctx_pose"], r["near"], r["far"])
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            if g.means.dtype != torch.float32:
                raise AssertionError(f"{name} encoder: Gaussians leave in {g.means.dtype}")
            out[(name, n_ctx)] = float(np.median(times[1:]))
            del model, g
            torch.cuda.empty_cache()
        print(f"encoder, {n_ctx} context panoramas: bf16 {out[('bf16', n_ctx)]:.1f} ms, "
              f"f32 {out[('f32', n_ctx)]:.1f} ms (median of {iters} after a warm-up)", flush=True)
    return out


def small_bf16_encoder(seed):
    """The tiny encoder of phase 3b with bf16 compute on the card and on the
    CPU (same weights and inputs), held to the policy's own rounding as
    measured on the CPU (CPU bf16 against CPU f32)."""
    from dataclasses import replace

    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.serve import build_model, encode

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1), bf16_compute=True)
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, 64, 256, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    near, far = np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)
    runs = {}
    for name, c, dev in (("cpu f32", replace(cfg, bf16_compute=False), "cpu"),
                         ("cpu bf16", cfg, "cpu"), ("gpu bf16", cfg, "cuda")):
        model = build_model(c, seed=seed, device=dev)
        g, d = encode(model, *(torch.as_tensor(x, device=dev) for x in (img, pose, near, far)),
                      device=dev)
        runs[name] = [x.float().cpu() for x in (*g, d)]
    for i, leaf in enumerate(("means", "covariances", "harmonics", "opacities", "depth_map")):
        f32, c16, g16 = (runs[k][i] for k in ("cpu f32", "cpu bf16", "gpu bf16"))
        scale = float(f32.abs().max()) + 1e-12
        d_gpu, d_pol = (float((a - b).abs().max()) / scale for a, b in ((g16, c16), (c16, f32)))
        m_gpu, m_pol = (float((a - b).abs().mean()) / scale for a, b in ((g16, c16), (c16, f32)))
        print(f"  bf16 encoder {leaf}: max|gpu-cpu| {d_gpu:.3e} vs the policy's {d_pol:.3e}; "
              f"mean {m_gpu:.3e} vs {m_pol:.3e}")
        if runs["gpu bf16"][i].dtype != torch.float32:
            raise AssertionError(f"bf16 encoder {leaf} leaves in {runs['gpu bf16'][i].dtype}")
        if d_gpu > BF16_RATIO * d_pol or m_gpu > BF16_MEAN_RATIO * m_pol:
            raise AssertionError(f"bf16 encoder {leaf}: GPU differs from the CPU past the "
                                 f"policy's rounding")


@phase("3l. CLI evaluation on configs/hm3d.yaml: bf16 compute, 2 context panoramas on ERP and "
       "on cube faces, 3 on ERP")
def phase_cli_eval(seed):
    from splatter360_tpu_torch import native
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "imageio", "matplotlib", "cv2", "tensorstore")}
    have["native loader (g++, zstd)"] = native.available()
    print(f"available: {have}" + ("" if native.available() else
                                  f"\n  loader: {native.build_error()}"), flush=True)
    root = Path(tempfile.mkdtemp(prefix="splat360_cli_"))
    try:
        fmt = cli_scenes(root / "data", seed)
        print(f"{CLI_SCENES} test scenes of {CLI_FRAMES} frames written as {fmt}", flush=True)
        cfg = load_config(str(CONFIG), ["mode=test"])
        if not cfg.model.bf16_compute:
            raise AssertionError("configs/hm3d.yaml does not load with bf16_compute")
        state = create_train_state(cfg.model, cfg.train, seed=seed, device="cuda")
        ckpt.save_checkpoint(root / "ckpt", 1, state)
        saved = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        del state
        base = [str(CONFIG), "mode=test", f"dataset.roots=[{root / 'data'}]",
                f"checkpointing.load={root / 'ckpt'}", "test.eval_depth=true",
                "test.eval_time_skip_steps=1"]
        fused, unfused = "composite_forward_fused", "composite_forward_unfused"
        runs = {
            "ERP": cli_run("(a) 2 context panoramas, ERP scoring",
                           [*base, f"test.output_path={root / 'a'}"], fused, saved),
            "cubes": cli_run("(b) 2 context panoramas, test.eval_on_cubes",
                             [*base, "test.eval_on_cubes=true", f"test.output_path={root / 'b'}"],
                             fused, saved),
            "3-view": cli_run("(c) 3 context panoramas, ERP scoring",
                              [*base, f"dataset.view_sampler.num_context_views={N_CTX3}",
                               f"test.output_path={root / 'c'}"], unfused, saved),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    times = encoder_times(seed)
    small_bf16_encoder(seed)
    return dict(runs=runs, encoder_ms={f"{k[0]} {k[1]} views": v for k, v in times.items()})


class Tee:
    """stdout that is also kept, to read what a run printed."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def train_run(label, argv, device="cuda", restore_check=None):
    """One `main(argv)` run of mode=train, instrumented from outside the
    port: kernel launches over it, each train step's ms (synchronized at
    both ends), the main loop's waits on the Prefetcher, each validation's
    and each checkpoint save's seconds (and the file's bytes), the peak
    memory, what it printed. `restore_check(state, directory)` is called
    after each restore_checkpoint."""
    import splatter360_tpu_torch.train.checkpoint as ckpt
    import splatter360_tpu_torch.train.trainer as trainer
    from splatter360_tpu_torch.main import main as cli_main
    from splatter360_tpu_torch.ops.cuda import composite as comp

    rec = dict(step_ms=[], waits_s=[], val_s=[], save_s=[], save_bytes=[])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    originals = (trainer.train_step, trainer.Prefetcher, trainer.Validator.run,
                 ckpt.save_checkpoint, ckpt.restore_checkpoint)
    step_fn, prefetcher, val_run, save, restore = originals

    def timed_step(state, batch, **kw):
        sync()
        t0 = time.perf_counter()
        out = step_fn(state, batch, **kw)
        sync()
        rec["step_ms"].append((state.step, 1e3 * (time.perf_counter() - t0)))
        return out

    class TimedPrefetcher(prefetcher):
        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                rec["waits_s"].append(time.perf_counter() - t0)
                yield item

    def timed_val(self, state, step, writer=None):
        t0 = time.perf_counter()
        out = val_run(self, state, step, writer)
        sync()
        rec["val_s"].append((step, time.perf_counter() - t0))
        return out

    def timed_save(directory, step, state, max_to_keep=-1):
        sync()
        t0 = time.perf_counter()
        out = save(directory, step, state, max_to_keep)
        rec["save_s"].append((step, time.perf_counter() - t0))
        rec["save_bytes"].append((out / ckpt.FILE).stat().st_size)
        return out

    def checked_restore(directory, state, step=None):
        state, ok = restore(directory, state, step)
        if ok and restore_check is not None:
            restore_check(state, directory)
        return state, ok

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    (trainer.train_step, trainer.Prefetcher, trainer.Validator.run, ckpt.save_checkpoint,
     ckpt.restore_checkpoint) = (timed_step, TimedPrefetcher, timed_val, timed_save,
                                 checked_restore)
    tee = Tee()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            state = cli_main([*argv, "--device", device])
    finally:
        (trainer.train_step, trainer.Prefetcher, trainer.Validator.run, ckpt.save_checkpoint,
         ckpt.restore_checkpoint) = originals
    rec.update(wall_s=time.perf_counter() - t0, launches=dict(comp.launch_counts),
               printed=tee.text(), step=state.step)
    if device == "cuda":
        rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
    del state
    later = [ms for step, ms in rec["step_ms"] if step >= 2]
    print(f"{label}: {rec['wall_s']:.1f} s; train_step ms "
          f"{[round(ms, 1) for _, ms in rec['step_ms']]} (median of steps 2+ {float(np.median(later)) if later else float('nan'):.1f}); "
          f"prefetch waits s {[round(w, 4) for w in rec['waits_s']]}; validations s "
          f"{[(st, round(v, 2)) for st, v in rec['val_s']]}; checkpoint saves s "
          f"{[(st, round(v, 2)) for st, v in rec['save_s']]} of {rec['save_bytes']} bytes; "
          + (f"peak {rec['peak_gib']:.2f} GiB allocated, {rec['reserved_gib']:.2f} reserved; "
             if device == "cuda" else "") + f"launches {rec['launches']}", flush=True)
    return rec


def check_train_out(label, out: Path, ckpt_steps, val_steps, train_steps, sheet=True):
    """The run's artefacts: checkpoints, validation directories with all
    four artefacts, event scalars read back finite. With sheet=False (more
    than one Gaussian a pixel) the Gaussian sheet encoder_vis.png must be
    missing: the Validator skips it with a warning, as the JAX package's
    does."""
    from splatter360_tpu_torch.train.checkpoint import FILE
    from splatter360_tpu_torch.utils.tb_events import read_scalars

    for step in ckpt_steps:
        if not (out / "checkpoints" / str(step) / FILE).is_file():
            raise AssertionError(f"{label}: checkpoint {step} missing")
    for step in val_steps:
        vdir = out / "val" / f"{step:08d}"
        for name in ("comparison.png", "encoder_depth.png", "encoder_vis.png"):
            if (vdir / name).is_file() != (sheet or name != "encoder_vis.png"):
                raise AssertionError(f"{label}: {vdir / name} "
                                     + ("missing" if sheet else "written for gpp > 1"))
        frames = sorted((vdir / "interpolation").glob("*.png"))
        if not ((vdir / "interpolation.mp4").is_file() or len(frames) == 12):
            raise AssertionError(f"{label}: no interpolation video under {vdir}")
    scalars = [x for f in sorted((out / "tb").glob("events.out.tfevents.*"))
               for x in read_scalars(f)]
    by_tag = {}
    for step, tag, value, _ in scalars:
        by_tag.setdefault(tag, {})[step] = value
    want = {"train/loss": train_steps, "val/psnr": val_steps, "val/ssim": val_steps}
    for tag, steps in want.items():
        got = by_tag.get(tag, {})
        if sorted(got) != sorted(steps) or not all(math.isfinite(got[s]) for s in steps):
            raise AssertionError(f"{label}: {tag} scalars {got}, expected finite at {steps}")
    return by_tag


@phase("3m. CLI training on configs/hm3d.yaml: bf16, 2 context panoramas with validation, "
       "checkpoints, profile and resume; 3 context panoramas; GPU against CPU")
def phase_cli_train(seed):
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt

    fwd, bwd = comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    ufwd, ubwd = comp.UNFUSED_KERNEL_NAME, comp.UNFUSED_BWD_KERNEL_NAME
    root = Path(tempfile.mkdtemp(prefix="splat360_train_"))
    try:
        t0 = time.perf_counter()
        fmt = cli_scenes(root / "data", seed, "train", TRAIN_SCENES, TRAIN_FRAMES)
        cli_scenes(root / "data", seed + 1, "val", 1, CLI_FRAMES)
        print(f"{TRAIN_SCENES} train scenes of {TRAIN_FRAMES} frames and 1 val scene of "
              f"{CLI_FRAMES} written as {fmt} ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not load_config(str(CONFIG)).model.bf16_compute:
            raise AssertionError("configs/hm3d.yaml does not load with bf16_compute")
        out = root / "a"
        base = [str(CONFIG), "mode=train", f"dataset.roots=[{root / 'data'}]",
                f"output_dir={out}", "trainer.batch_size=1", "checkpointing.every_n_train_steps=2",
                "trainer.val_check_interval=2", "trainer.print_log_every_n_steps=1"]
        runs = {}
        runs["a"] = a = train_run(
            "(a) 2 context panoramas, bf16, 4 steps",
            [*base, f"trainer.max_steps={CLI_TRAIN_STEPS}", "trainer.num_sanity_val_steps=1",
             "trainer.profile_start=2", "trainer.profile_steps=1"])
        # a train step launches the fused pair once; a validation the forward
        # once for its 4 views and once a frame of its video
        vals = [0, 2, 4]
        want = {fwd: CLI_TRAIN_STEPS + len(vals) * 13, bwd: CLI_TRAIN_STEPS}
        if {k: a["launches"][k] for k in want} != want or a["launches"][ufwd] or \
                a["launches"][ubwd]:
            raise AssertionError(f"(a): launches {a['launches']}, expected {want}")
        a["scalars"] = check_train_out("(a)", out, [2, 4], vals, [1, 2, 3, 4])
        traces = sorted((out / "profile").glob("*.json"))
        if not traces:
            raise AssertionError("(a): no chrome trace under profile/")
        trace = json.loads(traces[0].read_text())
        events = trace.get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        a["trace"] = dict(file=traces[0].name, bytes=traces[0].stat().st_size, events=len(events),
                          kernels=len(kernels),
                          kernel_ms=sum(e.get("dur", 0) for e in kernels) / 1e3)
        print(f"(a) profile: {a['trace']}", flush=True)
        if not kernels:
            raise AssertionError("(a): the profiler's trace holds no device kernels")

        saved = torch.load(out / "checkpoints" / "4" / ckpt.FILE, map_location="cpu",
                           weights_only=True)
        restored = {}

        def same_as_saved(state, directory):
            opt = state.optimizer.state_dict()["state"]
            restored["ok"] = state.step == 4 and all(
                torch.equal(v.cpu(), saved["params"][k])
                for k, v in state.model.state_dict().items()) and all(
                torch.equal(v.cpu(), saved["opt_state"]["state"][i][k])
                for i, entry in opt.items() for k, v in entry.items())

        runs["resume"] = r = train_run(
            "(resume) the same command with trainer.max_steps=6",
            [*base, f"trainer.max_steps={CLI_RESUME_STEPS}", "trainer.num_sanity_val_steps=1"],
            restore_check=same_as_saved)
        if f"resumed from step {CLI_TRAIN_STEPS}" not in r["printed"]:
            raise AssertionError("(resume): no 'resumed from step 4' line")
        if not restored.get("ok"):
            raise AssertionError("(resume): parameters or Adam moments not restored as saved")
        if r["step"] != CLI_RESUME_STEPS or r["launches"][bwd] != CLI_RESUME_STEPS - 4:
            raise AssertionError(f"(resume): step {r['step']}, launches {r['launches']}")
        check_train_out("(resume)", out, [2, 4, 6], [0, 2, 4, 6], [1, 2, 3, 4, 5, 6])

        runs["b"] = b = train_run(
            "(b) 3 context panoramas, bf16, 2 steps",
            [str(CONFIG), "mode=train", f"dataset.roots=[{root / 'data'}]",
             f"output_dir={root / 'b'}", "trainer.batch_size=1",
             f"dataset.view_sampler.num_context_views={N_CTX3}", "trainer.max_steps=2",
             "trainer.val_check_interval=0", "trainer.num_sanity_val_steps=0",
             "trainer.print_log_every_n_steps=1"])
        if (b["launches"][ufwd], b["launches"][ubwd], b["launches"][fwd]) != (2, 2, 0):
            raise AssertionError(f"(b): launches {b['launches']}")
        check_train_out("(b)", root / "b", [2], [], [1, 2])

        runs["c"] = cli_train_gpu_cpu(root, seed)
        for run in runs.values():
            run.pop("printed", None)
        return runs
    finally:
        shutil.rmtree(root, ignore_errors=True)


def cli_train_gpu_cpu(root: Path, seed: int) -> dict:
    """(c) mode=train of the tiny f32 encoder at 64x256 on the card and with
    --device cpu, 2 steps each from one saved checkpoint
    (checkpointing.pretrained_model) on the same seeded scenes: every
    logged loss at 1e-3 relative (cuDNN sums in another order than the CPU,
    as in phase 3d), and the step-2 checkpoints through update_gaps."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    data = root / "small"
    cli_scenes(data, seed + 2, "train", 2, TRAIN_FRAMES, shape=(64, 256))
    tiny = ["dataset.image_shape=[64,256]", "model.bf16_compute=false", "model.d_feature=32",
            "model.num_depth_candidates=16", "model.costvolume_unet_feat_dim=32",
            "model.costvolume_unet_channel_mult=[1,1]", "model.costvolume_unet_attn_res=[2]",
            "model.depth_unet_feat_dim=8", "model.depth_unet_attn_res=[8]",
            "model.depth_unet_channel_mult=[1,1,1,1]", "model.gaussian_adapter.sh_degree=1"]
    cfg = load_config(str(CONFIG), tiny)
    state = create_train_state(cfg.model, cfg.train, seed=seed, device="cpu")
    ckpt.save_checkpoint(root / "small_ckpt", 0, state)
    names = [n for n, _ in state.model.named_parameters()]
    del state
    common = [str(CONFIG), "mode=train", f"dataset.roots=[{data}]", *tiny,
              f"checkpointing.pretrained_model={root / 'small_ckpt'}", "trainer.batch_size=1",
              "trainer.max_steps=2",
              "trainer.val_check_interval=0", "trainer.num_sanity_val_steps=0",
              "trainer.print_log_every_n_steps=1"]
    got = {}
    for dev in ("cuda", "cpu"):
        out = root / f"small_{dev}"
        rec = train_run(f"(c) tiny f32 model at 64x256, --device {dev}",
                        [*common, f"output_dir={out}"], device=dev)
        if "warm-started weights from pretrained_model" not in rec["printed"]:
            raise AssertionError(f"(c) {dev}: not warm-started from the saved checkpoint")
        got[dev] = check_train_out(f"(c) {dev}", out, [2], [], [1, 2])
        got[f"{dev}_launches"] = rec["launches"]
    gpu = got["cuda_launches"]
    if (gpu[comp.KERNEL_NAME], gpu[comp.BWD_KERNEL_NAME]) != (2, 2):
        raise AssertionError(f"(c): GPU launches {got['cuda_launches']}")
    if any(got["cpu_launches"].values()):
        raise AssertionError(f"(c): the CPU run launched kernels {got['cpu_launches']}")
    worst = 0.0
    for tag in sorted(t for t in got["cpu"] if t.startswith("train/loss")):
        for step, ref in got["cpu"][tag].items():
            rel = abs(got["cuda"][tag][step] - ref) / max(abs(ref), 1e-12)
            print(f"  {tag} step {step}: cpu {ref:.6g} gpu {got['cuda'][tag][step]:.6g} "
                  f"({rel:.2e} relative)")
            worst = max(worst, rel)
    if worst > 1e-3:
        raise AssertionError(f"(c): GPU losses differ from the CPU's by {worst:.2e} relative")
    def load(directory, step):
        return torch.load(directory / str(step) / ckpt.FILE, map_location="cpu",
                          weights_only=True)

    gaps = update_gaps(load(root / "small_ckpt", 0)["params"],
                       load(root / "small_cpu" / "checkpoints", 2),
                       load(root / "small_cuda" / "checkpoints", 2), names, cfg.train.optimizer)
    return dict(worst_rel=worst, losses={d: got[d]["train/loss"] for d in ("cuda", "cpu")},
                updates=gaps)


def update_gaps(start: dict, ref: dict, got: dict, names: list, opt_cfg) -> dict:
    """Checkpoints `got` (the card's) against `ref` (the CPU's), both taken
    from the parameters `start`, leaf by leaf: the change |got - ref|_2 /
    |ref|_2 and the same for both Adam moments, at most UPDATE_RTOL; a leaf
    the CPU holds still (first moment within STILL_M of the largest) must
    move by at most STILL_LR times the schedule's largest rate on the card
    too."""
    from splatter360_tpu_torch.train.state import learning_rate

    lr = max(learning_rate(opt_cfg, c) for c in range(ref["step"]))
    parts = {}
    for i, n in enumerate(names):
        r, g = ref["opt_state"]["state"][i], got["opt_state"]["state"][i]
        parts[n] = {"update": (ref["params"][n] - start[n], got["params"][n] - start[n]),
                    "exp_avg": (r["exp_avg"], g["exp_avg"]),
                    "exp_avg_sq": (r["exp_avg_sq"], g["exp_avg_sq"])}
    m_max = max(float(p["exp_avg"][0].abs().max()) for p in parts.values())
    worst, still, still_move = {}, 0, 0.0
    for n, p in parts.items():
        if float(p["exp_avg"][0].abs().max()) <= STILL_M * m_max:
            still += 1
            still_move = max(still_move, float(p["update"][1].abs().max()) / lr)
            continue
        for key, (r, g) in p.items():
            gap = float((g.double() - r.double()).norm() / r.double().norm())
            worst[key] = max(worst.get(key, (0.0, "")), (gap, n))
    out = dict({k: dict(gap=v[0], leaf=v[1]) for k, v in worst.items()}, still_leaves=still,
               still_move_lr=still_move, leaves=len(names))
    print(f"(c) step-2 checkpoints, card against CPU (relative L2 a leaf, bar {UPDATE_RTOL}): "
          f"{out}", flush=True)
    bad = [k for k, v in worst.items() if v[0] > UPDATE_RTOL]
    if bad or still_move > STILL_LR:
        raise AssertionError(f"(c): the card's step-2 checkpoint differs from the CPU's: {out}")
    return out


def option_request(gen):
    """train_batch's context and target views as an encode + render request."""
    batch = train_batch(gen)
    ctx, tgt = batch["context"], batch["target"]
    return batch, dict(image=ctx["image_sphere"], ctx_pose=ctx["extrinsics_sphere"],
                       near=ctx["near"], far=ctx["far"], tgt_pose=tgt["extrinsics_sphere"],
                       tgt_near=tgt["near"], tgt_far=tgt["far"])


def epipolar_memory(seed):
    """The epipolar block alone at HM3D width (2 views of 64x128 features of
    128 channels, 32 samples), forward and backward, in bf16 and float32:
    the peak memory above its inputs, and its ms."""
    from splatter360_tpu_torch.models.epipolar import EpipolarCrossAttention

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        block = EpipolarCrossAttention(128, 128, 32).to("cuda")
        with torch.no_grad():
            for p in block.parameters():
                p.copy_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
        block = block.to(dtype)
        feats = torch.randn((1, N_CTX, H // 8, W // 8, 128), generator=gen, device="cuda",
                            dtype=dtype, requires_grad=True)
        ext = torch.eye(4, device="cuda").repeat(1, N_CTX, 1, 1)
        ext[0, 1, :3, 3] = torch.tensor([0.3, 0.0, 0.1], device="cuda")
        near, far = (torch.full((1, N_CTX), x, device="cuda") for x in (0.1, 10.0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = block(feats, ext, near, far)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        name = str(dtype).split(".")[-1]
        out[name] = dict(forward_peak_gib=fwd_peak / 2**30, peak_gib=peak / 2**30, ms=ms)
        print(f"  epipolar block alone, {name}: forward peak {fwd_peak / 2**30:.3f} GiB, "
              f"forward + backward peak {peak / 2**30:.3f} GiB above its inputs, {ms:.1f} ms "
              f"(first call)", flush=True)
        del block, feats, y
    return out


@phase("3n (a). the encoder's Table 3 options at HM3D width, bf16: encode + render and ERP "
       "train steps per option group")
def phase_options(seed):
    """Per OPTION_GROUPS group, hm3d.yaml's model block (bf16) with its
    flags, seeded: an encode + render of N_TGT ERP views through the
    serving entry points, then 2 ERP train steps at B = 1 (TrainConfig
    (supervision="erp")); outputs finite, the kernel pair of the group's N
    launched (fused for one Gaussian a pixel, unfused for 2: N =
    2*512*1024*2 is past the fused table budget); encoder ms, render ms, the
    second step's ms and the steps' peak memory; for gpp 2, the unfused
    pair against its plain versions at the last step's inputs. Then the
    epipolar block's own memory."""
    from dataclasses import replace

    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import encode, render_erp_views
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    batch, r = option_request(gen)
    out = {}
    for group, kw in OPTION_GROUPS.items():
        cfg = replace(HM3D, **kw)
        n = N_CTX * H * W * cfg.gaussians_per_pixel
        fwd, bwd = path_kernels(n)
        torch.cuda.empty_cache()
        for k in comp.launch_counts:
            comp.launch_counts[k] = 0
        state = create_train_state(cfg, TrainConfig(supervision="erp"), seed=seed, device="cuda")
        encode(state.model, r["image"], r["ctx_pose"], r["near"], r["far"])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gaussians, depth_map = encode(state.model, r["image"], r["ctx_pose"], r["near"], r["far"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        views = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"], (H, W),
                                 render_depth=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if gaussians.means.shape[1] != n:
            raise AssertionError(f"{group}: {gaussians.means.shape[1]} Gaussians, expected {n}")
        check_outputs(gaussians, depth_map, views, r)
        del gaussians, depth_map, views
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(2):
            t3 = time.perf_counter()
            metrics = train_step(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t3))
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"{group}: non-finite metrics {vals}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(comp.launch_counts)
        want = {k: 3 if k == fwd else 2 if k == bwd else 0 for k in launches}
        if launches != want:
            raise AssertionError(f"{group}: launches {launches}, expected {want}")
        if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
            raise AssertionError(f"{group}: non-finite parameters")
        out[group] = dict(launches=launches, n=n, encoder_ms=1e3 * (t1 - t0),
                          render_ms=1e3 * (t2 - t1), step_ms=step_ms, peak_gib=peak,
                          loss=vals["loss"])
        print(f"  {group}: N={n}, encoder {out[group]['encoder_ms']:.1f} ms, render "
              f"{N_TGT} views {out[group]['render_ms']:.1f} ms, train steps "
              f"{[round(x, 1) for x in step_ms]} ms, peak {peak:.2f} GiB, loss "
              f"{vals['loss']:.5f}; launches {launches}", flush=True)
        if fwd == comp.UNFUSED_KERNEL_NAME:
            # the unfused pair at the step's shapes (after the run's count):
            # the last step's Gaussians in its N_TGT target views, each kernel
            # against its plain version at the 3-view checks' bars (3e, 3f;
            # coinciding pairs, see L2_TOL), then timed with CUDA events
            inp = step_inputs(state, batch, unfused=True)
            label = f"{group} step Gaussians, {N_TGT} views"
            fwd_err, _ = compare_kernel_plain(inp, label, unfused=True)
            res = compare_unfused_bwd_plain(inp, label, seed + 32, comp.BWD_SPAN,
                                            duplicates=bool(kw.get("wo_depth_refine")))
            args = res["args"]
            out[group].update(
                fwd_err=fwd_err, bwd_err=res["err"],
                fwd_kernel_ms=time_cuda(fwd_calls(inp, unfused=True)[0], 5),
                bwd_kernel_ms=time_cuda(lambda: comp.composite_backward_unfused(*args), 5))
            print(f"  {group}: unfused forward kernel {out[group]['fwd_kernel_ms']:.3f} ms, "
                  f"backward kernel {out[group]['bwd_kernel_ms']:.3f} ms at the step's "
                  f"{N_TGT} views; against the plain versions {fwd_err:.3e} / "
                  f"{res['err']:.3e}", flush=True)
            del inp, args, res
        del state
    torch.cuda.empty_cache()
    out["epipolar_block"] = epipolar_memory(seed)
    return out


@phase("3n (b). the option groups' tiny encoders and train steps: GPU against CPU, float32")
def phase_options_small(seed, cpu_steps):
    """Per group, the tiny f32 encoder of phase 3b with the group's flags on
    the same seeded weights and request on the card and on the CPU: the
    outputs at 1e-3 of max|x| (3b's bar); then small_train's GPU and CPU
    ERP steps (3d's bars: the loss at 1e-3 relative, every leaf's gradient
    at GRAD_TOL of the global max|g|, or one jump by jump_gaps), the CPU
    steps and jump_gaps' noise steps from `cpu_steps` (option_cpu_steps)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, 64, 256, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    nf = (np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32))
    worst = {}
    for group, kw in OPTION_GROUPS.items():
        option_group_small(seed, group, kw, img, pose, nf, worst,
                           lambda noise, g=group: cpu_steps[g, noise].result())
    return worst


@contextlib.contextmanager
def option_cpu_steps(seed):
    """Phase 3n (b)'s CPU steps submitted to OPTION_WORKERS processes: the
    groups' steps, then their noise steps; {(group, noise seed or None):
    future}. On leaving, what has not started is cancelled and the workers
    are joined."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(OPTION_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield {(g, noise): pool.submit(option_cpu_step, kw, seed, noise)
               for noise in (None, JUMP_NOISE_SEED) for g, kw in OPTION_GROUPS.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def option_cpu_step(options, seed, noise_seed):
    """Phase 3n (b)'s CPU train step of the tiny encoder with `options`, in
    a worker process: (metrics, gradients) of step_grads."""
    from splatter360_tpu_torch.train.state import TrainConfig

    torch.set_num_threads(OPTION_THREADS)
    tcfg = TrainConfig(supervision="erp", remat_faces=False)
    return step_grads(small_config(options), tcfg, small_batch(seed, N_CTX), seed, "cpu",
                      noise_seed)[:2]


def option_group_small(seed, group, kw, img, pose, nf, worst, cpu_step):
    """One group of phase 3n (b): its tiny encoder on both devices, then
    small_train with the CPU step from `cpu_step`."""
    from splatter360_tpu_torch.serve import build_model, encode

    enc = {}
    for dev in ("cpu", "cuda"):
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        model = build_model(small_config(kw), seed=seed, device=dev)
        g, d = encode(model, t(img), t(pose), t(nf[0]), t(nf[1]), device=dev)
        enc[dev] = [x.cpu() for x in (*g, d)]
    rels = [float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
            for a, b in zip(enc["cpu"], enc["cuda"])]
    worst[group] = max(rels)
    print(f"  {group}: encoder max|cpu-gpu|/max|cpu| "
          + ", ".join(f"{n} {r:.2e}" for n, r in zip(
              ("means", "covariances", "harmonics", "opacities", "depth_map"), rels)),
          flush=True)
    if worst[group] > 1e-3:
        raise AssertionError(f"{group}: GPU encoder differs from the CPU's "
                             f"({worst[group]:.2e})")
    small_train(seed, N_CTX, options=kw, cpu_step=cpu_step)


@phase("3n (c). the CLI with hm3d.yaml + biproj, use_epipolar_trans, gaussians_per_pixel=2: "
       "mode=train 2 steps, then mode=test")
def phase_options_cli(seed):
    """mode=train on 2 seeded 512x1024 train scenes (bf16, B = 1, a sanity
    validation, 2 steps), then mode=test of its step-2 checkpoint on 2 test
    scenes: N = 2*512*1024*2 takes the unfused pair; every artefact."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt

    ufwd, ubwd = comp.UNFUSED_KERNEL_NAME, comp.UNFUSED_BWD_KERNEL_NAME
    root = Path(tempfile.mkdtemp(prefix="splat360_opts_"))
    try:
        cli_scenes(root / "data", seed + 40, "train", 2, TRAIN_FRAMES)
        cli_scenes(root / "data", seed + 41, "test", 2, CLI_FRAMES)
        out = root / "run"
        tr = train_run(
            "(c) mode=train, biproj + epipolar + 2 Gaussians a pixel, bf16, 2 steps",
            [str(CONFIG), "mode=train", *CLI_OPTIONS, f"dataset.roots=[{root / 'data'}]",
             f"output_dir={out}", "trainer.batch_size=1", "trainer.max_steps=2",
             "trainer.num_sanity_val_steps=1", "trainer.val_check_interval=0",
             "trainer.print_log_every_n_steps=1"])
        # 2 steps, and a validation's 4 views and 12 video frames
        want = {ufwd: 2 + 13, ubwd: 2}
        if {k: tr["launches"][k] for k in want} != want or \
                tr["launches"][comp.KERNEL_NAME] or tr["launches"][comp.BWD_KERNEL_NAME]:
            raise AssertionError(f"(c) mode=train: launches {tr['launches']}, expected {want}")
        check_train_out("(c) mode=train", out, [2], [0], [1, 2], sheet=False)
        saved = torch.load(out / "checkpoints" / "2" / ckpt.FILE, map_location="cpu",
                           weights_only=True)["params"]
        ev = cli_run("(c) mode=test of its checkpoint",
                     [str(CONFIG), "mode=test", *CLI_OPTIONS, f"dataset.roots=[{root / 'data'}]",
                      f"checkpointing.load={out / 'checkpoints'}", "test.eval_depth=true",
                      "test.eval_time_skip_steps=1", f"test.output_path={root / 'test'}"],
                     ufwd, saved)
        if ev["launches"][comp.KERNEL_NAME]:
            raise AssertionError(f"(c) mode=test: the fused forward launched {ev['launches']}")
        tr.pop("printed", None)
        return dict(train=tr, test=ev, launches={k: tr["launches"][k] + ev["launches"][k]
                                                 for k in tr["launches"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dinov2_state(seed: int, dim: int = 384, depth: int = 12, grid: int = 37) -> dict:
    """A seeded state dict in DINOv2 ViT-S/14's layout (torch.hub
    dinov2_vits14: its key names and shapes, a pos_embed of 1 + 37*37
    tokens, the cls and mask tokens), random weights of realistic scale."""
    gen = torch.Generator().manual_seed(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen)

    sd = {"cls_token": t(1, 1, dim), "mask_token": t(1, dim),
          "pos_embed": t(1, 1 + grid * grid, dim, scale=0.02),
          "patch_embed.proj.weight": t(dim, 3, 14, 14, scale=588 ** -0.5),
          "patch_embed.proj.bias": t(dim, scale=0.02),
          "norm.weight": t(dim, scale=0.05, offset=1.0), "norm.bias": t(dim, scale=0.02)}
    for i in range(depth):
        p = f"blocks.{i}."
        for name, shape in (("norm1", (dim,)), ("norm2", (dim,)), ("attn.qkv", (3 * dim, dim)),
                            ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            sd[p + name + ".weight"] = (t(dim, scale=0.05, offset=1.0) if len(shape) == 1
                                        else t(*shape, scale=shape[1] ** -0.5))
            sd[p + name + ".bias"] = t(shape[0], scale=0.02)
        sd[p + "ls1.gamma"] = t(dim, scale=0.02, offset=0.1)
        sd[p + "ls2.gamma"] = t(dim, scale=0.02, offset=0.1)
    return sd


def unimatch_state(seed: int) -> dict:
    """A seeded state dict in UniMatch gmdepth's layout: the 115 keys and
    shapes of UNIMATCH_KEYS (CNNEncoder(output_dim=128) and a 6-layer d=128
    transformer). Conv and linear weights N(0, 1/fan_in), so no square
    kernel is symmetric; LayerNorm weights 1 + N(0, 0.2) and every bias
    N(0, 0.1), so a scale swapped with its bias shows."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in json.loads(UNIMATCH_KEYS.read_text()).items():
        x = torch.randn(shape, generator=gen)
        if len(shape) > 1:
            x = x / math.sqrt(math.prod(shape[1:]))
        elif key.endswith(("norm1.weight", "norm2.weight")):
            x = 1.0 + 0.2 * x
        else:
            x = 0.1 * x
        sd[key] = x
    return sd


def vit_ms(model, image, iters=5):
    """The mono ViT alone, bf16 as apply_encoder runs it: CUDA-event ms of
    one call on the context panoramas' normalised cube faces resized to a
    multiple of 14 (2 panoramas: 12 faces of 252x252, 3,888 tokens)."""
    from splatter360_tpu_torch.models.backbone import normalize_images
    from splatter360_tpu_torch.models.layers import bilinear_resize
    from splatter360_tpu_torch.serve import context_cubes

    bf16 = torch.bfloat16
    faces = normalize_images(context_cubes(image, FACE).to(bf16)).reshape(-1, FACE, FACE, 3)
    x = bilinear_resize(faces, 14 * MONO_GRID, 14 * MONO_GRID)
    params = {k: p.to(bf16) for k, p in model.dino.named_parameters()}
    with torch.no_grad():
        return time_cuda(lambda: torch.func.functional_call(model.dino, params, (x,)), iters)


@phase("3o (a-b). the mono branch at HM3D width, bf16: DINOv2 warm start, a served request and "
       "2 ERP train steps")
def phase_mono(seed, root: Path):
    """hm3d.yaml's model with add_mono_feat (ViT-S/14, its 18x18 token grid
    on the 256x256 faces), bf16, warm-started from a seeded DINOv2-layout
    file (MONO_LEAVES parameters): one request through the serving entry
    points (encode, 4 target ERP views: 1 fused forward launch), then 2 ERP
    train steps at B = 1 (fused forward and backward), the launches counted
    over that run; the ViT bit-equal before and after the steps and the
    rgbd_fusion layers changed; encoder ms with the branch and without it
    on the same request, the ViT's own ms, the steps' ms and peak."""
    from dataclasses import replace

    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import build_model, encode, render_erp_views
    from splatter360_tpu_torch.train.checkpoint import warm_start_mono
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    path = root / "dinov2_vits14.pth"
    torch.save(dinov2_state(seed + 50), path)
    cfg = replace(HM3D, add_mono_feat=True, vit_type="vits")
    torch.cuda.empty_cache()
    state = create_train_state(cfg, TrainConfig(supervision="erp"), seed=seed, device="cuda",
                               mono_grid=MONO_GRID)
    n = warm_start_mono(state.model, path)
    print(f"  warm-started the mono branch from {path.name} ({n} leaves)", flush=True)
    if n != MONO_LEAVES:
        raise AssertionError(f"warm start copied {n} leaves, expected {MONO_LEAVES}")
    vit0 = {k: v.clone() for k, v in state.model.dino.state_dict().items()}
    fusion0 = {k: p.detach().clone() for k, p in state.model.named_parameters()
               if k.startswith("rgbd_fusion_")}
    batch, r = option_request(torch.Generator(device="cuda").manual_seed(seed + 51))
    args = (r["image"], r["ctx_pose"], r["near"], r["far"])

    encode(state.model, *args)  # warm-up (cuDNN autotuning)
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gaussians, depth_map = encode(state.model, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    views = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"], (H, W),
                             render_depth=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_outputs(gaussians, depth_map, views, r)
    del gaussians, depth_map, views
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(2):
        t3 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t3))
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics {vals}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(comp.launch_counts)
    want = {k: 3 if k == comp.KERNEL_NAME else 2 if k == comp.BWD_KERNEL_NAME else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    vit1 = state.model.dino.state_dict()
    moved = [k for k in vit0 if not torch.equal(vit0[k], vit1[k])]
    if moved:
        raise AssertionError(f"the frozen ViT changed in training: {moved}")
    still = [k for k, p in state.model.named_parameters()
             if k in fusion0 and torch.equal(fusion0[k], p.detach())]
    if still:
        raise AssertionError(f"rgbd_fusion parameters did not train: {still}")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters")

    vit = vit_ms(state.model, r["image"])
    base = build_model(HM3D, seed=seed)
    encode(base, *args)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    encode(base, *args)
    torch.cuda.synchronize()
    base_ms = 1e3 * (time.perf_counter() - t4)
    out = dict(launches=launches, leaves=n, encoder_ms=1e3 * (t1 - t0),
               encoder_ms_without=base_ms, vit_ms=vit, render_ms=1e3 * (t2 - t1),
               step_ms=step_ms, peak_gib=peak, loss=vals["loss"])
    print(f"  mono: encoder {out['encoder_ms']:.1f} ms (without the branch {base_ms:.1f} ms on "
          f"the same request; the ViT alone {vit:.3f} ms), render {N_TGT} views "
          f"{out['render_ms']:.1f} ms, train steps {[round(x, 1) for x in step_ms]} ms, peak "
          f"{peak:.2f} GiB, loss {vals['loss']:.5f}; launches {launches}; the ViT bit-equal "
          f"after the steps, rgbd_fusion trained", flush=True)
    del state, base
    torch.cuda.empty_cache()
    return out


@phase("3o (c). the CLI with hm3d.yaml + add_mono_feat + checkpointing.pretrained_mono: "
       "mode=train 2 steps, then mode=test")
def phase_mono_cli(seed, root: Path):
    """mode=train on 2 seeded 512x1024 train scenes (bf16, B = 1, a sanity
    validation, 2 steps), warm-started from phase 3o's DINOv2 file (it
    prints MONO_LEAVES leaves), then mode=test of its step-2 checkpoint on 2
    test scenes; every artefact and score; the checkpoint's ViT the file's
    bit for bit (frozen through the steps)."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.utils.torch_convert import convert_dinov2, load_torch_state_dict

    fwd, bwd = comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    path = root / "dinov2_vits14.pth"
    data, out = root / "data", root / "run"
    cli_scenes(data, seed + 52, "train", 2, TRAIN_FRAMES)
    cli_scenes(data, seed + 53, "test", 2, CLI_FRAMES)
    mono = ["model.add_mono_feat=true", f"checkpointing.pretrained_mono={path}"]
    tr = train_run(
        "(c) mode=train, the mono branch, bf16, 2 steps",
        [str(CONFIG), "mode=train", *mono, f"dataset.roots=[{data}]", f"output_dir={out}",
         "trainer.batch_size=1", "trainer.max_steps=2", "trainer.num_sanity_val_steps=1",
         "trainer.val_check_interval=0", "trainer.print_log_every_n_steps=1"])
    line = f"warm-started the mono branch from pretrained_mono ({MONO_LEAVES} leaves)"
    if line not in tr["printed"]:
        raise AssertionError(f"(c) mode=train did not print {line!r}")
    # 2 steps, and the sanity validation's 4 views and 12 video frames
    want = {fwd: 2 + 13, bwd: 2}
    unfused = tr["launches"][comp.UNFUSED_KERNEL_NAME] + tr["launches"][
        comp.UNFUSED_BWD_KERNEL_NAME]
    if {k: tr["launches"][k] for k in want} != want or unfused:
        raise AssertionError(f"(c) mode=train: launches {tr['launches']}, expected {want}")
    check_train_out("(c) mode=train", out, [2], [0], [1, 2])
    saved = torch.load(out / "checkpoints" / "2" / ckpt.FILE, map_location="cpu",
                       weights_only=True)["params"]
    vit = convert_dinov2(load_torch_state_dict(path), MONO_GRID)
    changed = [k for k, v in vit.items() if not torch.equal(saved[f"dino.{k}"], v)]
    if changed:
        raise AssertionError(f"(c) the checkpoint's ViT is not the file's: {changed}")
    ev = cli_run("(c) mode=test of its checkpoint",
                 [str(CONFIG), "mode=test", "model.add_mono_feat=true",
                  f"dataset.roots=[{data}]", f"checkpointing.load={out / 'checkpoints'}",
                  "test.eval_depth=true", "test.eval_time_skip_steps=1",
                  f"test.output_path={root / 'test'}"], fwd, saved)
    if ev["launches"][comp.UNFUSED_KERNEL_NAME]:
        raise AssertionError(f"(c) mode=test: the unfused forward launched {ev['launches']}")
    tr.pop("printed", None)
    return dict(train=tr, test=ev, launches={k: tr["launches"][k] + ev["launches"][k]
                                             for k in tr["launches"]})


@phase("3o (d). the tiny f32 mono encoder and train step: GPU against CPU")
def phase_mono_small(seed, root: Path):
    """The tiny f32 encoder of phase 3b with add_mono_feat (ViT-S/14 over
    the 2x2 token grid of 32x32 faces), warm-started from phase 3o's file,
    on the card and on the CPU: the outputs at 1e-3 of max|x| (3b's bar);
    the ViT alone card against CPU in float32 and bf16 (measured, for
    ROADMAP Queue 3); then small_train's GPU and CPU ERP steps with the
    branch (3d's bars:
    the loss at 1e-3 relative, every trainable leaf's gradient at GRAD_TOL
    of the global max|g|, or one jump by jump_gaps)."""
    from splatter360_tpu_torch.models.dino import token_grid
    from splatter360_tpu_torch.serve import build_model, encode
    from splatter360_tpu_torch.train.checkpoint import warm_start_mono

    options = {"add_mono_feat": True}
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (1, 2, 64, 256, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    nf = (np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32))
    enc = {}
    for dev in ("cpu", "cuda"):
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        model = build_model(small_config(options), seed=seed, device=dev,
                            mono_grid=token_grid(32))
        warm_start_mono(model, root / "dinov2_vits14.pth")
        g, d = encode(model, t(img), t(pose), t(nf[0]), t(nf[1]), device=dev)
        enc[dev] = [x.cpu() for x in (*g, d)]
    rels = [float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12)
            for a, b in zip(enc["cpu"], enc["cuda"])]
    print("  mono encoder max|cpu-gpu|/max|cpu| " + ", ".join(
        f"{n} {r:.2e}" for n, r in zip(("means", "covariances", "harmonics", "opacities",
                                        "depth_map"), rels)), flush=True)
    if max(rels) > 1e-3:
        raise AssertionError(f"the GPU mono encoder differs from the CPU's ({max(rels):.2e})")
    vit = vit_card_vs_cpu(model.dino, img)
    small_train(seed, N_CTX, options=options)
    return dict(encoder=max(rels), vit=vit)


def vit_card_vs_cpu(dino, img):
    """The warm-started ViT-S/14 alone on the small request's 12 cube faces
    (32x32, resized to 28x28: 48 tokens), on the card and on the CPU, in
    float32 and in bf16 (parameters and input cast, as apply_encoder casts
    them): max|card - CPU| over max|CPU|, the mean over the mean, and the
    share of bit-equal elements (ROADMAP Queue 3 records them)."""
    from splatter360_tpu_torch.models.backbone import normalize_images
    from splatter360_tpu_torch.models.layers import bilinear_resize
    from splatter360_tpu_torch.serve import context_cubes

    faces = normalize_images(context_cubes(torch.as_tensor(img), 32)).reshape(-1, 32, 32, 3)
    x = bilinear_resize(faces, 28, 28)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        res = {}
        for dev in ("cpu", "cuda"):
            params = {k: p.to(dev, dtype) for k, p in dino.named_parameters()}
            with torch.no_grad():
                res[dev] = torch.func.functional_call(dino, params,
                                                      (x.to(dev, dtype),)).float().cpu()
        a, b = res["cpu"], res["cuda"]
        name = str(dtype).split(".")[-1]
        out[name] = dict(max_rel=float((a - b).abs().max() / a.abs().max()),
                         mean_rel=float((a - b).abs().mean() / a.abs().mean()),
                         equal_share=float((a == b).float().mean()))
        print(f"  ViT alone, card against CPU, {name}: max {out[name]['max_rel']:.3e} of "
              f"max|x|, mean {out[name]['mean_rel']:.3e} of mean|x|, "
              f"{100 * out[name]['equal_share']:.2f}% of elements bit-equal", flush=True)
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"non-finite ViT output on the card ({name})")
    return out


@phase("3p (a). the UniMatch backbone warm start at HM3D width, bf16: a served request and 2 "
       "ERP train steps")
def phase_backbone(seed, root: Path):
    """hm3d.yaml's model in bf16 warm-started from a seeded file in gmdepth's
    layout (unimatch_state in {"model": ...}): 2 x 115 parameters copied,
    both backbones' parameters on the card the file's bit for bit; then one
    request through the serving entry points (encode, 4 target ERP views: 1
    fused forward launch) and 2 ERP train steps at B = 1 (fused forward and
    backward), the launches counted over that run. Returns the numbers, and
    the request and its Gaussians for phase 3p (c)."""
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import encode, render_erp_views
    from splatter360_tpu_torch.train.checkpoint import warm_start_backbones
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step
    from splatter360_tpu_torch.utils.torch_convert import convert_unimatch_backbone

    sd = unimatch_state(seed + 60)
    path = root / "gmdepth.pth"
    torch.save({"model": sd}, path)
    want = 2 * len(json.loads(UNIMATCH_KEYS.read_text()))
    torch.cuda.empty_cache()
    state = create_train_state(HM3D, TrainConfig(supervision="erp"), seed=seed, device="cuda")
    n = warm_start_backbones(state.model, path)
    print(f"  warm-started both backbones from {path.name} ({n} leaves; the key map gives "
          f"{want})", flush=True)
    if n != want:
        raise AssertionError(f"warm start copied {n} leaves, expected {want}")
    donor = convert_unimatch_backbone(sd)
    for name in ("backbone_cube", "backbone_erp"):
        params = dict(getattr(state.model, name).named_parameters())
        differ = [k for k, v in donor.items() if not torch.equal(params[k].cpu(), v)]
        if differ:
            raise AssertionError(f"{name} is not the file's bit for bit: {differ}")
    batch, r = option_request(torch.Generator(device="cuda").manual_seed(seed + 61))
    args = (r["image"], r["ctx_pose"], r["near"], r["far"])

    encode(state.model, *args)  # warm-up (cuDNN autotuning)
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gaussians, depth_map = encode(state.model, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    views = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"], (H, W),
                             render_depth=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_outputs(gaussians, depth_map, views, r)
    del depth_map, views
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(2):
        t3 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t3))
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite metrics {vals}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(comp.launch_counts)
    expect = {k: 3 if k == comp.KERNEL_NAME else 2 if k == comp.BWD_KERNEL_NAME else 0
              for k in launches}
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters")
    out = dict(launches=launches, leaves=n, encoder_ms=1e3 * (t1 - t0),
               render_ms=1e3 * (t2 - t1), step_ms=step_ms, peak_gib=peak, loss=vals["loss"])
    print(f"  warm-started model: encoder {out['encoder_ms']:.1f} ms, render {N_TGT} views "
          f"{out['render_ms']:.1f} ms, train steps {[round(x, 1) for x in step_ms]} ms, peak "
          f"{peak:.2f} GiB, loss {vals['loss']:.5f}; launches {launches}", flush=True)
    del state
    torch.cuda.empty_cache()
    return dict(out, leaves_expected=want), gaussians, r


def video_frames(path: Path) -> tuple[str, int]:
    """What save_video wrote at `path`: ("mp4", frames) or ("png", frames
    in its frame directory); ("missing", 0) for neither."""
    if path.is_file():
        import cv2

        cap = cv2.VideoCapture(str(path))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return "mp4", n
    frames = path.with_suffix("")
    if frames.is_dir():
        return "png", len(list(frames.glob("*.png")))
    return "missing", 0


@phase("3p (b). the CLI with hm3d.yaml + checkpointing.pretrained_backbone: mode=train 2 steps, "
       "then mode=test with test.save_video")
def phase_backbone_cli(seed, root: Path):
    """mode=train on 2 seeded 512x1024 train scenes (bf16, B = 1, no
    validation, 2 steps) warm-started from phase 3p (a)'s file (it prints
    the same count), then mode=test of its step-2 checkpoint on 2 test
    scenes with test.save_video and test.eval_depth: the fused forward
    launched once a scene for the scores and VIDEO_FRAMES times a scene for
    the video, and each scene's interpolate and interpolate_depth videos
    written with VIDEO_FRAMES frames."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt

    fwd, bwd = comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    unfused = (comp.UNFUSED_KERNEL_NAME, comp.UNFUSED_BWD_KERNEL_NAME)
    path = root / "gmdepth.pth"
    want = 2 * len(json.loads(UNIMATCH_KEYS.read_text()))
    data, out, test_out = root / "data", root / "run", root / "test"
    cli_scenes(data, seed + 62, "train", 2, TRAIN_FRAMES)
    cli_scenes(data, seed + 63, "test", 2, CLI_FRAMES)
    tr = train_run(
        "(b) mode=train, pretrained_backbone, bf16, 2 steps",
        [str(CONFIG), "mode=train", f"checkpointing.pretrained_backbone={path}",
         f"dataset.roots=[{data}]", f"output_dir={out}", "trainer.batch_size=1",
         "trainer.max_steps=2", "trainer.num_sanity_val_steps=0", "trainer.val_check_interval=0",
         "trainer.print_log_every_n_steps=1"])
    line = f"warm-started both backbones from pretrained_backbone ({want} leaves)"
    if line not in tr["printed"]:
        raise AssertionError(f"(b) mode=train did not print {line!r}")
    if (tr["launches"][fwd], tr["launches"][bwd]) != (2, 2) or any(tr["launches"][k]
                                                                   for k in unfused):
        raise AssertionError(f"(b) mode=train: launches {tr['launches']}, expected 2 and 2")
    check_train_out("(b) mode=train", out, [2], [], [1, 2])
    saved = torch.load(out / "checkpoints" / "2" / ckpt.FILE, map_location="cpu",
                       weights_only=True)["params"]
    ev = cli_run("(b) mode=test of its checkpoint with test.save_video",
                 [str(CONFIG), "mode=test", f"dataset.roots=[{data}]",
                  f"checkpointing.load={out / 'checkpoints'}", "test.eval_depth=true",
                  "test.save_video=true", "test.eval_time_skip_steps=1",
                  f"test.output_path={test_out}"], fwd, saved)
    scenes = sorted(p.name for p in test_out.iterdir() if p.is_dir())
    expect = len(scenes) * (1 + VIDEO_FRAMES)
    if ev["launches"][fwd] != expect or any(ev["launches"][k] for k in unfused):
        raise AssertionError(f"(b) mode=test: launches {ev['launches']}, expected {expect} "
                             f"fused forward launches over {len(scenes)} scenes")
    written = {}
    for scene in scenes:
        for stem in ("interpolate", "interpolate_depth"):
            kind, n = video_frames(test_out / scene / f"{stem}.mp4")
            written[f"{scene}/{stem}"] = (kind, n)
            if n != VIDEO_FRAMES:
                raise AssertionError(f"(b) {scene}/{stem}: {kind} with {n} frames, expected "
                                     f"{VIDEO_FRAMES}")
    print(f"  (b) videos written: {written}", flush=True)
    tr.pop("printed", None)
    return dict(train=tr, test=ev, videos=written,
                launches={k: tr["launches"][k] + ev["launches"][k] for k in tr["launches"]})


@phase("3p (c). trajectory videos at HM3D width: interpolate, wobble and spin through "
       "Evaluator.render_video")
def phase_videos(seed, root: Path, gaussians, r):
    """The three trajectories of VIDEO_FRAMES frames about phase 3p (a)'s
    request, through Evaluator.render_video on its Gaussians (N =
    1,048,576): VIDEO_FRAMES fused forward launches each, every frame
    finite and at least 0 (the share above 1, which the writes clip, is
    reported); interpolate's frame 0 bit-equal to
    render_erp_views at the first context pose; one spin frame's forward
    kernel bit-equal to its plain version at the same span. Times: each
    video (host clock, its PNG or mp4 writes included) and one frame's
    render_erp_views (CUDA events)."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.geometry.transforms import trajectory_spin
    from splatter360_tpu_torch.models.decoder import render_erp_views
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import evaluator as ev_mod

    cfg = load_config(str(CONFIG), [f"dataset.image_shape=[{H},{W}]",
                                    f"test.output_path={root / 'videos'}"])
    evaluator = ev_mod.Evaluator(cfg, None, device="cuda")
    ctx = r["ctx_pose"][0]
    near, far = float(r["tgt_near"][0, 0]), float(r["tgt_far"][0, 0])
    nf = [torch.full((1, 1), v, device="cuda") for v in (near, far)]
    frames, save = {}, ev_mod.save_video

    def keep(images, path, fps=30):
        frames[Path(path).name] = images
        save(images, path, fps)

    out = {}
    launches = {k: 0 for k in comp.launch_counts}
    ev_mod.save_video = keep
    try:
        for traj in ("interpolate", "wobble", "spin"):
            for k in comp.launch_counts:
                comp.launch_counts[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluator.render_video(gaussians, ctx, near, far, root / "videos" / f"{traj}.mp4",
                                   trajectory=traj)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            got = dict(comp.launch_counts)
            for k, v in got.items():
                launches[k] += v
            expect = {k: VIDEO_FRAMES if k == comp.KERNEL_NAME else 0 for k in got}
            if got != expect:
                raise AssertionError(f"{traj}: launches {got}, expected {expect}")
            images = np.stack(frames[f"{traj}.mp4"])
            if images.shape != (VIDEO_FRAMES, H, W, 3) or not np.isfinite(images).all() \
                    or images.min() < 0.0:
                raise AssertionError(f"{traj}: frames {images.shape}, min {images.min()}, "
                                     f"finite {np.isfinite(images).all()}")
            kind, n = video_frames(root / "videos" / f"{traj}.mp4")
            if n != VIDEO_FRAMES:
                raise AssertionError(f"{traj}: {kind} with {n} frames written")
            # colours are clamped at 0 only (the 3DGS colour model, as in JAX);
            # save_video clips what lies above 1
            over = float((images > 1.0).mean())
            out[traj] = dict(video_ms=wall, written=kind, frames=n, max=float(images.max()),
                             share_over_1=over)
            print(f"  {traj}: {VIDEO_FRAMES} frames in {wall:.1f} ms ({wall / VIDEO_FRAMES:.1f} "
                  f"ms a frame, writes included; {kind}, {n} frames), values in "
                  f"[{images.min():.4f}, {images.max():.4f}], {100 * over:.4f}% above 1; "
                  f"launches {got}", flush=True)
    finally:
        ev_mod.save_video = save
    direct = render_erp_views(gaussians, ctx[0][None, None], *nf, (H, W))
    first = direct.color[0, 0].cpu().numpy()
    if not np.array_equal(first, frames["interpolate.mp4"][0]):
        raise AssertionError("interpolate's frame 0 differs from render_erp_views at the first "
                             "context pose")
    i = VIDEO_FRAMES // 3
    pose = trajectory_spin(ctx[0], float(np.linspace(0, 1, VIDEO_FRAMES)[i]))
    inp = target_inputs(gaussians, pose[None])
    err, stats = compare_kernel_plain(inp, f"spin frame {i}", exact=True)
    kernel_ms = time_cuda(lambda: fwd_calls(inp)[0](), 10)
    bound, by, _, _ = bound_ms(inp, stats)
    frame_ms = time_cuda(lambda: render_erp_views(gaussians, pose[None, None], *nf, (H, W)), 10)
    print(f"  interpolate's frame 0 bit-equal to the direct render; spin frame {i}: kernel "
          f"bit-equal to its plain version, kernel {kernel_ms:.3f} ms (bound {bound:.4f} ms by "
          f"{by}; plain {stats['plain_ms']:.1f} ms); one frame's render_erp_views "
          f"{frame_ms:.3f} ms (CUDA events)", flush=True)
    return dict(trajectories=out, launches=launches, frame_ms=frame_ms, err=err,
                kernel_ms=kernel_ms, bound_ms=bound, bound_by=by, plain_ms=stats["plain_ms"])


def scan_gpu_vs_cpu(attrs, assignments, shape, wrap_x, label):
    """composite_tiles_scan on the card against the CPU on the same inputs,
    the planes at the compositor bars (tests/test_torch_cuda.py holds its
    gradients too)."""
    from splatter360_tpu_torch.ops.composite_scan import composite_tiles_scan

    res = {}
    for dev in ("cpu", "cuda"):
        asg = [type(x)(*(moved(f, dev) for f in x)) for x in assignments]
        with torch.no_grad():
            res[dev] = [x.cpu() for x in composite_tiles_scan(
                asg, attrs.to(dev), shape, torch.zeros(3, device=dev), wrap_x)]
    errs = {}
    for i, (name, atol) in enumerate((("color", ATOL_RGB), ("alpha", ATOL_RGB),
                                      ("depth", ATOL_DEPTH))):
        errs[name] = float((res["cpu"][i] - res["cuda"][i]).abs().max())
        if errs[name] > atol:
            raise AssertionError(f"{label}: scan {name} card vs CPU {errs[name]:.2e} > {atol:g}")
    print(f"  {label}: card vs CPU colour {errs['color']:.2e}, alpha {errs['alpha']:.2e}, "
          f"depth {errs['depth']:.2e}", flush=True)
    return errs


@phase("3n (d). configs/synthetic_smoke.yaml as written (render_backend jax): mode=train, "
       "then mode=test, through the scan compositor")
def phase_smoke_config(seed):
    """Two synthetic scenes at the config's 128x256 (a train one, a test
    one), mode=train for SMOKE_STEPS steps overriding only dataset.roots,
    output_dir and trainer.max_steps (cube supervision, remat_faces, a
    sanity validation), then mode=test of its checkpoint: every render goes
    through the scan compositor and no kernel launches; ms a step and the
    peak. Then one card render of an ERP view against the CPU's on the same
    inputs."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.main import main as cli_main
    from splatter360_tpu_torch.ops import composite_scan as scan
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.ops.rasterizer import batch_inputs
    from splatter360_tpu_torch.serve import build_model, encode
    from splatter360_tpu_torch.train import checkpoint as ckpt

    cfg = load_config(str(SMOKE_CONFIG))
    if (cfg.train.render_backend, cfg.train.supervision) != ("jax", "cubes"):
        raise AssertionError(f"{SMOKE_CONFIG.name}: {cfg.train}")
    shape = tuple(cfg.dataset.image_shape)
    root = Path(tempfile.mkdtemp(prefix="splat360_smoke_"))
    try:
        for split, name, s in (("train", "s0", seed + 50), ("test", "t0", seed + 51)):
            write_synthetic_scene(root / "data", split, name, n_frames=12, image_shape=shape,
                                  n_gaussians=1500, seed=s)
        out = root / "run"
        before = scan.scan_counts[scan.SCAN_NAME]
        tr = train_run(f"(d) {SMOKE_CONFIG.name} mode=train, {SMOKE_STEPS} steps",
                       [str(SMOKE_CONFIG), f"dataset.roots=[{root / 'data'}]",
                        f"output_dir={out}", f"trainer.max_steps={SMOKE_STEPS}"])
        tr["scan_renders"] = scan.scan_counts[scan.SCAN_NAME] - before
        # each step renders each target view's faces, and again in the
        # backward (remat_faces); the sanity validation its 2 views and 12
        # video frames
        n_tgt = cfg.dataset.view_sampler.num_target_views
        want = SMOKE_STEPS * 2 * n_tgt + 13
        if tr["scan_renders"] != want or any(tr["launches"].values()):
            raise AssertionError(f"(d) mode=train: {tr['scan_renders']} scan renders (expected "
                                 f"{want}), kernel launches {tr['launches']}")
        # train/loss is logged at step 1 (print_log_every_n_steps 10)
        check_train_out("(d) mode=train", out, [SMOKE_STEPS], [0], [1])
        before = scan.scan_counts[scan.SCAN_NAME]
        for k in comp.launch_counts:
            comp.launch_counts[k] = 0
        t0 = time.perf_counter()
        scores = cli_main([str(SMOKE_CONFIG), "mode=test", f"dataset.roots=[{root / 'data'}]",
                           f"output_dir={out}", f"test.output_path={root / 'test'}"])
        test_s = time.perf_counter() - t0
        test_scans = scan.scan_counts[scan.SCAN_NAME] - before
        if test_scans < 1 or any(comp.launch_counts.values()):
            raise AssertionError(f"(d) mode=test: {test_scans} scan renders, kernel launches "
                                 f"{comp.launch_counts}")
        avg = json.loads((root / "test" / "scores_all_avg.json").read_text())
        if not all(math.isfinite(v) for v in avg.values()) or not scores:
            raise AssertionError(f"(d) mode=test: scores {avg}")
        if not any((root / "test" / "t0" / "color").glob("*.png")):
            raise AssertionError("(d) mode=test: no t0/color images")
        print(f"(d) mode=test: {test_s:.1f} s, {test_scans} scan renders; psnr "
              f"{avg['psnr']:.3f} ssim {avg['ssim']:.4f}", flush=True)

        # one card render against the CPU's, on the trained model's Gaussians
        model = build_model(cfg.model, device="cuda")
        state = torch.load(out / "checkpoints" / str(SMOKE_STEPS) / ckpt.FILE,
                           map_location="cuda", weights_only=True)["params"]
        model.load_state_dict(state)
        gen = torch.Generator(device="cuda").manual_seed(seed + 52)
        img = torch.rand((1, 2, *shape, 3), generator=gen, device="cuda")
        pose = torch.eye(4, device="cuda").repeat(1, 2, 1, 1)
        pose[0, 1, :3, 3] = torch.tensor([0.3, 0.0, 0.2], device="cuda")
        near, far = (torch.full((1, 2), x, device="cuda") for x in (cfg.dataset.near,
                                                                   cfg.dataset.far))
        g, _ = encode(model, img, pose, near, far)
        g = [x[0].cpu() for x in g]
        c2w = torch.eye(4)[None]
        c2w[0, :3, 3] = torch.tensor([0.1, 0.0, 0.1])
        with torch.no_grad():
            attrs, asg, wrap = batch_inputs(*g, c2w, shape, cfg.dataset.near, cfg.dataset.far)
        erp = scan_gpu_vs_cpu(attrs, asg, shape, wrap, f"{shape[0]}x{shape[1]} ERP view")
        tr.pop("printed", None)
        return dict(train=tr, test=dict(wall_s=test_s, scan_renders=test_scans, scores=avg),
                    card_vs_cpu=erp)
    finally:
        shutil.rmtree(root, ignore_errors=True)


@phase("3n (e). a 64x128 ERP view with backend pallas goes through the scan compositor")
def phase_narrow_erp(seed):
    """render_tiled at 64x128 (one tile column) with backend "pallas": the
    scan compositor renders it, no kernel launches, and it equals
    composite_tiles_scan called on the same inputs, bit for bit."""
    from splatter360_tpu_torch.ops import composite_scan as scan
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.ops.rasterizer import batch_inputs, render_tiled

    means, covs, sh, opac = (torch.as_tensor(x, device="cuda")
                             for x in bench_scene(seed + 60, 20000, sh_degree=2))
    c2w = torch.eye(4, device="cuda")
    shape = (64, 128)
    before, calls = scan.scan_counts[scan.SCAN_NAME], dict(comp.launch_counts)
    out = render_tiled(means, covs, sh, opac, c2w, shape, backend="pallas", render_depth=True)
    torch.cuda.synchronize()
    if scan.scan_counts[scan.SCAN_NAME] != before + 1 or comp.launch_counts != calls:
        raise AssertionError(f"narrow ERP: scan renders {scan.scan_counts[scan.SCAN_NAME] - before}"
                             f", kernel launches {comp.launch_counts}")
    attrs, asg, wrap = batch_inputs(means, covs, sh, opac, c2w[None], shape, 0.1, 100.0)
    rgb, alpha, depth = scan.composite_tiles_scan(asg, attrs, shape,
                                                  torch.zeros(3, device="cuda"), wrap, 512)
    for name, a, b in (("color", out.color, rgb[0]), ("alpha", out.alpha, alpha[0]),
                       ("depth", out.depth, depth[0])):
        if not torch.equal(a, b):
            raise AssertionError(f"narrow ERP {name}: render_tiled differs from the scan "
                                 f"called directly by {float((a - b).abs().max()):.2e}")
    if not (bool(torch.isfinite(out.color).all()) and float(out.alpha.max()) > 0.5):
        raise AssertionError("narrow ERP: empty or non-finite render")
    print(f"  64x128 ERP: 1 scan render, no kernel launch, equal to the scan called directly; "
          f"alpha max {float(out.alpha.max()):.3f}", flush=True)
    return dict(scan_renders=1)


def fwd_row(label, res, unfused):
    """A forward kernel's row on res["inp"]: its ms (CUDA events), the plain
    version's ms and the bound from res["stats"] (compare_kernel_plain's)."""
    inp = res["inp"]
    ms = time_cuda(fwd_calls(inp, unfused)[0], iters=20)
    plain_ms = res["stats"]["plain_ms"]
    b_ms, b_by, ops_ms, bytes_ms = bound_ms(inp, res["stats"], unfused)
    print(f"[{label}] kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
          f"set by {b_by} (operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
          f"blocks {res['stats']['blocks_processed']}, "
          f"gated pairs {res['stats']['pairs_alive']}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def bwd_row(label, res, unfused):
    """A backward kernel's row on res["args"] (compare_bwd_plain's or
    compare_unfused_bwd_plain's): its ms at BWD_SPAN, the plain version's ms
    and the bound from res["stats"]."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    args, inp = res["args"], res["inp"]
    backward = comp.composite_backward_unfused if unfused else comp.composite_backward
    ms = time_cuda(lambda: backward(*args), iters=10)
    b_ms, b_by, ops_ms, bytes_ms = bwd_bound_ms(inp, res["stats"], unfused)
    print(f"[{label}] kernel {ms:.3f} ms (span {comp.BWD_SPAN}), plain {res['plain_ms']:.1f} "
          f"ms, bound {b_ms:.4f} ms set by {b_by} (operations {ops_ms:.4f} ms, bytes "
          f"{bytes_ms:.4f} ms), {res['stats']}")
    return dict(ms=ms, plain_ms=res["plain_ms"], bound_ms=b_ms, bound_by=b_by)


ORBAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "torch_orbax_hm3d"
ORBAX_STEP = 1234
ORBAX_LEAVES = 616  # tensors of hm3d.yaml's encoder (16,671,350 parameters)
ORBAX_STEPS = 2  # bf16 steps resumed from the fixture
ORBAX_SCENES = 2  # test scenes of its mode=test


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """{dotted key path: leaf} of the orbax reader's nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = v
    return out


@phase("3q (a). the zstd runtime library and the native scene-shard loader, built without "
       "zstd's headers")
def phase_zstd_loader(seed, root: Path):
    """The libzstd.so.1 that utils/zstd.py loads and the native loader
    (loader.cpp linked to that library) built; one 512x1024 scene through
    save_scene and load_scene as .s3z, read back equal (cli_scenes). The
    binding's decoder runs in (b), on the fixture's frames (written without
    a content size, as orbax writes them)."""
    from splatter360_tpu_torch import native
    from splatter360_tpu_torch.utils import zstd

    lib = zstd.library_path()
    if not native.available():
        raise AssertionError(f"the native scene-shard loader did not build: "
                             f"{native.build_error()}")
    loader = Path(native._LIB._name).name
    t0 = time.perf_counter()
    fmt = cli_scenes(root / "zstd_data", seed + 70, "test", 1, CLI_FRAMES)
    scene_s = time.perf_counter() - t0
    if fmt != ".s3z":
        raise AssertionError(f"a scene was written as {fmt}, not .s3z")
    shard = next((root / "zstd_data" / "test").glob("*.s3z"))
    print(f"libzstd: {lib}; native loader {loader} built; 1 scene of {CLI_FRAMES} frames of "
          f"{H}x{W} written as {fmt} ({shard.stat().st_size} bytes) and read back equal in "
          f"{scene_s:.2f} s", flush=True)
    return dict(libzstd=lib, loader=loader, scene_format=fmt, scene_s=scene_s)


@phase("3q (b). the committed orbax checkpoint of hm3d.yaml's train state (step 1234), read "
       "without orbax or tensorstore: every leaf's sha256")
def phase_orbax_fixture(seed, root: Path):
    """A copy of tests/data/torch_orbax_hm3d read by train/orbax_reader.py
    (OCDBT manifest and B+tree nodes, zstd frames without a content size,
    zarr v2 chunks): every leaf's shape, dtype and sha256 against
    expected.json, 616 parameter tensors, the step 1234. Returns the copy's
    directory, the tree and the read's seconds."""
    import hashlib

    from splatter360_tpu_torch.train import orbax_reader

    ckpt_dir = root / "orbax_ckpt"
    shutil.copytree(ORBAX_FIXTURE, ckpt_dir)
    t0 = time.perf_counter()
    tree = orbax_reader.read_checkpoint(ckpt_dir / str(ORBAX_STEP))
    read_s = time.perf_counter() - t0
    expected = json.loads((ckpt_dir / "expected.json").read_text())
    got = flat_tree(tree)
    if sorted(got) != sorted(expected):
        raise AssertionError(f"the fixture's keys differ from expected.json: "
                             f"{sorted(set(got) ^ set(expected))[:5]}")
    for k, rec in expected.items():
        arr = np.ascontiguousarray(got[k])
        mine = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                    sha256=hashlib.sha256(arr.tobytes()).hexdigest())
        if mine != rec:
            raise AssertionError(f"fixture leaf {k}: {mine}, expected {rec}")
    n_params = len(flat_tree(tree["params"]))
    if n_params != ORBAX_LEAVES or int(tree["step"]) != ORBAX_STEP:
        raise AssertionError(f"the fixture holds {n_params} parameter tensors at step "
                             f"{int(tree['step'])}")
    size = sum(p.stat().st_size for p in ORBAX_FIXTURE.rglob("*") if p.is_file())
    print(f"{len(expected)} leaves ({n_params} parameter tensors, step {int(tree['step'])}) read "
          f"in {read_s:.2f} s from {size} bytes; every sha256 equals expected.json", flush=True)
    return dict(dir=ckpt_dir, tree=tree, read_s=read_s, leaves=len(expected), bytes=size)


@phase("3q (c). mode=test on configs/hm3d.yaml with checkpointing.load at the JAX package's "
       "orbax checkpoint: 2 scenes through the fused forward kernel")
def phase_orbax_eval(seed, root: Path, fixture):
    """hm3d.yaml's mode=test on 2 seeded 512x1024 test scenes with
    checkpointing.load at (b)'s copy: the restored weights bit-equal to
    convert.torch_state_from_flax of the tree (cli_run), the line naming
    the orbax checkpoint at step 1234 printed and the random-weights
    warning not, one fused forward launch a scene."""
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.ops.cuda import composite as comp

    fwd = comp.KERNEL_NAME
    saved = torch_state_from_flax(fixture["tree"]["params"])
    data = root / "orbax_test_data"
    fmt = cli_scenes(data, seed + 71, "test", ORBAX_SCENES, CLI_FRAMES)
    tee = Tee()
    with contextlib.redirect_stdout(tee):
        ev = cli_run("(c) mode=test of the orbax checkpoint",
                     [str(CONFIG), "mode=test", f"dataset.roots=[{data}]",
                      f"checkpointing.load={fixture['dir']}", "test.eval_depth=true",
                      "test.eval_time_skip_steps=1", f"test.output_path={root / 'orbax_test'}"],
                     fwd, saved)
    printed = tee.text()
    if "random weights" in printed:
        raise AssertionError("(c) mode=test evaluated random weights")
    line = f"the JAX package's orbax checkpoint at step {ORBAX_STEP}"
    if line not in printed:
        raise AssertionError(f"(c) mode=test did not print {line!r}")
    if ev["launches"][fwd] != ORBAX_SCENES or any(
            ev["launches"][k] for k in ev["launches"] if k != fwd):
        raise AssertionError(f"(c) launches {ev['launches']}, expected {ORBAX_SCENES} fused "
                             f"forward")
    print(f"  (c) scenes written as {fmt}; restored {len(saved)} tensors bit-equal to the "
          f"converted tree", flush=True)
    return ev


@phase("3q (d). mode=train resumed from the orbax checkpoint: 2 bf16 steps from step 1234 "
       "through the fused pair, then the port's own step 1236 is the latest")
def phase_orbax_resume(seed, root: Path, fixture):
    """hm3d.yaml's mode=train (bf16, B = 1, no validation) over
    <output_dir>/checkpoints holding the fixture's step 1234: the restore
    checked (parameters bit-equal to the converted tree, Adam's moments to
    the converted mu and nu, its step 1234 on every tensor), "resumed from
    step 1234" printed, the first step's learning rate learning_rate(cfg,
    1234), ORBAX_STEPS steps timed with one fused forward and one fused
    backward launch each; then latest_step and describe pick the port's
    checkpoint.pt of step 1236 beside the orbax step."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train import trainer
    from splatter360_tpu_torch.train.state import learning_rate

    fwd, bwd = comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    tree = fixture["tree"]
    params = torch_state_from_flax(tree["params"])
    adam = tree["opt_state"]["1"]["0"]
    moments = {"exp_avg": torch_state_from_flax(adam["mu"]),
               "exp_avg_sq": torch_state_from_flax(adam["nu"])}
    data, out = root / "orbax_train_data", root / "orbax_run"
    cli_scenes(data, seed + 72, "train", 2, TRAIN_FRAMES)
    shutil.copytree(fixture["dir"] / str(ORBAX_STEP), out / "checkpoints" / str(ORBAX_STEP))
    restored = {}

    def same_as_tree(state, directory):
        opt = state.optimizer.state_dict()["state"]
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        steps = {float(entry["step"]) for entry in opt.values()}
        restored["adam_step"] = sorted(steps)
        restored["ok"] = (state.step == ORBAX_STEP and steps == {float(ORBAX_STEP)} and all(
            torch.equal(v.cpu(), params[k]) for k, v in state.model.state_dict().items())
            and all(torch.equal(opt[i][key].cpu(), moments[key][n])
                    for i, n in enumerate(names) for key in moments))
        print(f"  (d) restored step {state.step}, Adam's step {sorted(steps)} on "
              f"{len(opt)} tensors", flush=True)

    lrs = []
    step_fn = trainer.train_step

    def lr_step(state, batch, **kw):
        out_metrics = step_fn(state, batch, **kw)
        lrs.append((state.step - 1, state.optimizer.param_groups[0]["lr"]))
        return out_metrics

    final = ORBAX_STEP + ORBAX_STEPS
    trainer.train_step = lr_step
    try:
        tr = train_run(f"(d) mode=train resumed from the orbax step, bf16, {ORBAX_STEPS} steps",
                       [str(CONFIG), "mode=train", f"dataset.roots=[{data}]", f"output_dir={out}",
                        "trainer.batch_size=1", f"trainer.max_steps={final}",
                        f"checkpointing.every_n_train_steps={ORBAX_STEPS}",
                        "trainer.num_sanity_val_steps=0", "trainer.val_check_interval=0",
                        "trainer.print_log_every_n_steps=1"], restore_check=same_as_tree)
    finally:
        trainer.train_step = step_fn
    line = f"resumed from step {ORBAX_STEP} (the JAX package's orbax checkpoint"
    if line not in tr["printed"]:
        raise AssertionError(f"(d) no {line!r} line")
    if not restored.get("ok"):
        raise AssertionError("(d) parameters, Adam's moments or step not restored as read")
    ocfg = load_config(str(CONFIG)).train.optimizer
    want_lr = [(s, learning_rate(ocfg, s)) for s in range(ORBAX_STEP, final)]
    if lrs != want_lr:
        raise AssertionError(f"(d) learning rates {lrs}, expected {want_lr}")
    if tr["step"] != final or (tr["launches"][fwd], tr["launches"][bwd]) != (ORBAX_STEPS,
                                                                             ORBAX_STEPS):
        raise AssertionError(f"(d) step {tr['step']}, launches {tr['launches']}")
    check_train_out("(d)", out, [final], [], list(range(ORBAX_STEP + 1, final + 1)))
    latest = ckpt.latest_step(out / "checkpoints")
    said = ckpt.describe(out / "checkpoints")
    if latest != final or "checkpoint.pt" not in said:
        raise AssertionError(f"(d) the next resume would take {latest} ({said})")
    saved = torch.load(out / "checkpoints" / str(final) / ckpt.FILE, map_location="cpu",
                       weights_only=True)
    if saved["step"] != final or {float(e["step"]) for e in
                                  saved["opt_state"]["state"].values()} != {float(final)}:
        raise AssertionError(f"(d) step {final}'s checkpoint.pt holds step {saved['step']}")
    print(f"  (d) learning rates {lrs}; the next resume takes {said}", flush=True)
    tr.pop("printed", None)
    return dict(tr, lrs=lrs, adam_step=restored["adam_step"], next_resume=said)


@phase("3q (e). checkpointing.pretrained_model at the orbax checkpoint: weights only, step 0")
def phase_orbax_pretrained(seed, root: Path, fixture):
    """hm3d.yaml's mode=train with checkpointing.pretrained_model at (b)'s
    copy and trainer.max_steps=0: the line naming the orbax checkpoint
    printed, the run's step 0 and its step-0 checkpoint.pt holding the
    converted tree's parameters bit for bit and fresh Adam moments."""
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt

    params = torch_state_from_flax(fixture["tree"]["params"])
    data, out = root / "orbax_train_data", root / "orbax_pretrained"
    tr = train_run("(e) mode=train with pretrained_model, 0 steps",
                   [str(CONFIG), "mode=train", f"dataset.roots=[{data}]", f"output_dir={out}",
                    f"checkpointing.pretrained_model={fixture['dir']}", "trainer.batch_size=1",
                    "trainer.max_steps=0", "trainer.num_sanity_val_steps=0",
                    "trainer.val_check_interval=0"])
    line = (f"warm-started weights from pretrained_model (the JAX package's orbax checkpoint at "
            f"step {ORBAX_STEP})")
    if line not in tr["printed"]:
        raise AssertionError(f"(e) no {line!r} line")
    saved = torch.load(out / "checkpoints" / "0" / ckpt.FILE, map_location="cpu",
                       weights_only=True)
    if tr["step"] != 0 or saved["step"] != 0 or saved["opt_state"]["state"]:
        raise AssertionError(f"(e) step {tr['step']}, Adam state "
                             f"{len(saved['opt_state']['state'])} tensors")
    if sorted(saved["params"]) != sorted(params) or not all(
            torch.equal(saved["params"][k], v) for k, v in params.items()):
        raise AssertionError("(e) the warm-started weights differ from the converted tree")
    print(f"  (e) step 0, {len(params)} tensors bit-equal to the converted tree", flush=True)
    tr.pop("printed", None)
    return tr


# phase 3s: generated scenes (preprocess/): the CLI's train and test scenes,
# frames a scene, the room's Gaussian spacing (the generator's default,
# ~19k Gaussians a room) and (a)'s small room
GEN_TRAIN, GEN_TEST, GEN_FRAMES, GEN_SPACING = 2, 1, 12, 0.09
GEN_SMALL = dict(seed=3, spacing=0.25, sh_degree=1)
# (a): the card's batched compositor against the walk on the CPU, each plane
# within DENSE_ULPS float32 ULPs of its max|x| (exp rounds differently on the
# two devices); the walk without the transmittance cut (a contribution after
# T falls below 1e-4), the control, must be past that bar
DENSE_ULPS = 8
# (b)'s cube-rig frame against the direct one on the central band: the JAX
# package's bars (tests/test_preprocess.py:64-78)
CUBE_COLOR_MAE, CUBE_DEPTH_MEDIAN_REL = 0.035, 0.05
# (d): render_projections' panels card against CPU
PROJ_RES = 256


def walk_one_at_a_time(proj, colors, opacities, image_shape, background, wrap_x, depth_vals,
                       t_cut=1e-4):
    """The dense compositor (ops/rasterizer_ref.composite_dense) as it was
    before it went in chunks: one step of full-image tensor ops a sorted
    Gaussian, ~25 launches a step on the card; a Gaussian contributes while
    T after it stays at or above `t_cut`."""
    h, w = image_shape
    order = torch.argsort(torch.where(proj.valid, proj.depth,
                                      torch.full_like(proj.depth, math.inf)), stable=True)
    mean2d, conic, col = proj.mean2d[order], proj.conic[order], colors[order]
    op = torch.where(proj.valid, opacities, torch.zeros_like(opacities))[order]
    dep, rad = depth_vals[order], proj.radius[order]
    dev = mean2d.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=mean2d.dtype, device=dev),
                            torch.arange(w, dtype=mean2d.dtype, device=dev), indexing="ij")
    rgb = torch.zeros((h, w, col.shape[-1]), device=dev)
    trans, dacc = torch.ones((h, w), device=dev), torch.zeros((h, w), device=dev)
    for m, cn, c, o, d, r in zip(mean2d, conic, col, op, dep, rad):
        dx = xx - m[0]
        if wrap_x:
            dx = dx - w * torch.round(dx / w)
        dy = yy - m[1]
        power = -0.5 * (cn[0] * dx * dx + cn[2] * dy * dy) - cn[1] * dx * dy
        alpha = torch.clamp(o * torch.exp(power), max=0.99)
        inside = (torch.abs(dx) <= r[0]) & (torch.abs(dy) <= r[1])
        alpha = torch.where(inside & (power > -4.5) & (power <= 0.0) & (alpha >= 1.0 / 255.0),
                            alpha, torch.zeros_like(alpha))
        trans_new = trans * (1.0 - alpha)
        weight = torch.where(trans_new >= t_cut, alpha * trans, torch.zeros_like(alpha))
        rgb = rgb + weight[..., None] * c
        dacc = dacc + weight * d
        trans = trans_new
    return rgb + trans[..., None] * background, trans, dacc


def walk_chunks_in_order(proj, colors, opacities, image_shape, background, wrap_x,
                         depth_vals):
    """composite_dense with each chunk's K alpha slices walked in order over
    its window, the dead ones as zeros, in place of moving each pixel's
    live Gaussians to the front: the same products and sums (a zero alpha
    leaves T, colour and depth as they were), one step a Gaussian."""
    from splatter360_tpu_torch.ops import rasterizer_ref as rr

    h, w = image_shape
    order = torch.argsort(torch.where(proj.valid, proj.depth,
                                      torch.full_like(proj.depth, math.inf)), stable=True)
    mean2d, conic, col = proj.mean2d[order], proj.conic[order], colors[order]
    op = torch.where(proj.valid, opacities, torch.zeros_like(opacities))[order]
    dep, rad = depth_vals[order], proj.radius[order]
    dt, dev = mean2d.dtype, mean2d.device
    rgb = torch.zeros((h, w, col.shape[-1]), dtype=col.dtype, device=dev)
    trans = torch.ones((h, w), dtype=col.dtype, device=dev)
    dacc = torch.zeros((h, w), dtype=col.dtype, device=dev)
    k = max(1, (rr.CHUNK_BYTES if dev.type == "cuda" else rr.HOST_CHUNK_BYTES) // (4 * h * w))
    for s in range(0, mean2d.shape[0], k):
        m, cn, r, o = mean2d[s:s + k], conic[s:s + k], rad[s:s + k], op[s:s + k]
        on = (o > 0)[:, None]
        box = torch.cat([torch.where(on, m - r, math.inf).amin(0),
                         torch.where(on, m + r, -math.inf).amax(0)]).tolist()
        if not all(map(math.isfinite, box)):
            if box[0] == math.inf:
                continue
            box = [0, 0, w, h]
        x0, y0 = (max(math.floor(v) - 1, 0) for v in box[:2])
        x1, y1 = min(math.ceil(box[2]) + 2, w), min(math.ceil(box[3]) + 2, h)
        if wrap_x:
            x0, x1 = 0, w
        if x0 >= x1 or y0 >= y1:
            continue
        xx = torch.arange(x0, x1, dtype=dt, device=dev)[None, None, :]
        yy = torch.arange(y0, y1, dtype=dt, device=dev)[None, :, None]
        m, cn = m[:, :, None, None], cn[:, :, None, None]
        dx = xx - m[:, 0]
        if wrap_x:
            dx = dx - w * torch.round(dx / w)
        dy = yy - m[:, 1]
        power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * dx * dy
        alpha = torch.clamp(o[:, None, None] * torch.exp(power), max=0.99)
        inside = (torch.abs(dx) <= r[:, 0, None, None]) & (torch.abs(dy) <= r[:, 1, None, None])
        live = inside & (power > -4.5) & (power <= 0.0) & (alpha >= 1.0 / 255.0)
        a = torch.where(live, alpha, torch.zeros_like(alpha))
        win = (slice(y0, y1), slice(x0, x1))
        t, acc_c, acc_d = trans[win].clone(), rgb[win].clone(), dacc[win].clone()
        for j in range(a.shape[0]):
            t_new = t * (1.0 - a[j])
            weight = torch.where(t_new >= 1e-4, a[j] * t, torch.zeros_like(a[j]))
            acc_c = acc_c + weight[..., None] * col[s + j]
            acc_d = acc_d + weight * dep[s + j]
            t = t_new
        trans[win], rgb[win], dacc[win] = t, acc_c, acc_d
    return rgb + trans[..., None] * background, trans, dacc


def dense_inputs(world, shape, device):
    """composite_dense's inputs for the first pose of a 12-frame trajectory
    through `world`, projected on the CPU and moved to `device`."""
    from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
    from splatter360_tpu_torch.preprocess import sample_trajectory

    c2w = torch.as_tensor(sample_trajectory(world, GEN_FRAMES, seed=3)[0])
    g = [torch.as_tensor(a) for a in (world.means, world.covariances, world.harmonics,
                                      world.opacities)]
    proj = project_erp(g[0], g[1], c2w, shape, 0.05)
    cols = sh_colors(g[2], g[0], c2w[:3, 3], int(math.isqrt(g[2].shape[-1])) - 1)
    proj = type(proj)(*(None if t is None else t.to(device) for t in proj))
    return [proj, cols.to(device), g[3].to(device), shape, torch.zeros(3, device=device), True]


def timed_composites(args, in_order=False):
    """composite_dense, the walk and, with `in_order`, walk_chunks_in_order
    on the same inputs: outputs and ms."""
    from splatter360_tpu_torch.ops import rasterizer_ref as rr

    fns = [lambda: rr.composite_dense(*args, True, depth_vals=args[0].depth),
           lambda: walk_one_at_a_time(*args, args[0].depth)]
    if in_order:
        fns.append(lambda: walk_chunks_in_order(*args, args[0].depth))
    out, ms = [], []
    for fn in fns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(fn())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


@phase("3s (a). the batched dense compositor on the card against the walk over one Gaussian "
       "at a time: on the card at 32x64 and 512x1024, on the CPU at 32x64")
def phase_dense_walk(seed):
    """ERP frames projected on the CPU, so that both devices composite the
    same inputs: composite_dense on the card bit-equal to the walk on the
    card, on a 32x64 frame of build_room_world(**GEN_SMALL) (2,382
    Gaussians) and on a 512x1024 frame of the default room (~19k), each
    with its time, and at 512x1024 walk_chunks_in_order too, bit-equal and
    timed; at 32x64 within DENSE_ULPS of the walk on the CPU, and the CPU's
    walk without the transmittance cut (the control) past that bar."""
    from splatter360_tpu_torch.preprocess import build_room_world

    names = ("colour", "transmittance", "depth")
    res = {}
    for label, world, shape in (
            ("small", build_room_world(**GEN_SMALL), (32, 64)),
            ("hm3d", build_room_world(seed=3, spacing=GEN_SPACING), (H, W))):
        args = dense_inputs(world, shape, "cuda")
        outs, ms = timed_composites(args, in_order=label == "hm3d")
        got = outs[0]
        same = {n: all(torch.equal(a, o[i]) for o in outs[1:])
                for i, (n, a) in enumerate(zip(names, got))}
        res[label] = dict(n_gaussians=int(world.means.shape[0]), shape=shape,
                          bit_equal_card_walk=same, batched_ms=ms[0], walk_ms=ms[1])
        if len(ms) > 2:
            res[label]["in_order_ms"] = ms[2]
        if label == "small":
            cpu_args = dense_inputs(world, shape, "cpu")
            walks = {cut: walk_one_at_a_time(*cpu_args, cpu_args[0].depth, t_cut=cut)
                     for cut in (1e-4, 0.0)}
            res[label]["bars"] = {
                n: DENSE_ULPS * torch.finfo(torch.float32).eps * float(b.abs().max())
                for n, b in zip(names, walks[1e-4])}
            for key, cut in (("cpu_walk_distance", 1e-4), ("control_distance", 0.0)):
                res[label][key] = {n: float((a.cpu() - b).abs().max())
                                   for n, a, b in zip(names, got, walks[cut])}
        print(f"{label}: {res[label]}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"{label}: the batched compositor differs from a walk on "
                                 f"the card: {same}")
        del got, outs, args
    small = res["small"]
    if any(small["cpu_walk_distance"][n] > small["bars"][n] for n in names):
        raise AssertionError("the batched compositor on the card is past DENSE_ULPS of the "
                             "CPU's walk")
    if all(small["control_distance"][n] <= small["bars"][n] for n in names):
        raise AssertionError("the walk without the transmittance cut is within DENSE_ULPS: "
                             "the bar cannot see it")
    return res


@phase("3s (b). python -m splatter360_tpu_torch.preprocess at HM3D width: 2 train and 1 test "
       "scenes of 12 frames of 512x1024 with --validate, and one frame through the cube rig")
def phase_generate(seed, root: Path):
    """The CLI on the card at the generator's default spacing: ms a frame
    (the renders of a scene over its frames, synchronized), s a scene,
    retries, peak memory (above what earlier phases hold), the --validate
    statistics; then one frame of the test scene's room through the cube
    rig (6 faces of 256x256, stitched) against the direct frame on the
    central band."""
    from splatter360_tpu_torch.preprocess import __main__ as cli
    from splatter360_tpu_torch.preprocess import generate, sample_trajectory
    from splatter360_tpu_torch.preprocess.scene_builder import build_room_world

    render, scene_fn = generate._render_frames, cli.generate_scene
    frames_s, scene_s = [], []

    def timed(fn, record):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            record(a, time.perf_counter() - t0)
            return out
        return run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    generate._render_frames = timed(render, lambda a, s: frames_s.append(
        (len(a[1]), s, int(a[0].means.shape[0]))))
    cli.generate_scene = timed(scene_fn, lambda a, s: scene_s.append(s))
    t0 = time.perf_counter()
    try:
        infos = cli.main([str(root), str(GEN_TRAIN), str(GEN_TEST), "--frames", str(GEN_FRAMES),
                          "--shape", f"{H}x{W}", "--spacing", str(GEN_SPACING),
                          "--seed", str(seed), "--validate"])
    finally:
        generate._render_frames, cli.generate_scene = render, scene_fn
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    if len(infos) != GEN_TRAIN + GEN_TEST:
        raise AssertionError(f"{len(infos)} scenes generated")
    frame_ms = [1e3 * s / n for n, s, _ in frames_s]
    print(f"{len(infos)} scenes in {wall:.1f} s with --validate: s a scene (world, "
          f"trajectory, renders, files) {[round(x, 2) for x in scene_s]}; "
          f"{len(frames_s)} trajectories rendered (retries {[i['rejections'] for i in infos]}), "
          f"Gaussians {[n for _, _, n in frames_s]}, ms a 512x1024 frame "
          f"{[round(ms, 1) for ms in frame_ms]}, peak {peak:.2f} GiB over the {held:.2f} GiB "
          f"held by earlier phases; consistency {[i['consistency'] for i in infos]}",
          flush=True)

    # the cube rig against the direct render: the middle frame of the first
    # trajectory drawn for the test scene
    test_seed = seed + 10_000
    world = build_room_world(seed=test_seed, spacing=GEN_SPACING)
    pose = sample_trajectory(world, GEN_FRAMES, seed=test_seed)[GEN_FRAMES // 2][None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cub = render(world, pose, (H, W), True, 30.0)[0]
    cube_ms = 1e3 * (time.perf_counter() - t0)
    erp = render(world, pose, (H, W), False, 30.0)[0]
    band = slice(H // 4, 3 * H // 4)
    color_mae = float(np.abs(erp[0][band] - cub[0][band]).mean())
    d_erp = erp[1][band] / np.maximum(erp[2][band], 1e-6)
    d_cub = cub[1][band] / np.maximum(cub[2][band], 1e-6)
    rel = float(np.median(np.abs(d_erp - d_cub) / np.maximum(d_erp, 0.2)))
    print(f"cube rig frame (6 faces of {H // 2}x{H // 2}, stitched) {cube_ms:.1f} ms; against "
          f"the direct frame on the central band: colour MAE {color_mae:.4f} (bar "
          f"{CUBE_COLOR_MAE}), median relative depth {rel:.4f} (bar {CUBE_DEPTH_MEDIAN_REL})",
          flush=True)
    if not (color_mae < CUBE_COLOR_MAE and rel < CUBE_DEPTH_MEDIAN_REL):
        raise AssertionError("the cube-rig frame misses the direct frame's bars")
    return dict(infos=infos, wall_s=wall, frame_ms=frame_ms, scene_s=scene_s,
                trajectories=[dict(frames=n, s=s, gaussians=g) for n, s, g in frames_s],
                peak_gib=peak, held_gib=held, cube_frame_ms=cube_ms, cube_color_mae=color_mae,
                cube_depth_median_rel=rel, world=world)


@phase("3s (c). mode=train (2 steps) then mode=test of its checkpoint on the generated scenes, "
       "hm3d.yaml at HM3D width")
def phase_generated_cli(seed, root: Path):
    """hm3d.yaml's mode=train on (b)'s train scenes, bf16 at B = 1, 2 steps
    with a checkpoint at step 2 (the fused pair, once a step), then
    mode=test on (b)'s test scene restoring that checkpoint's weights (the
    fused forward)."""
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train import checkpoint as ckpt

    fwd, bwd = comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    out = root / "gen_train"
    tr = train_run("(c) mode=train on the generated train scenes, 2 steps",
                   [str(CONFIG), "mode=train", f"dataset.roots=[{root}]", f"output_dir={out}",
                    "trainer.batch_size=1", "trainer.max_steps=2",
                    "checkpointing.every_n_train_steps=2", "trainer.val_check_interval=0",
                    "trainer.num_sanity_val_steps=0", "trainer.print_log_every_n_steps=1"])
    if tr["step"] != 2 or (tr["launches"][fwd], tr["launches"][bwd]) != (2, 2):
        raise AssertionError(f"(c) mode=train: step {tr['step']}, launches {tr['launches']}")
    tr.pop("printed", None)
    saved = torch.load(out / "checkpoints" / "2" / ckpt.FILE, map_location="cpu",
                       weights_only=True)["params"]
    te = cli_run("(c) mode=test on the generated test scene, the step-2 checkpoint",
                 [str(CONFIG), "mode=test", f"dataset.roots=[{root}]",
                  f"checkpointing.load={out / 'checkpoints'}", "test.eval_depth=true",
                  f"test.output_path={root / 'gen_test'}"], fwd, saved)
    return dict(train=tr, test=te)


@phase("3s (d). render_projections of a generated room at 256x256, the card against the CPU")
def phase_projections(gen):
    """utils/drawing.render_projections of (b)'s test-scene world (three
    orthographic panels, unlabelled) on the card and on the CPU, at the
    forward bar (1e-4) but for gate flips on at most 1e-3 of the pixels."""
    from splatter360_tpu_torch.utils.drawing import render_projections

    world = gen["world"]
    g = (world.means, world.covariances, world.harmonics, world.opacities)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = render_projections(*(torch.as_tensor(a, device="cuda") for a in g), PROJ_RES,
                              draw_label=False)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = render_projections(*g, PROJ_RES, draw_label=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = np.abs(card - cpu).max(-1)
    share = float((diff > ATOL_RGB).mean())
    print(f"3 panels of {PROJ_RES}x{PROJ_RES}, {world.means.shape[0]} Gaussians: card "
          f"{card_s:.2f} s, CPU {cpu_s:.2f} s; max |card - CPU| {diff.max():.2e}, past 1e-4 on "
          f"{share:.2e} of the pixels; mean colour {card.mean():.4f}", flush=True)
    if share > 1e-3 or not np.isfinite(card).all() or card.max() < 0.05:
        raise AssertionError("render_projections: the card's panels differ from the CPU's")
    return dict(card_s=card_s, cpu_s=cpu_s, max_diff=float(diff.max()), past_bar_share=share)


# phase 3r: training and evaluation across ranks (parallel/)
# (a) the emulated band ranks, (b) the emulated face ranks
BAND_RANKS, FACE_RANKS = (2, 8), (2, 4)
# (a), (b), (d): a sharded render against the unsharded one, at the bars the
# JAX package holds its own sharded renders to (tests/test_render_sharding.py:
# colour and alpha 2e-5, depth 1e-4), but for (a)'s alpha and gate flips.
# (a) and (d) hold each band render against the one-band render
# (render_erp_sharded over one rank), which bins the same tile lists, and
# (a) holds the one-band render against render_erp_views, which bins the
# opacity-tightened, culled boxes, so its lists hold fewer instances the
# gate turns away. Either way a tile's instances fall into other 128-blocks
# (a band's sorted list starts at its own first tile), which moves the
# tile's early exit and the grouping of its logT sums (ROADMAP Queue 3). A
# splat whose 3-sigma box is taller or wider than the tiling's spans is cut
# from the box's top left, so the two boxes cover it differently (0.26 on
# an H100): (a) leaves those out on both sides
SHARD_RGB_TOL, SHARD_DEPTH_TOL = 2e-5, 1e-4
# (a)'s alpha: a tile's walk ends after the first block past which every
# pixel's T is below 1e-4 (the kernels' exit), so where other blocks move
# the exit, alpha (1 - T) may differ by up to 1e-4 (9.2e-5 read on an H100
# on the flagship scene)
BAND_ALPHA_TOL = 1e-4
# (a)'s colour and depth: no weight is taken past T_i (1 - alpha) < 1e-4,
# and T_i comes from logT summed over other blocks, so a pair on that gate
# can flip in or out and move its pixel by w = alpha T_i ~ 1e-4 alpha /
# (1 - alpha) (3.76e-5 in colour read on an H100 on the flagship scene).
# tests/test_torch_serve.py's rule for such flips: past the bar on at most
# GATE_FLIP_SHARE of the values, and each within GATE_FLIP_SCALE of the
# plane's max |value|
GATE_FLIP_SHARE, GATE_FLIP_SCALE = 1e-4, 1e-2
# (c), (d): steps of each run under torchrun, and its time limit (s)
RANK_STEPS, RANK_TIMEOUT = 2, 400


def band_inp(asg, attrs, band_h):
    """compare_kernel_plain's inputs of one band (band_inputs' outputs)."""
    return dict(attrs=attrs, gidx=asg.gaussian_idx[None], tile_ids=asg.tile_ids[None],
                starts=asg.tile_starts[None], counts=asg.tile_counts[None],
                nty=asg.num_tiles_y, ntx=asg.num_tiles_x, shape=(band_h, W), wrap=True,
                dropped=[int(asg.dropped)])


def hm3d_gaussians(seed, gen):
    """hm3d.yaml's model (bf16, seeded) on one request: its 1,048,576
    Gaussians (no gradient) and the request."""
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.serve import build_model, encode

    model = build_model(HM3D, seed=seed, device="cuda")
    r = request_data(gen)
    with torch.no_grad():
        gaussians, _ = encode(model, r["image"], r["ctx_pose"], r["near"], r["far"])
    del model
    torch.cuda.empty_cache()
    if gaussians.means.shape[1] != N_CTX * H * W:
        raise AssertionError(f"{gaussians.means.shape[1]} Gaussians")
    return gaussians, r


def fit_tile_spans(leaves, views, tight=False):
    """Which Gaussians fit the tiling's spans in every view: an ERP splat
    taller than SPAN_H tile rows or wider than SPAN_W tile columns is binned
    into its first SPAN_H rows and SPAN_W columns only, counted from its
    box's top left (ops/tiling.py, as in the JAX package). A band clamps the
    box to its own rows first, and bins the 3-sigma box where the unsharded
    render bins the opacity-tightened one, so a band render covers such a
    splat elsewhere than the unsharded render (ROADMAP Queue 3). The boxes
    are the ones the bands bin, the 3-sigma boxes of the projection without
    opacities, or with `tight` the unsharded render's."""
    from splatter360_tpu_torch.ops.projection import project_erp
    from splatter360_tpu_torch.ops.tiling import SPAN_H, SPAN_W, TILE_H, TILE_W

    means, covs, _, opac = leaves
    fits = torch.ones_like(opac, dtype=torch.bool)
    with torch.no_grad():
        for c2w in views:
            p = project_erp(means, covs, c2w, (H, W), 0.1, opacities=opac if tight else None)
            (u, v), (rx, ry) = p.mean2d.unbind(-1), p.radius.unbind(-1)
            top = torch.floor((v - ry) / TILE_H).clamp(0, H // TILE_H - 1)
            bottom = torch.floor((v + ry) / TILE_H).clamp(0, H // TILE_H - 1)
            cols = torch.floor((u + rx) / TILE_W) - torch.floor((u - rx) / TILE_W) + 1
            fits &= ~p.valid | ((bottom - top + 1 <= SPAN_H) & (cols <= SPAN_W))
    return fits


def band_lists_match(leaves, c2w, k):
    """Whether each of k bands bins every tile of its rows as one band does:
    the same instances a tile in the same order (band_inputs of
    render_erp_sharded over Emulated(k) and Emulated(1), one view)."""
    from splatter360_tpu_torch.parallel import render_sharding as prs
    from splatter360_tpu_torch.parallel.mesh import Emulated

    def bands(n):
        starts, rows, band_h = prs.band_layout(H, n)
        table = prs.packed_table(*leaves, c2w, (H, W), Emulated(n), near=0.1)
        return [(s, r, prs.band_inputs(table, s, r, band_h, W)[0]) for s, r in zip(starts, rows)]

    with torch.no_grad():
        ((_, _, one),) = bands(1)
        for s, r, band in bands(k):
            ntx = band.num_tiles_x
            counts, lo = band.tile_counts[:r * ntx], int(one.tile_starts[s * ntx])
            n = int(counts.sum())
            if not (torch.equal(counts, one.tile_counts[s * ntx:(s + r) * ntx])
                    and torch.equal(band.gaussian_idx[:n], one.gaussian_idx[lo:lo + n])):
                return False
    return True


def planes(out):
    """[(colour, alpha, depth)] a view: of a list of render_erp_sharded's
    outputs, or of render_erp_views' (one batch)."""
    if isinstance(out, list):
        return [(o.color, o.alpha, o.depth) for o in out]
    return [(out.color[0, v], out.alpha[0, v], out.depth[0, v])
            for v in range(out.color.shape[1])]


def gate_flips(outs, refs):
    """Views against views (planes): for colour, alpha and depth the max
    |a - b|, the share of values past its bar, and
    whether it misses: alpha past BAND_ALPHA_TOL anywhere, colour or depth
    past SHARD_RGB_TOL / SHARD_DEPTH_TOL on more than GATE_FLIP_SHARE of the
    values or by more than GATE_FLIP_SCALE times the plane's max |value|."""
    res = {}
    for i, (name, bar) in enumerate((("colour", SHARD_RGB_TOL), ("alpha", BAND_ALPHA_TOL),
                                     ("depth", SHARD_DEPTH_TOL))):
        d = torch.stack([(o[i] - r[i]).abs() for o, r in zip(outs, refs)])
        big, past = float(d.max()), float((d > bar).float().mean())
        scale = max(float(r[i].abs().max()) for r in refs)
        res[name] = dict(max=big, past=past, miss=big > bar and (
            name == "alpha" or past > GATE_FLIP_SHARE or big > GATE_FLIP_SCALE * scale))
    return res


@phase("3r (a). band-sharded ERP decode over 2 and 8 emulated ranks, HM3D width")
def phase_band_ranks(seed):
    """First a view of the flagship scene (bench_scene, whole: its splats
    past the tiling's spans pass them in 3 sigma and in their tight boxes
    alike) band-sharded over one rank (render_erp_sharded with
    Emulated(1)) against render_erp_views, and over each k of BAND_RANKS
    against the one-band view, each band's tile lists equal to one band's
    (band_lists_match), both under gate_flips. Then the encoder's
    Gaussians of one request into N_TGT 512x1024 views,
    each band-sharded over k emulated ranks (render_erp_sharded with
    Emulated(k)): one fused forward launch a band and view; every band of
    one view through the kernel and its plain version bit for bit, with the
    kernel's ms a band, their balance (max / mean) and the whole view's
    kernel ms, on the view whose heaviest tile holds the fewest blocks (the
    plain version walks a band to its heaviest tile's last block, and a
    random encoder piles ~1,200 blocks into a tile). The views held as the
    flagship's (the lists on that view), with the splats whose 3-sigma
    boxes (the ones the bands bin) are taller or wider than the tiling's
    spans (fit_tile_spans) left out, and no instance dropped (the distance to
    render_erp_views with those splats is printed, and the count of splats
    whose tight boxes are past the spans)."""
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.parallel import render_sharding as prs
    from splatter360_tpu_torch.parallel.mesh import Emulated
    from splatter360_tpu_torch.serve import render_erp_views

    def sharded(leaves, views, k):
        with torch.no_grad():
            return [prs.render_erp_sharded(*leaves, c2w, (H, W), Emulated(k), near=0.1,
                                           render_depth=True) for c2w in views]

    def held(outs, refs, label):
        """gate_flips of the views `outs` against `refs` (planes), no
        instance dropped in `outs`."""
        flips, dropped = gate_flips(planes(outs), refs), sum(int(o.dropped) for o in outs)
        if dropped or any(st["miss"] for st in flips.values()):
            raise AssertionError(f"{label}: {flips}, dropped {dropped}")
        return flips

    def line(flips):
        return " / ".join(f"{st['max']:.2e} ({st['past']:.1e} past)" for st in flips.values())

    bars = (f"bars {SHARD_RGB_TOL} / {BAND_ALPHA_TOL} / {SHARD_DEPTH_TOL}, gate flips on at "
            f"most {GATE_FLIP_SHARE} of the values")

    # the flagship scene, whole (see the docstring)
    flagship = bench_scene(seed, N_CTX * H * W)
    eye = torch.eye(4, device="cuda")
    nf = [torch.full((1, 1), v, device="cuda") for v in (0.1, 10.0)]
    flagship_oversized = int((~fit_tile_spans(flagship, [eye])).sum())
    flagship_tight = int((~fit_tile_spans(flagship, [eye], tight=True)).sum())
    with torch.no_grad():
        flagship_ref = render_erp_views(Gaussians(*(x[None] for x in flagship)), eye[None, None],
                                        *nf, (H, W), render_depth=True)
    comp.launch_counts[comp.KERNEL_NAME] = 0
    flagship_one = sharded(flagship, [eye], 1)
    flagship_res = {1: held(flagship_one, planes(flagship_ref),
                            "the flagship's one-band view against render_erp_views")}
    flagship_one = planes(flagship_one)
    for k in BAND_RANKS:
        if not band_lists_match(flagship, eye, k):
            raise AssertionError(f"the flagship's {k} bands bin other tile lists than one band")
        flagship_res[k] = held(sharded(flagship, [eye], k), flagship_one,
                               f"the flagship's {k} bands against one band")
    flagship_launches = comp.launch_counts[comp.KERNEL_NAME]
    print(f"3r (a) the flagship scene ({flagship_oversized} splats past the tiling's spans in "
          f"3 sigma, {flagship_tight} in their tight boxes; colour / alpha / depth): one band "
          f"against render_erp_views {line(flagship_res[1])}; "
          + ", ".join(f"{k} bands against one band {line(flagship_res[k])}" for k in BAND_RANKS)
          + f" (the same tile lists); {bars}", flush=True)
    del flagship, flagship_ref, flagship_one

    gaussians, r = hm3d_gaussians(seed, torch.Generator(device="cuda").manual_seed(seed + 80))
    leaves = [x[0] for x in gaussians]
    views = list(r["tgt_pose"][0])
    fits = fit_tile_spans(leaves, views)
    # the splats that fit, as many as a multiple of every band count, so
    # that no band render pads the table with rows of its own
    keep = torch.nonzero(fits).squeeze(1)
    fitting = [x[keep[:len(keep) - len(keep) % math.lcm(*BAND_RANKS)]] for x in leaves]
    refs = {}
    with torch.no_grad():
        for name, g in (("all", leaves), ("fitting", fitting)):
            refs[name] = planes(render_erp_views(Gaussians(*(x[None] for x in g)), r["tgt_pose"],
                                                 r["tgt_near"], r["tgt_far"], (H, W),
                                                 render_depth=True))
    oversized = int((~fits).sum())
    oversized_tight = int((~fit_tile_spans(leaves, views, tight=True)).sum())
    comp.launch_counts[comp.KERNEL_NAME] = 0
    one_outs = sharded(fitting, views, 1)
    one_launches = comp.launch_counts[comp.KERNEL_NAME]
    one_flips = held(one_outs, refs["fitting"], "the encoder's one-band views against "
                                                "render_erp_views")
    one = planes(one_outs)
    del one_outs
    print(f"3r (a) the encoder's {N_TGT} views without the {oversized} splats past the "
          f"tiling's spans in 3 sigma ({oversized_tight} in their tight boxes): one band "
          f"against render_erp_views (colour / alpha / depth) {line(one_flips)}; {bars}",
          flush=True)
    heaviest = comp.segment_blocks(*(target_inputs(gaussians, views)[k]
                                     for k in ("starts", "counts"))).max(dim=1).values
    v0 = int(heaviest.argmin())
    whole_ms = time_cuda(fwd_calls(target_inputs(gaussians, views[v0:v0 + 1]))[0], iters=5)
    res = dict(launches={k: 0 for k in comp.launch_counts}, ranks={}, whole_view_ms=whole_ms,
               err=0.0, oversized=oversized, oversized_tight=oversized_tight, view=v0,
               one_band=one_flips, heaviest_tile_blocks=[int(x) for x in heaviest],
               flagship=dict(oversized=flagship_oversized, oversized_tight=flagship_tight,
                             err=flagship_res))
    res["launches"][comp.KERNEL_NAME] += flagship_launches + one_launches
    for k in BAND_RANKS:
        for name in comp.launch_counts:
            comp.launch_counts[name] = 0
        outs = sharded(leaves, views, k)
        torch.cuda.synchronize()
        launched = dict(comp.launch_counts)
        want = {name: (k * N_TGT if name == comp.KERNEL_NAME else 0) for name in launched}
        if launched != want:
            raise AssertionError(f"{k} ranks: launches {launched}, expected {want}")
        for name, n in launched.items():
            res["launches"][name] += n
        if not all(bool(torch.isfinite(o.color).all()) for o in outs):
            raise AssertionError(f"{k} ranks: non-finite colour")
        all_flips = gate_flips(planes(outs), refs["all"])
        if not band_lists_match(fitting, views[v0], k):
            raise AssertionError(f"{k} ranks: the bands bin other tile lists than one band")
        flips = held(sharded(fitting, views, k), one, f"{k} ranks against one band")
        del outs
        starts, rows, band_h = prs.band_layout(H, k)
        with torch.no_grad():
            table = prs.packed_table(*leaves, views[v0], (H, W), Emulated(k), near=0.1)
        bands = []
        for b in range(k):
            with torch.no_grad():
                asg, attrs = prs.band_inputs(table, starts[b], rows[b], band_h, W)
            inp = band_inp(asg, attrs, band_h)
            e, stats = compare_kernel_plain(inp, f"3r (a) {k} ranks, band {b} (tile rows "
                                                 f"{starts[b]}+{rows[b]}) of view {v0}",
                                            exact=True)
            bands.append(dict(rows=rows[b], ms=time_cuda(fwd_calls(inp)[0], iters=5),
                              plain_ms=stats["plain_ms"], bound_ms=bound_ms(inp, stats)[0],
                              instances=int(asg.tile_counts.sum()), err=e))
        ms = [b["ms"] for b in bands]
        res["ranks"][k] = dict(bands=bands, against_one=flips, all_against_ref=all_flips,
                               band_ms_max=max(ms), band_ms_mean=float(np.mean(ms)),
                               balance=max(ms) / float(np.mean(ms)))
        res["err"] = max(res["err"], *(b["err"] for b in bands))
        print(f"3r (a) {k} ranks: bands (tile rows) {list(rows)} of view {v0} (heaviest tiles "
              f"of the 4 views {res['heaviest_tile_blocks']} blocks), kernel ms a band "
              f"{[round(x, 3) for x in ms]} (max {max(ms):.3f}, mean {np.mean(ms):.3f}, "
              f"balance {max(ms) / np.mean(ms):.3f}; the whole view {whole_ms:.3f} ms), "
              f"instances a band {[b['instances'] for b in bands]}; views against one band "
              f"(colour / alpha / depth) {line(flips)} (the same tile lists on view {v0}), "
              f"against render_erp_views with the splats past the spans {line(all_flips)}; "
              f"launches {launched}", flush=True)
        del table
    return res


@phase("3r (b). face-sharded cube supervision over 2 and 4 emulated ranks, HM3D width")
def phase_face_ranks(seed):
    """A cube-supervision step's render and loss (remat_faces, the MSE of
    N_TGT views' 6 faces against the target faces) on the encoder's
    Gaussians, the faces split over k emulated face ranks
    (render_cube_views_face_sharded): outputs at SHARD_*_TOL and the
    Gaussians' gradients, summed over the ranks, at GRAD_TOL and L2_TOL,
    against render_cube_views."""
    from splatter360_tpu_torch.models.decoder import render_cube_views
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.parallel.mesh import Emulated
    from splatter360_tpu_torch.parallel.render_sharding import render_cube_views_face_sharded
    from splatter360_tpu_torch.serve import context_cubes
    from splatter360_tpu_torch.train.losses import mse_loss

    gen = torch.Generator(device="cuda").manual_seed(seed + 81)
    gaussians, r = hm3d_gaussians(seed, gen)
    tgt = torch.rand((1, N_TGT, H, W, 3), generator=gen, device="cuda")
    gt = context_cubes(tgt, FACE)
    args = (r["tgt_pose"], r["tgt_near"], r["tgt_far"], (FACE, FACE))

    def step(k):
        leaves = [x.detach().requires_grad_(True) for x in gaussians]
        for name in comp.launch_counts:
            comp.launch_counts[name] = 0
        if k == 1:
            out = render_cube_views(Gaussians(*leaves), *args, render_depth=True,
                                    remat_faces=True)
        else:
            out = render_cube_views_face_sharded(Gaussians(*leaves), *args, Emulated(k),
                                                 render_depth=True, remat_faces=True)
        mse_loss(out.color, gt).backward()
        torch.cuda.synchronize()
        return out, [x.grad for x in leaves], dict(comp.launch_counts)

    ref, ref_g, _ = step(1)
    res = dict(launches={k: 0 for k in comp.launch_counts}, ranks={}, err=0.0)
    for k in FACE_RANKS:
        out, grads, launched = step(k)
        # a rank's slice of the item is one launch, rendered again in the backward
        want = {name: {comp.KERNEL_NAME: 2 * k, comp.BWD_KERNEL_NAME: k}.get(name, 0)
                for name in launched}
        if launched != want:
            raise AssertionError(f"{k} face ranks: launches {launched}, expected {want}")
        for name, n in launched.items():
            res["launches"][name] += n
        err = max(float((out.color - ref.color).abs().max()),
                  float((out.alpha - ref.alpha).abs().max()))
        derr = float((out.depth - ref.depth).abs().max())
        rows = {}
        for name, g, g_ref in zip(Gaussians._fields, grads, ref_g):
            rows[name] = (float((g - g_ref).abs().max() / g_ref.abs().max()),
                          float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref)))
        print(f"3r (b) {k} face ranks ({N_TGT * 6 // k} faces of {FACE}x{FACE} a rank): outputs "
              f"{err:.2e} / depth {derr:.2e}; gradients (max / L2 relative) "
              + ", ".join(f"{n} {a:.2e} / {b:.2e}" for n, (a, b) in rows.items())
              + f"; launches {launched}", flush=True)
        if (err > SHARD_RGB_TOL or derr > SHARD_DEPTH_TOL
                or any(a > GRAD_TOL or b > L2_TOL for a, b in rows.values())):
            raise AssertionError(f"{k} face ranks disagree with render_cube_views")
        res["ranks"][k] = dict(err=err, depth_err=derr, grads=rows)
        res["err"] = max(res["err"], err)
    return res


def batch_digest(batch) -> str:
    """sha256 of a batch's context and target arrays, in key order."""
    h = hashlib.sha256()
    for part in ("context", "target"):
        for k in sorted(batch[part]):
            h.update(np.ascontiguousarray(batch[part][k]).tobytes())
    return h.hexdigest()


def rank_run(spec_path):
    """One rank under torchrun (chip_smoke.py --rank-run spec.json): the
    process group first (maybe_initialize_distributed), then the go of
    torchrun_finish (a file), then each CLI argv
    of the spec through main(), instrumented from outside the port: each
    step's ms (synchronized), the first batch's digest, the step-1
    gradients the optimizer took (spec "grads"), launches and peak memory
    a run; with spec "band_check", a 512x1024 view of the flagship scene
    band-sharded over the world group against the same view over one
    emulated rank (mesh.Emulated(1)). Writes
    rank<r>.json (and grads<r>.pt) under spec "out"."""
    import torch.distributed as dist

    import splatter360_tpu_torch.train.trainer as trainer
    from splatter360_tpu_torch.main import main as cli_main
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.parallel.mesh import Group, maybe_initialize_distributed

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    dev = maybe_initialize_distributed("cuda")
    rank = dist.get_rank()
    # started early: the runs begin at torchrun_finish's go
    waited = time.perf_counter()
    while not (out / "go").exists():
        if time.perf_counter() - waited > RANK_TIMEOUT:
            raise SystemExit(f"rank {rank}: no go within {RANK_TIMEOUT} s")
        time.sleep(0.1)
    rec = dict(rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
               device=str(dev), runs=[])
    step_fn = trainer.train_step
    for i, argv in enumerate(spec["runs"]):
        run = dict(argv=argv, step_ms=[], batch=None)

        def timed(state, batch, **kw):
            if run["batch"] is None:
                run["batch"] = batch_digest(batch)
            grads = {}

            def keep(stage):
                if stage == "backward":
                    grads.update({k: p.grad.detach().cpu() for k, p in
                                  state.model.named_parameters() if p.grad is not None})

            capture = spec.get("grads") and i == 0 and state.step == 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            metrics = step_fn(state, batch, on_stage=keep if capture else None, **kw)
            torch.cuda.synchronize(dev)
            run["step_ms"].append(1e3 * (time.perf_counter() - t0))
            if capture:
                torch.save(grads, out / f"grads{rank}.pt")
            return metrics

        for k in comp.launch_counts:
            comp.launch_counts[k] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.train_step = timed
        t0 = time.perf_counter()
        try:
            result = cli_main(list(argv))
        finally:
            trainer.train_step = step_fn
        run.update(wall_s=time.perf_counter() - t0, launches=dict(comp.launch_counts),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        if isinstance(result, dict):
            run["scores"] = result
        else:
            run["step"] = result.step
            del result
        rec["runs"].append(run)
    if spec.get("band_check"):
        from splatter360_tpu_torch.parallel.mesh import Emulated
        from splatter360_tpu_torch.parallel.render_sharding import render_erp_sharded

        means, covs, sh, opac = bench_scene(spec["seed"], N_CTX * H * W)
        c2w = torch.eye(4, device=dev)
        for k in comp.launch_counts:
            comp.launch_counts[k] = 0
        with torch.no_grad():
            got = render_erp_sharded(means, covs, sh, opac, c2w, (H, W), Group(), near=0.1,
                                     render_depth=True)
            launched = dict(comp.launch_counts)
            ref = render_erp_sharded(means, covs, sh, opac, c2w, (H, W), Emulated(1), near=0.1,
                                     render_depth=True)
        rec["band_check"] = dict(
            launches=launched,
            err=max(float((got.color - ref.color).abs().max()),
                    float((got.alpha - ref.alpha).abs().max())),
            depth_err=float((got.depth - ref.depth).abs().max()))
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


# the torchrun sessions started, stopped at the script's end
RANK_RUNS: list = []


def torchrun_start(label, root: Path, spec: dict, nproc: int) -> dict:
    """chip_smoke.py --rank-run under torchrun with nproc ranks on this
    machine's card(s), started now: the ranks start their process group,
    then wait for torchrun_finish's go, so that their start overlaps this
    process's work. Their output goes to root/<label>.log."""
    out = root / label
    out.mkdir(parents=True)
    spec = dict(spec, out=str(out))
    (out / "spec.json").write_text(json.dumps(spec))
    log = root / f"{label}.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(Path(__file__).resolve()), "--rank-run",
           str(out / "spec.json")]
    f = open(log, "w")
    proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                            cwd=Path(__file__).resolve().parent, start_new_session=True)
    run = dict(label=label, proc=proc, file=f, log=log, out=out, nproc=nproc,
               t0=time.perf_counter())
    RANK_RUNS.append(run)
    return run


def stop_rank_runs() -> None:
    """Kill the whole session of every torchrun still running."""
    import signal

    for run in RANK_RUNS:
        if run["proc"].poll() is None:
            os.killpg(run["proc"].pid, signal.SIGKILL)
            run["proc"].wait()
        run["file"].close()


def torchrun_finish(run: dict) -> list:
    """Let the ranks of torchrun_start's `run` go, wait for them (their whole
    session killed at RANK_TIMEOUT), print the tail of their output and
    return each rank's record."""
    import signal

    (run["out"] / "go").write_text("")
    t0 = time.perf_counter()
    proc = run["proc"]
    try:
        rc = proc.wait(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    run["file"].close()
    lines = run["log"].read_text().splitlines()
    print(f"--- {run['label']}: {run['nproc']} rank(s), rc {rc}, {time.perf_counter() - t0:.1f} s "
          f"after the go ({t0 - run['t0']:.1f} s after the start); the last lines of its "
          f"output:\n" + "\n".join(lines[-25:]), flush=True)
    if rc != 0:
        raise AssertionError(f"{run['label']}: torchrun ended with {rc}")
    return [json.loads((run["out"] / f"rank{r}.json").read_text()) for r in range(run["nproc"])]


def start_rank_runs(seed, root: Path) -> dict:
    """The scenes of 3r (c) and (d), and their torchrun sessions started
    (torchrun_start): (c) two ranks over gloo, (1) hm3d.yaml's mode=train at
    trainer.batch_size=2 with a band-sharded validation, (2) cube supervision
    with train.shard_faces at batch 1; (d) one rank over NCCL, mode=train on
    cube supervision with both shard flags, then mode=test of its
    checkpoint."""
    data = root / "data"
    cli_scenes(data, seed + 90, "train", 2, TRAIN_FRAMES)
    cli_scenes(data, seed + 91, "val", 1, CLI_FRAMES)
    base = [str(CONFIG), "mode=train", f"dataset.roots=[{data}]",
            f"trainer.max_steps={RANK_STEPS}", "trainer.print_log_every_n_steps=1",
            "trainer.num_sanity_val_steps=0", f"checkpointing.every_n_train_steps={RANK_STEPS}"]
    # one torchrun (one start of the two processes) for both runs
    c = torchrun_start("3r_c", root, dict(grads=True, runs=[
        [*base, f"output_dir={root / 'c1'}", "trainer.batch_size=2",
         f"trainer.val_check_interval={RANK_STEPS}", "train.shard_render=true"],
        [*base, f"output_dir={root / 'c2'}", "trainer.batch_size=1", "train.supervision=cubes",
         "train.shard_faces=true", "train.remat_faces=true", "trainer.val_check_interval=0"]]), 2)
    d_data, d_out = root / "d_data", root / "d"
    cli_scenes(d_data, seed + 92, "train", 1, TRAIN_FRAMES)
    cli_scenes(d_data, seed + 93, "test", 1, CLI_FRAMES)
    common = [str(CONFIG), f"dataset.roots=[{d_data}]", "train.shard_render=true",
              "train.shard_faces=true", "train.supervision=cubes"]
    d = torchrun_start("3r_d_nccl", root, dict(seed=seed, band_check=True, runs=[
        [*common, "mode=train", f"output_dir={d_out}", "trainer.batch_size=1",
         f"trainer.max_steps={RANK_STEPS}", "trainer.num_sanity_val_steps=0",
         "trainer.val_check_interval=0", f"checkpointing.every_n_train_steps={RANK_STEPS}"],
        [*common, "mode=test", f"checkpointing.load={d_out / 'checkpoints'}",
         f"test.output_path={d_out / 'test'}"]]), 1)
    return dict(data=data, c=c, d=d)


def release_memory(*results):
    """Drop the tensors the results of earlier phases hold (their inputs for
    phase 4), then return the freed memory to the card, so that 3r's ranks
    find it."""
    import gc

    def drop(x):
        if isinstance(x, dict):
            for k in list(x):
                v = x[k]
                if torch.is_tensor(v) or hasattr(v, "_fields") or (
                        isinstance(v, (tuple, list)) and any(torch.is_tensor(e) for e in v)):
                    del x[k]
                else:
                    drop(v)

    for res in results:
        drop(res)
    gc.collect()
    torch.cuda.empty_cache()


def grad_distance(got: dict, ref: dict) -> tuple[float, float]:
    """Over all leaves: max |got - ref| / max |ref| and mean |got - ref| /
    mean |ref|."""
    diff = torch.cat([(got[k] - ref[k]).abs().flatten() for k in ref])
    size = torch.cat([ref[k].abs().flatten() for k in ref])
    return float(diff.max() / size.max()), float(diff.mean() / size.mean())


@phase("3r (c). two torchrun ranks sharing the card over gloo: data grid 2x1, (data, face) grid 1x2")
def phase_two_ranks(seed, root: Path, started: dict):
    """hm3d.yaml's mode=train on 2 ranks of one card (gloo: two ranks share
    it): (1) trainer.batch_size=2 (one example a rank), RANK_STEPS steps and a
    band-sharded validation (train.shard_render) at the last; (2) cube
    supervision with train.shard_faces at batch 1, a 1x2 (data, face) grid
    (the example's 24 faces, 12 a rank), remat_faces on (the ranks were
    started by start_rank_runs). Before their go, this process takes the single-process steps the ranks'
    step 1 is held against, on the same global batch: bf16 at B = 2 twice
    (their distance printed beside) and, for the policy's own distance,
    float32 and bf16 at B = 1 on the first example; then it releases their
    memory. The ranks' all-reduced step-1 gradients (bit-equal across
    ranks) against the bf16 B = 2 step: within BF16_RATIO x the policy's
    distance by max and BF16_MEAN_RATIO x by mean."""
    from dataclasses import replace

    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.data.dataset import SceneDataset, batches
    from splatter360_tpu_torch.train.state import create_train_state, mono_grid, train_step

    if started is None:
        raise AssertionError("the ranks were not started")
    data = started["data"]
    cfg = load_config(str(CONFIG), [f"dataset.roots=[{data}]"])
    # each rank's first batch: its shard of the train split, seeded + rank
    firsts = [next(batches(SceneDataset(cfg.dataset, split="train", stage="train",
                                        seed=cfg.trainer.seed + r, shard_index=r, num_shards=2),
                           1)) for r in range(2)]
    both = {p: {k: np.concatenate([b[p][k] for b in firsts]) for k in firsts[0][p]}
            for p in ("context", "target")}

    def single(model_cfg, batch):
        state = create_train_state(model_cfg, cfg.train, seed=cfg.trainer.seed, device="cuda",
                                   mono_grid=mono_grid(cfg.train, H))
        grads = {}

        def keep(stage):
            if stage == "backward":
                grads.update({k: p.grad.detach().cpu() for k, p in
                              state.model.named_parameters() if p.grad is not None})

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, on_stage=keep)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del state
        release_memory()
        return grads, {k: float(v) for k, v in metrics.items()}, ms, peak

    g_a, m_a, ms_a, peak_a = single(cfg.model, both)
    g_b, _, ms_b, _ = single(cfg.model, both)
    first = {p: {k: v[:1] for k, v in both[p].items()} for p in both}
    g_bf1, _, _, _ = single(cfg.model, first)
    g_f1, _, _, _ = single(replace(cfg.model, bf16_compute=False), first)
    repeat = grad_distance(g_b, g_a)
    policy = grad_distance(g_bf1, g_f1)
    print(f"3r (c) single process, B = 2 bf16: steps {ms_a:.1f} / {ms_b:.1f} ms (the first "
          f"autotunes), peak {peak_a:.2f} GiB; two runs apart by {repeat[0]:.2e} (max) / "
          f"{repeat[1]:.2e} (mean) of |g|; the bf16 policy (B = 1, bf16 against float32) "
          f"{policy[0]:.2e} / {policy[1]:.2e}", flush=True)
    del g_b, g_bf1, g_f1
    release_memory()

    ranks = torchrun_finish(started["c"])
    for rk in ranks:
        if rk["backend"] != "gloo":
            raise AssertionError(f"rank {rk['rank']} on {rk['backend']}, not gloo")
    res = dict(single=dict(ms=[ms_a, ms_b], peak_gib=peak_a, metrics=m_a, repeat=repeat,
                           policy=policy), ranks={}, launches={})
    for i, label in enumerate(("data grid 2x1", "(data, face) grid 1x2")):
        runs = [rk["runs"][i] for rk in ranks]
        for run in runs:
            if len(run["step_ms"]) != RANK_STEPS or run["step"] != RANK_STEPS:
                raise AssertionError(f"{label}: steps {run['step_ms']}")
            for name, n in run["launches"].items():
                res["launches"][name] = res["launches"].get(name, 0) + n
        res["ranks"][label] = [dict(step_ms=run["step_ms"], peak_gib=run["peak_gib"],
                                    wall_s=run["wall_s"], launches=run["launches"])
                               for run in runs]
        print(f"3r (c) {label}: " + "; ".join(
            f"rank {r}: ms a step {[round(x, 1) for x in run['step_ms']]}, peak "
            f"{run['peak_gib']:.2f} GiB, {run['wall_s']:.1f} s, launches {run['launches']}"
            for r, run in enumerate(runs)), flush=True)
    if [rk["runs"][0]["batch"] for rk in ranks] != [batch_digest(b) for b in firsts]:
        raise AssertionError("the ranks' first batches are not the shards' first batches")
    checkpoints = sorted(p.name for p in (root / "c1" / "checkpoints").iterdir())
    if checkpoints != [str(RANK_STEPS)] or not (
            root / "c1" / "val" / f"{RANK_STEPS:08d}" / "comparison.png").is_file():
        raise AssertionError(f"data grid: checkpoints {checkpoints}, or no validation written")
    g0, g1 = (torch.load(root / "3r_c" / f"grads{r}.pt") for r in range(2))
    if g0.keys() != g_a.keys() or not all(torch.equal(g0[k], g1[k]) for k in g0):
        raise AssertionError("the ranks' all-reduced gradients differ")
    dp = grad_distance(g0, g_a)
    res["data_parallel"] = dp
    print(f"3r (c) step 1's all-reduced gradients against the single-process B = 2 step: "
          f"{dp[0]:.2e} (max) / {dp[1]:.2e} (mean) of |g|; bars {BF16_RATIO} x "
          f"{policy[0]:.2e} / {BF16_MEAN_RATIO} x {policy[1]:.2e} (the bf16 policy's); two "
          f"single-process runs {repeat[0]:.2e} / {repeat[1]:.2e}", flush=True)
    if dp[0] > BF16_RATIO * policy[0] or dp[1] > BF16_MEAN_RATIO * policy[1]:
        raise AssertionError("the two-rank step's gradients are past the bf16 bars")
    return res


@phase("3r (d). NCCL at world size 1: mode=train with both shard flags, mode=test")
def phase_nccl_one_rank(seed, root: Path, started: dict):
    """One torchrun rank (NCCL: it has the card to itself): mode=train on
    hm3d.yaml with cube supervision, train.shard_faces and train.shard_render
    (a 1x1 grid, the flags off as in JAX; the broadcast and barriers run on
    NCCL), mode=test of its checkpoint on one scene, then a flagship view
    band-sharded over the one-rank world group (NCCL's all_gather and
    all_reduce) against the same view over one emulated rank, which 3r (a)
    holds against render_erp_views."""
    if started is None:
        raise AssertionError("the rank was not started")
    (rk,) = torchrun_finish(started["d"])
    train, test = rk["runs"]
    band = rk["band_check"]
    print(f"3r (d) backend {rk['backend']} on {rk['device']}: train steps ms "
          f"{[round(x, 1) for x in train['step_ms']]}, peak {train['peak_gib']:.2f} GiB, launches "
          f"{train['launches']}; mode=test {test['wall_s']:.1f} s, scores {test['scores']}, "
          f"launches {test['launches']}; a band-sharded flagship view on 1 rank against "
          f"one emulated rank {band['err']:.2e} / depth {band['depth_err']:.2e}, launches "
          f"{band['launches']}", flush=True)
    if rk["backend"] != "nccl" or train["step"] != RANK_STEPS:
        raise AssertionError(f"(d): backend {rk['backend']}, step {train['step']}")
    scores = next(iter(test["scores"].values()))
    if not all(math.isfinite(v) for v in scores.values()):
        raise AssertionError(f"(d): non-finite scores {scores}")
    if band["err"] > SHARD_RGB_TOL or band["depth_err"] > SHARD_DEPTH_TOL:
        raise AssertionError("(d): the band-sharded view differs from one emulated rank's")
    launches = {}
    for run in (train, test, band):
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return dict(launches=launches, train=dict(step_ms=train["step_ms"],
                                              peak_gib=train["peak_gib"]),
                test_s=test["wall_s"], band=band)


@phase("4. timing")
def phase_timing(check, serve, bcheck, train, ucheck, ubcheck, serve3, train3, pin, cserve,
                 ctrain, cremat):
    from splatter360_tpu_torch.ops.cuda import composite as comp

    rows = {}
    for label, res, unfused in (("flagship 1 view", check, False),
                                ("serving 4 views", serve, False),
                                ("unfused 3-view flagship 1 view", ucheck, True),
                                ("unfused serving 4 views", serve3, True)):
        if res is None:
            continue
        inp = res["inp"]
        rows[label] = fwd_row(label, res, unfused)
        ms = rows[label]["ms"]
        if unfused:
            # what the JAX threshold costs here: the fused kernel on the same
            # Gaussians, against the unfused path's pack + kernel
            pack_ms = time_cuda(lambda: comp.pack_instances(
                inp["attrs"], inp["gidx"], inp["tile_ids"], inp["nty"] * inp["ntx"]), iters=10)
            fused_ms = time_cuda(fwd_calls(inp)[0], iters=20)
            print(f"[{label}] pack_instances {pack_ms:.3f} ms; unfused path (pack + kernel) "
                  f"{pack_ms + ms:.3f} ms; the fused kernel on the same inputs {fused_ms:.3f} ms")
            rows[label].update(pack_ms=pack_ms, fused_ms=fused_ms)
    for label, res, unfused in (("backward flagship 1 view", bcheck, False),
                                ("backward train 4 views", train, False),
                                ("unfused backward 3-view flagship 1 view", ubcheck, True),
                                ("unfused backward train 4 views", train3, True)):
        if res is None:
            continue
        args, inp = res["args"], res["inp"]
        backward = comp.composite_backward_unfused if unfused else comp.composite_backward
        rows[label] = bwd_row(label, res, unfused)
        ms = rows[label]["ms"]
        at = 5 if unfused else 6  # nproc
        rep = nproc_report(args[at], label)
        region_visits(inp, args[at], label)
        rows[label]["span_ms"] = sweep = span_sweep(backward, args, label)
        # how much of the time the heavy tiles take: the walk capped at 64
        # blocks a tile (an input to this timing only, never to a check)
        capped = list(args)
        capped[at] = args[at].clamp(max=64)
        capped_ms = {span: time_cuda(lambda: backward(*capped, span=span), iters=5)
                     for span in (None, comp.BWD_SPAN)}
        print(f"[{label}] one span a tile: {1e3 * np.mean(sweep[None]) / rep['max']:.3f} us per "
              f"walked block of the heaviest tile; every tile capped at 64 blocks: "
              + ", ".join(f"span {k} {v:.3f} ms" for k, v in capped_ms.items()))
        if unfused:
            # the scatter apart, and the fused backward kernel on the same
            # inputs (what the JAX threshold costs here)
            dout = comp.composite_backward_unfused(*args)
            inst, starts, counts, g_planes, lt, nproc = args[:6]
            n = inp["attrs"].shape[1]
            scatter_ms = time_cuda(lambda: comp.scatter_out_blocks(
                dout, inp["gidx"], starts, counts, nproc, n), iters=10)
            fused_ms = time_cuda(lambda: comp.composite_backward(
                inp["attrs"], inp["gidx"], starts, counts, *args[3:]), iters=10)
            print(f"[{label}] scatter_out_blocks {scatter_ms:.3f} ms; unfused path (kernel + "
                  f"scatter) {ms + scatter_ms:.3f} ms; the fused backward kernel on the same "
                  f"inputs {fused_ms:.3f} ms")
            rows[label].update(scatter_ms=scatter_ms, fused_ms=fused_ms)
    # the cube path's inputs: the flagship scenes' 6 faces (phase 2e), the
    # cube serving requests (3h) and the cube train steps (3i); and the
    # forward on the train steps' inputs of both paths, with its bound
    pin, cserve, ctrain = (moved(x or {}, "cuda") for x in (pin, cserve, ctrain))
    cremat = moved(cremat, "cuda")
    for label, res, unfused in (("flagship 6 faces", pin.get(N_CTX), False),
                                ("unfused 3-view flagship 6 faces", pin.get(N_CTX3), True),
                                ("cube serving 24 faces", cserve.get(N_CTX), False),
                                ("unfused cube serving 24 faces", cserve.get(N_CTX3), True)):
        if res is not None:
            rows[label] = fwd_row(label, res, unfused)
    for label, res, unfused in (("train 4 views", train, False),
                                ("unfused train 4 views", train3, True),
                                ("cube train 24 faces", ctrain.get(N_CTX), False),
                                ("unfused cube train 24 faces", ctrain.get(N_CTX3), True)):
        if res is not None:
            _, stats = compare_kernel_plain(res["inp"], f"forward, {label}", unfused=unfused)
            rows[f"forward {label}"] = fwd_row(f"forward {label}", dict(res, stats=stats), unfused)
    for label, res, unfused in (
            ("backward flagship 6 faces", pin.get(N_CTX, {}).get("bwd"), False),
            ("unfused backward 3-view flagship 6 faces", pin.get(N_CTX3, {}).get("bwd"), True),
            ("backward cube train 24 faces", ctrain.get(N_CTX), False),
            ("unfused backward cube train 24 faces", ctrain.get(N_CTX3), True),
            ("backward cube train 6 faces (remat_faces launch)", cremat, False)):
        if res is not None:
            rows[label] = bwd_row(label, res, unfused)
            at = 5 if unfused else 6
            nproc_report(res["args"][at], label)
    # the forward by span on the flagship scene, the serving inputs and the
    # last train steps' Gaussians
    for label, res, unfused in (("flagship 1 view", check, False),
                                ("unfused 3-view flagship 1 view", ucheck, True),
                                ("serving 4 views", serve, False),
                                ("unfused serving 4 views", serve3, True),
                                ("train 4 views", train, False),
                                ("unfused train 4 views", train3, True)):
        if res is None:
            continue
        # the flagship scenes' calls take well under a millisecond: more of them
        fwd_report(res["inp"], f"forward, {label}", unfused,
                   iters=20 if "flagship" in label else 3)
    for label, res, face in (("4 views", serve, None),
                             ("4 views x 6 faces", cserve.get(N_CTX), FACE),
                             ("3-view, 4 views x 6 faces", cserve.get(N_CTX3), FACE)):
        if res is not None:
            parts = render_breakdown(res["gaussians"], list(res["tgt_pose"]), face=face)
            print(f"[render breakdown, {label}] " +
                  ", ".join(f"{s} {t:.3f} ms" for s, t in parts.items()))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-run", help="run as one torchrun rank of phase 3r (a spec file)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import splatter360_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.rank_run:
        rank_run(args.rank_run)
        return

    smi = smi_line()
    print(f"card: {smi}; host: {len(os.sched_getaffinity(0))} cores, torch "
          f"{torch.get_num_threads()} threads", flush=True)
    phase_build()
    built = not failures
    check = phase_kernel_check(args.seed) if built else None
    bcheck = phase_bwd_check(check, args.seed) if check is not None else None
    ucheck = phase_unfused_check(args.seed) if built else None
    ubcheck = phase_unfused_bwd_check(ucheck, args.seed) if ucheck is not None else None
    pin = phase_pinhole_check(args.seed) if built else None
    serve = phase_serve(args.seed)
    phase_small_reference(args.seed)
    train = phase_train(args.seed)
    phase_small_train(args.seed)
    serve3 = phase_serve3(args.seed)
    train3 = phase_train3(args.seed)
    phase_small_train3(args.seed)
    cserve = phase_serve_cubes(args.seed) or {}
    ctrain = phase_train_cubes(args.seed) or {}
    phase_small_train_cubes(args.seed)
    cremat = phase_train_remat(args.seed, ctrain)
    cli = phase_cli_eval(args.seed)
    cli_train = phase_cli_train(args.seed) or {}
    t_opts = time.perf_counter()
    with option_cpu_steps(args.seed) as cpu_steps:
        options = phase_options(args.seed) or {}
        options_small = phase_options_small(args.seed, cpu_steps)
    options_cli = phase_options_cli(args.seed) or {}
    smoke = phase_smoke_config(args.seed)
    narrow = phase_narrow_erp(args.seed)
    options_s = time.perf_counter() - t_opts
    print(f"phase 3n took {options_s:.1f} s", flush=True)
    t_mono = time.perf_counter()
    mono_root = Path(tempfile.mkdtemp(prefix="splat360_mono_"))
    try:
        mono = phase_mono(args.seed, mono_root) or {}
        mono_cli = phase_mono_cli(args.seed, mono_root) or {}
        mono_small = phase_mono_small(args.seed, mono_root)
    finally:
        shutil.rmtree(mono_root, ignore_errors=True)
    mono_s = time.perf_counter() - t_mono
    print(f"phase 3o took {mono_s:.1f} s", flush=True)
    t_backbone = time.perf_counter()
    backbone_root = Path(tempfile.mkdtemp(prefix="splat360_backbone_"))
    try:
        backbone, served, request = phase_backbone(args.seed, backbone_root) or ({}, None, None)
        backbone_cli = phase_backbone_cli(args.seed, backbone_root) or {}
        videos = phase_videos(args.seed, backbone_root, served, request) or {}
        del served, request
    finally:
        shutil.rmtree(backbone_root, ignore_errors=True)
    backbone_s = time.perf_counter() - t_backbone
    print(f"phase 3p took {backbone_s:.1f} s", flush=True)
    t_orbax = time.perf_counter()
    orbax_root = Path(tempfile.mkdtemp(prefix="splat360_orbax_"))
    try:
        zstd_loader = phase_zstd_loader(args.seed, orbax_root) or {}
        fixture = phase_orbax_fixture(args.seed, orbax_root)
        orbax_eval = orbax_resume = orbax_pretrained = None
        if fixture is not None:
            orbax_eval = phase_orbax_eval(args.seed, orbax_root, fixture)
            orbax_resume = phase_orbax_resume(args.seed, orbax_root, fixture)
            orbax_pretrained = phase_orbax_pretrained(args.seed, orbax_root, fixture)
            fixture = {k: v for k, v in fixture.items() if k not in ("dir", "tree")}
    finally:
        shutil.rmtree(orbax_root, ignore_errors=True)
    orbax_s = time.perf_counter() - t_orbax
    print(f"phase 3q took {orbax_s:.1f} s", flush=True)
    t_gen = time.perf_counter()
    gen_root = Path(tempfile.mkdtemp(prefix="splat360_gen_"))
    try:
        dense_walk = phase_dense_walk(args.seed)
        gen = phase_generate(args.seed, gen_root)
        gen_cli = projections = None
        if gen is not None:
            gen_cli = phase_generated_cli(args.seed, gen_root)
            projections = phase_projections(gen)
            del gen["world"]
    finally:
        shutil.rmtree(gen_root, ignore_errors=True)
    gen_s = time.perf_counter() - t_gen
    print(f"phase 3s took {gen_s:.1f} s", flush=True)
    rows = phase_timing(check, serve, bcheck, train, ucheck, ubcheck, serve3, train3, pin,
                        cserve, ctrain, cremat) or {}
    release_memory(check, serve, bcheck, train, ucheck, ubcheck, serve3, train3, pin, cserve,
                   ctrain, cremat, cli, cli_train, options, mono, backbone, videos)
    t_ranks = time.perf_counter()
    ranks_root = Path(tempfile.mkdtemp(prefix="splat360_ranks_"))
    try:
        # (c)'s and (d)'s ranks start while (a) and (b) run
        started = start_rank_runs(args.seed, ranks_root)
        bands = phase_band_ranks(args.seed)
        faces = phase_face_ranks(args.seed)
        release_memory()
        two_ranks = phase_two_ranks(args.seed, ranks_root, started)
        one_rank = phase_nccl_one_rank(args.seed, ranks_root, started)
    finally:
        stop_rank_runs()
        shutil.rmtree(ranks_root, ignore_errors=True)
    ranks_s = time.perf_counter() - t_ranks
    print(f"phase 3r took {ranks_s:.1f} s", flush=True)
    # each path's own kernels, counted over its own run
    fused = ("composite_forward_fused", "composite_backward_fused")
    unfused = ("composite_forward_unfused", "composite_backward_unfused")
    for label, res, names in (
            ("serving", serve, fused[:1]),
            ("training", train, fused),
            ("3-view serving", serve3, unfused[:1]),
            ("3-view training", train3, unfused),
            ("cube serving", cserve.get(N_CTX), fused[:1]),
            ("cube training", ctrain.get(N_CTX), fused),
            ("3-view cube serving", cserve.get(N_CTX3), unfused[:1]),
            ("3-view cube training", ctrain.get(N_CTX3), unfused),
            ("cube training, TrainConfig() with remat_faces", cremat, fused),
            ("CLI evaluation, ERP", (cli or {}).get("runs", {}).get("ERP"), fused[:1]),
            ("CLI evaluation, cubes", (cli or {}).get("runs", {}).get("cubes"), fused[:1]),
            ("CLI evaluation, 3 views", (cli or {}).get("runs", {}).get("3-view"), unfused[:1]),
            ("CLI training", cli_train.get("a"), fused),
            ("CLI training, resumed", cli_train.get("resume"), fused),
            ("CLI training, 3 views", cli_train.get("b"), unfused),
            *((f"option {g} at HM3D width", options.get(g),
               unfused if kw.get("gaussians_per_pixel", 1) > 1 else fused)
              for g, kw in OPTION_GROUPS.items()),
            ("CLI with biproj, epipolar and 2 Gaussians a pixel", options_cli or None, unfused),
            ("mono branch at HM3D width", mono or None, fused),
            ("CLI with the mono branch", mono_cli or None, fused),
            ("UniMatch warm start at HM3D width", backbone or None, fused),
            ("CLI with pretrained_backbone and save_video", backbone_cli or None, fused),
            ("trajectory videos at HM3D width", videos or None, fused[:1]),
            ("mode=test of the JAX package's orbax checkpoint", orbax_eval, fused[:1]),
            ("mode=train resumed from the orbax checkpoint", orbax_resume, fused),
            ("mode=train on the generated scenes (3s c)", (gen_cli or {}).get("train"), fused),
            ("mode=test on the generated scenes (3s c)", (gen_cli or {}).get("test"), fused[:1]),
            ("band-sharded ERP decode over emulated ranks (3r a)", bands, fused[:1]),
            ("face-sharded cube supervision over emulated ranks (3r b)", faces, fused),
            ("two torchrun ranks over gloo (3r c)", two_ranks, fused),
            ("one torchrun rank over NCCL (3r d)", one_rank, fused)):
        if res is None:
            failures.append(f"{label} run missing")
        elif min(res["launches"].get(k, 0) for k in names) == 0:
            failures.append(f"a kernel of {names} never launched on the {label} path")
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        sys.exit(1)

    def row(name, source, replaces, res, err, timing, cube_res, cube_timing):
        """The kernel's numbers on its ERP path (launches over that path's
        run, ms, plain_ms, bound at its inputs) and, under cube_*, on its
        cube path; max_abs_err over every check of it; cli_train_launches
        over the CLI's bf16 training run of its path (3m (a), or (b) for
        the unfused pair); option_launches over phase 3n (a)'s runs of every
        option group and, for the unfused pair, gpp2_ms at its gpp = 2
        step's inputs; mono_launches over phase 3o's runs (the mono
        branch's request and steps, and its CLI runs); backbone_launches
        over phase 3p (a-b)'s (the warm-started model's request and steps,
        the CLI's training and its mode=test with videos); video_launches
        over phase 3p (c)'s three videos and, for the fused forward,
        video_frame_ms, its bound and its plain version's ms on one spin
        frame; orbax_launches over phase 3q (c-d)'s (mode=test of the JAX
        package's orbax checkpoint, the steps resumed from it);
        parallel_launches over phase 3r's (the band-sharded decodes of (a),
        the face-sharded renders of (b), and every rank's runs in (c) and
        (d)) and, for the fused forward, band_ms_max / band_ms_mean at 8
        emulated band ranks; generated_launches over phase 3s (c)'s (mode=train
        and mode=test on the generated scenes)."""
        ctrain = cli_train["b" if "unfused" in name else "a"]
        return dict(name=name, route="cuda", source=f"splatter360_tpu_torch/csrc/{source}",
                    replaces=f"splatter360_tpu/ops/pallas/composite.py:{replaces}",
                    launches=res["launches"][name], max_abs_err=err, ms=timing["ms"],
                    plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                    bound_by=timing["bound_by"], library_ms=None,
                    cube_launches=cube_res["launches"][name], cube_ms=cube_timing["ms"],
                    cube_plain_ms=cube_timing["plain_ms"], cube_bound_ms=cube_timing["bound_ms"],
                    cube_bound_by=cube_timing["bound_by"],
                    cli_train_launches=ctrain["launches"][name],
                    option_launches=sum(options[g]["launches"][name] for g in OPTION_GROUPS),
                    mono_launches=mono["launches"][name] + mono_cli["launches"][name],
                    backbone_launches=backbone["launches"][name]
                    + backbone_cli["launches"][name],
                    video_launches=videos["launches"][name],
                    orbax_launches=orbax_eval["launches"][name]
                    + orbax_resume["launches"][name],
                    parallel_launches=sum(r["launches"].get(name, 0)
                                          for r in (bands, faces, two_ranks, one_rank)),
                    generated_launches=gen_cli["train"]["launches"][name]
                    + gen_cli["test"]["launches"][name],
                    **({"band_ms_max": bands["ranks"][8]["band_ms_max"],
                        "band_ms_mean": bands["ranks"][8]["band_ms_mean"]}
                       if name == "composite_forward_fused" else {}),
                    **({"video_frame_ms": videos["kernel_ms"],
                        "video_frame_bound_ms": videos["bound_ms"],
                        "video_frame_plain_ms": videos["plain_ms"]}
                       if name == "composite_forward_fused" else {}),
                    **({"gpp2_ms": options["gpp2"][
                        "bwd_kernel_ms" if "backward" in name else "fwd_kernel_ms"]}
                       if "unfused" in name else {}))

    def gpp2_errs(key):
        """The unfused pair's errors against its plain versions at phase
        3n (a)'s gpp = 2 steps."""
        return [options[g][key] for g, kw in OPTION_GROUPS.items()
                if kw.get("gaussians_per_pixel", 1) > 1]

    kernels = [
        row("composite_forward_fused", "composite_fwd.cu", 370, serve,
            max(check["err"], serve["err"], pin[N_CTX]["err"], cserve[N_CTX]["err"],
                bands["err"]),
            rows["serving 4 views"], cserve[N_CTX], rows["cube serving 24 faces"]),
        row("composite_backward_fused", "composite_bwd.cu", 517, train,
            max(bcheck["err"], train["err"], pin[N_CTX]["bwd"]["err"], ctrain[N_CTX]["err"],
                cremat["err"]),
            rows["backward train 4 views"], ctrain[N_CTX], rows["backward cube train 24 faces"]),
        row("composite_forward_unfused", "composite_fwd_unfused.cu", 289, serve3,
            max(ucheck["err"], serve3["err"], pin[N_CTX3]["err"], cserve[N_CTX3]["err"],
                *gpp2_errs("fwd_err")),
            rows["unfused serving 4 views"], cserve[N_CTX3],
            rows["unfused cube serving 24 faces"]),
        row("composite_backward_unfused", "composite_bwd_unfused.cu", 705, train3,
            max(ubcheck["err"], train3["err"], pin[N_CTX3]["bwd"]["err"], ctrain[N_CTX3]["err"],
                *gpp2_errs("bwd_err")),
            rows["unfused backward train 4 views"], ctrain[N_CTX3],
            rows["unfused backward cube train 24 faces"]),
    ]
    print(json.dumps({"cli_eval": cli, "card": smi}))
    print(json.dumps({"cli_train": cli_train, "card": smi}))
    print(json.dumps({"options": dict(hm3d=options, small_gpu_vs_cpu=options_small,
                                      cli=options_cli, smoke=smoke, narrow_erp=narrow,
                                      seconds=options_s), "card": smi}))
    print(json.dumps({"mono": dict(hm3d=mono, cli=mono_cli, small_gpu_vs_cpu=mono_small,
                                   seconds=mono_s), "card": smi}))
    print(json.dumps({"backbone_and_videos": dict(hm3d=backbone, cli=backbone_cli,
                                                  videos=videos, seconds=backbone_s),
                      "card": smi}))
    print(json.dumps({"orbax": dict(zstd_loader=zstd_loader, fixture=fixture, eval=orbax_eval,
                                    resume=orbax_resume, pretrained=orbax_pretrained,
                                    seconds=orbax_s), "card": smi}, default=str))
    print(json.dumps({"generated": dict(dense_walk=dense_walk, generate=gen, cli=gen_cli,
                                        projections=projections, seconds=gen_s),
                      "card": smi}, default=str))
    print(json.dumps({"ranks": dict(bands=bands, faces=faces, two=two_ranks, one=one_rank,
                                    seconds=ranks_s), "card": smi}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
