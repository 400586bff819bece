"""Train state and the train step with cube-face or ERP supervision.

Counterpart of splatter360_tpu/train/state.py (`OptimizerConfig`,
`TrainConfig`, `make_optimizer`, `create_train_state`, `compute_losses`,
`make_train_step`):

    state = create_train_state(HM3D, TrainConfig(), seed=0)   # device="cuda"
    metrics = train_step(state, batch)                        # one update

One step: encode the context panoramas -> Gaussians -> render the targets
(one compositor launch for all of an item's views or faces, CUDA backward)
-> the image loss + LPIPS + sin(phi)-weighted depth L1 on the encoder's
depth map -> global-norm clip (optax's formula) -> Adam with optax's cosine
one-cycle schedule (or its linear warm-up, `cosine_lr=False`). The image
loss follows `supervision`: "cubes" (the JAX default, the reference's
protocol) renders the 6 pinhole faces of every target view and takes the
MSE against the targets resampled to faces;
"erp" renders the target panoramas and takes the sin(phi)-weighted ERP
MSE. A batch is the JAX package's dict: {"context": {image_sphere [B, V, H,
W, 3], extrinsics_sphere [B, V, 4, 4], depth_sphere [B, V, H, W], near, far
[B, V]}, "target": {image_sphere, extrinsics_sphere, near, far}}. The
encoder runs under its config's precision policy (models/encoder.
apply_encoder: float32, or bf16 compute over float32 master parameters);
everything else computes in float32 with TF32 off. Across ranks
(parallel/mesh.py), `train_step(state, batch, grid=grid)` takes this
rank's share of the global batch and averages the gradients over the ranks
before the clip; with train.shard_faces the cube faces are split over the
grid's face ranks (parallel/render_sharding.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device, set_f32_policy
from ..models import decoder
from ..models.dino import token_grid
from ..models.encoder import EncoderConfig, EncoderCostVolume360, apply_encoder
from ..ops.rasterizer import BACKENDS
from ..parallel.mesh import RankGrid
from ..parallel.render_sharding import render_cube_views_face_sharded
from ..serve import build_model, context_cubes
from .losses import LossConfig, depth_l1_terms, mse_loss, sin_weighted_mse
from .lpips import LPIPS, init_lpips, load_lpips_torch_weights
from .metrics import compute_psnr


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-4
    warm_up_steps: int = 2000  # the linear warm-up schedule's (cosine_lr False)
    cosine_lr: bool = True
    max_steps: int = 100_000
    grad_clip: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    supervision: str = "cubes"  # "cubes" | "erp"
    cube_face_size: Optional[int] = None  # default: H // 2
    # "pallas": the CUDA kernels, the Pallas kernels' counterparts; "jax":
    # the scan compositor, composite_jax's (ops/composite_scan.py)
    render_backend: str = "pallas"
    max_per_tile: int = 2048  # the "jax" backend's segment cap
    wo_depth_supervise: bool = False
    # the JAX package's XLA face schedule (lax.map, vmap or "unroll" of the
    # supervision faces): it bounds memory inside one traced program and does
    # not change the function; the port renders an item's faces in one launch
    # whatever its value (remat_faces is the port's memory device)
    sequential_faces: "bool | str" = True
    # render each target view's 6 faces again in the backward instead of
    # keeping their activations (torch.utils.checkpoint); hm3d.yaml sets False
    remat_faces: bool = True
    # band-sharded ERP decodes of validation and mode=test across all ranks,
    # and cube supervision's faces split over a (data, face) rank grid
    # (parallel/): each acts as off where its axis has one rank, as in JAX
    shard_render: bool = False
    shard_faces: bool = False


def check_ported(train_cfg: TrainConfig) -> None:
    """Raise ValueError for an unknown supervision or render backend."""
    if train_cfg.supervision not in ("cubes", "erp"):
        raise ValueError(f"supervision={train_cfg.supervision!r}: expected 'cubes' or 'erp'")
    if train_cfg.render_backend not in BACKENDS:
        raise ValueError(f"render_backend={train_cfg.render_backend!r}: expected one of "
                         f"{BACKENDS}")


def mono_grid(train_cfg: TrainConfig, image_height: int) -> int:
    """The mono ViT's token grid side for the train step's cube faces
    (cube_face_size, or H // 2)."""
    return token_grid(train_cfg.cube_face_size or image_height // 2)


def learning_rate(cfg: OptimizerConfig, count: int) -> float:
    """The JAX package's schedule at update `count` (the count before the
    increment), in optax's float32 arithmetic.

    cosine_lr: optax.cosine_onecycle_schedule(steps, lr, pct_start) with
    steps = max(max_steps, 2) and pct_start = max(0.01, 1.001 / steps): from
    lr/25 up to lr at step int(pct_start * steps), then down to
    lr/(25 * 1e4) at `steps`, by cosine interpolation.

    Otherwise optax.linear_schedule(lr / max(w, 1) * 0, lr, w) with w =
    warm_up_steps: from 0 up to lr at step w, lr after it (0 throughout when
    w <= 0, optax's constant init_value)."""
    f32 = np.float32
    if not cfg.cosine_lr:
        w = cfg.warm_up_steps
        init = cfg.lr / max(w, 1) * 0
        if w <= 0:
            return float(init)
        frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
        return float(f32(init - cfg.lr) * frac + f32(cfg.lr))
    steps = max(cfg.max_steps, 2)
    bounds = (0, int(max(0.01, 1.001 / steps) * steps), int(steps))
    values = np.cumprod([cfg.lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    if count >= bounds[2]:
        return float(f32(values[2]))
    i = 0 if count < bounds[1] else 1
    pct = f32(count - bounds[i]) / f32(bounds[i + 1] - bounds[i])
    half = f32((values[i] - values[i + 1]) / 2.0)
    return float(f32(values[i + 1]) + half * (np.cos(f32(np.pi) * pct) + f32(1.0)))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm is at least
    max_norm, each gradient becomes (g / norm) * max_norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_). Returns the unclipped norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclass
class TrainState:
    model: EncoderCostVolume360
    optimizer: torch.optim.Optimizer
    encoder_cfg: EncoderConfig
    train_cfg: TrainConfig
    lpips: Optional[LPIPS] = None
    step: int = 0


def make_optimizer(params, cfg: OptimizerConfig) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
    over `params` (create_train_state passes the trainable ones);
    train_step sets the learning rate of each update from learning_rate()."""
    return torch.optim.Adam(params, lr=learning_rate(cfg, 0), betas=(0.9, 0.999), eps=1e-8)


def create_train_state(encoder_cfg: EncoderConfig, train_cfg: TrainConfig, seed: int = 0,
                       device: str | torch.device = "cuda",
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       lpips_state: Optional[Mapping[str, torch.Tensor]] = None,
                       mono_grid: Optional[int] = None) -> TrainState:
    """The encoder with `state_dict` or seeded random weights (`mono_grid`:
    the mono ViT's token grid with add_mono_feat, see mono_grid()), the
    frozen LPIPS network (when its weight is > 0) with `lpips_state`, else
    the file `train_cfg.loss.lpips_weights`, else seeded random features,
    Adam over the trainable parameters (not the frozen ViT's: JAX's zero
    gradients there give zero updates and add nothing to the clip's norm)
    and a step counter at 0, on `device`."""
    check_ported(train_cfg)
    dev = resolve_device(device)
    set_f32_policy()
    model = build_model(encoder_cfg, seed=seed, device=dev, state_dict=state_dict,
                        mono_grid=mono_grid).train()
    lpips = None
    if train_cfg.loss.lpips_weight > 0:
        lpips = LPIPS()
        if lpips_state is not None:
            lpips.load_state_dict(lpips_state)
        elif train_cfg.loss.lpips_weights:
            load_lpips_torch_weights(lpips, train_cfg.loss.lpips_weights)
        else:
            init_lpips(lpips, seed)
        lpips = lpips.requires_grad_(False).to(dev).eval()
    trainable = [p for p in model.parameters() if p.requires_grad]
    return TrainState(model=model, optimizer=make_optimizer(trainable, train_cfg.optimizer),
                      encoder_cfg=encoder_cfg, train_cfg=train_cfg, lpips=lpips)


def _on_device(batch: Mapping, dev: torch.device) -> dict:
    return {part: {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                   for k, v in batch[part].items() if k != "index"}
            for part in ("context", "target")}


def compute_losses(state: TrainState, batch: Mapping,
                   on_stage: Optional[Callable[[str], None]] = None,
                   grid: Optional[RankGrid] = None):
    """The JAX compute_losses: (total loss, metrics). `on_stage(name)`, if
    given, is called after "encoder", "render" and "losses" (chip_smoke.py
    records CUDA events there). With train.shard_faces and a `grid` whose
    face axis has more than one rank, the cube faces are rendered
    face-sharded over it (JAX's use_face_shard): every rank of the face group
    gets all the faces and computes the same loss, the mean over all v*6
    faces of its examples."""
    mark = on_stage or (lambda name: None)
    dev = next(state.model.parameters()).device
    batch = _on_device(batch, dev)
    ctx, tgt = batch["context"], batch["target"]
    tcfg = state.train_cfg
    h, w = ctx["image_sphere"].shape[2:4]
    face = tcfg.cube_face_size or h // 2
    gaussians, pred_depth = apply_encoder(
        state.model, ctx["image_sphere"], context_cubes(ctx["image_sphere"], face),
        ctx["extrinsics_sphere"], ctx["near"], ctx["far"], state.step)
    mark("encoder")
    if tcfg.supervision == "cubes":
        args = (gaussians, tgt["extrinsics_sphere"], tgt["near"], tgt["far"], (face, face))
        kw = dict(remat_faces=tcfg.remat_faces, backend=tcfg.render_backend,
                  max_per_tile=tcfg.max_per_tile)
        if tcfg.shard_faces and grid is not None and grid.n_face > 1:
            rendered = render_cube_views_face_sharded(*args, grid.face, **kw)
        else:
            rendered = decoder.render_cube_views(*args, **kw)
        gt = context_cubes(tgt["image_sphere"], face)
        loss_mse = mse_loss(rendered.color, gt)
        img_shape = (face, face)
    else:
        rendered = decoder.render_erp_views(gaussians, tgt["extrinsics_sphere"], tgt["near"],
                                            tgt["far"], (h, w), backend=tcfg.render_backend,
                                            max_per_tile=tcfg.max_per_tile)
        gt = tgt["image_sphere"]
        loss_mse = sin_weighted_mse(rendered.color, gt)
        img_shape = (h, w)
    mark("render")

    lcfg = tcfg.loss
    flat_pred = rendered.color.reshape(-1, *img_shape, 3)
    flat_gt = gt.reshape(-1, *img_shape, 3)
    metrics = {"psnr": torch.mean(compute_psnr(flat_gt, flat_pred.detach())),
               "loss_mse": loss_mse,
               # splats lost to emission-cap overflow over all rendered views or faces
               "dropped": torch.sum(rendered.dropped).to(torch.float32)}
    total = lcfg.mse_weight * loss_mse
    if lcfg.lpips_weight > 0 and state.lpips is not None:
        if state.step >= lcfg.lpips_apply_after_step:
            lp = torch.mean(state.lpips(flat_pred, flat_gt))
        else:
            lp = torch.zeros((), device=dev)
        total = total + lcfg.lpips_weight * lp
        metrics["loss_lpips"] = lp
    if not tcfg.wo_depth_supervise and lcfg.depth_weight > 0:
        num, den = depth_l1_terms(pred_depth, ctx["depth_sphere"], ctx["far"])
        if grid is not None and grid.n_data > 1:
            # JAX divides by the weight of the whole global batch, whose
            # examples' hole masks differ: each rank takes n_data * its sum
            # over that, and train_step's mean over the ranks gives JAX's
            # loss (a face group's ranks hold the same examples)
            (den,) = grid.world.all_reduce([den.detach()])
            num, den = num * grid.n_data, den / grid.n_face
        ld = num / torch.clamp(den, min=1e-10)
        total = total + lcfg.depth_weight * ld
        metrics["loss_depth"] = ld
    metrics["loss"] = total
    mark("losses")
    return total, metrics


def train_step(state: TrainState, batch: Mapping,
               on_stage: Optional[Callable[[str], None]] = None,
               grid: Optional[RankGrid] = None) -> dict[str, torch.Tensor]:
    """One update of `state` in place (parameters, Adam moments, step + 1).
    Returns the metrics of the step: loss, loss_mse, loss_lpips, loss_depth,
    psnr, dropped and grad_norm (of the unclipped gradients). `on_stage` is
    also called after "backward" and "optimizer".

    Across ranks (`grid`, parallel/mesh.create_rank_grid), `batch` is this
    rank's share of the global batch: the gradients are averaged over the
    ranks between the backward and the clip, in one flat buffer, as XLA's
    psum precedes optax's clip, and so are the metrics (dropped summed over
    the data ranks), so every rank takes the same update."""
    mark = on_stage or (lambda name: None)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_losses(state, batch, on_stage, grid)
    loss.backward()
    ocfg = state.train_cfg.optimizer
    params = [p for p in state.model.parameters() if p.grad is not None]
    if grid is not None and grid.world.size > 1:
        # the ranks of a face group hold the same gradients, so the mean over
        # all ranks is the mean over the data ranks
        for p, g in zip(params, grid.world.all_reduce([p.grad for p in params], mean=True)):
            p.grad.copy_(g)
        names = sorted(metrics)
        reduced = grid.world.all_reduce([metrics[k].detach().float() for k in names], mean=True)
        metrics = dict(zip(names, reduced))
        metrics["dropped"] = metrics["dropped"] * grid.n_data
    mark("backward")
    grads = [p.grad for p in params]
    metrics["grad_norm"] = clip_by_global_norm_(grads, ocfg.grad_clip)
    lr = learning_rate(ocfg, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    mark("optimizer")
    return {k: v.detach() for k, v in metrics.items()}


def make_eval_step(train_cfg: TrainConfig):
    """The JAX make_eval_step: eval_step(state, batch) -> the metrics of
    compute_losses with `train_cfg`, at the state's step, without gradients."""
    check_ported(train_cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping) -> dict[str, torch.Tensor]:
        _, metrics = compute_losses(dataclasses.replace(state, train_cfg=train_cfg), batch)
        return metrics

    return eval_step
