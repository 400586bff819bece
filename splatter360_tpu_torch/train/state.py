"""Train state and the train step with ERP supervision.

Counterpart of splatter360_tpu/train/state.py (`OptimizerConfig`,
`TrainConfig`, `make_optimizer`, `create_train_state`, the ERP branch of
`compute_losses`, `make_train_step`):

    state = create_train_state(HM3D, TrainConfig(), seed=0)   # device="cuda"
    metrics = train_step(state, batch)                        # one update

One step: encode the context panoramas -> Gaussians -> render the target
panoramas (one compositor launch for all views, fused CUDA backward) ->
sin(phi)-weighted ERP MSE + LPIPS + sin(phi)-weighted depth L1 on the
encoder's depth map -> global-norm clip (optax's formula) -> Adam with
optax's cosine one-cycle schedule. A batch is the JAX package's dict:
{"context": {image_sphere [B, V, H, W, 3], extrinsics_sphere [B, V, 4, 4],
depth_sphere [B, V, H, W], near, far [B, V]}, "target": {image_sphere,
extrinsics_sphere, near, far}}. Computes in float32 with TF32 off.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device, set_f32_policy
from ..models import decoder
from ..models.encoder import EncoderConfig, EncoderCostVolume360
from ..serve import build_model, context_cubes
from .losses import LossConfig, sin_weighted_depth_l1, sin_weighted_mse
from .lpips import LPIPS, init_lpips
from .metrics import compute_psnr


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-4
    cosine_lr: bool = True  # False (optax's linear warm-up) is not ported
    max_steps: int = 100_000
    grad_clip: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    supervision: str = "erp"  # "cubes" is not ported
    shard_faces: bool = False
    shard_render: bool = False


def _check_ported(train_cfg: TrainConfig) -> None:
    if train_cfg.supervision != "erp":
        raise NotImplementedError(f"supervision={train_cfg.supervision!r}: only 'erp' is ported")
    for flag in ("shard_faces", "shard_render"):
        if getattr(train_cfg, flag):
            raise NotImplementedError(f"{flag}=True is not ported")
    if not train_cfg.optimizer.cosine_lr:
        raise NotImplementedError("cosine_lr=False (the linear warm-up schedule) is not ported")
    if train_cfg.loss.lpips_weights:
        raise NotImplementedError("loading LPIPS weights (loss.lpips_weights) is not ported")
    if train_cfg.loss.depth_smoothness_weight > 0:
        raise NotImplementedError("depth_smoothness_weight > 0 is not ported")


def learning_rate(cfg: OptimizerConfig, count: int) -> float:
    """optax.cosine_onecycle_schedule(steps, lr, pct_start) at update `count`
    (the count before the increment), with steps = max(max_steps, 2) and
    pct_start = max(0.01, 1.001 / steps), in optax's float32 arithmetic:
    from lr/25 up to lr at step int(pct_start * steps), then down to
    lr/(25 * 1e4) at `steps`, by cosine interpolation."""
    steps = max(cfg.max_steps, 2)
    bounds = (0, int(max(0.01, 1.001 / steps) * steps), int(steps))
    values = np.cumprod([cfg.lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    f32 = np.float32
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
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0);
    train_step sets the learning rate of each update from learning_rate()."""
    return torch.optim.Adam(params, lr=learning_rate(cfg, 0), betas=(0.9, 0.999), eps=1e-8)


def create_train_state(encoder_cfg: EncoderConfig, train_cfg: TrainConfig, seed: int = 0,
                       device: str | torch.device = "cuda",
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       lpips_state: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
    """The encoder with `state_dict` or seeded random weights, the frozen
    LPIPS network (when its weight is > 0) with `lpips_state` or seeded
    random features, Adam and a step counter at 0, on `device`."""
    _check_ported(train_cfg)
    dev = resolve_device(device)
    set_f32_policy()
    model = build_model(encoder_cfg, seed=seed, device=dev, state_dict=state_dict).train()
    lpips = None
    if train_cfg.loss.lpips_weight > 0:
        lpips = LPIPS()
        if lpips_state is None:
            init_lpips(lpips, seed)
        else:
            lpips.load_state_dict(lpips_state)
        lpips = lpips.requires_grad_(False).to(dev).eval()
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), train_cfg.optimizer),
                      encoder_cfg=encoder_cfg, train_cfg=train_cfg, lpips=lpips)


def _on_device(batch: Mapping, dev: torch.device) -> dict:
    return {part: {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                   for k, v in batch[part].items() if k != "index"}
            for part in ("context", "target")}


def compute_losses(state: TrainState, batch: Mapping,
                   on_stage: Optional[Callable[[str], None]] = None):
    """The ERP branch of the JAX compute_losses: (total loss, metrics).
    `on_stage(name)`, if given, is called after "encoder", "render" and
    "losses" (chip_smoke.py records CUDA events there)."""
    mark = on_stage or (lambda name: None)
    dev = next(state.model.parameters()).device
    batch = _on_device(batch, dev)
    ctx, tgt = batch["context"], batch["target"]
    h, w = ctx["image_sphere"].shape[2:4]
    gaussians, pred_depth = state.model(
        ctx["image_sphere"], context_cubes(ctx["image_sphere"], h // 2),
        ctx["extrinsics_sphere"], ctx["near"], ctx["far"], state.step)
    mark("encoder")
    rendered = decoder.render_erp_views(gaussians, tgt["extrinsics_sphere"], tgt["near"],
                                        tgt["far"], (h, w))
    mark("render")

    lcfg = state.train_cfg.loss
    pred, gt = rendered.color, tgt["image_sphere"]
    loss_mse = sin_weighted_mse(pred, gt)
    flat_pred, flat_gt = pred.reshape(-1, h, w, 3), gt.reshape(-1, h, w, 3)
    metrics = {"psnr": torch.mean(compute_psnr(flat_gt, flat_pred.detach())),
               "loss_mse": loss_mse,
               # splats lost to emission-cap overflow over all rendered views
               "dropped": torch.sum(rendered.dropped).to(torch.float32)}
    total = lcfg.mse_weight * loss_mse
    if lcfg.lpips_weight > 0 and state.lpips is not None:
        if state.step >= lcfg.lpips_apply_after_step:
            lp = torch.mean(state.lpips(flat_pred, flat_gt))
        else:
            lp = torch.zeros((), device=dev)
        total = total + lcfg.lpips_weight * lp
        metrics["loss_lpips"] = lp
    if lcfg.depth_weight > 0:
        ld = sin_weighted_depth_l1(pred_depth, ctx["depth_sphere"], ctx["far"])
        total = total + lcfg.depth_weight * ld
        metrics["loss_depth"] = ld
    metrics["loss"] = total
    mark("losses")
    return total, metrics


def train_step(state: TrainState, batch: Mapping,
               on_stage: Optional[Callable[[str], None]] = None) -> dict[str, torch.Tensor]:
    """One update of `state` in place (parameters, Adam moments, step + 1).
    Returns the metrics of the step: loss, loss_mse, loss_lpips, loss_depth,
    psnr, dropped and grad_norm (of the unclipped gradients). `on_stage` is
    also called after "backward" and "optimizer"."""
    mark = on_stage or (lambda name: None)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_losses(state, batch, on_stage)
    loss.backward()
    mark("backward")
    ocfg = state.train_cfg.optimizer
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    metrics["grad_norm"] = clip_by_global_norm_(grads, ocfg.grad_clip)
    lr = learning_rate(ocfg, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    mark("optimizer")
    return {k: v.detach() for k, v in metrics.items()}
