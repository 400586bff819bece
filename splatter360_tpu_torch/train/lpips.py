"""LPIPS with a VGG16 backbone, the perceptual term of the training loss.

Counterpart of splatter360_tpu/train/lpips_jax.py: VGG16 conv features at
relu1_2/2_2/3_3/4_3/5_3 (3x3 convolutions with zero padding 1, 2x2 max
pools), inputs shifted and scaled by the LPIPS constants, channels
unit-normalised (+1e-10 inside the square root), |lin| channel weights, a
spatial mean, and the sum over the five layers. Parameter names follow the
flax module (`vgg.conv{stage}_{i}`, `lin{i}`) so convert.lpips_state_from_flax
maps them one to one. The network is frozen: it takes no optimizer state.

No LPIPS weights are in the repository, so `init_lpips` draws seeded random
VGG features (and lin = 1/C, flax's initial value) unless a torch LPIPS
state dict is loaded (`load_lpips_torch_weights`, the JAX package's key
map).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = (
    (64, 64),            # -> relu1_2
    (128, 128),          # -> relu2_2
    (256, 256, 256),     # -> relu3_3
    (512, 512, 512),     # -> relu4_3
    (512, 512, 512),     # -> relu5_3
)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for si, stage in enumerate(_VGG_CFG):
            for ci, ch in enumerate(stage):
                self.add_module(f"conv{si}_{ci}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [B, 3, H, W] -> the five stages' features, NCHW."""
        feats = []
        for si, stage in enumerate(_VGG_CFG):
            for ci in range(len(stage)):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            feats.append(x)
            if si != len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, stage in enumerate(_VGG_CFG):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((stage[-1],), 1.0 / stage[-1])))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1 [B, H, W, 3] in [0, 1] -> [B] distances."""
        shift = torch.tensor(_SHIFT, dtype=img0.dtype, device=img0.device)
        scale = torch.tensor(_SCALE, dtype=img0.dtype, device=img0.device)

        def norm_input(x):
            return ((2.0 * x - 1.0 - shift) / scale).permute(0, 3, 1, 2)

        f0 = self.vgg(norm_input(img0))
        f1 = self.vgg(norm_input(img1))
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            w = torch.abs(getattr(self, f"lin{i}"))
            d = torch.sum((a - b) ** 2 * w[None, :, None, None], dim=1)
            total = total + torch.mean(d, dim=(-2, -1))
        return total


def init_lpips(model: LPIPS, seed: int) -> None:
    """Seeded random VGG weights N(0, 1/fan_in) and zero biases, drawn on the
    CPU in parameter-name order; the lin weights keep 1/C."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.vgg.named_parameters()):
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.zero_()


# the torchvision vgg16 `features` indices of the 13 convolutions, by stage
_TORCH_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def load_lpips_torch_weights(model: LPIPS, path) -> LPIPS:
    """Load a torch LPIPS(net='vgg') state dict file into `model` in place,
    with the key map of the JAX package's load_lpips_torch_weights
    (lpips_jax.py): the convolutions from `net.slice{s}.{i}.*`, or from the
    raw torchvision layout `features.{i}.*`, and each lin weight from
    `lins.{i}.model.1.weight` where the file has it (else it keeps its
    value). The file must hold a state dict (torch.load with
    weights_only=True)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for si, idxs in enumerate(_TORCH_CONV_IDX):
            for ci, ti in enumerate(idxs):
                prefix = f"net.slice{si + 1}.{ti}."
                if prefix + "weight" not in sd:
                    prefix = f"features.{ti}."
                conv = getattr(model.vgg, f"conv{si}_{ci}")
                conv.weight.copy_(sd[prefix + "weight"])
                conv.bias.copy_(sd[prefix + "bias"])
        for i in range(len(_VGG_CFG)):
            key = f"lins.{i}.model.1.weight"
            if key in sd:
                getattr(model, f"lin{i}").copy_(sd[key][0, :, 0, 0])
    return model


def make_lpips_fn(weights_path: str | None = None, device: str | torch.device = "cuda"):
    """LPIPS distance fn(pred [B, H, W, 3] in [0, 1], gt) -> [B], frozen, on
    `device`: the counterpart of make_lpips_fn (splatter360_tpu/train/
    lpips_jax.py): the weights of `weights_path` (load_lpips_torch_weights),
    or, without one, seeded random VGG features (init_lpips, seed 0), with
    the JAX package's warning."""
    import sys

    from ..device import resolve_device

    dev = resolve_device(device)
    model = LPIPS()
    if weights_path:
        load_lpips_torch_weights(model, weights_path)
    else:
        print("warning: LPIPS using seeded-random VGG features (no weights checkpoint) — values "
              "are run-stable but not comparable to published LPIPS; set "
              "train.loss.lpips_weights for parity.", file=sys.stderr)
        init_lpips(model, 0)
    model = model.requires_grad_(False).to(dev).eval()

    @torch.no_grad()
    def lpips_fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return model(pred, gt)

    return lpips_fn
