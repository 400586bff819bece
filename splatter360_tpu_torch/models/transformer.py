"""Multi-view Swin-style feature transformer (NHWC, static shifted windows).

Counterpart of splatter360_tpu/models/transformer.py: per layer a windowed
self-attention and a cross-view attention whose keys/values are the other
views' tokens at the same window position (or, with no_cross_attn, the
self-attention alone with the FFN); every second layer shifts the windows by
half a window with the precomputed Swin mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .layers import const, gelu, layer_norm


@functools.lru_cache(maxsize=32)
def _shifted_window_mask(h: int, w: int, splits: int) -> np.ndarray:
    """Swin SW-MSA mask: [nW, L, L] additive (-100 across regions) float32."""
    wh, ww = h // splits, w // splits
    sh, sw = wh // 2, ww // 2
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, h - wh), slice(h - wh, h - sh), slice(h - sh, None)):
        for ws in (slice(0, w - ww), slice(w - ww, w - sw), slice(w - sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(splits, wh, splits, ww).transpose(0, 2, 1, 3)
    win = win.reshape(splits * splits, wh * ww)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _partition(x: torch.Tensor, splits: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., nW, L, C]."""
    *lead, h, w, c = x.shape
    wh, ww = h // splits, w // splits
    x = x.reshape(*lead, splits, wh, splits, ww, c).movedim(-3, -4)
    return x.reshape(*lead, splits * splits, wh * ww, c)


def _merge(x: torch.Tensor, splits: int, h: int, w: int) -> torch.Tensor:
    *lead, nw, l, c = x.shape
    wh, ww = h // splits, w // splits
    x = x.reshape(*lead, splits, splits, wh, ww, c).movedim(-4, -3)
    return x.reshape(*lead, h, w, c)


class TransformerLayer(nn.Module):
    """Single-head attention, post-norm, optional concat-FFN."""

    def __init__(self, d_model: int, no_ffn: bool = False, ffn_dim_expansion: int = 4):
        super().__init__()
        c = d_model
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = layer_norm(c)
        self.no_ffn = no_ffn
        if not no_ffn:
            self.Dense_0 = nn.Linear(2 * c, 2 * c * ffn_dim_expansion, bias=False)
            self.Dense_1 = nn.Linear(2 * c * ffn_dim_expansion, c, bias=False)
            self.norm2 = layer_norm(c)

    def forward(self, source, target, mask=None):
        c = source.shape[-1]
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        scores = q @ k.transpose(-1, -2) / const(c ** 0.5, q)
        if mask is not None:
            scores = scores + mask
        attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        message = self.norm1(self.merge(attn @ v))
        if not self.no_ffn:
            y = gelu(self.Dense_0(torch.cat([source, message], dim=-1)))
            message = self.norm2(self.Dense_1(y))
        return source + message


class MultiViewFeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4, no_cross_attn: bool = False):
        super().__init__()
        self.num_layers, self.no_cross_attn = num_layers, no_cross_attn
        for i in range(num_layers):
            # without cross-view attention (wo_backbone_cross_attn) the self
            # layer carries the FFN
            self.add_module(f"layer{i}_self",
                            TransformerLayer(d_model, not no_cross_attn, ffn_dim_expansion))
            if not no_cross_attn:
                self.add_module(f"layer{i}_cross",
                                TransformerLayer(d_model, False, ffn_dim_expansion))

    def forward(self, features: torch.Tensor, attn_splits: int = 2) -> torch.Tensor:
        """features [B, V, H, W, C] -> same shape."""
        b, v, h, w, c = features.shape
        shift_mask = torch.as_tensor(_shifted_window_mask(h, w, attn_splits),
                                     device=features.device, dtype=features.dtype)
        wh, ww = h // attn_splits, w // attn_splits
        sh, sw = wh // 2, ww // 2

        def windowed(attn, xs, cross, with_shift):
            y = torch.roll(xs, shifts=(-sh, -sw), dims=(-3, -2)) if with_shift else xs
            win = _partition(y, attn_splits)  # [B, V, nW, L, C]
            if cross and v > 1:
                kv = torch.stack([
                    torch.cat([win[:, j] for j in range(v) if j != i], dim=-2)
                    for i in range(v)
                ], dim=1)
                m = shift_mask.repeat(1, 1, v - 1) if with_shift else None
                out = attn(win, kv, m)
            else:
                out = attn(win, win, shift_mask if with_shift else None)
            out = _merge(out, attn_splits, h, w)
            return torch.roll(out, shifts=(sh, sw), dims=(-3, -2)) if with_shift else out

        x = features
        for i in range(self.num_layers):
            shift = i % 2 == 1
            x = windowed(getattr(self, f"layer{i}_self"), x, False, shift)
            if not self.no_cross_attn:
                x = windowed(getattr(self, f"layer{i}_cross"), x, True, shift)
        return x
