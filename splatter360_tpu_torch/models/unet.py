"""2D U-Net with optional cross-view self-attention, NHWC.

Counterpart of splatter360_tpu/models/unet.py (inference only, so no
activation checkpointing). Submodule names follow Flax's creation order
(Conv_i, ResBlock_i, AttentionBlock_i, GroupNorm_0) so parameters map by path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import torch
from torch import nn

from .layers import Conv, Dense, GroupNorm, const, silu


def _gn(c: int) -> GroupNorm:
    return GroupNorm(min(32, c), c)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.GroupNorm_0 = _gn(in_channels)
        self.Conv_0 = Conv(in_channels, out_channels, 3)
        self.GroupNorm_1 = _gn(out_channels)
        self.Conv_1 = Conv(out_channels, out_channels, 3)
        self.Conv_2 = Conv(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x):
        h = self.Conv_0(silu(self.GroupNorm_0(x)))
        h = self.Conv_1(silu(self.GroupNorm_1(h)))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return x + h


class AttentionBlock(nn.Module):
    """Self-attention over spatial tokens, jointly across views if cross_view."""

    def __init__(self, channels: int, num_head_channels: int = 32, cross_view: bool = True):
        super().__init__()
        self.heads = max(channels // num_head_channels, 1)
        self.cross_view = cross_view
        self.GroupNorm_0 = _gn(channels)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)

    def forward(self, x, num_views: int):
        bv, h, w, c = x.shape
        nh, d = self.heads, c // self.heads
        q, k, v = self.qkv(self.GroupNorm_0(x).reshape(bv, h * w, c)).chunk(3, dim=-1)
        b, l = bv, h * w
        if self.cross_view and num_views > 1:
            b, l = bv // num_views, num_views * h * w
        q, k, v = (t.reshape(b, l, nh, d).transpose(1, 2) for t in (q, k, v))
        scores = q @ k.transpose(-1, -2) / const(d ** 0.5, q)
        attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        out = (attn @ v).transpose(1, 2).reshape(bv, h * w, c)
        return x + self.proj(out).reshape(bv, h, w, c)


class UNet2D(nn.Module):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int = 1, attn_resolutions: Sequence[int] = (),
                 channel_mult: Sequence[int] = (1, 1, 1), num_head_channels: int = 32,
                 cross_view_attn: bool = True):
        super().__init__()
        counters: dict = defaultdict(int)
        ops: list = []

        def add(kind, module, op):
            name = f"{kind}_{counters[kind]}"
            counters[kind] += 1
            self.add_module(name, module)
            ops.append((op, name))

        def attn(c):
            add("AttentionBlock", AttentionBlock(c, num_head_channels, cross_view_attn), "attn")

        mc = model_channels
        ch = mc
        add("Conv", Conv(in_channels, ch, 3), "conv")
        skips = [ch]
        ops.append(("push", None))
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                add("ResBlock", ResBlock(ch, mult * mc), "res")
                ch = mult * mc
                if ds in attn_resolutions:
                    attn(ch)
                skips.append(ch)
                ops.append(("push", None))
            if level != len(channel_mult) - 1:
                add("Conv", Conv(ch, ch, 3, stride=2), "conv")
                ds *= 2
                skips.append(ch)
                ops.append(("push", None))
        add("ResBlock", ResBlock(ch, ch), "res")
        if attn_resolutions:
            attn(ch)
        add("ResBlock", ResBlock(ch, ch), "res")
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                ops.append(("pop", None))
                add("ResBlock", ResBlock(ch + skips.pop(), mult * mc), "res")
                ch = mult * mc
                if ds in attn_resolutions:
                    attn(ch)
                if level and i == num_res_blocks:
                    add("Conv", Conv(ch, ch, 3), "up")
                    ds //= 2
        add("GroupNorm", _gn(ch), "norm")
        add("Conv", Conv(ch, out_channels, 3), "conv")
        self._ops = ops

    def forward(self, x, num_views: int = 2):
        """x [B*V, H, W, C_in] -> [B*V, H, W, out_channels]."""
        h = x
        skips = []
        for op, name in self._ops:
            if op == "push":
                skips.append(h)
            elif op == "pop":
                h = torch.cat([h, skips.pop()], dim=-1)
            elif op == "attn":
                h = getattr(self, name)(h, num_views)
            elif op == "up":
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = getattr(self, name)(h)
            elif op == "norm":
                h = silu(getattr(self, name)(h))
            else:
                h = getattr(self, name)(h)
        return h
