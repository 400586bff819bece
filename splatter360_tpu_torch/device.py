"""Device selection for the port's entry points.

Entry points default to the card and never fall back to the CPU on their own:
the CPU is used only when the caller asks for it (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev


def set_f32_policy() -> None:
    """Full float32 wherever the bf16 policy casts nothing: no TF32 in
    matmuls or cuDNN convs. cuDNN convolutions default to TF32
    (allow_tf32=True) on Ampere and later; the port turns it off so its
    numbers stay comparable with the f32 reference.

    bf16 GEMMs, which run only under the bf16 policy
    (models/encoder.apply_encoder), forward and backward, reduce in float32
    as XLA's do: cuBLAS may otherwise reduce them in reduced precision
    (allow_bf16_reduced_precision_reduction, True by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
