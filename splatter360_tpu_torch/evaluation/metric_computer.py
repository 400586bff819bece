"""Offline metric recomputation over methods' saved frames.

Counterpart of splatter360_tpu/evaluation/metric_computer.py: for each
method directory, PSNR and SSIM (and LPIPS, given a metric fn) of every
frame against the ground-truth frame of the same name, side-by-side sheets,
and metrics.json.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..train.metrics import compute_psnr, compute_ssim
from ..utils.image_io import hcat, load_image, save_image


def compute_metrics_offline(gt_dir: str, method_dirs: dict, out_dir: str, lpips_fn=None,
                            save_sheets: bool = True,
                            device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gt_files = sorted(Path(gt_dir).glob("*.png"))
    results: dict = {}
    for method, mdir in method_dirs.items():
        psnrs, ssims, lpipss = [], [], []
        for f in gt_files:
            pred_path = Path(mdir) / f.name
            if not pred_path.exists():
                continue
            gt, pred = load_image(f)[None], load_image(pred_path)[None]
            g, p = torch.as_tensor(gt, device=dev), torch.as_tensor(pred, device=dev)
            psnrs.append(float(compute_psnr(g, p)[0]))
            ssims.append(float(compute_ssim(g, p)[0]))
            if lpips_fn is not None:
                lpipss.append(float(lpips_fn(p, g)[0]))
            if save_sheets:
                save_image(hcat(pred[0], gt[0], pad=4), out / "sheets" / method / f.name)
        results[method] = {
            "psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None,
            "lpips": float(np.mean(lpipss)) if lpipss else None,
            "n": len(psnrs),
        }
        print(f"{method}: {results[method]}")
    (out / "metrics.json").write_text(json.dumps(results, indent=2))
    return results
