"""The autoencoder's kernel = stride convolutions two ways, on the card.

    python3 mimm_tpu_torch/tools/patch_conv_timing.py

JAX computes ``PatchConv`` / ``PatchConvTranspose`` (mimm_tpu/models/
autoencoder.py:27-77) as a reshape and one matmul.  This times, in
bfloat16 at B=64, forward alone and forward + backward (input and weight
gradients):

* cuDNN: ``F.conv2d`` / ``F.conv_transpose2d`` with stride = kernel;
* matmul: the patches as rows, one ``torch.matmul`` with the weight as a
  matrix, and the layout copies around it (``patch_conv`` /
  ``patch_conv_transpose`` of models/autoencoder.py, which the port runs);

at the widest skip convolutions of the full-width ResNetAE (encoder
``skip0_conv``: 8 -> 512 channels, k = s = 64 over 256 x 256; decoder
``skip5_conv``: 512 -> 8, k = s = 64 from 4 x 4) and at the 2 x 2
down/up convolutions of the first and last levels.  Each pair is checked
to agree, and the times (CUDA events, median of 20) are printed with the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from mimm_tpu_torch.models.autoencoder import (  # noqa: E402
    patch_conv, patch_conv_transpose)

BATCH = 64
# (name, transpose, in channels, out channels, k, input side)
SHAPES = (("encoder skip0_conv", False, 8, 512, 64, 256),
          ("decoder skip5_conv", True, 512, 8, 64, 4),
          ("encoder down0_conv", False, 8, 16, 2, 256),
          ("decoder up5_conv", True, 16, 8, 2, 128))


def time_ms(fn, iters=20) -> float:
    times = []
    for _ in range(iters + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[3:])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    for name, transpose, cin, cout, k, side in SHAPES:
        x = torch.rand(BATCH, cin, side, side, generator=gen, device="cuda"
                       ).to(dt).requires_grad_()
        wshape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        w = (torch.randn(wshape, generator=gen, device="cuda")
             / (cin * k * k) ** 0.5).to(dt).requires_grad_()
        b = torch.randn(cout, generator=gen, device="cuda").to(dt) \
            .requires_grad_()
        arms = {"cudnn": (lambda: F.conv_transpose2d(x, w, b, stride=k))
                if transpose else (lambda: F.conv2d(x, w, b, stride=k)),
                "matmul": (lambda: patch_conv_transpose(x, w, b, k))
                if transpose else (lambda: patch_conv(x, w, b, k))}
        ys = {a: f() for a, f in arms.items()}
        dy = torch.randn(ys["cudnn"].shape, generator=gen, device="cuda"
                         ).to(dt)
        grads = {a: torch.autograd.grad(y, (x, w, b), dy)
                 for a, y in ys.items()}
        scale = ys["cudnn"].float().abs().max().item()
        row = {"conv": name, "in": [BATCH, cin, side, side],
               "out": list(ys["cudnn"].shape), "k": k,
               "fwd_rel_diff": (ys["cudnn"].float() - ys["matmul"].float())
               .abs().max().item() / scale,
               "grad_rel_diff": max(
                   (g0.float() - g1.float()).abs().max().item()
                   / max(g0.float().abs().max().item(), 1e-30)
                   for g0, g1 in zip(grads["cudnn"], grads["matmul"]))}
        for arm, fn in arms.items():
            with torch.no_grad():
                row[f"{arm}_fwd_ms"] = time_ms(fn)
            row[f"{arm}_fwd_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(fn(), (x, w, b), dy))
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
