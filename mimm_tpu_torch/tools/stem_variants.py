"""The stem's forward and dW kernels (csrc/shallow_conv.cu) against
variants that each undo one design choice, timed in turns on one card,
beside the card's own write, read and copy rates at the same sizes.

Run from the repository root on a machine with the card:

    python3 mimm_tpu_torch/tools/stem_variants.py

A variant is the committed source with one exact text substitution (the
script stops if the source no longer holds the text), built with nvcc into
build/stem_variants/<name>, checked against the plain versions
(chip_smoke.check_stem at the train step's shape and two ragged ones) and
timed by profiler device time over ITERS calls at (64, 256, 256), f32 and
bf16, twice, in the order a b .. z z .. b a.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from mimm_tpu_torch.ops import _build  # noqa: E402
from mimm_tpu_torch.ops import shallow_conv as sc  # noqa: E402

SHAPE = (64, 256, 256)
ITERS = 40
CHECK_SHAPES = (SHAPE, (3, 257, 131), (2, 64, 196))
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "stem_variants")

# the forward's weights in registers (72 of them), as first designed
SMEM_WEIGHTS = (
    "  __shared__ float ws[C * K];                 // w[c, dr, dc] at [c·K + k]\n"
    "  if (threadIdx.x < C * K) ws[threadIdx.x] = w[threadIdx.x];\n"
    "  __syncthreads();\n")
REG_WEIGHTS = ("  float ws[C * K];\n#pragma unroll\n"
               "  for (int j = 0; j < C * K; ++j) ws[j] = w[j];\n")
FWD_BOUNDS = "__launch_bounds__(WALK_THREADS, FWD_BLOCKS)\nfwd_kernel("
PLAIN_STORES = ('#include "warp_mma.cuh"   // pack_bf16\n',
                '#include "warp_mma.cuh"   // pack_bf16\n'
                "#define __stcs(p, v) (*(p) = (v))\n")
# rows dealt to the warps one by one (a compact write front), not in runs
WALK = ("  long long i = w * N / n;\n"
        "  const long long end = (w + 1) * N / n;\n"
        "  while (i < end) {")
ROUND_ROBIN = "  for (long long i = w, end = w + 1; i < N; i += n - 1, end = i + 1) {"
DW_P = ("  constexpr int P = VEC_PX<TG>;\n  using G", "  constexpr int P = 4;\n  using G")
DW_LAUNCH_P = ("  constexpr int P = VEC_PX<Bt>;\n  const int grid = dw_blocks",
               "  constexpr int P = 4;\n  const int grid = dw_blocks")
DW_GRID3 = ("constexpr int DW_GRID = 2 * 132;", "constexpr int DW_GRID = 3 * 132;")
VARIANTS = {
    "final": [],
    "weights_in_registers": [(SMEM_WEIGHTS, REG_WEIGHTS),
                             (FWD_BOUNDS, "__launch_bounds__(WALK_THREADS)\n"
                                          "fwd_kernel("), PLAIN_STORES],
    "weights_in_registers_4_blocks": [
        (SMEM_WEIGHTS, REG_WEIGHTS),
        (FWD_BOUNDS, "__launch_bounds__(WALK_THREADS, 4)\nfwd_kernel(")],
    "plain_stores": [PLAIN_STORES],
    "rows_round_robin": [(WALK, ROUND_ROBIN)],
    "dw_p4": [DW_P, DW_LAUNCH_P],
    "dw_p4_grid_3x132": [DW_P, DW_LAUNCH_P, DW_GRID3],
}


def variant_source(edits) -> str:
    with open(os.path.join(_build.CSRC, f"{sc.SOURCE}.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str):
    """(name, library, {kernel: (registers, spill bytes)})."""
    work = os.path.join(OUT, name)
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, f"{sc.SOURCE}.cu")
    with open(src, "w") as f:
        f.write(variant_source(VARIANTS[name]))
    lib = os.path.join(work, f"lib{sc.SOURCE}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    usage = {f: (r, st) for f, (r, st, _) in
             smoke.ptxas_usage(proc.stderr).items()
             if "fwd_kernel" in f or "dw_kernel" in f}
    return name, ctypes.CDLL(lib), usage


def use(lib) -> None:
    _build.load = lambda _name: lib
    sc._entry.cache_clear()


def times(inputs) -> dict:
    out = {}
    for dt, (x, weight, dy) in inputs.items():
        name = str(dt).split(".")[1]
        out[f"fwd {name}"] = smoke.device_ms(
            lambda: sc.fwd(x, weight, dt), iters=ITERS)
        out[f"dw {name}"] = smoke.device_ms(
            lambda: sc.dw(x, dy, weight), iters=ITERS)
    return out


def card_rates() -> dict:
    """TB/s of fill_ (write), sum (read) and copy_ (read + write) at the
    size of y, in each dtype."""
    rates = {}
    for dt in smoke.DTYPES:
        y = torch.empty(SHAPE[0], 8, *SHAPE[1:], dtype=dt, device="cuda")
        src = torch.randn(y.shape, device="cuda").to(dt)
        nbytes = y.numel() * y.element_size()
        for label, fn, moved in (("fill_", lambda: y.fill_(1.0), nbytes),
                                 ("sum", lambda: src.sum(), nbytes),
                                 ("copy_", lambda: y.copy_(src), 2 * nbytes)):
            ms = smoke.device_ms(fn, iters=ITERS)
            rates[f"{label} {str(dt).split('.')[1]}"] = {
                "ms": ms, "tb_per_s": moved / ms / 1e9}
        del y, src
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {n: (lib, u) for n, lib, u in pool.map(build, VARIANTS)}
    for name, (lib, usage) in built.items():
        use(lib)
        print(f"{name}: ptxas (registers, spill bytes) "
              + ", ".join(f"{f.split('shallow_conv')[1][:30]} {u}"
                          for f, u in sorted(usage.items())))
        smoke.check_stem("cuda", shapes=CHECK_SHAPES)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 15)
    inputs = {dt: smoke.stem_inputs(*SHAPE, dt, gen, "cuda")
              for dt in smoke.DTYPES}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    result = {n: [] for n in VARIANTS}
    for name in order:
        use(built[name][0])
        result[name].append(times(inputs))
    for name, runs in result.items():
        print(f"{name}: " + ", ".join(
            f"{k} " + " / ".join(f"{r[k] * 1e3:.2f}" for r in runs)
            for k in runs[0]) + f" us  [{card}]")
    rates = card_rates()
    for k, v in rates.items():
        print(f"card {k}: {v['ms'] * 1e3:.2f} us, {v['tb_per_s']:.3f} TB/s "
              f"at {SHAPE[0]} x 8 x {SHAPE[1]} x {SHAPE[2]}  [{card}]")
    print(json.dumps({"card": card, "variants": result, "rates": rates,
                      "registers": {n: u for n, (_, u) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
