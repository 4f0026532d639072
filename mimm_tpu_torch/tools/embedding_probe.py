"""Which embedding backward gives the same bits on every call, and at what
cost, on the card (no deterministic-algorithms flag anywhere).

    python3 mimm_tpu_torch/tools/embedding_probe.py

At BERT's three lookups in a B=64 step at L=96 and L=320 (word ids with
each row's tail padded with id 0, position ids arange(L), token types all
0), in float32 and bfloat16, five backward calls each of:

* ``F.embedding`` (autograd);
* ``index_put_(accumulate=True)`` into a float32 zero table;
* ``index_add_`` into a float32 zero table;
* the port's ``embedding_lookup`` (ops/embedding.py).

Prints, for each, whether the five results are the same bits, the largest
error against a float64 sum, and the median milliseconds of a call (CUDA
events), with the card's name and power limit.
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

from mimm_tpu_torch.ops.embedding import embedding_backward  # noqa: E402

VOCAB, TYPES, POSITIONS, WIDTH, BATCH = 30522, 2, 512, 768, 64
REPEATS = 5


def lookups(seq: int, gen, device):
    """(name, ids, rows) of the three lookups at (BATCH, seq)."""
    words = torch.randint(5, VOCAB, (BATCH, seq), generator=gen,
                          device=device)
    lengths = torch.randint(seq // 4, seq + 1, (BATCH, 1), generator=gen,
                            device=device)
    pos = torch.arange(seq, device=device)
    words = torch.where(pos[None] < lengths, words, 0)
    words[:, 0] = 2
    return (("word", words, VOCAB), ("position", pos, POSITIONS),
            ("token_type", torch.zeros_like(words), TYPES))


def by_autograd(ids, dy, rows):
    w = torch.zeros(rows, dy.shape[-1], device=dy.device,
                    dtype=dy.dtype).requires_grad_()
    (g,) = torch.autograd.grad(F.embedding(ids, w), (w,), dy)
    return g


def by_index_put(ids, dy, rows):
    out = torch.zeros(rows, dy.shape[-1], device=dy.device)
    out.index_put_((ids.reshape(-1),), dy.reshape(-1, dy.shape[-1]).float(),
                   accumulate=True)
    return out


def by_index_add(ids, dy, rows):
    out = torch.zeros(rows, dy.shape[-1], device=dy.device)
    return out.index_add_(0, ids.reshape(-1),
                          dy.reshape(-1, dy.shape[-1]).float())


def by_port(ids, dy, rows):
    return embedding_backward(ids, dy, rows)


CANDIDATES = {"F.embedding": by_autograd, "index_put_": by_index_put,
              "index_add_": by_index_add, "embedding_lookup": by_port}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.are_deterministic_algorithms_enabled()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for seq in (96, 320):
        for name, ids, rows in lookups(seq, gen, "cuda"):
            shape = (*ids.shape, WIDTH)
            for dtype in (torch.float32, torch.bfloat16):
                # the position lookup's gradient arrives summed over the
                # batch: (L, width), each index once
                dy = torch.randn(*shape, generator=gen, device="cuda"
                                 ).to(dtype)
                exact = torch.zeros(rows, WIDTH, device="cuda",
                                    dtype=torch.float64).index_put_(
                    (ids.reshape(-1),),
                    dy.reshape(-1, WIDTH).double(), accumulate=True)
                for cand, fn in CANDIDATES.items():
                    outs = [fn(ids, dy, rows) for _ in range(REPEATS)]
                    same = all(torch.equal(outs[0], o) for o in outs[1:])
                    err = (outs[0].double() - exact).abs().max().item()
                    ms = time_ms(lambda: fn(ids, dy, rows))
                    row = {"lookup": name, "seq": seq,
                           "dtype": str(dtype).split(".")[-1],
                           "candidate": cand, "same_bits": same,
                           "max_abs_err_vs_f64": err, "ms": ms}
                    print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
