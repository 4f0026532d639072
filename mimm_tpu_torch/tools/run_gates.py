"""Run the port's gate tests and record their verdicts as an artifact
(tools/run_gates.py counterpart): one JSON record per gate (timestamp,
wall time, the pytest tail) appended to ``artifacts/torch/gates.jsonl``.

Gates (CPU, several processes; none needs the card):
  multihost   tests/test_torch_multihost_smoke.py: the real 4-process
              ``multihost_smoke`` (dp, tp + sp + GradCache and pp lanes,
              the sharded save and restore) and its data lane against
              JAX's unsharded step.  It takes seconds, so tier-1 runs it
              too: no variable opts it in.
  prodshape   tests/test_torch_prodshape_parity.py with
              MIMM_RUN_TORCH_PRODSHAPE=1: BERT-base's 40 float32 MI steps
              inside the torch oracle's rounding band.
  mesh        tests/test_torch_prodshape_mesh.py with
              MIMM_RUN_TORCH_PRODSHAPE_MESH=1: JAX's three mesh lanes at
              BERT-base width, 8 gloo ranks, against one rank.
  Tier-1 runs the narrow case of both files without the variable.

    python -m mimm_tpu_torch.tools.run_gates [--only multihost|prodshape|mesh]
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

from mimm_tpu_torch.tools.mm_vs_um_seeds import OUT_DIR, PACKAGE_PARENT

# name -> (the variable that opts the test in, None for a test tier-1
# runs anyway, the test file)
GATES = {
    "multihost": (None, "tests/test_torch_multihost_smoke.py"),
    "prodshape": ("MIMM_RUN_TORCH_PRODSHAPE",
                  "tests/test_torch_prodshape_parity.py"),
    "mesh": ("MIMM_RUN_TORCH_PRODSHAPE_MESH",
             "tests/test_torch_prodshape_mesh.py"),
}


def figures(out: str) -> list:
    """The JSON objects a gate's tests printed (one a line, after any
    progress dots pytest wrote on the same line)."""
    found = []
    for line in out.splitlines():
        start = line.find("{")
        if start < 0:
            continue
        try:
            obj = json.loads(line[start:])
        except ValueError:
            continue
        if isinstance(obj, dict):
            found.append(obj)
    return found


def run_gate(name, env_var, test_file, timeout):
    env = dict(os.environ, **({env_var: "1"} if env_var else {}))
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", test_file, "-x", "-q", "-s"],
            cwd=PACKAGE_PARENT, env=env, capture_output=True, text=True,
            timeout=timeout)
        rc, out = proc.returncode, proc.stdout
    except subprocess.TimeoutExpired as e:
        rc, out = -1, (e.stdout or b"").decode("utf-8", "replace") \
            + f"\nTIMEOUT after {timeout}s"
    wall = time.time() - t0
    tail = [ln for ln in out.strip().splitlines() if ln.strip()][-3:]
    rec = {
        "gate": name, "test": test_file,
        "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M"),
        "passed": rc == 0, "returncode": rc,
        "wall_seconds": round(wall, 1), "pytest_tail": tail,
        "figures": figures(out),
    }
    print(json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(GATES), default=None)
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-gate timeout in seconds")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "gates.jsonl"))
    args = ap.parse_args(argv)

    names = [args.only] if args.only else list(GATES)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ok = True
    with open(args.out, "a") as f:
        for name in names:
            env_var, test_file = GATES[name]
            rec = run_gate(name, env_var, test_file, args.timeout)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            ok = ok and rec["passed"]
    print(f"gate records appended to {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
