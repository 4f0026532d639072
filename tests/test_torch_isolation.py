"""The PyTorch port stands alone: no file of mimm_tpu_torch/ or
chip_smoke.py imports jax, flax or the JAX package (mimm_tpu, cli,
native), importing the serving and training entry points leaves jax
unloaded, and ``_build.build_all`` builds every CUDA source."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from tests.torch_port_child import REPO, child_env

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mimm_tpu", "cli",
             "native", "mimm_cli")
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "mimm_tpu_torch", "**", "*.py"),
                              recursive=True)) \
    + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_port_file_imports_nothing_of_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_serving_import_leaves_jax_unloaded():
    code = ("import sys, json; import mimm_tpu_torch.serve, "
            "mimm_tpu_torch.cli.serve; print(json.dumps(sorted("
            "m for m in sys.modules if m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_training_import_leaves_jax_unloaded():
    code = ("import sys, json; import mimm_tpu_torch.train.mi, "
            "mimm_tpu_torch.train.optim, mimm_tpu_torch.objectives.pairing, "
            "mimm_tpu_torch.ops.pairwise_critic, mimm_tpu_torch.ops.dropout, "
            "mimm_tpu_torch.ops.fused_ffn, mimm_tpu_torch.ops.shallow_conv, "
            "mimm_tpu_torch.data.pipeline, mimm_tpu_torch.metrics; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_build_all_lists_every_cuda_source(monkeypatch, tmp_path):
    """Every csrc/*.cu is built by build_all (one nvcc each), and a header
    edit changes every library's hash."""
    import shutil

    from mimm_tpu_torch.ops import _build

    csrc = os.path.join(REPO, "mimm_tpu_torch", "csrc")
    want = sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(csrc, "*.cu")))
    assert want == ["flash_attention_bwd", "flash_attention_fwd",
                    "fused_ffn_bwd", "fused_ffn_fwd",
                    "pairwise_critic_bwd", "pairwise_critic_fwd",
                    "shallow_conv"]
    monkeypatch.setattr(_build, "build", lambda name: f"lib{name}.so")
    assert sorted(_build.build_all()) == want

    copy = str(tmp_path / "csrc")
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = {n: _build.library_path(n) for n in want}
    with open(os.path.join(copy, "philox.cuh"), "a") as f:
        f.write("// edited\n")
    assert all(_build.library_path(n) != before[n] for n in want)
