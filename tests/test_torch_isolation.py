"""The PyTorch port stands alone: no file of mimm_tpu_torch/ or
chip_smoke.py imports jax, flax or the JAX package (mimm_tpu, cli,
native), importing the serving, training, MI pretraining, autoencoder,
classifier and validation entry points, the host library, the tokenizers,
profiling and the TensorBoard writer leaves jax unloaded, no port file
names the JAX package's host library (its directory or its .so) and a
process that loads the port's host library maps only the port's build of
it, and ``_build.build_all`` builds every CUDA source."""

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
PORT_SOURCES = PORT_FILES + sorted(
    glob.glob(os.path.join(REPO, "mimm_tpu_torch", "csrc", "**", "*.c*"),
              recursive=True))
JAX_HOST_LIBRARY = ("native/", "libmimm_host.so")


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


def test_mi_cli_import_leaves_jax_unloaded():
    """The MI entry point and what it reads from disk: the datasets, the
    transforms, the crop cache, the token features, the resume envelope
    and preemption."""
    code = ("import sys, json; import mimm_tpu_torch.cli.multi_modal, "
            "mimm_tpu_torch.data.features, mimm_tpu_torch.data.transforms, "
            "mimm_tpu_torch.data.crop_cache, mimm_tpu_torch.data.etl, "
            "mimm_tpu_torch.preempt, mimm_tpu_torch.utils, "
            "mimm_tpu_torch.checkpoint; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_ae_cli_import_leaves_jax_unloaded():
    """The autoencoder's entry point, its trainer and model, and the
    fixed-order embedding lookup."""
    code = ("import sys, json; import mimm_tpu_torch.cli.uni_modal, "
            "mimm_tpu_torch.train.ae, mimm_tpu_torch.models.autoencoder, "
            "mimm_tpu_torch.ops.embedding; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_classifier_cli_import_leaves_jax_unloaded():
    """The sweep and validation entry points, the classifier trainer,
    validation, Grad-CAM and the metrics."""
    code = ("import sys, json; import mimm_tpu_torch.cli.train, "
            "mimm_tpu_torch.cli.validate, mimm_tpu_torch.train.classifier, "
            "mimm_tpu_torch.validate, mimm_tpu_torch.cam, "
            "mimm_tpu_torch.metrics; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_SOURCES])
def test_port_file_names_no_jax_host_library(path):
    """No port module, source or chip_smoke.py names the JAX package's
    host library directory or its .so (the port builds its own,
    data/native_ops.py)."""
    with open(path) as f:
        text = f.read()
    named = [s for s in JAX_HOST_LIBRARY if s in text]
    assert not named, f"{os.path.relpath(path, REPO)} names {named}"


def test_host_library_import_leaves_jax_unloaded():
    """The host library, the tokenizers, profiling and the TensorBoard
    writer: jax unloaded, and after a transform and a WordPiece encode the
    process maps the port's build of the library and not the JAX
    package's."""
    code = ("import sys, json, tempfile, os, numpy as np; "
            "import mimm_tpu_torch.data.native_ops as n, "
            "mimm_tpu_torch.data.transforms as t, "
            "mimm_tpu_torch.data.tokenizer, mimm_tpu_torch.profiling, "
            "mimm_tpu_torch.tbevents; "
            "t.reference_transform(np.zeros((300, 300), np.uint8), "
            "np.random.default_rng(0), 256); "
            "d = tempfile.mkdtemp(); p = os.path.join(d, 'vocab.txt'); "
            "open(p, 'w').write('[UNK]\\nx\\n'); "
            "tok = mimm_tpu_torch.data.tokenizer.NativeWordPieceTokenizer"
            ".from_pretrained(d); tok.encode_wordpiece_ids('x'); "
            "maps = sorted({l.split()[-1] for l in open('/proc/self/maps') "
            "if 'mimm_host' in l}); "
            "print(json.dumps([sorted(m for m in sys.modules if "
            "m.split('.')[0] in %r), maps]))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    modules, maps = json.loads(proc.stdout.strip().splitlines()[-1])
    assert modules == []
    assert len(maps) == 1, maps
    assert maps[0].startswith(os.path.join(REPO, "build", "mimm_tpu_torch",
                                           "libmimm_host-")), maps


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
