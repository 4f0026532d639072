"""The port's serving export (mimm_tpu_torch/tools/export_serving.py)
against its own InferenceSession and against the JAX package's
tools/export_serving.py, from one save directory.

The JAX side writes reference-named ``.bin`` files (the image tower, a
Pneumonia classifier, a small TextBert with the flash gate open at
L = 16) and a bert config twice: as it is, and with ``fused_ffn`` and
``gelu_tanh`` (the fused FFN kernels' route), then exports and runs its
own StableHLO artifacts.  The port side (a jax-free child) exports the
same directory on the CPU, runs the artifacts against its live float32
sessions (rtol 1e-5, atol 1e-6, JAX's export test's tolerance), counts
the custom-operator nodes of the exported text graphs, exports an
image-only directory, and loads an artifact in two fresh interpreters:
one that imports only the manifest's ``requires`` and one that imports
nothing of the port.  Port against JAX: tests/test_torch_serve.py's f32
tolerance (2e-4).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

BERT = dict(vocab_size=64, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=32, num_classes=1,
            flash_attention=True, flash_min_seq_len=16)
FFN_BERT = dict(BERT, gelu_tanh=True, fused_ffn=True)
BATCH, SEQ = 4, 16
CLF_LAYERS = [16]
# port artifact against the port session (JAX's export test's tolerance)
RTOL, ATOL = 1e-5, 1e-6
# port against JAX (tests/test_torch_serve.py)
JAX_TOL = 2e-4
ENTRIES = {"base": ("embed_images", "embed_texts", "classify"),
           "ffn": ("embed_texts",)}
INPUTS = {"embed_images": ("imgs",), "embed_texts": ("ids", "masks", "segs"),
          "classify": ("imgs",)}
OPS = ("mimm_tpu_torch.flash_attention_fwd", "mimm_tpu_torch.fused_ffn_fwd")


def _inputs():
    rng = np.random.default_rng(7)
    ids = rng.integers(5, BERT["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    masks = np.zeros((BATCH, SEQ), np.int32)
    for i, n in enumerate((SEQ, 11, 5, 2)):
        masks[i, :n] = 1
    ids[:, 0] = 2
    return {"imgs": rng.random((BATCH, 256, 256, 1)).astype(np.float32),
            "ids": ids, "masks": masks, "segs": np.zeros_like(ids)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from mimm_tpu import checkpoint as ckpt
    from mimm_tpu.models.bert import BertConfig, TextBert
    from tests.test_serve import _make_artifacts
    from tests.torch_port_child import finish_child, remove_job, start_child

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from export_serving import export_artifacts, load_exported

    job = tmp_path_factory.mktemp("export")
    save, ffn_dir, img_only = (job / "save", job / "bert_ffn",
                               job / "image_only")
    for d in (save, ffn_dir, img_only):
        d.mkdir()
    _make_artifacts(save)
    shutil.copy(save / "pytorch_MI_image_model.bin", img_only)
    with open(save / "config.json", "w") as f:
        json.dump(BERT, f)
    with open(ffn_dir / "bert_config.json", "w") as f:
        json.dump(FFN_BERT, f)
    cfg = BertConfig.from_json_file(str(save / "config.json"))
    v = jax.device_get(TextBert(cfg).init(jax.random.PRNGKey(3),
                                          jnp.ones((1, SEQ), jnp.int32)))
    ckpt.save_state_dict_bin(str(save / "pytorch_MI_text_model.bin"),
                             ckpt.bert_state_dict_from_variables(
                                 v, cfg.num_hidden_layers))
    x = _inputs()
    np.savez(job / "in.npz", **x)
    proc = start_child(__file__, str(job))
    manifest = export_artifacts(str(save), str(job / "jax"),
                                batch_size=BATCH, disease="Pneumonia",
                                classifier_layers=CLF_LAYERS,
                                max_seq_length=SEQ)
    want = {e: np.asarray(load_exported(str(job / "jax"), e)(
        *(x[k] for k in INPUTS[e]))) for e in manifest["entries"]}
    got, meta = finish_child(proc, str(job), timeout=400)
    yield want, got, meta
    remove_job(str(job))


@pytest.mark.parametrize("key", [f"{s}/{e}" for s, es in ENTRIES.items()
                                 for e in es])
def test_artifact_matches_session(results, key):
    _, got, _ = results
    art, sess = got[f"art/{key}"], got[f"sess/{key}"]
    assert art.shape == sess.shape and art.dtype == np.float32
    if not key.endswith("classify"):
        assert np.ptp(sess, axis=0).max() > 1e-3    # rows really differ
    np.testing.assert_allclose(art, sess, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["base", "ffn"])
def test_text_graph_holds_one_operator_node_per_layer(results, name):
    """The exported graph calls the kernels' operators, not a plain
    decomposition: one flash forward a layer, and one fused FFN forward a
    layer with the flag."""
    _, _, meta = results
    layers = BERT["num_hidden_layers"]
    want = {OPS[0]: layers, OPS[1]: layers if name == "ffn" else 0}
    assert meta["op_nodes"][name] == want


def test_image_only_directory_exports_embed_images(results):
    _, _, meta = results
    assert meta["image_only"] == ["embed_images"]


def test_entries_export_only_those(results):
    """``entries`` picks among the supported entry points (the fused-FFN
    set exports ``embed_texts`` alone) and refuses one the directory does
    not support."""
    _, got, meta = results
    assert sorted(k for k in got if k.startswith("art/ffn/")) == \
        ["art/ffn/embed_texts"]
    assert "embed_texts" in meta["unsupported_entry"] and \
        "not among" in meta["unsupported_entry"]


@pytest.mark.parametrize("entry", ENTRIES["base"])
def test_port_artifacts_match_jax(results, entry):
    want, got, _ = results
    assert got[f"art/base/{entry}"].shape == want[entry].shape
    np.testing.assert_allclose(got[f"art/base/{entry}"], want[entry],
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_manifest_roundtrips(results):
    _, _, meta = results
    m = meta["manifest"]
    assert meta["manifest_on_disk"] == m
    assert m["batch_size"] == BATCH and m["device"] == "cpu"
    assert m["requires"] == ["mimm_tpu_torch.ops.flash_attention",
                             "mimm_tpu_torch.ops.fused_ffn"]
    assert set(m["entries"]) == set(ENTRIES["base"])
    assert m["entries"]["embed_texts"]["inputs"] == \
        [{"shape": [BATCH, SEQ], "dtype": "int32"}] * 3
    assert m["entries"]["embed_texts"]["outputs"] == \
        [{"shape": [BATCH, BERT["hidden_size"]], "dtype": "float32"}]
    assert m["entries"]["classify"]["outputs"] == \
        [{"shape": [BATCH], "dtype": "float32"}]


def test_requires_only_child_loads_and_runs(results):
    _, got, meta = results
    child = meta["requires_child"]
    assert child["rc"] == 0, child["stderr"]
    assert not [m for m in child["modules"]
                if m.startswith("mimm_tpu_torch.models")]
    np.testing.assert_allclose(got["requires_child"],
                               got["art/base/embed_texts"], rtol=RTOL,
                               atol=ATOL)


def test_bare_child_fails_with_an_error(results):
    _, _, meta = results
    child = meta["bare_child"]
    assert child["rc"] != 0 and "mimm_tpu_torch" in child["stderr"]


# ---- port side (jax-free child) ------------------------------------------

REQUIRES_CHILD = """
import importlib, json, sys
import numpy as np
import torch
job, art = sys.argv[1], sys.argv[2]
with open(job + "/port/base/manifest.json") as f:
    manifest = json.load(f)
for m in manifest["requires"]:
    importlib.import_module(m)
x = np.load(job + "/in.npz")
with torch.inference_mode():
    y = torch.export.load(art).module()(
        *(torch.from_numpy(x[k]) for k in ("ids", "masks", "segs")))
np.save(job + "/requires_child.npy", y.numpy())
print(json.dumps(sorted(m for m in sys.modules if m.startswith("mimm"))))
"""
BARE_CHILD = """
import sys
import numpy as np
import torch
x = np.load(sys.argv[1] + "/in.npz")
y = torch.export.load(sys.argv[2]).module()(
    *(torch.from_numpy(x[k]) for k in ("ids", "masks", "segs")))
print("ran", y.shape)
"""


def _child(job):
    import torch

    from mimm_tpu_torch.models.bert import BertConfig
    from mimm_tpu_torch.serve import InferenceSession
    from mimm_tpu_torch.tools.export_serving import (export_artifacts,
                                                     load_exported)
    from tests.torch_port_child import child_env

    torch.backends.mkldnn.enabled = False
    with np.load(os.path.join(job, "in.npz")) as z:
        x = {k: z[k] for k in z.files}
    save = os.path.join(job, "save")
    out, meta = {}, {"op_nodes": {}}
    kw = dict(batch_size=BATCH, max_seq_length=SEQ, device="cpu")
    sets = {
        "base": (dict(disease="Pneumonia", classifier_layers=CLF_LAYERS),
                 BertConfig(**BERT)),
        "ffn": (dict(bert_pretrained_dir=os.path.join(job, "bert_ffn"),
                     entries=ENTRIES["ffn"]), BertConfig(**FFN_BERT))}
    children = {}
    for name, (extra, bert) in sets.items():
        d = os.path.join(job, "port", name)
        manifest = export_artifacts(save, d, **kw, **extra)
        if name == "base":
            meta["manifest"] = manifest
            with open(os.path.join(d, "manifest.json")) as f:
                meta["manifest_on_disk"] = json.load(f)
            # the two fresh interpreters run meanwhile
            art = os.path.join(d, "embed_texts.pt2")
            for key, code in (("requires_child", REQUIRES_CHILD),
                              ("bare_child", BARE_CHILD)):
                env = child_env()
                if key == "bare_child":     # the port is not importable
                    env["PYTHONPATH"] = ""
                children[key] = subprocess.Popen(
                    [sys.executable, "-c", code, job, art], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=job)
        sess = InferenceSession(save, bert_config=bert,
                                classifier_layers=extra.get(
                                    "classifier_layers"),
                                disease=extra.get("disease"), **kw)
        for entry in manifest["entries"]:
            args = [x[k] for k in INPUTS[entry]]
            out[f"sess/{name}/{entry}"] = getattr(sess, entry)(*args)
            out[f"art/{name}/{entry}"] = load_exported(d, entry)(
                *(torch.from_numpy(a) for a in args)).numpy()
        graph = torch.export.load(os.path.join(d, "embed_texts.pt2")).graph
        targets = [str(n.target) for n in graph.nodes
                   if n.op == "call_function"]
        meta["op_nodes"][name] = {op: sum(t.startswith(op) for t in targets)
                                  for op in OPS}
    meta["image_only"] = list(export_artifacts(
        os.path.join(job, "image_only"), os.path.join(job, "port", "img"),
        **kw)["entries"])
    try:
        export_artifacts(os.path.join(job, "image_only"),
                         os.path.join(job, "port", "none"), **kw,
                         entries=["embed_texts"])
        meta["unsupported_entry"] = "no error"
    except ValueError as e:
        meta["unsupported_entry"] = str(e)
    for key, proc in children.items():
        stdout, stderr = proc.communicate(timeout=120)
        meta[key] = {"rc": proc.returncode, "stderr": stderr[-3000:]}
        if key == "requires_child" and proc.returncode == 0:
            meta[key]["modules"] = json.loads(stdout.splitlines()[-1])
            out[key] = np.load(os.path.join(job, "requires_child.npy"))
    np.savez(os.path.join(job, "out.npz"), **out)
    with open(os.path.join(job, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _child(sys.argv[1])
