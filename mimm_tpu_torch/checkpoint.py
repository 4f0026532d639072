"""The native resume checkpoint, reference ``.bin`` checkpoints and the
weight bridge from the JAX package.

The resume checkpoint (mimm_tpu/checkpoint.py:47-170 counterpart) is one
file: a versioned envelope ``{"__mimm_ckpt__": 1, "tree": ...}`` written
by ``torch.save`` to a temporary name and renamed, whose tree holds
tensors (on the CPU), numbers, strings, lists and dicts only, so that
``load_checkpoint`` reads it with ``weights_only=True``.  It is the
port's own format: the port cannot read JAX's ``mi_epoch<N>.ckpt`` (a
pickle of optax and flax types), nor JAX the port's.  Weights cross
between the two through the ``.bin`` exports.

``.bin`` files are pickled torch state dicts in the reference layout
(``pytorch_MI_image_model.bin``, ``pytorch_MI_text_model.bin``,
``pytorch_image_classifier_<disease>_epoch<N>.bin``); the port's modules use
the same keys and load them with ``strict=True``.

The ``*_state_dict_from_flax`` functions take a JAX parameter tree as numpy
arrays (nested dicts, flax naming) and return the reference-keyed torch
state dict — the same layout mimm_tpu/checkpoint.py writes with its
``*_state_dict_from_variables`` exporters, re-implemented here so the port
imports nothing of the JAX package.  ``mi_weights_from_flax`` bridges a
JAX MI train state the same way.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# Bump when the envelope's layout changes; load_checkpoint refuses newer
# versions instead of misreading them.
CKPT_FORMAT_VERSION = 1


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def save_checkpoint(path: str, tree: Any, format: str = "pickle") -> str:
    """Write ``tree`` as a one-file envelope at ``path`` (a temporary file,
    then a rename: a kill during the write, say at the end of a preemption's
    grace window, never leaves a truncated file where ``--resume_from auto``
    looks).  Only ``format="pickle"`` is written here; multi-rank sharded
    saves come with the parallel slice."""
    if format != "pickle":
        raise NotImplementedError(
            f"checkpoint_format {format!r}: sharded multi-rank saves come "
            f"with the parallel slice (ROADMAP.md queue A, \"parallel/"
            f"mesh.py and parallel/pipeline.py\")")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"__mimm_ckpt__": CKPT_FORMAT_VERSION, "tree": _to_cpu(tree)},
               tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Any:
    """The tree of an envelope ``save_checkpoint`` wrote, on the CPU;
    refuses a newer version."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "__mimm_ckpt__" in obj):
        raise ValueError(f"{path} is not a resume checkpoint of this package")
    version = obj["__mimm_ckpt__"]
    if version > CKPT_FORMAT_VERSION:
        raise ValueError(f"{path} is checkpoint format v{version}; this build "
                         f"reads up to v{CKPT_FORMAT_VERSION}")
    return obj["tree"]


def prune_checkpoints(save_dir: str, prefix: str, keep: int) -> list:
    """Keep only the newest ``keep`` ``<prefix><epoch>.ckpt`` files (by
    epoch number) in ``save_dir``; returns the deleted paths.  ``keep`` <=
    0 keeps all.  A preemption checkpoint (no epoch number) and the
    ``.bin`` exports, the downstream contract, are never touched."""
    if keep <= 0:
        return []
    found = []
    for path in glob.glob(os.path.join(save_dir, f"{prefix}*.ckpt")):
        m = re.fullmatch(re.escape(prefix) + r"(\d+)\.ckpt",
                         os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    deleted = []
    for _, path in sorted(found)[:-keep]:
        os.remove(path)
        deleted.append(path)
    return deleted


def load_state_dict_bin(path: str) -> StateDict:
    """Read a reference ``.bin`` onto the CPU, migrating the legacy
    LayerNorm names gamma/beta -> weight/bias (reference model.py:429-439)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.replace("gamma", "weight").replace("beta", "bias"): v
            for k, v in sd.items()}


def save_state_dict_bin(path: str, sd) -> str:
    """Write a state dict (torch tensors or numpy arrays) as a ``.bin``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: (v.detach().cpu().clone() if torch.is_tensor(v)
                    else torch.from_numpy(np.array(v, copy=True)))
                for k, v in sd.items()}, path)
    return path


def save_joint_state_dict_bin(path: str, image_sd, text_sd) -> str:
    """The reference's joint ``pytorch_model_epoch<N>.bin``: the image and
    text state dicts under ``image_model.`` / ``text_model.`` prefixes."""
    joint = {f"image_model.{k}": v for k, v in image_sd.items()}
    joint.update({f"text_model.{k}": v for k, v in text_sd.items()})
    return save_state_dict_bin(path, joint)


def normalize_bert_keys(sd: StateDict) -> StateDict:
    """Bare BertModel checkpoints (``bert_pretrain_*/pytorch_model.bin``)
    carry no ``bert.`` prefix; TextBert checkpoints do."""
    if any(k.startswith("bert.") for k in sd):
        return dict(sd)
    return {(k if k.startswith("classifier.") else "bert." + k): v
            for k, v in sd.items()}


def strip_joint_prefix(sd: StateDict, tower: str = "image_model."
                       ) -> StateDict:
    """Keep only the ``<tower>*`` keys of a joint checkpoint, without the
    prefix, dropping the image tower's fc head: the reference's
    ``loading_from_joint`` (model.py:446-455)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(tower):
            sub = k[len(tower):]
            if tower == "image_model." and sub.startswith("fc"):
                continue
            out[sub] = v
    return out


def load_resnet_from_bin(path: str, loading_from_joint: bool = False
                         ) -> StateDict:
    """The reference's ``build_resnet_model(checkpoint_path=...)`` read
    (model.py:408-497): the ``.bin``'s image-tower state dict with the
    legacy keys migrated; ``loading_from_joint`` takes the ``image_model.``
    entries of a joint ``pytorch_model_epoch<N>.bin`` and leaves ``fc1``
    out, so the result loads with ``strict=False`` (only ``fc1.*``
    missing)."""
    sd = load_state_dict_bin(path)
    return strip_joint_prefix(sd, "image_model.") if loading_from_joint else sd


def load_bert_pytorch_bin(bert_pretrained_dir: str,
                          filename: str = "pytorch_model.bin"
                          ) -> Optional[StateDict]:
    """The pytorch_transformers BERT weights of ``bert_pretrained_dir`` as a
    TextBert-keyed state dict (``bert.*``, and ``classifier.*`` if the file
    has them), or None if the file is absent (the reference needs the
    directory at run time but does not ship it)."""
    path = os.path.join(bert_pretrained_dir, filename)
    if not os.path.exists(path):
        return None
    return normalize_bert_keys(load_state_dict_bin(path))


# ---- layout transforms (flax -> torch) -----------------------------------

def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _t(kernel) -> torch.Tensor:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return _tensor(np.asarray(kernel).T)


def _conv(kernel) -> torch.Tensor:
    """flax Conv kernel (KH, KW, I, O) -> torch Conv2d weight (O, I, KH, KW)."""
    return _tensor(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def flatten_perm(c: int, h: int, w: int) -> np.ndarray:
    """``perm[i_nhwc] = i_nchw``: a flax (H, W, C) flatten equals the torch
    (C, H, W) flatten indexed by ``perm``."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _linear_in_perm(kernel, c: int) -> torch.Tensor:
    """flax Dense kernel (in, out) reading an (H, W, C)-flattened map ->
    torch Linear weight (out, in) reading the (C, H, W) flatten."""
    kernel = np.asarray(kernel)
    n = kernel.shape[0]
    h = int(round((n // c) ** 0.5))
    wt = kernel.T
    if c * h * h != n:  # non-square geometry: left unpermuted
        return _tensor(wt)
    out = np.empty_like(wt)
    out[:, flatten_perm(c, h, h)] = wt
    return _tensor(out)


def _deconv(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (KH, KW, I, O) -> torch ConvTranspose2d
    weight (I, O, KH, KW), spatially flipped: flax applies the kernel
    unflipped, torch's transposed convolution (the gradient of conv)
    flipped (mimm_tpu/checkpoint.py:236 ``_deconv_back``)."""
    return _tensor(np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1)))


def _linear_out_perm(kernel, c: int) -> torch.Tensor:
    """flax Dense kernel (in, out) whose output is reshaped to an (H, W, C)
    map -> torch Linear weight (out, in) whose output is reshaped to (C, H,
    W) (mimm_tpu/checkpoint.py:281 ``_linear_out_perm_back``)."""
    kernel = np.asarray(kernel)
    m = kernel.shape[1]
    h = int(round((m // c) ** 0.5))
    wt = kernel.T
    if c * h * h != m:
        return _tensor(wt)
    out = np.empty_like(wt)
    out[flatten_perm(c, h, h), :] = wt
    return _tensor(out)


def _vec_perm(bias, c: int) -> torch.Tensor:
    """A bias over an (H, W, C)-flattened map -> over the (C, H, W) flatten
    (mimm_tpu/checkpoint.py:298 ``_vec_perm_back``)."""
    bias = np.asarray(bias)
    m = bias.shape[0]
    h = int(round((m // c) ** 0.5))
    if c * h * h != m:
        return _tensor(bias)
    out = np.empty_like(bias)
    out[flatten_perm(c, h, h)] = bias
    return _tensor(out)


# ---- ResNet256_6_2_1 ------------------------------------------------------

def resnet_state_dict_from_flax(variables: dict,
                                blocks_per_layer: Sequence[int] = (2,) * 6
                                ) -> StateDict:
    """flax ResNet256_6_2_1 ``{'params', 'batch_stats'}`` -> state dict."""
    p, bs = variables["params"], variables["batch_stats"]
    sd: StateDict = {}

    def bn(tp, fnode, snode):
        sd[f"{tp}.weight"] = _tensor(fnode["scale"])
        sd[f"{tp}.bias"] = _tensor(fnode["bias"])
        sd[f"{tp}.running_mean"] = _tensor(snode["mean"])
        sd[f"{tp}.running_var"] = _tensor(snode["var"])
        sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    sd["conv1.weight"] = _conv(p["conv1"]["kernel"])
    bn("bn1", p["bn1"], bs["bn1"])
    for li, blocks in enumerate(blocks_per_layer):
        for bi in range(blocks):
            tp, fp = f"layer{li + 1}.{bi}", f"layer{li + 1}_block{bi}"
            sd[f"{tp}.conv1.weight"] = _conv(p[fp]["conv1"]["kernel"])
            sd[f"{tp}.conv2.weight"] = _conv(p[fp]["conv2"]["kernel"])
            bn(f"{tp}.bn1", p[fp]["bn1"], bs[fp]["bn1"])
            bn(f"{tp}.bn2", p[fp]["bn2"], bs[fp]["bn2"])
            if "downsample_conv" in p[fp]:
                sd[f"{tp}.downsample.0.weight"] = _conv(
                    p[fp]["downsample_conv"]["kernel"])
                bn(f"{tp}.downsample.1", p[fp]["downsample_bn"],
                   bs[fp]["downsample_bn"])
    if "fc1" in p:
        # fc1 reads the 2x2x192 pool map: flax flattens NHWC, the
        # reference layout NCHW (192 = the last layer's planes)
        sd["fc1.weight"] = _linear_in_perm(p["fc1"]["kernel"], c=192)
        sd["fc1.bias"] = _tensor(p["fc1"]["bias"])
    return sd


# ---- TextBert (pytorch_transformers 1.0.0 BertModel layout) ---------------

def bert_state_dict_from_flax(variables: dict, num_layers: int) -> StateDict:
    """flax TextBert ``{'params': {'bert': ..., 'classifier': ...}}`` ->
    state dict with ``bert.*`` (+ ``classifier.*``) keys."""
    p = variables["params"]["bert"]
    sd: StateDict = {}
    emb = "bert.embeddings"
    sd[f"{emb}.word_embeddings.weight"] = _tensor(p["word_embeddings"]["embedding"])
    sd[f"{emb}.position_embeddings.weight"] = _tensor(
        p["position_embeddings"]["embedding"])
    sd[f"{emb}.token_type_embeddings.weight"] = _tensor(
        p["token_type_embeddings"]["embedding"])
    sd[f"{emb}.LayerNorm.weight"] = _tensor(p["embeddings_layernorm"]["scale"])
    sd[f"{emb}.LayerNorm.bias"] = _tensor(p["embeddings_layernorm"]["bias"])
    for i in range(num_layers):
        tp, fp = f"bert.encoder.layer.{i}", p[f"layer{i}"]
        for name in ("query", "key", "value"):
            sd[f"{tp}.attention.self.{name}.weight"] = _t(
                fp["attention"][name]["kernel"])
            sd[f"{tp}.attention.self.{name}.bias"] = _tensor(
                fp["attention"][name]["bias"])
        for torch_name, flax_name in (("attention.output.dense", "attention_output"),
                                      ("intermediate.dense", "intermediate"),
                                      ("output.dense", "output")):
            sd[f"{tp}.{torch_name}.weight"] = _t(fp[flax_name]["kernel"])
            sd[f"{tp}.{torch_name}.bias"] = _tensor(fp[flax_name]["bias"])
        for torch_name, flax_name in (("attention.output.LayerNorm",
                                       "attention_layernorm"),
                                      ("output.LayerNorm", "output_layernorm")):
            sd[f"{tp}.{torch_name}.weight"] = _tensor(fp[flax_name]["scale"])
            sd[f"{tp}.{torch_name}.bias"] = _tensor(fp[flax_name]["bias"])
    sd["bert.pooler.dense.weight"] = _t(p["pooler"]["kernel"])
    sd["bert.pooler.dense.bias"] = _tensor(p["pooler"]["bias"])
    cls = variables["params"].get("classifier")
    if cls is not None:
        sd["classifier.weight"] = _t(cls["kernel"])
        sd["classifier.bias"] = _tensor(cls["bias"])
    return sd


# ---- ResNetAE -------------------------------------------------------------

def ae_state_dict_from_flax(variables: dict, n_levels: int = 6,
                            n_res: int = 2, z_dim: int = 192) -> StateDict:
    """flax ResNetAE ``{'params', 'batch_stats'}`` -> the reference-keyed
    state dict (mimm_tpu/checkpoint.py:575-643
    ``ae_state_dict_from_variables``).  fc1 reads and fc2 writes the
    (z_dim, lat, lat) latent, which flax flattens NHWC and the reference
    NCHW."""
    p, bs = variables["params"], variables["batch_stats"]
    sd: StateDict = {}

    def node(tree, tower, path):
        n = tree[tower]
        for k in path:
            n = n[k]
        return n

    def conv(tower, path, tp, transpose=False):
        n = node(p, tower, path)
        sd[f"{tp}.weight"] = (_deconv if transpose else _conv)(n["kernel"])
        sd[f"{tp}.bias"] = _tensor(n["bias"])

    def bn(tower, path, tp):
        n, s = node(p, tower, path), node(bs, tower, path)
        sd[f"{tp}.weight"] = _tensor(n["scale"])
        sd[f"{tp}.bias"] = _tensor(n["bias"])
        sd[f"{tp}.running_mean"] = _tensor(s["mean"])
        sd[f"{tp}.running_var"] = _tensor(s["var"])
        sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def res_blocks(tower, i):
        for b in range(n_res):
            fp, tp = f"level{i}_res{b}", f"{tower}.res_blk_list.{i}.{b}"
            conv(tower, [fp, "conv1"], f"{tp}.residual_block.0")
            bn(tower, [fp, "bn1"], f"{tp}.residual_block.1")
            conv(tower, [fp, "conv2"], f"{tp}.residual_block.3")
            bn(tower, [fp, "bn2"], f"{tp}.residual_block.4")

    def skip(tower, i, transpose):
        if f"skip{i}_conv" in p[tower]:
            conv(tower, [f"skip{i}_conv"],
                 f"{tower}.multi_res_skip_list.{i}.0", transpose)
            bn(tower, [f"skip{i}_bn"], f"{tower}.multi_res_skip_list.{i}.1")

    conv("encoder", ["input_conv"], "encoder.input_conv.0")
    bn("encoder", ["input_bn"], "encoder.input_conv.1")
    for i in range(n_levels):
        res_blocks("encoder", i)
        conv("encoder", [f"down{i}_conv"], f"encoder.conv_list.{i}.0")
        bn("encoder", [f"down{i}_bn"], f"encoder.conv_list.{i}.1")
        skip("encoder", i, False)
    conv("encoder", ["output_conv"], "encoder.output_conv")

    conv("decoder", ["input_conv"], "decoder.input_conv.0")
    bn("decoder", ["input_bn"], "decoder.input_conv.1")
    for i in range(n_levels):
        conv("decoder", [f"up{i}_conv"], f"decoder.conv_list.{i}.0", True)
        bn("decoder", [f"up{i}_bn"], f"decoder.conv_list.{i}.1")
        res_blocks("decoder", i)
        skip("decoder", i, True)
    conv("decoder", ["output_conv"], "decoder.output_conv")

    sd["fc1.weight"] = _linear_in_perm(p["fc1"]["kernel"], c=z_dim)
    sd["fc1.bias"] = _tensor(p["fc1"]["bias"])
    sd["fc2.weight"] = _linear_out_perm(p["fc2"]["kernel"], c=z_dim)
    sd["fc2.bias"] = _vec_perm(p["fc2"]["bias"], c=z_dim)
    return sd


def load_ae_from_bins(model, save_dir: str, epoch: int) -> None:
    """Load epoch ``epoch``'s exports of ``save_ae_checkpoint`` into a
    ``ResNetAE``, each ``strict=True``: ``autoencoder_path_<N>.bin`` into
    the whole model, then ``encoder_<N>.bin`` and ``decoder_<N>.bin`` (the
    files the downstream classifier and the reference read) into its
    encoder and decoder."""
    bin_ = lambda name: load_state_dict_bin(
        os.path.join(save_dir, f"{name}_{epoch}.bin"))
    model.load_state_dict(bin_("autoencoder_path"), strict=True)
    model.encoder.load_state_dict(bin_("encoder"), strict=True)
    model.decoder.load_state_dict(bin_("decoder"), strict=True)


# ---- Basic_MLP / make_mlp -------------------------------------------------

def mlp_state_dict_from_flax(params: List[dict], sequential: bool = False
                             ) -> StateDict:
    """list of ``{'w': (in, out), 'b': (out,)}`` -> state dict.  Keys are
    Basic_MLP's ``layers.N`` or, with ``sequential=True``, make_mlp's
    nn.Sequential indices 0, 2, 4, ... (ReLUs between)."""
    sd: StateDict = {}
    for i, layer in enumerate(params):
        key = f"{2 * i}" if sequential else f"layers.{i}"
        sd[f"{key}.weight"] = _t(layer["w"])
        sd[f"{key}.bias"] = _tensor(layer["b"])
    return sd


# ---- the MI train state ----------------------------------------------------

def mi_weights_from_flax(params: dict, batch_stats: dict,
                         critic_params: List[dict], num_layers: int) -> dict:
    """JAX ``MITrainState`` parts as numpy trees -> the port's weights:
    ``{'image_model': sd, 'text_model': sd, 'critic': [{'w', 'b'}]}``, the
    argument ``train/mi.py create_mi_state(weights=...)`` loads.  The
    critic needs no re-wiring: the port's image embedding is flattened in
    JAX's NHWC order."""
    return {
        "image_model": resnet_state_dict_from_flax(
            {"params": params["image_model"],
             "batch_stats": batch_stats["image_model"]}),
        "text_model": bert_state_dict_from_flax(
            {"params": params["text_model"]}, num_layers),
        "critic": [{k: _tensor(layer[k]) for k in ("w", "b")}
                   for layer in critic_params],
    }
