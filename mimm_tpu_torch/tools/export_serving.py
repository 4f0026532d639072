"""Export the serving entry points as self-contained ``torch.export``
artifacts (tools/export_serving.py counterpart).

``torch.export`` captures each inference function — its graph, with the
weights as the program's own state — into a ``.pt2`` file that
``torch.export.load`` runs without this package's model code: the loader
imports only the modules that register the custom operators the graph
calls (``manifest["requires"]``: the flash-attention and fused-FFN
forwards, ``mimm_tpu_torch::flash_attention_fwd`` and
``mimm_tpu_torch::fused_ffn_fwd``), the counterpart of the JAX artifact's
need for a jax runtime.  Under the operators the hand-written kernels run
on the card, their plain versions on the CPU.

Exports (what the checkpoint directory supports):
* ``embed_images``:  (B, H, W, 1) float32 -> (B, 768) — ResNet encoder,
  with the on-device normalization (ops/image_norm.py) folded in.
* ``embed_texts``:   ids/mask/segments (B, L) int32 -> (B, 768) — BERT
  (needs pytorch_MI_text_model.bin + a bert config).
* ``classify``:      (B, H, W, 1) float32 -> (B,) probabilities
  (needs a per-disease classifier checkpoint; pass --disease).

Usage:
    python -m mimm_tpu_torch.tools.export_serving \
        --save_directory save_dir/mm_dv_epoch20 --out exported/ \
        --batch_size 64 --disease Pneumonia [--device cuda]

Writes ``<out>/<name>.pt2`` plus ``<out>/manifest.json`` (batch size,
shapes, dtypes, the device, the torch version and the modules a loader
imports).  The artifacts compute in float32 and hold their weights on the
export's device (``--device``: one device per artifact set, where the JAX
tool lowers for a list of platforms).  Reload with :func:`load_exported`.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
from typing import Optional, Sequence

import torch
from torch import nn

# the modules whose import registers the operators an artifact calls
REQUIRES = ("mimm_tpu_torch.ops.flash_attention",
            "mimm_tpu_torch.ops.fused_ffn")


class _EmbedImages(nn.Module):
    def __init__(self, image_model: nn.Module):
        super().__init__()
        self.image_model = image_model

    def forward(self, images):
        from mimm_tpu_torch.ops.image_norm import device_normalize
        return self.image_model(device_normalize(images))[1].float()


class _EmbedTexts(nn.Module):
    def __init__(self, text_model: nn.Module):
        super().__init__()
        self.text_model = text_model

    def forward(self, ids, masks, segments):
        return self.text_model(ids.long(), segments.long(),
                               masks.long())[0].float()


class _Classify(nn.Module):
    def __init__(self, embed: _EmbedImages, classifier: nn.Module):
        super().__init__()
        self.embed = embed
        self.classifier = classifier

    def forward(self, images):
        return self.classifier(self.embed(images))[:, 0].float()


def _build_entry_points(save_directory: str, img_size: int, batch_size: int,
                        bert_pretrained_dir=None, disease=None,
                        classifier_layers=None, max_seq_length: int = 320,
                        output_channels: int = 1, device="cpu"):
    """{name: (module, [example inputs])} for everything the checkpoint
    directory supports: float32 modules in eval mode on ``device``, their
    weights loaded ``strict=True`` from the reference ``.bin`` files."""
    from mimm_tpu_torch import checkpoint as ckpt
    from mimm_tpu_torch.models.bert import BertConfig, TextBert
    from mimm_tpu_torch.models.mlp import BasicMLP
    from mimm_tpu_torch.models.resnet import ResNet256_6_2_1

    def ready(model: nn.Module, sd) -> nn.Module:
        model.load_state_dict(sd, strict=True)
        return model.eval().to(device)

    entries = {}
    image_model = ready(ResNet256_6_2_1(output_channels=output_channels),
                        ckpt.load_state_dict_bin(os.path.join(
                            save_directory, "pytorch_MI_image_model.bin")))
    images = torch.zeros(batch_size, img_size, img_size, 1, device=device)
    embed_images = _EmbedImages(image_model)
    entries["embed_images"] = (embed_images, [images])

    txt_path = os.path.join(save_directory, "pytorch_MI_text_model.bin")
    bert_config = None
    for d, name in ((bert_pretrained_dir, "bert_config.json"),
                    (bert_pretrained_dir, "config.json"),
                    (save_directory, "config.json")):
        if d and os.path.exists(os.path.join(d, name)):
            bert_config = BertConfig.from_json_file(os.path.join(d, name))
            break
    if bert_config is not None and os.path.exists(txt_path):
        text_model = ready(TextBert(bert_config), ckpt.normalize_bert_keys(
            ckpt.load_state_dict_bin(txt_path)))
        # three distinct tensors: the tracer takes one tensor passed twice
        # for one input
        tokens = [torch.full((batch_size, max_seq_length), fill,
                             dtype=torch.int32, device=device)
                  for fill in (0, 1, 0)]
        entries["embed_texts"] = (_EmbedTexts(text_model), tokens)

    if disease is not None:
        from mimm_tpu_torch.validate import find_classifier_checkpoint
        if classifier_layers is None:
            from mimm_tpu_torch.config import DEFAULT_CLASSIFIER_LAYERS
            classifier_layers = list(DEFAULT_CLASSIFIER_LAYERS)
        clf = ready(BasicMLP(image_model.fc1.in_features,
                             list(classifier_layers)),
                    ckpt.load_state_dict_bin(find_classifier_checkpoint(
                        save_directory, disease)))
        entries["classify"] = (_Classify(embed_images, clf), [images])
    return entries


def _specs(values) -> list:
    return [{"shape": list(v.shape), "dtype": str(v.dtype).replace(
        "torch.", "")} for v in values]


def export_artifacts(save_directory: str, out_dir: str, batch_size: int = 64,
                     img_size: int = 256, bert_pretrained_dir=None,
                     disease=None, classifier_layers=None,
                     max_seq_length: int = 320, device="cuda",
                     entries: Optional[Sequence[str]] = None) -> dict:
    """Export every supported entry point (or those of ``entries`` among
    them); returns the manifest dict.

    The batch dim is fixed at ``batch_size`` (static shapes — callers pad
    like ``serve.InferenceSession`` does).  ``device``: where the
    artifacts' weights live and their graphs run (the card unless the
    caller asks for the CPU).  The graphs follow the loading process's
    TF32 settings, as live modules do (PyTorch's default runs cuDNN
    convolutions in TF32)."""
    from mimm_tpu_torch import resolve_device

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    supported = _build_entry_points(
        save_directory, img_size, batch_size,
        bert_pretrained_dir=bert_pretrained_dir, disease=disease,
        classifier_layers=classifier_layers, max_seq_length=max_seq_length,
        device=dev)
    unknown = set(entries or ()) - set(supported)
    if unknown:
        raise ValueError(f"entries {sorted(unknown)} are not among the "
                         f"directory's {sorted(supported)}")
    manifest = {"batch_size": batch_size, "device": dev.type,
                "torch_version": torch.__version__,
                "requires": list(REQUIRES), "entries": {}}
    for name, (module, inputs) in supported.items():
        if entries is not None and name not in entries:
            continue
        with torch.no_grad():
            program = torch.export.export(module, tuple(inputs))
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(program, path)
        outputs = [n for n in program.graph.nodes if n.op == "output"][0]
        manifest["entries"][name] = {
            "file": os.path.basename(path),
            "inputs": _specs(inputs),
            "outputs": _specs(v.meta["val"] for v in outputs.args[0]),
        }
    # the manifest last, whole (a temporary name, then a rename): a
    # loader that finds it finds every artifact it names
    path = os.path.join(out_dir, "manifest.json")
    with open(path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(path + ".tmp", path)
    return manifest


def load_exported(out_dir: str, name: str):
    """Import the manifest's ``requires`` (the custom operators' modules)
    and load one artifact; returns its module (a callable, its weights
    frozen: an inference function)."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for module in manifest["requires"]:
        importlib.import_module(module)
    return torch.export.load(os.path.join(
        out_dir, manifest["entries"][name]["file"])).module() \
        .requires_grad_(False)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--save_directory", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--max_seq_length", type=int, default=320)
    p.add_argument("--disease", default=None)
    p.add_argument("--bert_pretrained_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="the artifacts' device: 'cuda' (the card's kernels) "
                        "or 'cpu' (their plain versions)")
    args = p.parse_args(argv)
    manifest = export_artifacts(
        args.save_directory, args.out, batch_size=args.batch_size,
        img_size=args.img_size, bert_pretrained_dir=args.bert_pretrained_dir,
        disease=args.disease, max_seq_length=args.max_seq_length,
        device=args.device)
    print(json.dumps(manifest))


if __name__ == "__main__":
    main()
