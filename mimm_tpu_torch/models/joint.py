"""ImageReportModel — the joint image-report tower
(mimm_tpu/models/joint.py counterpart; reference model.py:529-595).

Holds the ResNet image encoder as ``image_model`` and the TextBert text
encoder as ``text_model``, so its state dict carries the ``image_model.``
/ ``text_model.`` keys of the reference's joint ``pytorch_model_epoch<N>.bin``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mimm_tpu_torch.models.bert import BertConfig, TextBert
from mimm_tpu_torch.models.resnet import ResNet256_6_2_1


class ImageReportModel(nn.Module):
    def __init__(self, bert_config: BertConfig, output_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bert_config = bert_config
        self.output_channels = output_channels
        self.dtype = dtype
        self.image_model = ResNet256_6_2_1(output_channels=output_channels,
                                           dtype=dtype)
        self.text_model = TextBert(bert_config, dtype=dtype)

    def forward(self, img, txt_ids, txt_masks=None, txt_segments=None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns (embedding_img, embedding_txt, logits_img, logits_txt),
        as the reference forward (model.py:540-555).  ``train``: BatchNorm
        on batch statistics (running statistics updated in place) and the
        text tower's dropout drawn from ``generator``."""
        _, emb_img, _, _, logits_img = self.image_model(img, train=train)
        emb_txt, logits_txt = self.text_model(
            txt_ids, token_type_ids=txt_segments, attention_mask=txt_masks,
            deterministic=not train, generator=generator)
        return emb_img, emb_txt, logits_img, logits_txt
