"""The port's data layer: tokenizers, token features, transforms, the crop
cache and the datasets (mimm_tpu/data counterpart)."""

from .tokenizer import NativeWordPieceTokenizer, WordPieceTokenizer

__all__ = ["NativeWordPieceTokenizer", "WordPieceTokenizer"]
