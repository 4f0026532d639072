"""WordPiece tokenizers, vocab-file compatible with BertTokenizer.

The port's own copy of mimm_tpu/data/tokenizer.py (``load_vocab``,
``BasicTokenizer``, ``WordpieceTokenizer``, ``WordPieceTokenizer``,
``NativeWordPieceTokenizer``): basic tokenization (clean/lower/strip
accents/split punctuation), then greedy longest-match-first wordpiece with
'##' continuations.  ``NativeWordPieceTokenizer`` encodes ASCII text in
the port's host library (data/native_ops.py) without the GIL.
"""

from __future__ import annotations

import collections
import os
import unicodedata
import weakref
from typing import Dict, List, Optional


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab = collections.OrderedDict()
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    """Whitespace/punctuation/accent normalization (BERT 'basic' stage)."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Optional[List[str]] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or
                               ["[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"])

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        tokens = text.split()
        out = []
        for tok in tokens:
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordpieceTokenizer:
    """Greedy longest-match-first sub-word tokenization."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out = []
        for token in text.split():
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens = []
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.extend([self.unk_token] if is_bad else sub_tokens)
        return out


class WordPieceTokenizer:
    """BertTokenizer-compatible facade: ``from_pretrained(dir)`` reads
    ``vocab.txt``; ``tokenize`` + ``convert_tokens_to_ids`` as used by the
    reference featurizer (model_utils.py:480-501)."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_pretrained(cls, vocab_dir_or_file: str, do_lower_case: bool = True
                        ) -> "WordPieceTokenizer":
        path = vocab_dir_or_file
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(load_vocab(path), do_lower_case=do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get("[UNK]", 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, "[UNK]") for i in ids]

    def encode_wordpiece_ids(self, text: str) -> List[int]:
        """Wordpiece ids for ``text`` WITHOUT [CLS]/[SEP] — the featurizer's
        one-call form (the name is deliberately NOT ``encode``: transformers'
        ``encode`` adds special tokens, and the featurizer must not confuse
        the two when handed an HF tokenizer)."""
        return self.convert_tokens_to_ids(self.tokenize(text))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)



class NativeWordPieceTokenizer(WordPieceTokenizer):
    """``WordPieceTokenizer`` whose ``encode_wordpiece_ids`` runs in the
    host library (csrc/host/mimm_host.cpp ``mimm_wp_encode``) for ASCII
    text, without the GIL: featurization fans out over threads, also once
    CUDA is initialized (features.convert_examples_to_features).  A text
    with a non-ASCII byte takes the Python encoder, which carries the full
    Unicode rules; that is the only text the Python path sees.  A library
    that cannot be built raises.

    ``from_pretrained(dir or vocab.txt)`` builds one.  The C++ vocabulary
    is freed with the tokenizer (``weakref.finalize``).  Pickling drops the
    raw handle, and the unpickled copy loads its own from the same
    vocabulary file."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        super().__init__(load_vocab(vocab_file), do_lower_case=do_lower_case)
        self.vocab_file = vocab_file
        self._attach()

    def _attach(self) -> None:
        from mimm_tpu_torch.data import native_ops
        self._native_handle = native_ops.wp_create(self.vocab_file)
        # the destroy function itself is captured, so the finalizer also
        # runs at interpreter shutdown
        self._finalizer = weakref.finalize(self, native_ops.wp_destroy,
                                           self._native_handle)

    @property
    def native_gil_free(self) -> bool:
        return True

    @classmethod
    def from_pretrained(cls, vocab_dir_or_file: str, do_lower_case: bool = True
                        ) -> "NativeWordPieceTokenizer":
        path = vocab_dir_or_file
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(path, do_lower_case=do_lower_case)

    def encode_wordpiece_ids(self, text: str) -> List[int]:
        from mimm_tpu_torch.data import native_ops
        ids = native_ops.wp_encode(self._native_handle, text,
                                   self.basic.do_lower_case)
        return super().encode_wordpiece_ids(text) if ids is None else ids

    def __getstate__(self):
        # a raw C pointer: meaningless in another process
        state = dict(self.__dict__)
        state.pop("_native_handle")
        state.pop("_finalizer")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._attach()
