"""Caption tokenisation for the BERT path.

Counterpart of text_guided_face_recognition_tpu/data/tokenizers.py, as far
as the port's path needs it: the deterministic offline HashTokenizer (same
output contract as a HuggingFace tokenizer with padding='max_length':
input_ids padded to `bert_words_num` plus the attention mask). The HF and
corpus-trained WordPiece resolutions of the JAX package wait for a later
slice (ROADMAP.md).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = ["HashTokenizer", "get_bert_tokenizer"]

_WORD_RE = re.compile(r"\w+")


class HashTokenizer:
    """Deterministic offline stand-in for a HF subword tokenizer: [CLS]-like
    id 101, [SEP]-like id 102, word tokens hashed (FNV-1a) into
    [1000, vocab_size), id 0 = PAD."""

    cls_id, sep_id, pad_id = 101, 102, 0

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def _hash(self, token: str) -> int:
        h = 2166136261
        for ch in token.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 1000 + h % (self.vocab_size - 1000)

    def __call__(self, caption: str, max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        words = _WORD_RE.findall(caption.lower())
        ids = [self.cls_id] + [self._hash(w) for w in words]
        ids = ids[: max_length - 1] + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_id] * pad
        mask = mask + [0] * pad
        return (np.asarray(ids, np.int32), np.asarray(mask, np.int32))


def get_bert_tokenizer(args):
    """(caption, max_length) -> (input_ids, attention_mask), with the
    `cache_tag` that namespaces the caption cache ("-hash", as in the JAX
    package's HashTokenizer fallback)."""
    from text_guided_face_recognition_tpu_torch.models.text_bert import (
        TEXT_ARCHS)
    ht = HashTokenizer(TEXT_ARCHS[args.bert_type].vocab_size)
    fn = lambda caption, max_length: ht(caption, max_length)  # noqa: E731
    fn.cache_tag = "-hash"
    return fn
