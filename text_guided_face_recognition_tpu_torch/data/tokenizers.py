"""Caption tokenisation for the BERT path.

Counterpart of text_guided_face_recognition_tpu/data/tokenizers.py, as far
as the BERT path needs it: `get_bert_tokenizer` resolves a tokenizer in the
JAX package's order and with its cache tags (a HuggingFace tokenizer from
the local cache, a WordPiece vocabulary trained on the caption corpus
(data/wordpiece.py), the deterministic HashTokenizer), each with the output
contract of a HuggingFace tokenizer with padding='max_length': input_ids
padded to `bert_words_num` plus the attention mask.
"""

from __future__ import annotations

import re
import warnings
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
    """The BERT-family tokenizer of bert_type: a callable
    (caption, max_length) -> (input_ids, attention_mask) with a `cache_tag`
    that names its caption cache, so two tokenizers never share one.

    Resolution order (the JAX package's):
      1. the HF tokenizer of `<bert_type>_config`, from the local cache only
         (`local_files_only`), cache_tag "";
      2. a WordPiece vocabulary trained on the caption corpus under
         data_dir (data/wordpiece.py), cache_tag "-wordpiece";
      3. the HashTokenizer, cache_tag "-hash".
    `transformers` and `tokenizers` are imported here; where one is
    missing, its step fails and the next one is taken.
    """
    from text_guided_face_recognition_tpu_torch.models.text_bert import (
        TEXT_ARCHS)
    name = getattr(args, f"{args.bert_type}_config")
    arch_vocab = TEXT_ARCHS[args.bert_type].vocab_size
    try:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(name, local_files_only=True)

        def encode(caption: str, max_length: int):
            caption = caption.replace("��", " ")
            enc = tok(caption, add_special_tokens=True, max_length=max_length,
                      padding="max_length", truncation=True,
                      return_attention_mask=True)
            return (np.asarray(enc["input_ids"], np.int32),
                    np.asarray(enc["attention_mask"], np.int32))

        encode.cache_tag = ""
        return encode
    except Exception as e:  # not cached, or transformers missing
        hf_err = f"{type(e).__name__}"
    wp_why = "no caption corpus to train WordPiece on"
    try:
        from text_guided_face_recognition_tpu_torch.data import wordpiece
        wp = wordpiece.load_or_train(args.data_dir, vocab_size=arch_vocab)
        if wp is not None and wp.vocab_size <= arch_vocab:
            warnings.warn(
                f"HF tokenizer {name!r} unavailable offline ({hf_err}); "
                "using corpus-trained WordPiece vocab "
                f"({wp.vocab_size} pieces, {wp.vocab_path})")
            return wp
        if wp is not None:
            wp_why = (f"existing WordPiece vocab {wp.vocab_path} has "
                      f"{wp.vocab_size} pieces > arch vocab {arch_vocab}")
    except Exception as e:
        wp_why = f"WordPiece fallback failed ({type(e).__name__}: {e})"
    warnings.warn(
        f"HF tokenizer {name!r} unavailable offline ({hf_err}) and "
        f"{wp_why}; using deterministic HashTokenizer fallback")
    ht = HashTokenizer(arch_vocab)
    fn = lambda caption, max_length: ht(caption, max_length)  # noqa: E731
    fn.cache_tag = "-hash"
    return fn
