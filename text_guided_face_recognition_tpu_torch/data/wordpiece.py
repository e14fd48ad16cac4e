"""WordPiece tokenisation trained offline on the caption corpus.

Counterpart of text_guided_face_recognition_tpu/data/wordpiece.py, the
second step of data/tokenizers.get_bert_tokenizer: where no HuggingFace
tokenizer is cached, a WordPiece vocabulary is trained on the caption
corpus itself (the `tokenizers` package's trainer) and captions are encoded
with the BERT contract:

    [CLS] piece... [SEP] [PAD]...   padded to max_length, attention mask.

The vocabulary persists as one piece per line in
`<data_dir>/wordpiece_vocab.txt`, so later runs, and the JAX package on the
same directory, load the same vocabulary byte for byte. `tokenizers` is
imported inside the functions: where it is missing, `load_or_train` raises
ImportError and the caller falls through to the hash tokenizer, as the
JAX package does.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["VOCAB_FILENAME", "WordPieceTokenizer", "load_or_train",
           "corpus_caption_texts"]

VOCAB_FILENAME = "wordpiece_vocab.txt"
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _build_tokenizer(vocab: dict):
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]",
                                     max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    return tok


class WordPieceTokenizer:
    """Callable (caption, max_length) -> (input_ids, attention_mask), the
    output contract of the HF path (padded to max_length, truncated keeping
    the trailing [SEP])."""

    cache_tag = "-wordpiece"

    def __init__(self, vocab_path: str):
        vocab = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                piece = line.rstrip("\n")
                if piece:
                    vocab[piece] = i
        self.vocab_path = vocab_path
        self.vocab_size = len(vocab)
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab["[PAD]"]
        self._tok = _build_tokenizer(vocab)

    def __call__(self, caption: str, max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        caption = caption.replace("��", " ")
        ids = self._tok.encode(caption, add_special_tokens=False).ids
        ids = [self.cls_id] + ids[: max_length - 2] + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_id] * pad
        mask = mask + [0] * pad
        return (np.asarray(ids, np.int32), np.asarray(mask, np.int32))


def corpus_caption_texts(data_dir: str) -> List[str]:
    """Every caption line of every split, in (split, sorted name) order,
    read by the datasets' own caption parser, so the trained vocabulary is
    the one of the text that is encoded."""
    from text_guided_face_recognition_tpu_torch.data.datasets import (
        _read_caption_file)

    caps: List[str] = []
    for split in ("train", "valid", "test"):
        path = os.path.join(data_dir, split, "filenames.pickle")
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            names = list(pickle.load(f))
        for name in sorted(names):
            if not os.path.isfile(
                    os.path.join(data_dir, "text", str(name) + ".txt")):
                continue
            caps.extend(_read_caption_file(data_dir, str(name)))
    return caps


def load_or_train(data_dir: str, vocab_size: int = 30522
                  ) -> Optional[WordPieceTokenizer]:
    """Load `<data_dir>/wordpiece_vocab.txt` if present, else train it on
    the caption corpus under `data_dir` (all splits). None when the
    directory holds no captions: the caller falls through to the hash
    tokenizer."""
    vocab_path = os.path.join(data_dir, VOCAB_FILENAME)
    if os.path.isfile(vocab_path):
        return WordPieceTokenizer(vocab_path)
    caps = corpus_caption_texts(data_dir)
    if not caps:
        return None
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    from tokenizers.trainers import WordPieceTrainer
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    trainer = WordPieceTrainer(vocab_size=vocab_size, special_tokens=SPECIALS,
                               show_progress=False,
                               continuing_subword_prefix="##")
    tok.train_from_iterator(caps, trainer=trainer)
    vocab = tok.get_vocab()  # piece -> id
    pieces = sorted(vocab, key=vocab.get)
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(pieces) + "\n")
    return WordPieceTokenizer(vocab_path)
