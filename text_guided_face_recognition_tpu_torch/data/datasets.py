"""Datasets: caption/identity metadata and images.

Counterpart of text_guided_face_recognition_tpu/data/datasets.py, for BERT
and LSTM/GRU captions. Samples are dicts of numpy arrays; images are NHWC
float32 in [-1, 1] (or uint8 with `uint8_images`), the same wire format as
the JAX package. Images on disk take the JAX package's paths: the fused native
decode + resize + augment (data/native.py, native/tgfr_dataio.cpp; one
uint64 seed drawn per train image, where the JAX package draws it) when the
library loads, else PIL (data/transforms.py), with the JAX package's
warning. So the two packages make the same batches from the same files,
seed and tokenizer, and from `synthetic=True`, which generates a
deterministic random image per key, the same bytes as the JAX package
generates (tests/test_torch_data.py holds both).

Ported: the reference's on-disk formats (filenames/class pickles, per-id
caption files, the BERT caption caches named by the tokenizer's cache tag,
the LSTM path's captions_RNN.pickle), `TrainDataset` (flat samples, as
training and extraction use them) and `TestDataset` (pair lists), and the
`compat_bert_caption_bug` switch (the reference's caption index). A BERT
sample carries the padded token ids and their attention `mask`; an LSTM or
GRU sample the word ids padded with 0 ('<end>') to `lstm_words_num` and
their count `cap_len`: a longer caption keeps `lstm_words_num` of its
words, chosen at random in order (`pad_lstm_caption`, from the sample's
generator: (seed, index, visit) in training, (0, pair index) for both
sides of a test pair, (1, key index) for a table-mode sample). With a
frozen-feature cache installed (`set_feature_cache`,
engine/feature_cache.py) a train sample carries the backbone's `img_gl`
and `img_lc` at its index in place of `img`, and its generator takes the
draws the image would have taken, so its caption is the one drawn
without the cache.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from text_guided_face_recognition_tpu_torch.data.tokenizers import (
    LstmTokenizer,
    Vocabulary,
    build_dictionary,
    get_bert_tokenizer,
)
from text_guided_face_recognition_tpu_torch.data.transforms import (
    decode_image,
    eval_transform,
    train_aug_u8,
    train_transform,
)

__all__ = ["load_filenames", "load_class_id", "load_captions",
           "load_text_data", "load_text_data_bert", "TrainDataset",
           "TestDataset"]


def load_filenames(data_dir: str, split: str) -> List[str]:
    path = os.path.join(data_dir, split, "filenames.pickle")
    if not os.path.isfile(path):
        return []
    with open(path, "rb") as f:
        names = pickle.load(f)
    print(f"Load {split} filenames from: {path} ({len(names)})")
    return list(names)


def load_class_id(split_dir: str) -> List[int]:
    path = os.path.join(split_dir, "class_info.pickle")
    with open(path, "rb") as f:
        class_id = pickle.load(f, encoding="bytes")
    print(f"Load class_info from: {path} ({len(class_id)})")
    return list(class_id)


def _read_caption_file(data_dir: str, filename: str) -> List[str]:
    cap_path = os.path.join(data_dir, "text", filename + ".txt")
    with open(cap_path, "r") as f:
        return [c for c in f.read().split("\n") if len(c) > 0]


def load_captions(data_dir: str, filenames, embeddings_num: int
                  ) -> List[List[str]]:
    """The LSTM path's tokens of `embeddings_num` captions per image (the
    first ones with any word)."""
    tok = LstmTokenizer()
    all_captions: List[List[str]] = []
    for name in filenames:
        cnt = 0
        for cap in _read_caption_file(data_dir, name):
            tokens = tok.tokenize(cap)
            if not tokens:
                continue
            all_captions.append(tokens)
            cnt += 1
            if cnt == embeddings_num:
                break
        if cnt < embeddings_num:
            print(f"ERROR: the captions for {name} less than {cnt}")
    return all_captions


def load_text_data(data_dir: str, embeddings_num: int):
    """The LSTM caption cache data_dir/captions_RNN.pickle, the reference's
    layout ([train, valid, test captions as word-id lists, ixtoword,
    wordtoix], pickle protocol 2), built from the caption files on first
    use. Returns (train names, train captions, valid names, valid
    captions, test names, test captions, vocabulary). Raises
    FileNotFoundError when the split metadata is absent."""
    names = {s: load_filenames(data_dir, s) for s in ("train", "valid", "test")}
    if not names["train"] and not names["test"]:
        raise FileNotFoundError(f"no split metadata under {data_dir}")
    filepath = os.path.join(data_dir, "captions_RNN.pickle")
    if not os.path.isfile(filepath):
        raw = [load_captions(data_dir, names[s], embeddings_num)
               for s in ("train", "valid", "test")]
        (train_caps, valid_caps, test_caps), vocab = build_dictionary(*raw)
        with open(filepath, "wb") as f:
            pickle.dump([train_caps, valid_caps, test_caps,
                         vocab.ixtoword, vocab.wordtoix], f, protocol=2)
        print("\nSave to: ", filepath)
    else:
        with open(filepath, "rb") as f:
            x = pickle.load(f)
        train_caps, valid_caps, test_caps = x[0], x[1], x[2]
        vocab = Vocabulary(wordtoix=x[4], ixtoword=x[3])
    return (names["train"], train_caps, names["valid"], valid_caps,
            names["test"], test_caps, vocab)


def _as_numpy_caption(x) -> np.ndarray:
    """Accept torch tensors (reference cache format) or arrays/lists."""
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.int32)
    return np.asarray(x, np.int32)


def load_text_data_bert(data_dir: str, args):
    """BERT caption cache: the reference's captions_<bert_type>.pickle when
    present, else captions_<bert_type><tag>.pickle, built on first use by
    the tokenizer that data/tokenizers.get_bert_tokenizer resolves, <tag>
    its cache tag ("", "-wordpiece" or "-hash"). Raises FileNotFoundError
    when the split metadata is absent."""
    names = {s: load_filenames(data_dir, s) for s in ("train", "valid", "test")}
    if not names["train"] and not names["test"]:
        raise FileNotFoundError(f"no split metadata under {data_dir}")
    filepath = os.path.join(data_dir, f"captions_{args.bert_type}.pickle")
    if not os.path.isfile(filepath):
        encode = get_bert_tokenizer(args)
        filepath = os.path.join(
            data_dir, f"captions_{args.bert_type}{encode.cache_tag}.pickle")
    if not os.path.isfile(filepath):
        store = []
        for split in ("train", "valid", "test"):
            caps, masks = [], []
            for name in names[split]:
                cnt = 0
                for cap in _read_caption_file(data_dir, name):
                    ids, mask = encode(cap, args.bert_words_num)
                    caps.append(ids)
                    masks.append(mask)
                    cnt += 1
                    if cnt == args.captions_per_image:
                        break
                if cnt < args.captions_per_image:
                    print(f"ERROR: the captions for {name} less than {cnt}")
            store += [caps, masks]
        with open(filepath, "wb") as f:
            pickle.dump(store, f, protocol=2)
        print("\nSave to: ", filepath)
        tr_c, tr_m, va_c, va_m, te_c, te_m = store
    else:
        print("Loading ", filepath)
        with open(filepath, "rb") as f:
            x = pickle.load(f)
        tr_c, tr_m, va_c, va_m, te_c, te_m = (
            [_as_numpy_caption(c) for c in part] for part in x)
    return (names["train"], tr_c, tr_m, names["valid"], va_c, va_m,
            names["test"], te_c, te_m)


def _synthetic_image(key: str, img_size: int) -> np.ndarray:
    """Deterministic per-key uint8 image for data-free end-to-end runs."""
    seed = int.from_bytes(hashlib.sha1(key.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(img_size, img_size, 3), dtype=np.uint8)


class _DatasetBase:
    use_native: bool = True  # the fused C++ decode + transform when it loads

    def _init_common(self, filenames, captions, att_masks, split, args,
                     synthetic, vocab):
        self.filenames = list(filenames)
        self.captions = captions
        self.att_masks = att_masks
        self.vocab = vocab
        self.en_type = args.en_type
        self.word_num = (args.bert_words_num if args.en_type == "BERT"
                         else args.lstm_words_num)
        self.split = split
        self.args = args
        self.synthetic = synthetic or bool(getattr(args, "synthetic", False))
        self.embeddings_num = args.captions_per_image
        self.data_dir = args.data_dir
        self.model_type = args.model_type
        self.img_size = args.img_size
        self.uint8_images = bool(getattr(args, "uint8_images", False))

    def _native_ok(self) -> bool:
        if not self.use_native or self.synthetic:
            return False
        from text_guided_face_recognition_tpu_torch.data import native
        if self.uint8_images:
            return native.supports_u8()  # a v1 library cannot emit uint8
        return native.available()

    def _load_transformed(self, path: str, train: bool,
                          rng: Optional[np.random.Generator]
                          ) -> Optional[np.ndarray]:
        """The fused native decode + resize + augment + normalise of one
        image (native/tgfr_dataio.cpp), with one uint64 seed from `rng` for
        a train image; None: the caller takes the PIL path."""
        if not self._native_ok():
            return None
        from text_guided_face_recognition_tpu_torch.data import native
        seeds = (np.asarray([rng.integers(0, 2**63)], np.uint64) if train
                 else None)
        try:
            return native.decode_batch(
                [path], self.img_size, self.img_size, seeds=seeds,
                train_aug=train, bgr=self.model_type == "adaface",
                n_threads=1, u8_out=self.uint8_images)[0]
        except Exception:
            return None

    def _raw_image(self, path: str, key: str) -> np.ndarray:
        if self.synthetic:
            return _synthetic_image(key, self.img_size)
        return decode_image(path, self.img_size)

    def _eval_image(self, raw: np.ndarray) -> np.ndarray:
        if self.uint8_images:
            return np.ascontiguousarray(raw)  # the device normalises
        return eval_transform(raw, self.model_type)

    def pad_lstm_caption(self, caption, rng: np.random.Generator
                         ) -> Tuple[np.ndarray, int]:
        """(word ids padded with 0 to word_num, their count): a caption
        longer than word_num keeps word_num of its words in order, drawn by
        one permutation from `rng`."""
        cap = np.asarray(caption, np.int64)
        if (cap == 0).sum() > 0:
            print("ERROR: do not need END (0) token", cap)
        x = np.zeros((self.word_num,), np.int32)
        n = len(cap)
        if n <= self.word_num:
            x[:n] = cap
            return x, n
        ix = np.sort(rng.permutation(n)[: self.word_num])
        x[:] = cap[ix]
        return x, self.word_num

    def _caption(self, index: int, rng: np.random.Generator
                 ) -> Dict[str, np.ndarray]:
        """Caption `index`: {"caps", "mask"} (BERT) or {"caps",
        "cap_len"} (LSTM/GRU, padded or subsampled from `rng`)."""
        if self.en_type == "BERT":
            return {"caps": _as_numpy_caption(self.captions[index]),
                    "mask": _as_numpy_caption(self.att_masks[index])}
        caps, cap_len = self.pad_lstm_caption(self.captions[index], rng)
        return {"caps": caps, "cap_len": np.int32(cap_len)}


class TrainDataset(_DatasetBase):
    """Flat (image, caption) samples. Each __getitem__ call derives its RNG
    from (seed, index, visit#), so concurrent loader threads stay
    deterministic."""

    def __init__(self, filenames, captions, att_masks=None, split="train",
                 args=None, synthetic: bool = False, seed: int = 0,
                 vocab: Optional[Vocabulary] = None):
        self._init_common(filenames, captions, att_masks, split, args,
                          synthetic, vocab)
        try:
            self.class_id = load_class_id(os.path.join(self.data_dir, split))
        except (FileNotFoundError, OSError):
            if not self.synthetic:
                raise
            self.class_id = [i % args.num_classes
                             for i in range(len(self.filenames))]
        self.seed = seed
        # the reference's caption index (utils/train_dataset.py:77-82)
        self.compat_bug = bool(args.compat_bert_caption_bug)
        self._visits: Dict[int, int] = {}
        # the frozen-feature cache: {"gl", "lc"} indexed as the dataset
        self._feature_cache = None
        # serving knobs: no augmentation, a pinned caption index
        self.augment: bool = True
        self.fixed_sent_ix: Optional[int] = None

    def check_classifier_coverage(self, num_classes: int) -> None:
        """Fail when the identity count outgrows the classifier: a label
        >= num_classes would make the margin cross-entropy index past its
        logits. Called by the trainers, where a classifier exists."""
        nc = int(num_classes or 0)
        if nc and self.class_id and max(self.class_id) >= nc:
            raise ValueError(
                f"dataset '{self.split}' class ids reach "
                f"{max(self.class_id)} but num_classes is {nc}; raise "
                "num_classes to cover the dataset's identity count")

    def __len__(self) -> int:
        return len(self.filenames)

    def _produce_image(self, index: int, rng: np.random.Generator
                       ) -> np.ndarray:
        key = self.filenames[index]
        path = os.path.join(self.data_dir, "images", self.split, key + ".jpg")
        if not self.synthetic:
            img = self._load_transformed(path, train=self.augment, rng=rng)
            if img is not None:
                return img
        raw = self._raw_image(path, key)
        if not self.augment:
            return self._eval_image(raw)
        if self.uint8_images:
            return train_aug_u8(raw, rng)
        return train_transform(raw, rng, self.model_type)

    def _consume_aug_draws(self, rng: np.random.Generator) -> None:
        """Advance `rng` as `_produce_image` does, draw for draw, without
        the image: the native path's one uint64 seed (drawn when the
        library loads and the image is not synthetic), else the two
        uniforms of `train_aug_u8` (grayscale, flip), which
        `train_transform` calls. An image that fails native decode after
        its seed takes two more on the PIL path; the cache assumes
        decodable files."""
        if not self.augment:
            return                      # the eval transform draws nothing
        if not self.synthetic and self._native_ok():
            rng.integers(0, 2**63)      # _load_transformed's seed
        else:
            rng.random()                # train_aug_u8: RandomGrayscale
            rng.random()                # train_aug_u8: RandomHorizontalFlip

    def peek_augmented_image(self, index: int) -> np.ndarray:
        """The image __getitem__ gives `index` at its next visit, without
        counting the visit (the cache's refresh before each epoch)."""
        visit = self._visits.get(index, -1) + 1
        rng = np.random.default_rng((self.seed, index, visit))
        return self._produce_image(index, rng)

    def count_visits(self, indices) -> None:
        """Count a visit of each index without loading it: another rank
        loads these rows of the global batch (data/loader.py
        `process_shard`), and every row's next draws must be the ones one
        process would take."""
        for i in indices:
            i = int(i)
            self._visits[i] = self._visits.get(i, -1) + 1

    def set_feature_cache(self, cache) -> None:
        """cache: {"gl": (N, ...), "lc": (N, ...)} (numpy arrays or CPU
        tensors) aligned with the dataset's indices, or holding some of
        them with "slot" (one row an index, -1 where not held:
        engine/feature_cache.py at more than one rank), or None."""
        self._feature_cache = cache

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key = self.filenames[index]
        visit = self._visits[index] = self._visits.get(index, -1) + 1
        rng = np.random.default_rng((self.seed, index, visit))
        cache = self._feature_cache
        if cache is not None:
            self._consume_aug_draws(rng)
            at = index
            if cache.get("slot") is not None:
                at = int(cache["slot"][index])
                if at < 0:
                    raise KeyError(f"the feature cache holds no row for "
                                   f"index {index} (another rank's)")
            sample = {"img_gl": cache["gl"][at], "img_lc": cache["lc"][at]}
        else:
            sample = {"img": self._produce_image(index, rng)}
        sent_ix = (self.fixed_sent_ix if self.fixed_sent_ix is not None
                   else int(rng.integers(0, self.embeddings_num)))
        cap_index = index * self.embeddings_num + sent_ix
        if self.compat_bug and self.en_type == "BERT":
            cap_index = sent_ix
        sample.update(self._caption(cap_index, rng))
        sample.update(key=key, cls_id=np.int32(self.class_id[index]))
        return sample


class TestDataset(_DatasetBase):
    """Pair-list verification dataset: pairs from `img1 img2 label` lines
    (or synthetic identification groups); each side takes the first caption
    of its key."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, filenames, captions, att_masks=None, split="test",
                 args=None, synthetic: bool = False,
                 vocab: Optional[Vocabulary] = None):
        self._init_common(filenames, captions, att_masks, split, args,
                          synthetic, vocab)
        self._index = {name: i for i, name in enumerate(self.filenames)}
        pair_file = (args.test_pair_list if split == "test"
                     else args.valid_pair_list)
        # a real pair list wins even over synthetic images
        self.synthetic_pairs = self.synthetic and not os.path.isfile(pair_file)
        self.imgs_pair, self.pair_label = self._read_pairs(pair_file)

    def _read_pairs(self, path: str):
        if self.synthetic_pairs:
            return self._synthetic_pairs()
        pairs, labels = [], []
        with open(path) as fd:
            for line in fd:
                parts = line.split(" ")
                if len(parts) < 3:
                    continue
                pairs.append([parts[0], parts[1]])
                labels.append(int(parts[2]))
        return pairs, labels

    def _synthetic_pairs(self):
        """Per subject: 1 genuine pair at column 0 of its 4-pair group, then
        3 imposters."""
        n = min(len(self.filenames), 64)
        pairs, labels = [], []
        for i in range(n):
            for j in range(4):
                a = self.filenames[i] + ".jpg"
                b = self.filenames[(i + j) % n] + ".jpg"
                pairs.append([a, b])
                labels.append(1 if j == 0 else 0)
        return pairs, labels

    def __len__(self) -> int:
        return len(self.imgs_pair)

    def pair_sides(self, index: int):
        """[(img_name, key), (img_name, key)] for pair `index`; bare
        `<id>_<k>.jpg` names resolve to the on-disk `<id>/<id>_<k>.jpg`
        layout unless the filename index holds the bare stem."""
        out = []
        for n in self.imgs_pair[index]:
            if n[:-4] not in self._index:
                joined = os.path.join(n.split("_")[0], n)
                if joined[:-4] in self._index or not self.synthetic:
                    n = joined
            out.append((n, n[:-4]))
        return out

    def get_sample(self, name: str, key: str, need_caption: bool = True,
                   rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, np.ndarray]:
        """One side's sample: eval image + first caption (sent_ix = 0), an
        LSTM caption's words chosen from `rng` (default: the sample's own,
        (1, key index), so a table-mode sample is the same in every pair);
        `need_caption=False` leaves the caption out (the image-only
        org_face_test table)."""
        path = os.path.join(self.data_dir, "images", self.split, name)
        img = (None if self.synthetic
               else self._load_transformed(path, train=False, rng=None))
        if img is None:
            img = self._eval_image(self._raw_image(path, key))
        side: Dict[str, np.ndarray] = {"img": img}
        if not need_caption:
            return side
        real_index = self._index.get(key, 0)
        if rng is None:
            rng = np.random.default_rng((1, real_index))
        cap = self._caption(real_index * self.embeddings_num, rng)
        side["cap"] = cap.pop("caps")
        side.update(cap)
        return side

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((0, index))     # both sides, in turn
        sample: Dict[str, np.ndarray] = {
            "pair_label": np.int32(self.pair_label[index])}
        for slot, (name, key) in enumerate(self.pair_sides(index), start=1):
            for k, v in self.get_sample(name, key, rng=rng).items():
                sample[f"{k}{slot}"] = v
        return sample
