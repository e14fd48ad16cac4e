"""On-disk data in the port against the JAX package, the long-caption
refusal, and K2's per-stream counters.

An on-disk Face2Text-layout set written into tmp_path: 8 JPEGs stored at
112, 128 and 250 pixels (the native resize is bilinear without antialias,
PIL's has one, so only the native path gives the JAX package's pixels at
128 and 250), the split pickles, a pair list and the caption files, and no
captions_bert.pickle. Both packages' `prepare_dataloader` run on copies of
it with the native decode on (native/libtgfr_dataio.so): the train and
eval batches, the caption indices they draw and the token ids must be
equal, element for element, and both must write the same caption cache
(the tokenizer resolution: HF from the local cache, then a WordPiece
vocabulary trained on the corpus, then the hash tokenizer). The
`tokenizers` trainer orders pieces of equal rank differently from one run
to the next, in either package, which is why a trained vocabulary is kept
in the data directory and reused: the port is handed the JAX package's
file, as a later run would find it, and its own training on a third copy
is held to the same size and specials.

The `cuda` case holds K2 on two streams at once against K2 run serially,
bit for bit, and skips without a card. The JAX package is imported inside
the tests, so on a card's host without it the case runs alone:
  python -m pytest tests/test_torch_data.py -m cuda --noconftest -q
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch import config as pconfig
from text_guided_face_recognition_tpu_torch.config import TGFRConfig as PConfig
from text_guided_face_recognition_tpu_torch.data import native as pnative
from text_guided_face_recognition_tpu_torch.data.datasets import (
    load_text_data_bert)
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep

SIZES = (112, 128, 250, 112, 250, 128, 112, 250)
TRAIN = [f"{i}_{k}" for i in range(1, 5) for k in range(2)]
TEST = ["5_0", "5_1", "6_0", "6_1"]
CAPTIONS = ["the man has short dark hair and a beard",
            "a smiling woman with long blond hair",
            "she wears glasses and has a round face",
            "an old man with grey hair and a moustache"]


def _write_set(root):
    from PIL import Image
    rng = np.random.default_rng(0)
    for split, names in (("train", TRAIN), ("test", TEST)):
        os.makedirs(root / split)
        with open(root / split / "filenames.pickle", "wb") as f:
            pickle.dump(names, f)
        with open(root / split / "class_info.pickle", "wb") as f:
            pickle.dump([int(n.split("_")[0]) - 1 for n in names], f)
        os.makedirs(root / "images" / split)
        for i, n in enumerate(names):
            s = SIZES[(i + (4 if split == "test" else 0)) % len(SIZES)]
            # smooth content plus noise, as a face crop has both
            yy, xx = np.mgrid[0:s, 0:s] / s
            base = np.stack([yy, xx, (yy + xx) / 2], -1) * 200
            img = base + rng.normal(0, 20, (s, s, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / "images" / split / f"{n}.jpg", quality=90)
    os.makedirs(root / "text")
    for i, n in enumerate(TRAIN + TEST):
        lines = [CAPTIONS[(i + k) % len(CAPTIONS)] for k in range(3)]
        (root / "text" / f"{n}.txt").write_text("\n".join(lines) + "\n")
    (root / "pairs.txt").write_text(
        "5_0.jpg 5_1.jpg 1\n5_0.jpg 6_0.jpg 0\n6_0.jpg 6_1.jpg 1\n"
        "6_1.jpg 5_1.jpg 0\n")


class _Jax:
    def __init__(self):
        from text_guided_face_recognition_tpu.config import TGFRConfig
        from text_guided_face_recognition_tpu.data import native
        from text_guided_face_recognition_tpu.data.tokenizers import (
            get_bert_tokenizer)
        from text_guided_face_recognition_tpu.engine import prepare
        self.Config, self.native, self.prep = TGFRConfig, native, prepare
        self.get_bert_tokenizer = get_bert_tokenizer


@pytest.fixture
def jx():
    return _Jax()


@pytest.fixture
def disk_set(tmp_path, jx):
    """(JAX's data dir, the port's data dir): two copies of one set."""
    if not jx.native.available():  # builds native/ with make where absent
        pytest.skip("the native dataio library does not build here")
    _write_set(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    return tmp_path / "j", tmp_path / "p"


def _cfg(data_dir, **kw):
    base = dict(en_type="BERT", synthetic=False, data_dir=str(data_dir),
                test_pair_list=str(data_dir / "pairs.txt"), bert_type="bert",
                bert_words_num=16, captions_per_image=2, img_size=112,
                model_type="arcface", batch_size=4, num_workers=0,
                manual_seed=3, num_classes=8, is_ident=False,
                uint8_images=False)
    base.update(kw)
    return base


def _batches(prep, args, split):
    dl, ds = prep.prepare_dataloader(args, split)
    return ds, list(dl)


def _batches_match(jx, jdir, pdir, **kw):
    """Both packages' train and test batches from their copies of the set
    are equal, element for element; returns the port's, by split."""
    jargs = jx.Config().replace(**_cfg(jdir, **kw), num_devices=1)
    pargs = PConfig().replace(**_cfg(pdir, **kw))
    jbatches = {s: _batches(jx.prep, jargs, s) for s in ("train", "test")}
    vocab = jdir / "wordpiece_vocab.txt"
    if vocab.is_file():                   # the JAX package trained one
        shutil.copy(vocab, pdir / vocab.name)
    out = {}
    for split in ("train", "test"):
        jds, jb = jbatches[split]
        pds, pb = out[split] = _batches(pprep, pargs, split)
        assert jds._native_ok() and pds._native_ok(), split
        assert len(jb) == len(pb) > 0, split
        for j, p in zip(jb, pb):
            assert sorted(j) == sorted(p), split
            for k in p:
                np.testing.assert_array_equal(p[k], j[k],
                                              err_msg=f"{split} {k}")
    return {split: pb for split, (_, pb) in out.items()}


def test_on_disk_batches_match_jax(disk_set, tmp_path, jx):
    jdir, pdir = disk_set
    shutil.copytree(pdir, tmp_path / "own")
    _batches_match(jx, jdir, pdir)
    vocab = jdir / "wordpiece_vocab.txt"
    # the caches: the same resolved tokenizer's, on both sides
    jc = sorted(f for f in os.listdir(jdir) if f.startswith("captions_"))
    pc = sorted(f for f in os.listdir(pdir) if f.startswith("captions_"))
    assert jc == pc and len(pc) == 1, (jc, pc)
    with open(jdir / jc[0], "rb") as f:
        jcache = pickle.load(f)
    with open(pdir / pc[0], "rb") as f:
        pcache = pickle.load(f)
    assert [len(a) for a in jcache] == [len(b) for b in pcache]
    for a, b in zip(jcache, pcache):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    if vocab.is_file():
        # the port trains its own vocabulary: as many pieces, specials
        # first, and the cache named alike (which pieces win a tie in the
        # trainer differs between runs of either package)
        assert pc == ["captions_bert-wordpiece.pickle"]
        own = tmp_path / "own"
        load_text_data_bert(str(own), PConfig().replace(**_cfg(own)))
        assert (own / pc[0]).is_file()
        lj = vocab.read_text().split("\n")
        lp = (own / vocab.name).read_text().split("\n")
        assert lp[:5] == lj[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                    "[MASK]"]
        assert len(lp) == len(lj)


def test_on_disk_batches_match_jax_with_the_caption_bug(disk_set, jx):
    """compat_bert_caption_bug: the train batches index captions by the
    drawn sentence alone (the reference's bug), as the JAX package's do,
    and differ from the batches without the switch; test batches do not
    change."""
    jdir, pdir = disk_set
    bug = _batches_match(jx, jdir, pdir, compat_bert_caption_bug=True)
    fixed = _batches_match(jx, jdir, pdir)
    assert any(not np.array_equal(a["caps"], b["caps"])
               for a, b in zip(bug["train"], fixed["train"]))
    for a, b in zip(bug["test"], fixed["test"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_on_disk_images_take_the_native_path(disk_set):
    """The port's eval image of a 250-pixel JPEG is the native library's
    (bilinear, no antialias), not PIL's, and a train image depends on the
    seed drawn for it."""
    from text_guided_face_recognition_tpu_torch.data.datasets import (
        TrainDataset)
    from text_guided_face_recognition_tpu_torch.data.transforms import (
        decode_image, eval_transform)
    _, pdir = disk_set
    pargs = PConfig().replace(**_cfg(pdir))
    _, ds = pprep.prepare_dataloader(pargs, "test")
    name = "5_0.jpg"                                  # stored at 250
    path = str(pdir / "images" / "test" / name)
    side = ds.get_sample(name, name[:-4])
    np.testing.assert_array_equal(side["img"],
                                  pnative.decode_batch([path], 112, 112)[0])
    assert np.abs(side["img"] - eval_transform(decode_image(path, 112))
                  ).max() > 0
    ds.use_native = False                             # the PIL path
    np.testing.assert_array_equal(
        ds.get_sample(name, name[:-4])["img"],
        eval_transform(decode_image(path, 112)))
    tr = TrainDataset(TRAIN, *_captions(pargs), args=pargs, seed=0)
    a = tr._produce_image(0, np.random.default_rng(1))
    b = tr._produce_image(0, np.random.default_rng(1))
    c = tr._produce_image(0, np.random.default_rng(2))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def _captions(args):
    out = load_text_data_bert(args.data_dir, args)
    return out[1], out[2]


def test_tokenizer_resolution_matches_jax(tmp_path, monkeypatch, jx):
    """Without a corpus the WordPiece step has nothing to train on and both
    packages take the hash tokenizer; with `tokenizers` missing, the port
    falls through to it as well."""
    import builtins

    from text_guided_face_recognition_tpu_torch.data.tokenizers import (
        get_bert_tokenizer as pget)
    kw = _cfg(tmp_path)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        j = jx.get_bert_tokenizer(jx.Config().replace(**kw, num_devices=1))
    with pytest.warns(UserWarning, match="HashTokenizer"):
        p = pget(PConfig().replace(**kw))
    assert j.cache_tag == p.cache_tag == "-hash"
    cap = "a smiling man with glasses"
    for a, b in zip(j(cap, 16), p(cap, 16)):
        np.testing.assert_array_equal(a, b)
    _write_set(tmp_path / "corpus")
    real_import = builtins.__import__

    def no_tokenizers(name, *a, **k):
        if name.split(".")[0] in ("tokenizers", "transformers"):
            raise ImportError(f"no module named {name!r}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        q = pget(PConfig().replace(**_cfg(tmp_path / "corpus")))
    assert q.cache_tag == "-hash"


@pytest.mark.parametrize("fused_block", ["both", "tower", "ffn", "attn"])
def test_long_captions_refused_at_the_config_check(fused_block):
    """In bf16 the half-layer kernels take 512 tokens with a gradient and
    without one (K5's and K6's tensor-core attention, bert-base's position
    table); the whole-tower kernels 64 with a gradient and 128 without; in
    f32 every fused block 64 with a gradient and 128 without. A longer
    bert_words_num is refused where the configuration is checked, before
    any step, and the message names the limit."""
    cfg = PConfig().replace(fused_block=fused_block, bert_words_num=64)
    assert cfg.compute_dtype == "bfloat16"
    for dtype in ("bfloat16", "float32"):
        at = cfg.replace(compute_dtype=dtype)
        train = 512 if dtype == "bfloat16" and fused_block != "tower" else 64
        serve = 512 if dtype == "bfloat16" and fused_block != "tower" else 128
        pconfig.check_stage1(at.replace(bert_words_num=train))
        pconfig.check_stage2(at.replace(fusion_type="fcfm",
                                        bert_words_num=train))
        for check in (pconfig.check_stage1, pconfig.check_stage2):
            with pytest.raises(NotImplementedError,
                               match=f"at most {train} tokens when a "
                                     f"gradient is needed in {dtype}"):
                check(at.replace(bert_words_num=train + 1))
        pconfig.check_serving(at.replace(bert_words_num=serve))
        with pytest.raises(NotImplementedError,
                           match=f"at most {serve} tokens in serving in "
                                 f"{dtype}"):
            pconfig.check_serving(at.replace(bert_words_num=serve + 1))
    # unfused, any length the position table holds (bert-base: 512); a
    # longer one is refused whatever the mode
    off = cfg.replace(fused_block="none", bert_words_num=512)
    pconfig.check_stage1(off)
    pconfig.check_serving(off)
    for check in (pconfig.check_stage1, pconfig.check_serving):
        with pytest.raises(ValueError, match="has 512 positions"):
            check(off.replace(bert_words_num=513))


def test_long_captions_refused_before_the_first_step(monkeypatch, tmp_path):
    """The serving entries refuse before they load data or build a
    model."""
    from text_guided_face_recognition_tpu_torch.cli import test as cli
    from text_guided_face_recognition_tpu_torch.engine import prepare
    from text_guided_face_recognition_tpu_torch.engine.extract import (
        extract_embeddings)

    def no_data(*a, **k):
        raise AssertionError("data loaded before the configuration check")

    monkeypatch.setattr(prepare, "prepare_dataloader", no_data)
    cfg = tmp_path / "long.yml"
    cfg.write_text("bert_words_num: 513\nfused_block: both\n")
    with pytest.raises(NotImplementedError, match="at most 512 tokens"):
        cli.main(["--cfg", str(cfg), "--synthetic", "--cpu"])
    with pytest.raises(NotImplementedError, match="at most 128 tokens"):
        extract_embeddings(PConfig().replace(
            fused_block="tower", bert_words_num=129, cpu=True,
            synthetic=True))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_bwd_two_streams_at_once(tdt):
    """K2 on two streams at once, each with its own arrival counters,
    equals K2 run serially, bit for bit; the counters are 0 after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from text_guided_face_recognition_tpu_torch.ops import layernorm
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows, h = 768, 768
    ins = [tuple(torch.randn(rows, h, generator=g).to(dev, tdt)
                 for _ in range(2)) for _ in range(2)]
    gamma = (1 + 0.1 * torch.randn(h, generator=g)).to(dev)
    serial = [layernorm.layernorm_bwd(dy, x, gamma) for dy, x in ins]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):                    # interleaved, to overlap
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(layernorm.layernorm_bwd(*ins[i], gamma))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            for a, b in zip(got, serial[i]):
                assert torch.equal(a, b)
        with torch.cuda.stream(streams[i]):
            counter = layernorm.ln_bwd_counter(dev)
        assert not counter.any()
    with torch.cuda.stream(streams[0]):
        c0 = layernorm.ln_bwd_counter(dev)
    with torch.cuda.stream(streams[1]):
        c1 = layernorm.ln_bwd_counter(dev)
    assert c0.data_ptr() != c1.data_ptr()
