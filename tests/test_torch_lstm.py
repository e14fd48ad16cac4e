"""The port's LSTM/GRU recipe (cfg/train_lstm.yml, cfg/fusion_lstm.yml)
against the JAX package on the CPU: the LSTM tokenizer, the caption cache
and the padded captions, the RNN encoder (LSTM and GRU), WordLevelCFA_LSTM,
the two converters of the reference's files, the stage-1 loss and step,
the stage-2 step (linear and fcfm), the fused embeddings and run_test's
scores, and the two CLIs.

Small sizes: a vocabulary of 48 words and '<end>', captions of T = 8 words,
batch 4, 16 classes; the encoder at the shipped widths (embedding 300, 128
units per direction), the full ImageHeading on the 14 x 14 x 256 local map
(the words' width, 256, is the regions' and WordLevelCFA_LSTM's). The
batches carry precomputed backbone features, or the serving twins run an
iResNet with one block per stage. Inputs come from numpy seeds. Dropout
(rate 0.5 on the embeddings) takes the same bits on both sides: the JAX
side's Bernoulli draw is replaced by the keep mask of uint32 bits the test
draws (keep iff bit >= 2^31, ops/dropout.py's rule), the port takes the
bits as int32.

Rounding. In f32 both sides compute the same function and differ by
summation order only. In bf16 the port follows flax's cells: inputs,
kernels and biases rounded to bf16, each product rounded, the bias added in
bf16, gates in bf16, the carry (c, h) in f32 (models/text_rnn.py).

Tolerances (each stated where it is checked; rtol = atol unless said):
modules in f32 1e-5, in bf16 2e-2; the encoder's gradients |g_p - g_j| <=
1e-5 max |g_j| per parameter; WordLevelCFA_LSTM in f32 1e-4 (a 256 x 256
Gram and a softmax over 256 positions, each summed in another order);
models and trainers (loss, metrics) rtol 1e-5, gradients 1e-4 max |g_j| +
1e-6 G per parameter, G the model's largest gradient element, as in
tests/test_torch_stage1.py; fused embeddings 1e-4 and pair scores 1e-5, as
in tests/test_torch_serving.py.
"""

import functools
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.data import datasets as jds
from text_guided_face_recognition_tpu.data import tokenizers as jtok
from text_guided_face_recognition_tpu.engine import evaluate as jev
from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.engine import stage2 as jstage2
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig, check_serving, check_stage2)
from text_guided_face_recognition_tpu_torch.data import datasets as pds
from text_guided_face_recognition_tpu_torch.data import tokenizers as ptok
from text_guided_face_recognition_tpu_torch.engine import evaluate as pev
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer as PStage1)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer as PStage2)

from _torch_port import bridge, close, randomize_stats, to_numpy, write_cfg

B, T, CLASSES, VOCAB = 4, 8, 16, 48
CPU = torch.device("cpu")
RNNS = ("LSTM", "GRU")


def _cfg(**kw):
    base = dict(en_type="LSTM", synthetic=True, batch_size=B, num_workers=2,
                compute_dtype="float32", captions_per_image=2,
                manual_seed=0, num_classes=CLASSES, lstm_words_num=T,
                embedding_dim=256, aux_feat_dim_per_granularity=256,
                checkpoints_path="", text_encoder_path="",
                image_encoder_path="", fusion_net_path="",
                adam_moments_dtype="float32", is_ident=False, is_roc=False)
    base.update(kw)
    return (JConfig().replace(**base, num_devices=1),
            PConfig().replace(**base))


@pytest.fixture
def small_vocab(monkeypatch):
    """The synthetic corpus over VOCAB words on both sides."""
    for mod in (jprep, pprep):
        make = mod._synthetic_vocab
        monkeypatch.setattr(mod, "_synthetic_vocab",
                            lambda n, make=make: make(VOCAB))


def _bits(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


@pytest.fixture
def same_dropout(monkeypatch):
    """jax.random.bernoulli, which flax's Dropout draws its keep mask from,
    returns the keep mask of `same_dropout.bits` (the port's rule)."""

    class Feed:
        bits = None

        def bernoulli(self, key, p, shape):
            assert p == 0.5 and self.bits.size == int(np.prod(shape))
            return jnp.asarray((self.bits >= 2**31).reshape(shape))

        def port(self) -> torch.Tensor:
            return torch.from_numpy(self.bits.view(np.int32).copy())

    feed = Feed()
    monkeypatch.setattr(jax.random, "bernoulli", feed.bernoulli)
    return feed


def _captions(seed: int = 0, b: int = B, t: int = T):
    """(b, t) word ids, 0 past each caption's length; lengths from 1 to t,
    the first caption full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = t
    caps = rng.integers(1, VOCAB + 1, (b, t)).astype(np.int32)
    caps[np.arange(t)[None, :] >= lens[:, None]] = 0
    return caps, lens


# ------------------------------------------------------------------ data --

def test_lstm_tokenizer_matches_jax():
    caps = ["A man with a BEARD, and glasses.", "Her hair's  blond/grey",
            "café naïve École x1 2nd", "��odd  text",
            "", "...", "üü only-ascii_under"]
    for c in caps:
        assert ptok.LstmTokenizer().tokenize(c) == \
            jtok.LstmTokenizer().tokenize(c), c


def _write_corpus(root, n_per_split=(3, 2, 2)):
    """Filenames pickles and caption files (3 captions an image, one of
    them word-free, one non-ASCII) under `root`."""
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(30)] + ["café", "Beard"]
    for split, n in zip(("train", "valid", "test"), n_per_split):
        names = [f"{split}{i}/{split}{i}_0" for i in range(n)]
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "filenames.pickle"), "wb") as f:
            pickle.dump(names, f)
        for name in names:
            path = os.path.join(root, "text", name + ".txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            lines = [" ".join(rng.choice(words, rng.integers(2, 12)))
                     for _ in range(2)]
            with open(path, "w") as f:
                f.write("\n".join([lines[0], "!!", lines[1], ""]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caption_cache_is_shared_with_jax(tmp_path, writer):
    """captions_RNN.pickle written by one package, read by the other: the
    same captions and vocabulary, and the same as the writer's own."""
    _write_corpus(str(tmp_path))
    load = {"port": pds.load_text_data, "jax": jds.load_text_data}
    first = load[writer](str(tmp_path), 2)
    assert os.path.isfile(tmp_path / "captions_RNN.pickle")
    second = load["jax" if writer == "port" else "port"](str(tmp_path), 2)
    for a, b in zip(first[:6], second[:6]):
        assert a == b
    assert first[6].wordtoix == second[6].wordtoix
    assert first[6].ixtoword == second[6].ixtoword
    assert first[6].n_words == second[6].n_words > 20
    assert len(first[1]) == 6 and 0 not in sum(first[1], [])


@pytest.mark.parametrize("n", [1, 5, T, T + 1, 3 * T])
def test_pad_lstm_caption_matches_jax(n):
    """Short captions pad with 0; longer ones keep T words in order, the
    same ones as the JAX package draws from the same generator."""
    jargs, pargs = _cfg()
    vocab = jprep._synthetic_vocab(VOCAB)
    j = jds.TrainDataset(["s0_0"], [[1]], vocab=vocab, args=jargs,
                         synthetic=True)
    p = pds.TrainDataset(["s0_0"], [[1]], args=pargs, synthetic=True,
                         vocab=vocab)
    cap = list(np.random.default_rng(n).integers(1, VOCAB, n))
    want = j.pad_lstm_caption(cap, np.random.default_rng(7))
    got = p.pad_lstm_caption(cap, np.random.default_rng(7))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == min(n, T) and got[0].dtype == np.int32


def test_lstm_batches_match_jax(small_vocab):
    """The synthetic LSTM corpus through both loaders: train batches (the
    caption subsampling drawn from each sample's generator), test pair
    batches, and the table-mode samples; vocab_size filled alike."""
    jargs, pargs = _cfg()
    for split in ("train", "test"):
        jdl, jd = jprep.prepare_dataloader(jargs, split)
        pdl, pd = pprep.prepare_dataloader(pargs, split)
        assert jargs.vocab_size == pargs.vocab_size == VOCAB + 1
        jb, pb = next(iter(jdl)), next(iter(pdl))
        assert sorted(jb) == sorted(pb)
        for k in pb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    lens = [len(c) for c in pd.captions]
    assert max(lens) > T      # the subsampling path is taken
    for i in range(0, len(pd), 7):
        for (name, key), _ in zip(pd.pair_sides(i), range(2)):
            a, b = pd.get_sample(name, key), jd.get_sample(name, key)
            assert sorted(a) == sorted(b) == ["cap", "cap_len", "img"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------- modules --

def _encoder_twins(en_type: str, dtype: str):
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = JM.RNNEncoder(vocab_size=VOCAB + 1, en_type=en_type, nhidden=256,
                      dtype=jdt)
    v = jax.jit(j.init)(jax.random.PRNGKey(3), jnp.zeros((1, T), jnp.int32),
                        jnp.ones((1,), jnp.int32))
    p = bridge(PM.RNNEncoder(VOCAB + 1, en_type, nhidden=256, dtype=pdt), v)
    return j, v, p


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("en_type", RNNS)
def test_rnn_encoder_matches_jax(en_type, dtype, tol):
    """Eval mode: words (B, 256, T), zero past each length, and the
    l2-normalised sentence vector."""
    j, v, p = _encoder_twins(en_type, dtype)
    caps, lens = _captions(1)
    jw, js = jax.jit(j.apply)(v, jnp.asarray(caps), jnp.asarray(lens))
    pw, ps = p(torch.from_numpy(caps), torch.from_numpy(lens))
    assert pw.shape == (B, 256, T) and pw.dtype == torch.float32
    assert (pw.permute(0, 2, 1)[torch.arange(T)[None, :] >=
                                torch.from_numpy(lens)[:, None]] == 0).all()
    close(pw, jw, tol, "words")
    close(ps, js, tol, "sentence")


@pytest.mark.parametrize("en_type", RNNS)
def test_rnn_encoder_train_mode_and_gradients_match_jax(en_type,
                                                        same_dropout):
    """Train mode with the same dropout bits: outputs at 1e-5, and the
    gradients of a random linear function of both outputs against
    jax.grad at 1e-5 of each parameter's largest (f32)."""
    j, v, p = _encoder_twins(en_type, "float32")
    p.train()
    caps, lens = _captions(2)
    same_dropout.bits = _bits(4, B * T * 300)
    rng = np.random.default_rng(5)
    rw = rng.normal(size=(B, 256, T)).astype(np.float32)
    rs = rng.normal(size=(B, 256)).astype(np.float32)

    def jloss(params):
        w, s = j.apply({"params": params}, jnp.asarray(caps),
                       jnp.asarray(lens), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(w * rw) + jnp.sum(s * rs), (w, s)

    (_, (jw, js)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])
    pw, ps = p(torch.from_numpy(caps), torch.from_numpy(lens),
               same_dropout.port())
    ((pw * torch.from_numpy(rw)).sum()
     + (ps * torch.from_numpy(rs)).sum()).backward()
    close(pw, jw, 1e-5, "words")
    close(ps, js, 1e-5, "sentence")
    gsd = state_dict_from_jax(to_numpy(jg), module=p)
    for name, prm in p.named_parameters():
        g_j = gsd[name].numpy()
        err = np.abs(prm.grad.numpy() - g_j).max()
        assert err <= 1e-5 * np.abs(g_j).max(), (name, err)


def test_rnn_encoder_refuses_missing_bits():
    p = PM.RNNEncoder(VOCAB + 1).train()
    caps, lens = _captions()
    with pytest.raises(ValueError, match="drop_bits"):
        p(torch.from_numpy(caps), torch.from_numpy(lens))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_wordlevel_cfa_lstm_matches_jax(dtype, tol, monkeypatch):
    """In bf16 the port sums each 8 x 8 average-pool window in f32 and
    rounds the mean, as torch's avg_pool2d (the reference's) does; XLA's
    CPU reduce_window sums a bf16 window in bf16 (0.19 off the f32 sum on
    these maps), so the JAX side's pool takes its sum in f32 here too.
    Every other rounding point is flax's."""
    import flax.linen
    pool = flax.linen.avg_pool
    monkeypatch.setattr(flax.linen, "avg_pool", lambda x, w, strides: pool(
        x.astype(jnp.float32), w, strides=strides).astype(x.dtype))
    rng = np.random.default_rng(6)
    local = rng.normal(size=(B, 14, 14, 256)).astype(np.float32)
    word = rng.normal(0, 0.2, size=(B, 256, T)).astype(np.float32)
    j = JM.WordLevelCFA_LSTM(channel_dim=256, dtype=getattr(jnp, dtype))
    v = jax.jit(j.init)(jax.random.PRNGKey(1), jnp.asarray(local),
                        jnp.asarray(word))
    v = jax.jit(lambda v: jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               x.shape), v))(v)  # LN affines
    p = bridge(PM.WordLevelCFA_LSTM(256, dtype=getattr(torch, dtype)), v)
    out_j = jax.jit(j.apply)(v, jnp.asarray(local), jnp.asarray(word))
    out_p = p(torch.from_numpy(local.transpose(0, 3, 1, 2).copy()),
              torch.from_numpy(word))
    assert out_p.shape == (B, 768)
    close(out_p, out_j, tol, "WordLevelCFA_LSTM")


# ------------------------------------------------------------ converters --

class _RefRNNEncoder(torch.nn.Module):
    """The reference's RNNEncoder layout: Embedding `encoder`, one
    bidirectional batch-first nn.LSTM / nn.GRU `rnn` of 128 units a
    direction, run the reference's way (packed by length)."""

    def __init__(self, en_type):
        super().__init__()
        torch.manual_seed(11)
        self.encoder = torch.nn.Embedding(VOCAB + 1, 300)
        cls = torch.nn.LSTM if en_type == "LSTM" else torch.nn.GRU
        self.rnn = cls(300, 128, 1, batch_first=True, bidirectional=True)
        with torch.no_grad():
            for prm in self.rnn.parameters():    # biases off zero
                prm.add_(0.1 * torch.randn(prm.shape))

    @torch.no_grad()
    def forward(self, caps, lens):
        from torch.nn.utils.rnn import (pack_padded_sequence,
                                        pad_packed_sequence)
        packed = pack_padded_sequence(self.encoder(caps.long()), lens,
                                      batch_first=True, enforce_sorted=False)
        out, hidden = self.rnn(packed)
        out = pad_packed_sequence(out, batch_first=True, total_length=T)[0]
        h_n = hidden[0] if isinstance(hidden, tuple) else hidden
        sent = h_n.transpose(0, 1).reshape(caps.shape[0], -1)
        return out.transpose(1, 2), sent / sent.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("en_type", RNNS)
def test_rnn_converter_matches_torch_rnn_and_jax(en_type, tmp_path):
    """The reference's {'model': sd} file through both packages' factories:
    the port's encoder equals torch's packed nn.LSTM / nn.GRU (the GRU's
    kept b_in, b_hn; the LSTM's folded biases) and the JAX package's, at
    1e-5 (f32)."""
    ref = _RefRNNEncoder(en_type)
    path = str(tmp_path / "text_encoder.pth")
    torch.save({"model": ref.state_dict()}, path)
    jargs, pargs = _cfg(en_type=en_type, vocab_size=VOCAB + 1,
                        text_encoder_path=path)
    jenc, jhead = jprep.prepare_text_encoder(jargs)
    penc, phead = pprep.prepare_text_encoder(pargs, CPU)
    assert jhead is None and phead is None
    caps, lens = _captions(3)
    rw, rs = ref(torch.from_numpy(caps), torch.from_numpy(lens))
    jw, js = jax.jit(jenc.module.apply)(jenc.variables, jnp.asarray(caps),
                                        jnp.asarray(lens))
    pw, ps = penc(torch.from_numpy(caps), torch.from_numpy(lens))
    close(pw, rw.numpy(), 1e-5, "words, torch")
    close(ps, rs.numpy(), 1e-5, "sentence, torch")
    close(pw, jw, 1e-5, "words, JAX")
    close(ps, js, 1e-5, "sentence, JAX")


def test_wordlevel_cfa_converter_matches_jax(tmp_path):
    """The reference's {'net': sd} WordLevelCFA_LSTM (1x1-conv projections,
    `module.`-prefixed, its dead `conv` and `bn_img` members included)
    through both packages' fusion factories, at 1e-4 (f32)."""
    g = torch.Generator().manual_seed(8)

    def rnd(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {}
    for name, c_out in (("query_proj", 128), ("key_proj", 128),
                        ("value_proj", 256)):
        sd[f"sa.{name}.weight"] = rnd(c_out, 256, 1, 1)
        sd[f"sa.{name}.bias"] = rnd(c_out)
    for ln in ("ln1", "ln2"):
        sd[f"{ln}.weight"] = 1 + rnd(256, 16, 16)
        sd[f"{ln}.bias"] = rnd(256, 16, 16)
    sd.update({"linear.weight": rnd(768, 1024), "linear.bias": rnd(768),
               "conv.weight": rnd(256, 256, 3, 3), "conv.bias": rnd(256),
               "bn_img.weight": rnd(256), "bn_img.bias": rnd(256)})
    path = str(tmp_path / "fusion.pth")
    torch.save({"net": {"module." + k: v for k, v in sd.items()}}, path)
    jargs, pargs = _cfg(fusion_type="fcfm", fusion_net_path=path)
    jnet, pnet = jprep.prepare_fusion_net(jargs), \
        pprep.prepare_fusion_net(pargs, CPU)
    assert isinstance(pnet, PM.WordLevelCFA_LSTM)
    rng = np.random.default_rng(9)
    local = rng.normal(size=(B, 14, 14, 256)).astype(np.float32)
    word = rng.normal(0, 0.2, size=(B, 256, T)).astype(np.float32)
    out_j = jax.jit(jnet.module.apply)(jnet.variables, jnp.asarray(local),
                                       jnp.asarray(word))
    out_p = pnet(torch.from_numpy(local.transpose(0, 3, 1, 2).copy()),
                 torch.from_numpy(word))
    close(out_p, out_j, 1e-4, "converted WordLevelCFA_LSTM")


def test_fusion_refusals():
    with pytest.raises(ValueError, match="GRU"):
        check_serving(PConfig().replace(en_type="GRU", fusion_type="fcfm"))
    with pytest.raises(ValueError, match="768"):
        check_stage2(PConfig().replace(en_type="LSTM", fusion_type="fcfm"))
    check_stage2(PConfig().replace(en_type="LSTM", fusion_type="fcfm",
                                   fusion_final_dim=768))
    check_stage2(PConfig().replace(en_type="GRU", fusion_type="linear"))


# -------------------------------------------------------------- trainers --

def _train_batch(seed: int = 0):
    """(JAX batch, port batch): captions with cap_len, classes with a
    shared one, backbone features (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    caps, lens = _captions(seed)
    cls = np.array([0, 3, 3, 7], np.int32)
    gl = rng.normal(size=(B, 512)).astype(np.float32)
    lc = rng.normal(size=(B, 14, 14, 256)).astype(np.float32)
    jb = dict(caps=jnp.asarray(caps), cap_len=jnp.asarray(lens),
              cls_id=jnp.asarray(cls), img_gl=jnp.asarray(gl),
              img_lc=jnp.asarray(lc))
    pb = dict(caps=torch.from_numpy(caps), cap_len=torch.from_numpy(lens),
              cls_id=torch.from_numpy(cls), img_gl=torch.from_numpy(gl),
              img_lc=torch.from_numpy(np.ascontiguousarray(
                  lc.transpose(0, 3, 1, 2))))
    return jb, pb


class _Twins:
    """A JAX trainer (its backbone stubbed: the batches carry backbone
    features) and a port trainer of the same stage holding its init."""

    def __init__(self, monkeypatch, stage: int, **kw):
        jargs, pargs = _cfg(**kw)
        monkeypatch.setattr(jprep, "prepare_backbone",
                            lambda args: jprep.Bundle(None, {}))
        monkeypatch.setattr(pprep, "prepare_backbone", lambda args, dev:
                            PM.IResNet(layers=(1, 1, 1, 1)))
        jcls, pcls = ((jstage1.Stage1Trainer, PStage1) if stage == 1
                      else (jstage2.FusionTrainer, PStage2))
        self.j = jcls(jargs)
        self.p = pcls(pargs, CPU)
        self.p.model.load_state_dict(self.sd(self.j.state.params,
                                             self.j.state.batch_stats))
        self.loss_fn = self.j.build_loss_fn()

    def sd(self, params, stats):
        return state_dict_from_jax(to_numpy(params), to_numpy(stats),
                                   module=self.p.model)

    def jax_grads(self, batch):
        """The JAX loss and gradients, jitted (the dropout mask a constant
        of the trace)."""
        (loss, (stats, metrics)), grads = jax.jit(jax.value_and_grad(
            self.loss_fn, has_aux=True))(self.j.state.params,
                                         self.j.state.batch_stats, batch, {},
                                         jax.random.PRNGKey(0))
        if "image_head" not in stats:       # stage 1: the head's alone
            stats = {"image_head": stats}
        return float(loss), stats, metrics, grads

    def check_step(self, jb, pb, feed):
        """Loss, metrics and gradients of one step, same dropout bits."""
        loss_j, stats_j, metrics_j, grads_j = self.jax_grads(jb)
        loss_p, metrics_p = self.p.compute_grads(pb, feed.port())
        np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
        assert set(metrics_p) == set(metrics_j)
        for k, v in metrics_p.items():
            np.testing.assert_allclose(float(v), float(metrics_j[k]),
                                       rtol=1e-5, err_msg=k)
        gsd = self.sd(grads_j, stats_j)
        named = dict(self.p.model.named_parameters())
        big = max(float(np.abs(gsd[n].numpy()).max()) for n in named)
        for name, prm in named.items():
            g_j = gsd[name].numpy()
            # no loss term reaches it (IMIM under linear fusion): JAX's zeros
            g_p = np.zeros_like(g_j) if prm.grad is None else prm.grad.numpy()
            err = np.abs(g_p - g_j).max()
            assert err <= 1e-4 * np.abs(g_j).max() + 1e-6 * big, (name, err)
        return grads_j, stats_j, gsd, metrics_p


LR1 = {"head": 2e-3, "encoder": 1e-3, "cls": 0.1}


def test_stage1_lstm_step_matches_jax(small_vocab, same_dropout,
                                      monkeypatch):
    """The LSTM stage-1 loss (DAMSM words only, the word mask from cap_len
    into words_loss, through the K9 wrapper with use_pallas; clip_loss;
    the identity losses), its gradients, and the parameters after the
    LSTM optimizer's step (encoder Adam (0.9, 0.5) with weight decay, head
    Adam (0.5, 0.999), cls SGD) against the JAX update: BN statistics and
    every clearly signed Adam element and the SGD group at 1e-6 (+ 1e-6
    relative, + lr times the gradient tolerance for SGD), the other Adam
    elements within 2 lr (tests/test_torch_stage1.py)."""
    tw = _Twins(monkeypatch, 1, use_pallas=True,
                lr_head=LR1["head"], init_lr_lstm=LR1["encoder"],
                weight_decay=1e-4, lambda_clip=1.0)
    assert tw.p.model.text_head is None
    assert tw.p.opt.opts["encoder"].hp["betas"] == (0.9, 0.5)
    assert tw.p.lr == LR1 == tw.j.lr
    jb, pb = _train_batch()
    same_dropout.bits = _bits(1, B * T * 300)
    old_sd = {k: v.clone() for k, v in tw.p.model.state_dict().items()}
    grads_j, stats_j, gsd, metrics = tw.check_step(jb, pb, same_dropout)
    assert metrics["damsm_loss"] == metrics["w_loss"]     # words only

    tx = joptim.make_stage1_lstm_tx(tw.j.args)
    opt_state = tx.init(tw.j.state.params)
    for group, lr in LR1.items():
        opt_state = joptim.set_lr(opt_state, group, lr)
    updates, _ = jax.jit(tx.update)(grads_j, opt_state, tw.j.state.params)
    new_sd = tw.sd(jax.jit(optax.apply_updates)(tw.j.state.params, updates),
                   stats_j)
    tw.p.opt.step()
    got = tw.p.model.state_dict()
    big = max(float(np.abs(gsd[n].numpy()).max())
              for n, _ in tw.p.model.named_parameters())
    for name, want in new_sd.items():
        w, g = want.numpy(), got[name].numpy()
        err = np.abs(g - w)
        tight = 1e-6 + 1e-6 * np.abs(w)
        group = poptim.GROUPS[name.split(".")[0]]
        if "running_" in name:
            assert (err <= tight).all(), (name, err.max())
            continue
        if group == "cls":
            gmax = np.abs(gsd[name].numpy()).max()
            assert (err <= tight + LR1[group] * (1e-4 * gmax + 1e-6 * big)
                    ).all(), (name, err.max())
            continue
        geff = gsd[name].numpy() + (
            1e-4 * old_sd[name].numpy() if group == "encoder" else 0)
        signed = np.abs(geff) > max(1e-4 * np.abs(geff).max(), 1e-6 * big)
        assert (err[signed] <= tight[signed]).all(), (name, err.max())
        assert (err[~signed] <= 2.0 * LR1[group] + 1e-6).all(), name


def test_stage1_lstm_schedule_artifacts_and_validation(small_vocab,
                                                      monkeypatch, tmp_path):
    """The LSTM schedule decays the encoder's rate with the head's; the
    text artifact is `LSTM_text_encoder_N` ({"model"}, no head) in a save
    directory without the bert_type level, and loads back; the concat
    validation runs on the headless encoder (a one-block-per-stage
    backbone)."""
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    _, pargs = _cfg(checkpoints_path=str(tmp_path), max_steps=1,
                    max_epoch=1)
    tr = PStage1(pargs, CPU)
    ds = tr.valid_dl.dataset         # 8 of its 128 synthetic pairs
    ds.imgs_pair, ds.pair_label = ds.imgs_pair[:8], ds.pair_label[:8]
    metrics = tr.validate()
    assert np.isfinite(metrics["auc"]) and tr.model.training
    tr.schedule_epoch_end(3)
    assert tr.lr == pytest.approx({"head": pargs.lr_head * 0.98,
                                   "encoder": pargs.init_lr_lstm * 0.98,
                                   "cls": 0.01})
    assert tr.opt.get_lr("encoder") == tr.lr["encoder"]
    save_dir = tr.save_dir()
    assert save_dir.endswith(os.path.join("Train", "LSTM_arcface"))
    tr.save_encoders(save_dir, 1)
    path = os.path.join(save_dir, "LSTM_text_encoder_1")
    obj = torch.load(path, weights_only=True)
    assert list(obj) == ["model"]
    enc, head = pprep.prepare_text_encoder(pargs.replace(
        text_encoder_path=path), CPU)
    assert head is None
    for k, v in tr.model.text_encoder.state_dict().items():
        assert torch.equal(enc.state_dict()[k], v), k


@pytest.mark.parametrize("fusion", ["linear", "fcfm"])
def test_stage2_lstm_step_matches_jax(fusion, small_vocab, same_dropout,
                                      monkeypatch):
    """A stage-2 step from the LSTM encoder: linear fusion of the image
    and sentence vectors, or WordLevelCFA_LSTM on the local map and the
    words (fusion_final_dim 768, its width): the focal loss and every
    gradient."""
    tw = _Twins(monkeypatch, 2, fusion_type=fusion,
                fusion_final_dim=640 if fusion == "linear" else 768,
                lr_image_train=0.01, lr_head=1e-3)
    want = PM.LinearFusion if fusion == "linear" else PM.WordLevelCFA_LSTM
    assert isinstance(tw.p.model.fusion_net, want)
    jb, pb = _train_batch(1)
    same_dropout.bits = _bits(2, B * T * 300)
    tw.check_step(jb, pb, same_dropout)


# --------------------------------------------------------------- serving --

@functools.lru_cache(maxsize=None)
def _serving_base():
    """JAX (modules, variables) and bridged port modules of the backbone
    (one block per stage), the image head and the LSTM encoder, made once
    (the tests only read them); each init jitted, one compile a module."""
    z, key = jnp.zeros, jax.random.PRNGKey
    mods = [JM.IResNet(layers=(1, 1, 1, 1), dtype=jnp.float32),
            JM.ImageHeading(feat_dim=256, dtype=jnp.float32),
            JM.RNNEncoder(vocab_size=VOCAB + 1, nhidden=256)]
    jv = [randomize_stats(jax.jit(mods[0].init)(key(0), z((1, 112, 112, 3))),
                          0),
          randomize_stats(jax.jit(mods[1].init)(key(1), z((1, 512)),
                                                z((1, 14, 14, 256))), 1),
          jax.jit(mods[2].init)(key(2), z((1, T), jnp.int32),
                                jnp.ones((1,), jnp.int32))]
    ports = [PM.IResNet(layers=(1, 1, 1, 1)), PM.ImageHeading(feat_dim=256),
             PM.RNNEncoder(VOCAB + 1, nhidden=256)]
    return mods, jv, [bridge(p, v) for p, v in zip(ports, jv)]


@functools.lru_cache(maxsize=None)
def _serving_twins(fusion: str):
    """`_serving_base` and the fusion net of `fusion` (None for concat):
    JAX (modules, variables) and the bridged port modules."""
    z, key = jnp.zeros, jax.random.PRNGKey
    mods, jv, ports = (list(x) for x in _serving_base())
    if fusion == "linear":
        mods.append(JM.LinearFusion(fusion_final_dim=640))
        jv.append(jax.jit(mods[3].init)(key(3), z((1, 256)), z((1, 256))))
        ports.append(bridge(PM.LinearFusion(512, 640), jv[3]))
    elif fusion == "fcfm":
        mods.append(JM.WordLevelCFA_LSTM(channel_dim=256))
        jv.append(jax.jit(mods[3].init)(key(3), z((1, 14, 14, 256)),
                                        z((1, 256, T))))
        ports.append(bridge(PM.WordLevelCFA_LSTM(256), jv[3]))
    else:
        mods.append(None)
        jv.append({})
        ports.append(None)
    return mods, jv, ports


@pytest.mark.parametrize("fusion", ["concat", "linear", "fcfm"])
def test_lstm_fused_embed_and_pair_scores_match_jax(fusion, small_vocab):
    """One pair batch of the synthetic LSTM test split: each side's fused
    embedding at 1e-4 and the pair scores at 1e-5 (f32)."""
    _, pargs = _cfg(fusion_type=fusion)
    dl, _ = pprep.prepare_dataloader(pargs, "test")
    b = next(iter(dl))
    (bb, ih, te, fu), jv, (p_bb, p_ih, p_te, p_fu) = _serving_twins(fusion)
    jcommon = (bb, ih, te, None, fu, "LSTM", "arcface", fusion, jv[0], jv[1],
               jv[2]["params"], {}, jv[3])
    # JAX's pair score is the cosine of its two sides' embeddings
    # (jev._pair_scores); one compiled embedding serves both sides
    j_e1, j_e2 = (jev._embed_batch(*jcommon, b[f"img{i}"], b[f"cap{i}"],
                                   b[f"cap_len{i}"]) for i in (1, 2))
    j_scores = jev.cosine_pairs(j_e1, j_e2)
    p_e1 = pev.embed_batch(pargs, p_bb, p_ih, p_fu, p_te, None, b["img1"],
                           b["cap1"], b["cap_len1"])
    p_scores = pev.pair_scores(pargs, p_bb, p_ih, p_fu, p_te, None,
                               b["img1"], b["img2"], b["cap1"], b["cap2"],
                               b["cap_len1"], b["cap_len2"])
    assert p_e1.shape == (B, {"concat": 512, "linear": 640,
                              "fcfm": 768}[fusion])
    close(p_e1, j_e1, 1e-4, "fused embeddings")
    close(p_scores, j_scores, 1e-5, "pair scores")


@pytest.mark.parametrize("table", [False, True])
def test_lstm_run_test_matches_jax(table, small_vocab, tmp_path):
    """run_test on 8 pairs of the synthetic LSTM test split, linear
    fusion, pair mode and table mode: the same labels, the scores at 1e-5,
    the same metrics."""
    jargs, pargs = _cfg(fusion_type="linear", eval_table_mode=table,
                        is_roc=True)
    jargs = jargs.replace(roc_file=str(tmp_path / "jax"))
    pargs = pargs.replace(roc_file=str(tmp_path / "port"))
    mods, jv, (p_bb, p_ih, p_te, p_fu) = _serving_twins("linear")
    jdl, jd = jprep.prepare_dataloader(jargs, "test")
    pdl, pd = pprep.prepare_dataloader(pargs, "test")
    for ds in (jd, pd):
        ds.imgs_pair, ds.pair_label = ds.imgs_pair[:8], ds.pair_label[:8]
    bb, ih, te, fu = (jprep.Bundle(m, v) for m, v in zip(mods, jv))
    j_metrics = jev.run_test(jargs, jdl, bb, ih, fu, te, None)
    p_metrics = pev.run_test(pargs, pdl, p_bb, p_ih, p_fu, p_te, None)
    scores = {}
    for side in ("jax", "port"):
        with open(tmp_path / f"{side}.npy", "rb") as f:
            scores[side] = (np.load(f), np.load(f))
    np.testing.assert_array_equal(scores["port"][0], scores["jax"][0])
    close(scores["port"][1], scores["jax"][1], 1e-5, "pair scores")
    assert p_metrics == pytest.approx(j_metrics, abs=1e-9)


# ------------------------------------------------------------------ CLIs --

def test_lstm_clis_on_the_cpu(small_vocab, monkeypatch, tmp_path):
    """cli/train_encoders_lstm.py (an LSTM and a GRU), then
    cli/fusion_lstm.py from the LSTM's artifacts (linear, two epochs,
    saved at the second), then cli/test.py and cli/extract_embeddings.py
    on cfg/fusion_lstm.yml with its artifacts, all --cpu --synthetic (a
    one-block-per-stage backbone)."""
    from text_guided_face_recognition_tpu_torch.cli import (
        extract_embeddings, fusion_lstm, test, train_encoders_lstm)
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.chdir(tmp_path)
    common = ["--cpu", "--synthetic", "--batch_size", str(B),
              "--compute_dtype", "float32"]
    for en_type in RNNS:
        cfg = write_cfg(tmp_path, "train_lstm.yml", en_type=en_type,
                        lstm_words_num=T)
        tr = train_encoders_lstm.main(["--cfg", cfg] + common + [
            "--max_steps", "2", "--max_epoch", "1",
            "--checkpoints_path", str(tmp_path / "s1")])
        assert tr.steps == 2 and tr.args.vocab_size == VOCAB + 1
        assert tr.model.text_encoder.en_type == en_type
    s1 = tmp_path / "s1" / "face2text" / "Train" / "LSTM_arcface"
    assert sorted(os.listdir(s1)) == ["LSTM_text_encoder_1",
                                      "arcface_image_encoder_1",
                                      "train_state_1"]
    fu = fusion_lstm.main(common + [
        "--max_steps", "2", "--max_epoch", "2",
        "--checkpoints_path", str(tmp_path / "s2"),
        "--text_encoder_path", str(s1 / "LSTM_text_encoder_1"),
        "--image_encoder_path", str(s1 / "arcface_image_encoder_1")])
    assert fu.steps == 4
    s2 = tmp_path / "s2" / "face2text" / "Fusion" / "LSTM_arcface" / "linear"
    pairs = tmp_path / "pairs.txt"      # 8 pairs of the synthetic split
    pairs.write_text("".join(f"s{i}_0.jpg s{(i + i % 2) % 32}_0.jpg "
                             f"{1 - i % 2}\n" for i in range(8)))
    cfg = write_cfg(tmp_path, "fusion_lstm.yml", test_pair_list=str(pairs),
                    text_encoder_path=str(s2 / "encoder_LSTM_linear_2"),
                    image_encoder_path=str(s2 / "fusion_linear_arcface_2"),
                    fusion_net_path=str(s2 / "fusion_linear_arcface_2"),
                    lstm_words_num=T)
    metrics = test.main(["--cfg", cfg] + common)
    assert np.isfinite(metrics["auc"])
    out = str(tmp_path / "emb.npz")
    res = extract_embeddings.main(["--cfg", cfg, "--out", out] + common)
    assert res["embeddings"].shape == (32, 640)
    assert np.isfinite(res["embeddings"]).all() and os.path.isfile(out)
