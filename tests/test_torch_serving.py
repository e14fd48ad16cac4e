"""The serving slice as a whole: the port's data, fused embeddings, pair
scores and run_test against the JAX package on bridged weights, and the two
port CLIs on the CPU.

Small sizes: the tiny post-LN BERT of _torch_port.py, iResNet with one
block per stage at 112x112, the full ImageHeading and FCFM. f32 throughout.
Tolerances (rtol = atol): embeddings 1e-4, as tests/test_torch_models.py
(summation order, A-S erf against erf); pair scores 1e-5 -- a cosine of two
640-d vectors whose entries agree to ~1e-6 moves far less than its inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import evaluate as jev
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig)
from text_guided_face_recognition_tpu_torch.engine import evaluate as pev
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep

from _torch_port import TINY, bridge, close, randomize_stats
from _torch_port import tiny_arch  # noqa: F401  (fixture)

CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=8, num_workers=2,
                compute_dtype="float32", bert_type="tiny", fusion_type="fcfm",
                fusion_final_dim=640, captions_per_image=2, manual_seed=0,
                is_ident=False, is_roc=False, checkpoints_path="",
                num_classes=16)
    base.update(kw)
    extra_j = {"num_devices": 1}
    return (JConfig().replace(**base, **extra_j), PConfig().replace(**base))


def _twins(fused_block="none", fused_ln=False):
    """JAX (module, variables) pairs and bridged port modules, in the order
    backbone, image head, text encoder, text head, fusion net."""
    z = jnp.zeros
    key = jax.random.PRNGKey
    bb = JM.IResNet(layers=(1, 1, 1, 1), dtype=jnp.float32)
    ih = JM.ImageHeading(feat_dim=256, dtype=jnp.float32)
    te = JM.TextEncoder(bert_type="tiny", dtype=jnp.float32,
                        fused_ln=fused_ln, fused_block=fused_block)
    th = JM.TextHeading(feat_dim=256, dtype=jnp.float32)
    fu = JM.FCFM(channel_dim=36, dtype=jnp.float32)
    jv = [randomize_stats(bb.init(key(0), z((1, 112, 112, 3))), 0),
          randomize_stats(ih.init(key(1), z((1, 512)), z((1, 14, 14, 256))),
                          1),
          te.init(key(2), z((1, 24), jnp.int32), jnp.ones((1, 24), jnp.int32)),
          th.init(key(3), z((1, 23, 128))),
          randomize_stats(fu.init(key(4), z((1, 14, 14, 256)),
                                  z((1, 256, 22)), z((1, 256)), z((1, 256))),
                          2)]
    ports = [PM.IResNet(layers=(1, 1, 1, 1)), PM.ImageHeading(feat_dim=256),
             PM.TextEncoder(bert_type="tiny", fused_ln=fused_ln,
                            fused_block=fused_block),
             PM.TextHeading(hidden=TINY["hidden"], feat_dim=256),
             PM.FCFM(channel_dim=36)]
    ports = [bridge(p, v) for p, v in zip(ports, jv)]
    return [bb, ih, te, th, fu], jv, ports


def _first_batch(pargs):
    dl, _ = pprep.prepare_dataloader(pargs, "test")
    return next(iter(dl))


def test_synthetic_batches_match_jax(tiny_arch):
    jargs, pargs = _cfg()
    for split in ("test", "train"):
        jdl, _ = jprep.prepare_dataloader(jargs, split)
        pdl, _ = pprep.prepare_dataloader(pargs, split)
        jb, pb = next(iter(jdl)), next(iter(pdl))
        assert sorted(jb) == sorted(pb)
        for k in pb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


def test_fused_embed_and_pair_scores_match_jax(tiny_arch):
    _, pargs = _cfg()
    jmods, jv, ports = _twins("both", True)
    b = _first_batch(pargs)
    bb, ih, te, th, fu = jmods
    jcommon = (bb, ih, te, th, fu, "BERT", "arcface", "fcfm", jv[0], jv[1],
               jv[2]["params"], jv[3]["params"], jv[4])
    j_e1 = jev._embed_batch(*jcommon, b["img1"], b["cap1"], b["mask1"])
    j_scores = jev._pair_scores(*jcommon, b["img1"], b["img2"], b["cap1"],
                                b["cap2"], b["mask1"], b["mask2"])
    p_bb, p_ih, p_te, p_th, p_fu = ports
    p_e1 = pev.embed_batch(pargs, p_bb, p_ih, p_fu, p_te, p_th, b["img1"],
                           b["cap1"], b["mask1"])
    p_scores = pev.pair_scores(pargs, p_bb, p_ih, p_fu, p_te, p_th,
                               b["img1"], b["img2"], b["cap1"], b["cap2"],
                               b["mask1"], b["mask2"])
    assert p_e1.shape == (8, 640)
    close(p_e1, j_e1, 1e-4, "fused embeddings")
    close(p_scores, j_scores, 1e-5, "pair scores")


@pytest.mark.parametrize("table", [False, True])
def test_run_test_matches_jax(tiny_arch, tmp_path, table):
    jargs, pargs = _cfg(eval_table_mode=table, is_roc=True, is_ident=True,
                        test_sub=4)
    jargs = jargs.replace(roc_file=str(tmp_path / "jax"))
    pargs = pargs.replace(roc_file=str(tmp_path / "port"))
    jmods, jv, ports = _twins()
    jdl, jds = jprep.prepare_dataloader(jargs, "test")
    pdl, pds = pprep.prepare_dataloader(pargs, "test")
    for ds in (jds, pds):  # 16 pairs keep the JAX side quick
        ds.imgs_pair, ds.pair_label = ds.imgs_pair[:16], ds.pair_label[:16]
    jargs.test_sub = pargs.test_sub = 4
    bundles = [jprep.Bundle(m, v) for m, v in zip(jmods, jv)]
    j_metrics = jev.run_test(jargs, jdl, bundles[0], bundles[1], bundles[4],
                             bundles[2], bundles[3])
    p_bb, p_ih, p_te, p_th, p_fu = ports
    p_metrics = pev.run_test(pargs, pdl, p_bb, p_ih, p_fu, p_te, p_th)
    scores = {}
    for side in ("jax", "port"):
        with open(tmp_path / f"{side}.npy", "rb") as f:
            scores[side] = (np.load(f), np.load(f))
    np.testing.assert_array_equal(scores["port"][0], scores["jax"][0])
    assert scores["port"][1].shape == (16,)
    close(scores["port"][1], scores["jax"][1], 1e-5, "pair scores")
    assert p_metrics == pytest.approx(j_metrics, abs=1e-9)


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLIs at a small size: the tiny arch under the name "bert", a
    one-block-per-stage backbone, run from a scratch directory (the test
    config dumps ROC and identification files into the working dir)."""
    from text_guided_face_recognition_tpu_torch.models import text_bert
    monkeypatch.setitem(text_bert.TEXT_ARCHS, "bert",
                        text_bert.TextArch(**TINY))
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.chdir(tmp_path)
    return ["--cpu", "--synthetic", "--batch_size", "8", "--fused_block",
            "both", "--fused_ln"]


def test_cli_test_runs_on_cpu(small_cli):
    from text_guided_face_recognition_tpu_torch.cli import test as cli
    metrics = cli.main(small_cli + ["--eval_table_mode"])
    assert set(metrics) >= {"auc", "eer", "score"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_cli_extract_runs_on_cpu(small_cli, tmp_path):
    from text_guided_face_recognition_tpu_torch.cli import (
        extract_embeddings as cli)
    out = tmp_path / "emb.npz"
    cli.main(small_cli + ["--out", str(out), "--compute_dtype", "float32"])
    saved = np.load(out)
    assert saved["embeddings"].shape == (32, 640)
    assert np.isfinite(saved["embeddings"]).all()
    assert len(saved["keys"]) == len(saved["class_ids"]) == 32


def test_cli_without_cpu_needs_cuda(small_cli, monkeypatch):
    from text_guided_face_recognition_tpu_torch.cli import test as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(small_cli[1:])


def test_caption_cache_round_trip(tmp_path):
    """On-disk captions: the first load tokenises with the tokenizer that
    get_bert_tokenizer resolves (here, with no HF cache, the WordPiece
    vocabulary trained on these captions, or the HashTokenizer where the
    `tokenizers` package is missing) and writes
    captions_bert<cache tag>.pickle; the second reads it back unchanged."""
    import pickle

    from text_guided_face_recognition_tpu_torch.data.datasets import (
        load_text_data_bert)
    from text_guided_face_recognition_tpu_torch.data.tokenizers import (
        get_bert_tokenizer)
    names = ["1_0", "2_0"]
    for split in ("train", "test"):
        (tmp_path / split).mkdir()
        with open(tmp_path / split / "filenames.pickle", "wb") as f:
            pickle.dump(names, f)
    (tmp_path / "text").mkdir()
    for n in names:
        (tmp_path / "text" / f"{n}.txt").write_text(
            "a smiling man with glasses\nshort dark hair\nthird\n")
    _, pargs = _cfg(data_dir=str(tmp_path), bert_type="bert")
    first = load_text_data_bert(str(tmp_path), pargs)
    encode = get_bert_tokenizer(pargs)
    assert encode.cache_tag in ("-wordpiece", "-hash")
    assert (tmp_path / f"captions_bert{encode.cache_tag}.pickle").is_file()
    second = load_text_data_bert(str(tmp_path), pargs)
    tr_names, tr_caps, tr_masks = first[:3]
    assert tr_names == names and len(tr_caps) == 2 * 2   # 2 captions each
    ids, mask = encode("a smiling man with glasses", pargs.bert_words_num)
    np.testing.assert_array_equal(tr_caps[0], ids)
    np.testing.assert_array_equal(tr_masks[0], mask)
    assert tr_masks[0].sum() >= 2 + 5                    # [CLS] 5 words [SEP]
    for a, b in zip(first[1] + first[7], second[1] + second[7]):
        np.testing.assert_array_equal(a, b)