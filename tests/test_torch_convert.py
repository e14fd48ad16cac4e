"""The reference's weight files in the port (engine/convert.py,
engine/prepare.py): every layout the reference ships or its trainers
write, made from seeded tensors under the reference's key names and
written with torch.save into tmp_path; the same file goes through the JAX
package's factory and the port's, and the loaded modules are held against
each other and against the torch oracles that the JAX package's own tests
hold its converters to (tests/test_convert.py, test_imim_parity.py,
test_fcfm_parity.py). Then the COTS baseline (org_face_test) and run_test
on those files for each backbone, the refusals, and the port's own
artifacts loading as before.

Small sizes: the tiny post-LN BERT of _torch_port.py, the full iresnet18
and ir_18 backbones at 112 x 112 (the oracles' size), batch 2-8, f32.
Tolerances (rtol = atol unless stated): port against JAX 1e-4 for modules
and 1e-5 for pair scores, the port's serving tolerances
(tests/test_torch_serving.py); against the oracles the JAX tests' own:
backbones rtol 1e-3 atol 2e-3, HF BERT atol 2e-4 at unmasked positions,
ImageHeading rtol 1e-4 atol 1e-5 (global) and rtol 1e-3 atol 1e-4 (local),
FCFM rtol 1e-3 atol 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import evaluate as jev
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.models import irnet as jirnet
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig, check_serving, check_stage1)
from text_guided_face_recognition_tpu_torch.engine import evaluate as pev
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    save_checkpoint)
from text_guided_face_recognition_tpu_torch.models import irnet as pirnet

from _torch_port import (TINY, bridge, close, randomize_stats, t,
                         write_reference_backbone)
from test_convert import _randomize_bn_stats
from test_fcfm_parity import TorchWorking
from test_imim_parity import TorchImageHeading

CPU = torch.device("cpu")
ORACLE = dict(rtol=1e-3, atol=2e-3)        # tests/test_convert.py


@pytest.fixture
def tiny_bert(monkeypatch):
    """The small arch under the name "bert" on both sides: the converters
    dispatch on bert_type."""
    from text_guided_face_recognition_tpu.models import text_bert as jtb
    from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
    monkeypatch.setitem(jtb.TEXT_ARCHS, "bert", jtb.TextArch(**TINY))
    monkeypatch.setitem(ptb.TEXT_ARCHS, "bert", ptb.TextArch(**TINY))
    return "bert"


def _cfg(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=8, num_workers=2,
                compute_dtype="float32", bert_type="bert", fusion_type="fcfm",
                fusion_final_dim=640, captions_per_image=2, manual_seed=0,
                is_ident=False, is_roc=False, checkpoints_path="",
                num_classes=16, text_encoder_path="", image_encoder_path="",
                fusion_net_path="")
    base.update(kw)
    return JConfig().replace(**base, num_devices=1), PConfig().replace(**base)


def _images(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 112, 112, 3)) * 0.5).astype(np.float32)


def _nchw(x):
    return t(x.transpose(0, 3, 1, 2))


def _save(tmp_path, name, obj):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


# ------------------------------------------------------ reference files --

_NAMES = {"arcface": "arcface_ir18.pth", "adaface": "adaface_ir18.ckpt",
          "magface": "magface_ir18.pth"}


def _backbone_file(tmp_path, model_type, seed=0, prefix=""):
    """(path, oracle) of a backbone file in the reference's layout."""
    path = str(tmp_path / _NAMES[model_type])
    return path, write_reference_backbone(path, model_type, seed, prefix)


def _hf_bert(seed):
    from transformers import BertConfig, BertModel
    torch.manual_seed(seed)
    cfg = BertConfig(vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden"],
                     num_hidden_layers=TINY["layers"],
                     num_attention_heads=TINY["heads"],
                     intermediate_size=TINY["intermediate"],
                     max_position_embeddings=TINY["max_positions"],
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = BertModel(cfg).eval()
    with torch.no_grad():     # LayerNorm affines off their init
        for name, p in model.named_parameters():
            if "LayerNorm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


def _text_bundle(seed):
    """The reference's stage-1 text artifact: {'model': TextEncoder
    state_dict (the HF model under 'model.'), 'head': TextHeading
    state_dict (Bert_Word_Mapping's Conv2d(1, 256, (K, E)) kernels)}."""
    model = _hf_bert(seed).state_dict()
    gen = torch.Generator().manual_seed(seed)
    head = {}
    for i, k in enumerate((2, 3, 4)):
        head[f"bwm.convs1.{i}.weight"] = 0.05 * torch.randn(
            256, 1, k, TINY["hidden"], generator=gen)
        head[f"bwm.convs1.{i}.bias"] = 0.1 * torch.randn(256, generator=gen)
    return {"model": {"model." + k: v for k, v in model.items()},
            "head": head}


def _randomize_affines(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.weight.shape).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    rng.normal(0, 0.2, m.bias.shape).astype(np.float32)))


_IMAGE_HEAD_KEYS = {
    "imim.q.": "imim.sa.query_proj.", "imim.k.": "imim.sa.key_proj.",
    "imim.v.": "imim.sa.value_proj.", "imim.c1.": "imim.conv1x1_1.",
    "imim.c2.": "imim.conv1x1_2.",
    "imim.proj.": "imim.project_local.projection.",
    "project_global.": "project_global.projection."}
_FCFM_KEYS = {"q.": "sa.query_proj.", "k.": "sa.key_proj.",
              "v.": "sa.value_proj.", "ln_gl.": "ln_gl_image."}


def _renamed(sd, table):
    """The oracle's state_dict under the reference's key names."""
    out = {}
    for k, v in sd.items():
        for old, new in table.items():
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def _image_head_oracle(seed):
    torch.manual_seed(seed)
    model = TorchImageHeading().eval()
    rng = np.random.default_rng(seed)
    _randomize_bn_stats(model, rng)
    _randomize_affines(model, rng)
    return model


def _fcfm_oracle(seed):
    torch.manual_seed(seed)
    model = TorchWorking(36).eval()
    rng = np.random.default_rng(seed)
    _randomize_bn_stats(model, rng)
    _randomize_affines(model, rng)
    return model


def _linear_fusion_sd(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"fc1.weight": 0.05 * torch.randn(640, 512, generator=gen),
            "fc1.bias": 0.1 * torch.randn(640, generator=gen),
            "ln.weight": torch.ones(512), "ln.bias": torch.zeros(512)}


# -------------------------------------------------------------- backbones --

def _backbone_twins(model_type, path):
    key = f"weights_{model_type}"
    jargs, pargs = _cfg(model_type=model_type, **{key: path})
    return jprep.prepare_backbone(jargs), pprep.prepare_backbone(pargs, CPU)


def _run_backbones(jb, pb, x):
    j_out = [np.asarray(o) for o in jb.module.apply(jb.variables,
                                                    jnp.asarray(x),
                                                    train=False)]
    with torch.no_grad():
        p_out = pb(_nchw(x))
    return j_out, p_out


@pytest.mark.parametrize("prefix", ["", "module."])
def test_arcface_pth_loads_like_jax(tmp_path, prefix):
    path, oracle = _backbone_file(tmp_path, "arcface", 0, prefix)
    assert not np.allclose(oracle.features.weight.detach().numpy(), 1.0)
    jb, pb = _backbone_twins("arcface", path)
    x = _images(2, 1)
    (j_g, j_l), (p_g, p_l) = _run_backbones(jb, pb, x)
    close(p_g, j_g, 1e-4, "global")
    close(p_l.permute(0, 2, 3, 1), j_l, 1e-4, "local")
    with torch.no_grad():
        o_g, o_l = oracle(_nchw(x))
    np.testing.assert_allclose(p_g.numpy(), o_g.numpy(), **ORACLE)
    np.testing.assert_allclose(p_l.numpy(), o_l.numpy(), **ORACLE)
    # the scale-free `features` BN took the torch weight into its variance
    f = oracle.features
    want = ((f.running_var + 1e-5) / f.weight.detach() ** 2 - 1e-5).numpy()
    np.testing.assert_allclose(pb.features.running_var.numpy(), want,
                               rtol=1e-6)
    assert pb.features.weight is None


def test_magface_pth_drops_the_margin_head(tmp_path):
    path, oracle = _backbone_file(tmp_path, "magface", 1)
    assert "module.fc.weight" in torch.load(path)["state_dict"]
    jb, pb = _backbone_twins("magface", path)
    x = _images(2, 2)
    (j_g, j_l), (p_g, p_l) = _run_backbones(jb, pb, x)
    close(p_g, j_g, 1e-4, "global")
    close(p_l.permute(0, 2, 3, 1), j_l, 1e-4, "local")
    with torch.no_grad():
        o_g, _ = oracle(_nchw(x))
    np.testing.assert_allclose(p_g.numpy(), o_g.numpy(), **ORACLE)


def test_adaface_lightning_ckpt_loads_like_jax(tmp_path):
    import pickle
    path, oracle = _backbone_file(tmp_path, "adaface", 2)
    with pytest.raises(pickle.UnpicklingError):   # hyper_parameters
        torch.load(path, weights_only=True)
    jb, pb = _backbone_twins("adaface", path)
    assert isinstance(pb, pirnet.IRBackbone)
    assert pb.output_features.weight is None
    assert pb.output_features.bias is None
    x = _images(2, 3)
    (j_g, j_l, j_n), (p_g, p_l, p_n) = _run_backbones(jb, pb, x)
    assert p_l.shape == (2, 256, 14, 14)
    close(p_g, j_g, 1e-4, "global")
    close(p_l.permute(0, 2, 3, 1), j_l, 1e-4, "local")
    close(p_n.numpy() / j_n.max(), j_n / j_n.max(), 1e-4, "norm")
    with torch.no_grad():
        o_g, o_l, _ = oracle(_nchw(x))
    np.testing.assert_allclose(p_g.numpy(), o_g.numpy(), **ORACLE)
    np.testing.assert_allclose(p_l.numpy(), o_l.numpy(), **ORACLE)


@pytest.mark.parametrize("block", ["basic_se", "bottleneck", "bottleneck_se"])
def test_ir_blocks_match_jax(block):
    """The other blocks of build_model's table, bridged from the JAX init:
    the SE module and the bottleneck, with and without a width change."""
    use_se = block.endswith("se")
    rng = np.random.default_rng(0)
    for cin, depth, stride in ((64, 64, 1), (64, 128, 2)):
        if block.startswith("basic"):
            jb = jirnet.BasicBlockIR(cin, depth, stride, use_se)
            pb = pirnet.BasicBlockIR(cin, depth, stride, use_se)
        else:
            jb = jirnet.BottleneckIR(cin, depth, stride, use_se)
            pb = pirnet.BottleneckIR(cin, depth, stride, use_se)
        x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
        variables = randomize_stats(jb.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8, 8, cin))))
        bridge(pb, variables)
        want = jb.apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = pb(_nchw(x))
        close(got.permute(0, 2, 3, 1), want, 1e-4, f"{block} {cin}->{depth}")


def test_build_model_table():
    assert set(pirnet._MODELS) == {
        "ir_18", "ir_34", "ir_50", "ir_101", "ir_152", "ir_200", "ir_se_50",
        "ir_se_101", "ir_se_152", "ir_se_200"}
    assert pirnet.build_model("ir_18").n_body == 8
    with pytest.raises(ValueError, match="not a correct model name"):
        pirnet.build_model("ir_19")


# ------------------------------------------------------------ text tower --

def test_raw_hf_bert_loads_like_jax(tiny_bert, tmp_path):
    hf = _hf_bert(3)
    path = _save(tmp_path, "bert.pth", hf.state_dict())
    jargs, pargs = _cfg(text_encoder_path=path)
    jte, _ = jprep.prepare_text_encoder(jargs)
    with pytest.warns(UserWarning, match="raw HF text model"):
        pte, _ = pprep.prepare_text_encoder(pargs, CPU)
    rng = np.random.default_rng(3)
    ids = rng.integers(1000, 30000, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    j_w, j_s = jte.module.apply(jte.variables, jnp.asarray(ids),
                                jnp.asarray(mask))
    with torch.no_grad():
        p_w, p_s = pte(t(ids), t(mask))
        ref = hf(t(ids).long(), attention_mask=t(mask).long()
                 ).last_hidden_state.numpy()
    close(p_w, j_w, 1e-4, "words")
    close(p_s, j_s, 1e-4, "sent")
    hidden = torch.cat([p_s[:, None], p_w], dim=1).numpy()
    np.testing.assert_allclose(hidden[0], ref[0], atol=2e-4)
    np.testing.assert_allclose(hidden[1, :8], ref[1, :8], atol=2e-4)


def test_text_bundle_loads_like_jax(tiny_bert, tmp_path):
    bundle = _text_bundle(4)
    path = _save(tmp_path, "bert_text_encoder_1", bundle)
    jargs, pargs = _cfg(text_encoder_path=path)
    jte, jth = jprep.prepare_text_encoder(jargs)
    pte, pth = pprep.prepare_text_encoder(pargs, CPU)
    # layer 1's fused qkv: [q | k | v] on the output axis
    m = bundle["model"]
    qkv = torch.cat([m[f"model.encoder.layer.1.attention.self.{n}.weight"]
                     for n in ("query", "key", "value")])
    torch.testing.assert_close(pte.model.layer_1.attn.qkv.weight, qkv,
                               rtol=0, atol=0)
    rng = np.random.default_rng(4)
    ids = rng.integers(1000, 30000, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[2, 7:] = 0
    j_w, j_s = jte.module.apply(jte.variables, jnp.asarray(ids),
                                jnp.asarray(mask))
    jw2, js2 = jth.module.apply(jth.variables, j_w)
    with torch.no_grad():
        p_w, p_s = pte(t(ids), t(mask))
        pw2, ps2 = pth(p_w)
    close(p_w, j_w, 1e-4, "words")
    close(p_s, j_s, 1e-4, "sent")
    close(pw2, jw2, 1e-4, "head words")
    close(ps2, js2, 1e-4, "head sent")


# ------------------------------------------------------ image head, fusion --

def test_image_head_file_loads_like_jax(tmp_path):
    oracle = _image_head_oracle(5)
    sd = _renamed(oracle.state_dict(), _IMAGE_HEAD_KEYS)
    assert sd["imim.sa.query_proj.weight"].ndim == 4
    path = _save(tmp_path, "arcface_image_encoder_1", {"image_head": sd})
    jargs, pargs = _cfg(image_encoder_path=path)
    jih = jprep.prepare_image_head(jargs)
    pih = pprep.prepare_image_head(pargs, CPU)
    rng = np.random.default_rng(5)
    gl = rng.normal(size=(2, 512)).astype(np.float32)
    lc = rng.normal(size=(2, 14, 14, 256)).astype(np.float32)
    j_g, j_l = jih.module.apply(jih.variables, jnp.asarray(gl),
                                jnp.asarray(lc), train=False)
    with torch.no_grad():
        p_g, p_l = pih(t(gl), _nchw(lc))
        o_g, o_l = oracle(t(gl), _nchw(lc))
    close(p_g, j_g, 1e-4, "global")
    close(p_l.permute(0, 2, 3, 1), j_l, 1e-4, "local")
    np.testing.assert_allclose(p_g.numpy(), o_g.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(p_l.numpy(), o_l.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("fusion_type", ["fcfm", "linear"])
def test_fusion_net_file_loads_like_jax(tmp_path, fusion_type):
    rng = np.random.default_rng(6)
    if fusion_type == "fcfm":
        oracle = _fcfm_oracle(6)
        sd = _renamed(oracle.state_dict(), _FCFM_KEYS)
    else:
        sd = _linear_fusion_sd(6)
    path = _save(tmp_path, f"fusion_{fusion_type}_arcface_1",
                 {"net": {"module." + k: v for k, v in sd.items()},
                  "image_head": {}})
    jargs, pargs = _cfg(fusion_type=fusion_type, fusion_net_path=path)
    jnet = jprep.prepare_fusion_net(jargs)
    pnet = pprep.prepare_fusion_net(pargs, CPU)
    gl = rng.normal(size=(3, 256)).astype(np.float32)
    sent = rng.normal(size=(3, 256)).astype(np.float32)
    if fusion_type == "linear":
        want = jnet.module.apply(jnet.variables, jnp.asarray(gl),
                                 jnp.asarray(sent))
        with torch.no_grad():
            got = pnet(t(gl), t(sent))
        torch.testing.assert_close(pnet.fc1.weight, sd["fc1.weight"],
                                   rtol=0, atol=0)
        close(got, want, 1e-4, "linear fusion")
        return
    img = rng.normal(size=(3, 14, 14, 256)).astype(np.float32)
    word = rng.normal(size=(3, 256, 22)).astype(np.float32)
    want = jnet.module.apply(jnet.variables, jnp.asarray(img),
                             jnp.asarray(word), jnp.asarray(gl),
                             jnp.asarray(sent), train=False)
    with torch.no_grad():
        got = pnet(_nchw(img), t(word), t(gl), t(sent))
        ref = oracle(_nchw(img), t(word), t(gl), t(sent))
    close(got, want, 1e-4, "fcfm")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3,
                               atol=1e-4)


# --------------------------------------------------------------- refusals --

_PATH_KEYS = {"backbone": "weights_arcface", "text": "text_encoder_path",
              "image": "image_encoder_path", "fusion": "fusion_net_path"}


def _factory(what, pargs):
    return {"backbone": lambda: pprep.prepare_backbone(pargs, CPU),
            "text": lambda: pprep.prepare_text_encoder(pargs, CPU),
            "image": lambda: pprep.prepare_image_head(pargs, CPU),
            "fusion": lambda: pprep.prepare_fusion_net(pargs, CPU)}[what]


@pytest.mark.parametrize("what", ["backbone", "text", "image", "fusion"])
def test_orbax_directory_and_unknown_files_raise(tiny_bert, tmp_path, what):
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    _, pargs = _cfg(**{_PATH_KEYS[what]: str(orbax)})
    with pytest.raises(NotImplementedError,
                       match="convert_weights.py" if what == "backbone"
                       else "tools/export_jax_checkpoint.py"):
        _factory(what, pargs)()

    other = _save(tmp_path, "other.pth", {"model": {"w": torch.zeros(2)},
                                          "head": {"w": torch.zeros(2)},
                                          "image_head": {}, "net": {},
                                          "state_dict": {}})
    _, pargs = _cfg(**{_PATH_KEYS[what]: other})
    if what == "backbone":
        with pytest.raises(ValueError, match="not the reference's"):
            _factory(what, pargs)()
    else:
        with pytest.raises(ValueError, match="neither layout") as e:
            _factory(what, pargs)()
        assert "port's artifact" in str(e.value)
        assert "the reference's" in str(e.value)

    garbage = tmp_path / "garbage"
    garbage.write_bytes(b"reference weights")
    _, pargs = _cfg(**{_PATH_KEYS[what]: str(garbage)})
    with pytest.raises(ValueError, match="not a torch file"):
        _factory(what, pargs)()


def test_port_artifacts_still_load(tiny_bert, tmp_path):
    """The trainers' own artifacts (engine/checkpoint.py) load back, key
    for key, beside the reference's layouts."""
    _, pargs = _cfg()
    enc, head = pprep.prepare_text_encoder(pargs.replace(manual_seed=7), CPU)
    ih = pprep.prepare_image_head(pargs.replace(manual_seed=8), CPU)
    net = pprep.prepare_fusion_net(pargs.replace(manual_seed=9), CPU)
    save_checkpoint(str(tmp_path / "text"), {"model": enc.state_dict(),
                                             "head": head.state_dict()})
    save_checkpoint(str(tmp_path / "fusion"), {"net": net.state_dict(),
                                               "image_head": ih.state_dict()})
    back = pargs.replace(text_encoder_path=str(tmp_path / "text"),
                         image_encoder_path=str(tmp_path / "fusion"),
                         fusion_net_path=str(tmp_path / "fusion"))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)   # nothing falls back
        got = [*pprep.prepare_text_encoder(back, CPU),
               pprep.prepare_image_head(back, CPU),
               pprep.prepare_fusion_net(back, CPU)]
    for g, w in zip(got, (enc, head, ih, net)):
        for k, v in w.state_dict().items():
            torch.testing.assert_close(g.state_dict()[k], v, rtol=0, atol=0)


def test_config_checks_the_backbone():
    _, pargs = _cfg()
    for model_type in ("arcface", "adaface", "magface"):
        check_serving(pargs.replace(model_type=model_type))
    check_serving(pargs.replace(img_size=128))          # arcface takes it
    for check in (check_serving, check_stage1):
        with pytest.raises(ValueError, match="112"):
            check(pargs.replace(model_type="adaface", img_size=128))
        with pytest.raises(ValueError, match="model_type"):
            check(pargs.replace(model_type="cosface"))


# -------------------------------------- COTS baseline and run_test on files --

MODEL_TYPES = ["arcface", "adaface", "magface"]


def _split(jargs, pargs, n_pairs=16):
    jdl, jds = jprep.prepare_dataloader(jargs, "test")
    pdl, pds = pprep.prepare_dataloader(pargs, "test")
    for ds in (jds, pds):           # 16 pairs keep the JAX side quick
        ds.imgs_pair = ds.imgs_pair[:n_pairs]
        ds.pair_label = ds.pair_label[:n_pairs]
    return jdl, pdl


def _scores(tmp_path, side):
    with open(tmp_path / f"{side}.npy", "rb") as f:
        return np.load(f), np.load(f)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_org_face_test_matches_jax(tmp_path, model_type):
    """The COTS baseline on the same backbone file, in its pair loop and
    in its table mode, port against JAX."""
    path, _ = _backbone_file(tmp_path, model_type, 10)
    for table in (False, True):
        jargs, pargs = _cfg(model_type=model_type, is_roc=True,
                            eval_table_mode=table,
                            **{f"weights_{model_type}": path})
        jargs = jargs.replace(roc_file=str(tmp_path / "jax"))
        pargs = pargs.replace(roc_file=str(tmp_path / "port"))
        jdl, pdl = _split(jargs, pargs)
        j_metrics = jev.org_face_test(jargs, jdl,
                                      jprep.prepare_backbone(jargs))
        p_metrics = pev.org_face_test(pargs, pdl,
                                      pprep.prepare_backbone(pargs, CPU))
        js, ps = _scores(tmp_path, "jax"), _scores(tmp_path, "port")
        np.testing.assert_array_equal(ps[0], js[0])
        assert ps[1].shape == (16,)
        close(ps[1], js[1], 1e-5, f"COTS pair scores, table={table}")
        assert p_metrics == pytest.approx(j_metrics, abs=1e-9)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_run_test_on_reference_files_matches_jax(tiny_bert, tmp_path,
                                                 model_type):
    """run_test with every module from a reference file: the backbone, the
    {'model', 'head'} text bundle, {'image_head'} and the FCFM {'net'}."""
    bb, _ = _backbone_file(tmp_path, model_type, 11)
    text = _save(tmp_path, "text", _text_bundle(12))
    image = _save(tmp_path, "image", {"image_head": _renamed(
        _image_head_oracle(13).state_dict(), _IMAGE_HEAD_KEYS)})
    fusion = _save(tmp_path, "fusion", {"net": _renamed(
        _fcfm_oracle(14).state_dict(), _FCFM_KEYS)})
    jargs, pargs = _cfg(model_type=model_type, is_roc=True,
                        text_encoder_path=text, image_encoder_path=image,
                        fusion_net_path=fusion,
                        **{f"weights_{model_type}": bb})
    jargs = jargs.replace(roc_file=str(tmp_path / "jax"))
    pargs = pargs.replace(roc_file=str(tmp_path / "port"))
    jdl, pdl = _split(jargs, pargs)
    jte, jth = jprep.prepare_text_encoder(jargs)
    j_metrics = jev.run_test(jargs, jdl, jprep.prepare_backbone(jargs),
                             jprep.prepare_image_head(jargs),
                             jprep.prepare_fusion_net(jargs), jte, jth)
    pte, pth = pprep.prepare_text_encoder(pargs, CPU)
    p_metrics = pev.run_test(pargs, pdl, pprep.prepare_backbone(pargs, CPU),
                             pprep.prepare_image_head(pargs, CPU),
                             pprep.prepare_fusion_net(pargs, CPU), pte, pth)
    js, ps = _scores(tmp_path, "jax"), _scores(tmp_path, "port")
    np.testing.assert_array_equal(ps[0], js[0])
    close(ps[1], js[1], 1e-5, "pair scores")
    assert p_metrics == pytest.approx(j_metrics, abs=1e-9)


def test_img_features_dict_matches_jax(tmp_path):
    """The identification feature table of the test pair list's images,
    decoded from disk, port against JAX on the same backbone file."""
    from PIL import Image
    path, _ = _backbone_file(tmp_path, "magface", 15)
    img_dir = tmp_path / "face2text" / "test_images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(15)
    names = [f"{i}_0.png" for i in range(5)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (112, 112, 3), np.uint8)).save(
            img_dir / n)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"{names[i]} {names[(i + 1) % 5]} {i % 2}\n"
                             for i in range(5)))
    jargs, pargs = _cfg(model_type="magface", weights_magface=path,
                        data_dir=str(tmp_path), dataset_name="face2text",
                        test_pair_list=str(pairs), batch_size=2)
    want = jev.get_img_features_dict(jargs, jprep.prepare_backbone(jargs))
    got = pev.get_img_features_dict(pargs, pprep.prepare_backbone(pargs, CPU))
    assert sorted(got) == sorted(want) == names
    for n in names:
        close(got[n], want[n], 1e-4, n)
