"""Model factories and the data loader.

Counterpart of text_guided_face_recognition_tpu/engine/prepare.py. Each
factory returns port modules in eval mode on the requested device, with
weights drawn from a `torch.Generator` seeded with `manual_seed` (on the
CPU, so a seed gives the same weights on every device), then loaded,
strictly, from the file its config key names:

  weights_arcface / weights_adaface / weights_magface (by model_type)
      the reference's pretrained backbones: ArcFace's iresnet18 .pth,
      AdaFace's ir_18 Lightning .ckpt, MagFace's iresnet18 .pth;
  text_encoder_path, image_encoder_path, fusion_net_path
      the port's own trainer artifacts (engine/checkpoint.py: the stage-1
      `*_image_encoder_N` / `*_text_encoder_N` and the stage-2
      `fusion_*_N` / `encoder_*_N`), or the reference's: its trainers'
      {"model", "head"}, {"image_head"} and {"net"} bundles, or a raw HF
      BERT state_dict for the text encoder; with en_type LSTM or GRU its
      {"model": RNNEncoder state_dict} file (or that state_dict alone);
      or the JAX package's artifacts of the same names, Orbax
      directories, exported to `.npz` by tools/export_jax_checkpoint.py:
      {"model", "head"} (an RNN encoder's {"model"}), {"image_head"},
      {"net", "image_head"}, each factory taking its own subtree, as the
      JAX factories' partial loads do.

With en_type LSTM or GRU the loader fills `vocab_size` from the corpus
(the synthetic one: 200 words and '<end>'), which the RNN encoder's
embedding takes, so `prepare_dataloader` runs before
`prepare_text_encoder`, as in the JAX trainers.

Reference files go through engine/convert.py into the JAX package's tree
layout and engine/from_jax.py onto the module, an export through
engine/from_jax.py (the text tower's legacy query / key / value leaves
fused first, engine/checkpoint.migrate_legacy_qkv). A file in none of
these layouts raises ValueError, an Orbax checkpoint (a directory)
NotImplementedError, naming the exporter on the trained-module paths;
an absent path warns and keeps the random init, as the JAX factories do
when no weights are found.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch import models as M
from text_guided_face_recognition_tpu_torch.data import (
    DataLoader,
    TestDataset,
    TrainDataset,
    load_text_data,
    load_text_data_bert,
)
from text_guided_face_recognition_tpu_torch.data.tokenizers import Vocabulary
from text_guided_face_recognition_tpu_torch.engine import convert as C
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    is_jax_export, load_checkpoint, load_jax_export, migrate_legacy_qkv)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.models.irnet import build_model
from text_guided_face_recognition_tpu_torch.models.magface import (
    network_builder)
from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm, LayerNormCHW, PReLU)
from text_guided_face_recognition_tpu_torch.models.text_bert import LayerNorm
from text_guided_face_recognition_tpu_torch.models.text_rnn import init_rnn_
from text_guided_face_recognition_tpu_torch.parallel import mesh

__all__ = ["resolve_device", "compute_dtype", "random_init_",
           "prepare_arcface", "prepare_adaface", "prepare_magface",
           "prepare_backbone", "prepare_text_encoder", "prepare_rnn_encoder",
           "prepare_image_head", "prepare_fusion_net", "prepare_dataloader",
           "rank_shard"]


def resolve_device(cpu: bool = False) -> torch.device:
    """The CUDA card, or the CPU when asked for; no silent CPU fallback.
    In a launched process, this rank's device in its process group
    (parallel/mesh.py `init_from_env`, which owns the rule)."""
    return mesh.init_from_env(cpu)


def compute_dtype(args) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[args.compute_dtype]


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from a CPU generator seeded with `seed`: linear and
    conv weights N(0, 1/fan_in) (lecun normal), embeddings N(0, 1), biases
    0, norm scales 1, BN statistics (0, 1), PReLU 0.25 (the flax inits)."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
        elif isinstance(m, (LayerNorm, LayerNormCHW, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
    return module


# ----------------------------------------------------------------- weights --
# Three layouts reach the trained-module paths (text_encoder_path,
# image_encoder_path, fusion_net_path). All keep the same top-level keys
# ({"model", "head"}, {"image_head"}, {"net", ...}). The JAX package's
# export is a `.npz` of `/`-joined tree paths (engine/checkpoint.
# is_jax_export); between the two torch files the inner keys tell them
# apart. The port's own artifacts (engine/checkpoint.py) hold each
# module's state_dict, flax-path keys (`model.layer_0.attn.qkv.weight`,
# `bwm.conv_k2.weight`). The reference's hold its torch modules' keys
# (`model.embeddings.word_embeddings.weight`, `bwm.convs1.0.weight`, 1x1
# convs as 4-D weights), which engine/convert.py maps into the JAX
# package's tree and engine/from_jax.py onto the module. The backbone paths
# (weights_arcface / _adaface / _magface) name the reference's files only.

_ORBAX = ("{what}: {path!r} is a directory; the port does not read the JAX "
          "package's Orbax checkpoints: export it with `JAX_PLATFORMS=cpu "
          "python tools/export_jax_checkpoint.py {path} <out>.npz` where JAX "
          "is installed, and pass the .npz")


def _read_weight_file(path: str, what: str):
    """The object in the torch file at `path`, read with weights_only=True
    (engine/checkpoint.load_checkpoint): the port's artifacts and the
    reference's bundles on these paths are tensors in dicts."""
    try:
        return load_checkpoint(path)
    except Exception as e:
        raise ValueError(f"{what}: {path!r} is not a torch file (the port "
                         "loads its own artifacts and the reference's "
                         "state_dict bundles)") from e


def _port_layout(sd, module: nn.Module) -> bool:
    """`sd` is `module`'s own state_dict: the same keys and shapes."""
    if not isinstance(sd, Mapping):
        return False
    target = module.state_dict()
    return set(sd) == set(target) and all(
        tuple(getattr(sd[k], "shape", ())) == tuple(v.shape)
        for k, v in target.items())


def _land(module: nn.Module, tree) -> None:
    """A JAX-layout tree ({"params", "batch_stats"} of numpy) onto `module`,
    strictly (engine/from_jax.py refuses a missing or extra leaf)."""
    module.load_state_dict(state_dict_from_jax(
        tree["params"], tree.get("batch_stats"), module=module), strict=True)


def _conv_weight(sd, key: str) -> bool:
    """The reference's 1x1-conv projection: `key` holds a 4-D weight."""
    return getattr(sd.get(key), "ndim", 0) == 4


def _load_trained(path: str, what: str, parts, reference) -> bool:
    """Load the file at `path` into `parts` ({top-level key: module}):
    the port's artifact when every part is its module's own state_dict,
    else the reference's layout when `reference[0](obj)` says so, by
    `reference[1](obj)`; anything else raises, naming both layouts
    (`reference[2]` describes the reference's). False when nothing is at
    `path`."""
    if not path or not os.path.exists(path):
        return False
    if os.path.isdir(path):
        raise NotImplementedError(_ORBAX.format(what=what, path=path))
    if is_jax_export(path):
        tree = load_jax_export(path)
        missing = [k for k in parts if k not in tree]
        if missing:
            raise ValueError(f"{what}: the JAX export {path!r} lacks "
                             f"{missing}; it holds {sorted(tree)}")
        for key, module in parts.items():
            _land(module, migrate_legacy_qkv(tree[key]))
        print(f"loading exported JAX {what}:", path)
        return True
    obj = _read_weight_file(path, what)
    is_ref, convert, ref_layout = reference
    if isinstance(obj, Mapping) and all(
            _port_layout(obj.get(k), m) for k, m in parts.items()):
        for key, module in parts.items():
            module.load_state_dict(obj[key], strict=True)
        print(f"loading {what}:", path)
    elif is_ref(obj):
        convert(obj)
        print(f"converted reference {what}:", path)
    else:
        port_layout = ", ".join(f"{k!r}: {type(m).__name__}.state_dict()"
                                for k, m in parts.items())
        raise ValueError(
            f"{what}: {path!r} is in neither layout the port loads: the "
            f"port's artifact {{{port_layout}}} (engine/checkpoint.py) or "
            f"the reference's {ref_layout}")
    return True


def _finish(module: nn.Module, loaded: bool, path: str, what: str,
            device: torch.device) -> nn.Module:
    if not loaded:
        warnings.warn(f"{what}: no weights at {path!r}; using random init "
                      "(synthetic/e2e mode)")
    return module.to(device).eval()


# --------------------------------------------------------------- backbones --

def _load_backbone(net: nn.Module, path: str, what: str, key, marker: str,
                   convert) -> bool:
    """The reference's backbone file at `path` (the state_dict under `key`
    when the file holds one there) into `net`, when it has `marker`."""
    if not path or not os.path.exists(path):
        return False
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{what}: {path!r} is a directory (an Orbax backbone of the JAX "
            "package's tools/convert_weights.py); the port reads the "
            "reference's backbone file it was converted from")
    try:
        sd = C.load_torch_state_dict(path, key=key)
    except Exception as e:
        raise ValueError(f"{what}: {path!r} is not a torch file") from e
    if marker not in sd and "module." + marker not in sd:
        raise ValueError(f"{what}: {path!r} is not the reference's "
                         f"checkpoint: no key {marker!r}")
    _land(net, convert(sd))
    print(f"loading pretrained {what} from {path}")
    return True


def prepare_arcface(args, device: torch.device) -> nn.Module:
    """Frozen ArcFace iresnet18 from the reference's .pth (its state_dict,
    `module.`-prefixed or not)."""
    net = random_init_(M.iresnet18(dtype=compute_dtype(args),
                                   img_size=args.img_size), args.manual_seed)
    loaded = _load_backbone(net, args.weights_arcface, "arcface backbone",
                            None, "layer1.0.conv1.weight", C.convert_iresnet)
    return _finish(net, loaded, args.weights_arcface, "arcface backbone",
                   device)


def prepare_adaface(args, device: torch.device) -> nn.Module:
    """Frozen AdaFace ir_18 from the reference's Lightning .ckpt: its
    `state_dict`, the backbone's keys under `model.`."""
    net = random_init_(build_model("ir_18", dtype=compute_dtype(args)),
                       args.manual_seed)

    def convert(sd):
        return C.convert_irbackbone(
            {k[6:]: v for k, v in sd.items() if k.startswith("model.")})

    loaded = _load_backbone(net, args.weights_adaface, "adaface backbone",
                            "state_dict", "model.input_layer.0.weight",
                            convert)
    return _finish(net, loaded, args.weights_adaface, "adaface backbone",
                   device)


def prepare_magface(args, device: torch.device) -> nn.Module:
    """Frozen MagFace iresnet18 from the reference's .pth: its
    `state_dict`, the backbone under `module.features.`; the margin head's
    `module.fc.weight` is dropped."""
    net = random_init_(network_builder("iresnet18", dtype=compute_dtype(args),
                                       img_size=args.img_size),
                       args.manual_seed)
    loaded = _load_backbone(net, args.weights_magface, "magface backbone",
                            "state_dict", "module.features.conv1.weight",
                            C.convert_magface)
    return _finish(net, loaded, args.weights_magface, "magface backbone",
                   device)


def prepare_backbone(args, device: torch.device) -> nn.Module:
    """The frozen backbone of `model_type` (arcface | adaface | magface)."""
    factories = {"arcface": prepare_arcface, "adaface": prepare_adaface,
                 "magface": prepare_magface}
    if args.model_type not in factories:
        raise ValueError(f"model_type={args.model_type!r} is not one of "
                         f"{tuple(factories)}")
    return factories[args.model_type](args, device)


# ------------------------------------------------------------ text + heads --

# The token-embedding key of each HF text model (the JAX package takes any
# file that is not a {'model', 'head'} bundle for one; the port recognises
# it by this key, so another file is refused naming both layouts).
_HF_WORDS = {"clip": "embeddings.token_embedding.weight",
             "groupvit": "embeddings.token_embedding.weight"}
_BERT_WORDS = "embeddings.word_embeddings.weight"


def _hf_text(sd, bert_type: str) -> bool:
    """An HF text model state_dict of `bert_type`, under any prefix
    (`bert.`, `text_model.`, `model.`)."""
    words = _HF_WORDS.get(bert_type, _BERT_WORDS)
    return isinstance(sd, Mapping) and any(k.endswith(words) for k in sd)


def _rnn_state_dict(obj):
    """The reference RNNEncoder's state_dict in `obj` ({'model': sd} or sd
    itself), or None."""
    if not isinstance(obj, Mapping):
        return None
    sd = obj.get("model", obj)
    if isinstance(sd, Mapping) and any(
            k.endswith("rnn.weight_ih_l0") for k in sd):
        return sd
    return None


def prepare_rnn_encoder(args, device: torch.device) -> nn.Module:
    """The LSTM or GRU caption encoder (models/text_rnn.py) over the
    corpus's `vocab_size` words; `text_encoder_path` names the port's
    {"model"} artifact or the reference's {'model': RNNEncoder state_dict}
    file (or the state_dict alone)."""
    enc = init_rnn_(M.RNNEncoder(max(int(args.vocab_size), 2), args.en_type,
                                 nhidden=args.embedding_dim,
                                 dtype=compute_dtype(args)),
                    torch.Generator().manual_seed(int(args.manual_seed)))
    path = args.text_encoder_path
    loaded = _load_trained(
        path, "text encoder", {"model": enc},
        (lambda obj: _rnn_state_dict(obj) is not None,
         lambda obj: _land(enc, C.convert_rnn_encoder(
             C.npify(_rnn_state_dict(obj)), args.en_type)),
         "{'model': RNNEncoder state_dict (keys 'encoder.weight', "
         "'rnn.weight_ih_l0', ...)} or that state_dict alone"))
    return _finish(enc, loaded, path, "text encoder", device)


def prepare_text_encoder(args, device: torch.device
                         ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """The text encoder of `bert_type` and its TextHeading, or with en_type
    LSTM or GRU the RNN encoder and None (it has no head). For BERT
    `text_encoder_path` names the port's {"model", "head"} artifact, the
    reference's {"model", "head"} bundle, or a raw HF text model of
    `bert_type` (BertModel, CLIPTextModel, GroupViTTextModel,
    FlavaTextModel), told by its token-embedding key (`_HF_WORDS`); the
    head then stays random, as in the JAX package."""
    if args.en_type != "BERT":
        return prepare_rnn_encoder(args, device), None
    dtype = compute_dtype(args)
    enc = M.TextEncoder(bert_type=args.bert_type, dtype=dtype,
                        fused_ln=bool(args.fused_ln),
                        fused_block=str(args.fused_block),
                        fused_dropout=bool(args.fused_dropout))
    head = M.TextHeading(hidden=M.TEXT_ARCHS[args.bert_type].hidden,
                         feat_dim=args.aux_feat_dim_per_granularity,
                         dtype=dtype)
    both = random_init_(nn.ModuleDict({"model": enc, "head": head}),
                        args.manual_seed)
    path, bt = args.text_encoder_path, args.bert_type

    def is_ref(obj) -> bool:
        return _hf_text(obj, bt) or (isinstance(obj, Mapping) and "head" in obj
                                     and _hf_text(obj.get("model"), bt))

    def convert(obj) -> None:
        if _hf_text(obj, bt):
            _land(enc, {"params": {"model": C.convert_hf_text_model(
                C.npify(obj), bt)["params"]}})
            warnings.warn(f"text encoder: {path!r} is a raw HF text model; "
                          "the text head keeps its random init")
            return
        _land(enc, C.convert_text_encoder_bundle(C.npify(obj["model"]), bt))
        _land(head, C.convert_text_heading(C.npify(obj["head"])))

    words = _HF_WORDS.get(bt, _BERT_WORDS)
    loaded = _load_trained(
        path, "text encoder", {"model": enc, "head": head},
        (is_ref, convert, "{'model': TextEncoder state_dict (keys "
         f"'model.{words}', ...), 'head': TextHeading state_dict (keys "
         "'bwm.convs1.0.weight', ...)} or a raw HF " + bt + " text model's "
         "state_dict"))
    _finish(both, loaded, path, "text encoder", device)
    return enc, head


def prepare_image_head(args, device: torch.device) -> nn.Module:
    """The ImageHeading; `image_encoder_path` names a file holding it under
    "image_head" (the stage-1 image artifact or a stage-2 fusion one)."""
    head = random_init_(
        M.ImageHeading(feat_dim=args.aux_feat_dim_per_granularity,
                       spatial=args.img_size // 8, dtype=compute_dtype(args)),
        args.manual_seed)

    def is_ref(obj) -> bool:
        return isinstance(obj, Mapping) and isinstance(
            obj.get("image_head"), Mapping) and _conv_weight(
                C.strip_module(C.npify(obj["image_head"])),
                "imim.sa.query_proj.weight")

    loaded = _load_trained(
        args.image_encoder_path, "image head", {"image_head": head},
        (is_ref, lambda obj: _land(head, C.convert_image_heading(
            C.npify(obj["image_head"]))),
         "{'image_head': ImageHeading state_dict with the 1x1-conv "
         "projections (a 4-D 'imim.sa.query_proj.weight')}"))
    return _finish(head, loaded, args.image_encoder_path, "image head",
                   device)


def prepare_fusion_net(args, device: torch.device, load: bool = True
                       ) -> Optional[nn.Module]:
    """The fusion net (None for concat); `load=False` (the stage-2 trainer)
    ignores `fusion_net_path`, which names a file holding it under "net"."""
    dtype = compute_dtype(args)
    feat = args.aux_feat_dim_per_granularity
    if args.fusion_type == "concat":
        return None
    rnn = args.en_type != "BERT"
    if args.fusion_type == "linear":
        net = M.LinearFusion(
            in_features=feat + (args.embedding_dim if rnn else 256),
            fusion_final_dim=args.fusion_final_dim, dtype=dtype)
        # the reference's dead `ln` member marks its state_dict
        is_net, convert = (lambda sd: "fc1.weight" in sd and "ln.weight" in sd,
                           C.convert_linear_fusion)
        ref_layout = ("{'net': LinearFusion state_dict (keys 'fc1.weight', "
                      "'ln.weight', ...)}")
    elif args.fusion_type == "fcfm" and args.en_type == "LSTM":
        net = M.WordLevelCFA_LSTM(channel_dim=256, dtype=dtype)
        is_net, convert = (
            lambda sd: _conv_weight(sd, "sa.query_proj.weight")
            and "ln1.weight" in sd, C.convert_wordlevel_cfa)
        ref_layout = ("{'net': WordLevelCFA_LSTM state_dict with the 1x1-"
                      "conv projections (a 4-D 'sa.query_proj.weight') and "
                      "'ln1.weight'}")
    elif args.fusion_type == "fcfm" and not rnn:
        net = M.FCFM(channel_dim=36, feat_dim=feat, dtype=dtype)
        is_net, convert = (
            lambda sd: _conv_weight(sd, "sa.query_proj.weight"),
            C.convert_fcfm)
        ref_layout = ("{'net': Working (FCFM) state_dict with the 1x1-conv "
                      "projections (a 4-D 'sa.query_proj.weight')}")
    else:
        raise ValueError(f"fusion_type {args.fusion_type!r} with en_type "
                         f"{args.en_type!r}: no fusion net takes it")
    random_init_(net, args.manual_seed)
    path = args.fusion_net_path if load else ""

    def is_ref(obj) -> bool:
        return isinstance(obj, Mapping) and isinstance(
            obj.get("net"), Mapping) and is_net(
                C.strip_module(C.npify(obj["net"])))

    loaded = _load_trained(
        path, "fusion net", {"net": net},
        (is_ref, lambda obj: _land(net, convert(C.npify(obj["net"]))),
         ref_layout))
    return _finish(net, loaded, path, "fusion net", device)


# --------------------------------------------------------------- dataloader --

def _captions(args):
    """{split: (names, captions, masks)} and the vocabulary (None for BERT;
    masks None for LSTM/GRU), synthetic when the caption assets are
    absent, and whether they are."""
    try:
        if args.en_type == "BERT":
            (tr_n, tr_c, tr_m, va_n, va_c, va_m,
             te_n, te_c, te_m) = load_text_data_bert(args.data_dir, args)
            vocab = None
        else:
            (tr_n, tr_c, va_n, va_c, te_n, te_c,
             vocab) = load_text_data(args.data_dir, args.captions_per_image)
            tr_m = va_m = te_m = None
        return ({"train": (tr_n, tr_c, tr_m), "valid": (va_n, va_c, va_m),
                 "test": (te_n, te_c, te_m)}, vocab, False)
    except (FileNotFoundError, OSError):
        warnings.warn("caption assets missing; generating synthetic "
                      "caption/token data")
    if args.en_type == "BERT":
        return ({s: _synthetic_bert(args, n) for s, n in
                 (("train", 64), ("valid", 32), ("test", 32))}, None, True)
    vocab = _synthetic_vocab(200)
    return ({s: _synthetic_lstm(args, n, vocab) + (None,) for s, n in
             (("train", 64), ("valid", 32), ("test", 32))}, vocab, True)


def prepare_dataloader(args, split: str):
    """The split's loader and dataset; synthetic captions when the caption
    assets are absent, as the JAX package does. With en_type LSTM or GRU
    sets `args.vocab_size` to the vocabulary's size. Under a process group
    of more than one rank the train loader yields this rank's rows of each
    global batch (`process_shard`), an eval loader this rank's share of
    each batch (`row_shard`), whose outputs the evaluation gathers
    (engine/evaluate.py)."""
    data, vocab, missing = _captions(args)
    synthetic = bool(args.synthetic) or missing
    if vocab is not None:
        args.vocab_size = vocab.n_words
    names, caps, masks = data[split]
    if split == "train":
        ds = TrainDataset(names, caps, masks, split="train", args=args,
                          synthetic=synthetic, seed=args.manual_seed,
                          vocab=vocab)
        dl = DataLoader(ds, batch_size=args.batch_size, drop_last=True,
                        shuffle=True, num_workers=args.num_workers,
                        seed=args.manual_seed, process_shard=rank_shard())
        return dl, ds
    ds = TestDataset(names, caps, masks, split=split, args=args,
                     synthetic=synthetic, vocab=vocab)
    if args.is_ident and ds.synthetic_pairs:
        # synthetic pair groups: the genuine pair at column 0 of each group
        args.test_sub = len(ds) // 4
    dl = DataLoader(ds, batch_size=args.batch_size, drop_last=False,
                    shuffle=False, num_workers=args.num_workers,
                    row_shard=rank_shard())
    return dl, ds


def rank_shard():
    """(rank, world) under a process group of more than one rank, else
    None: the loaders' shard."""
    world = mesh.world_size()
    return (mesh.rank(), world) if world > 1 else None


def _synthetic_vocab(n: int) -> Vocabulary:
    """'<end>' and the words w0 ... w{n-1}."""
    v = Vocabulary()
    for i in range(n):
        v.add(f"w{i}")
    return v


def _synthetic_lstm(args, n_images: int, vocab: Vocabulary):
    """The JAX package's synthetic LSTM captions, value for value: word
    ids in [1, n_words), 3 to lstm_words_num + 3 of them (the longer ones
    take the subsampling path)."""
    rng = np.random.default_rng(0)
    names = [f"s{i}_0" for i in range(n_images)]
    caps = [rng.integers(1, vocab.n_words,
                         size=rng.integers(3, args.lstm_words_num + 4)).tolist()
            for _ in range(n_images * args.captions_per_image)]
    return names, caps


def _synthetic_bert(args, n_images: int):
    """The JAX package's synthetic captions, value for value."""
    rng = np.random.default_rng(0)
    names = [f"s{i}_0" for i in range(n_images)]
    caps, masks = [], []
    for _ in range(n_images * args.captions_per_image):
        n_tok = int(rng.integers(4, args.bert_words_num))
        ids = np.zeros(args.bert_words_num, np.int32)
        ids[0] = 101
        ids[1:n_tok - 1] = rng.integers(1000, 30000, n_tok - 2)
        ids[n_tok - 1] = 102
        m = np.zeros(args.bert_words_num, np.int32)
        m[:n_tok] = 1
        caps.append(ids)
        masks.append(m)
    return names, caps, masks
