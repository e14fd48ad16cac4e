"""Model factories and the data loader.

Counterpart of text_guided_face_recognition_tpu/engine/prepare.py. Each
factory returns port modules in eval mode on the requested device, with
weights drawn from a `torch.Generator` seeded with `manual_seed` (on the
CPU, so a seed gives the same weights on every device). A weight path that
names a file written by the port's own trainers (engine/checkpoint.py: the
stage-1 `*_image_encoder_N` / `*_text_encoder_N` and the stage-2
`fusion_*_N` / `encoder_*_N` artifacts) is loaded, strictly. Loading Orbax
checkpoints (directories) and reference `.pth` files is not ported yet and
raises NotImplementedError; an absent path warns and random-inits, as the
JAX factories do when no weights are found.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch import models as M
from text_guided_face_recognition_tpu_torch.data import (
    DataLoader,
    TestDataset,
    TrainDataset,
    load_text_data_bert,
)
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    load_checkpoint)
from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm, LayerNormCHW, PReLU)
from text_guided_face_recognition_tpu_torch.models.text_bert import LayerNorm

__all__ = ["resolve_device", "compute_dtype", "random_init_",
           "prepare_backbone", "prepare_text_encoder", "prepare_image_head",
           "prepare_fusion_net", "prepare_dataloader"]


def resolve_device(cpu: bool = False) -> torch.device:
    """The CUDA card, or the CPU when asked for; no silent CPU fallback."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on an NVIDIA "
                           "GPU; pass --cpu (device='cpu') to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


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
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
    return module


def _load_port_checkpoint(parts, path: str, what: str) -> bool:
    """Load the port's own artifact at `path` into `parts` ({key of the
    saved tree: module}), strictly. False when nothing is there."""
    if not path or not os.path.exists(path):
        return False
    unported = NotImplementedError(
        f"{what}: {path!r} is not an artifact of this package's trainers; "
        "loading Orbax checkpoints and reference .pth files is not ported "
        "yet (ROADMAP.md, Queue 1); remove the path to use random weights")
    if not os.path.isfile(path):
        raise unported
    try:
        tree = load_checkpoint(path)
        for key, module in parts.items():
            module.load_state_dict(tree[key], strict=True)
    except Exception as e:   # not a torch file, or another tree
        raise unported from e
    print(f"loading {what}:", path)
    return True


def _finish(module: nn.Module, path: str, what: str, args,
            device: torch.device, parts=None) -> nn.Module:
    """Random init, then the port's artifact at `path` when there is one
    (`parts`: which saved sub-tree goes into which module)."""
    random_init_(module, args.manual_seed)
    if not _load_port_checkpoint(parts or {}, path, what):
        warnings.warn(f"{what}: no weights at {path!r}; using random init "
                      "(synthetic/e2e mode)")
    return module.to(device).eval()


def prepare_backbone(args, device: torch.device) -> nn.Module:
    """Frozen ArcFace iresnet18."""
    if args.model_type != "arcface":
        raise NotImplementedError(
            f"model_type={args.model_type!r}: only the arcface iresnet18 "
            "backbone is ported yet (ROADMAP.md, Queue 1)")
    net = M.iresnet18(dtype=compute_dtype(args), img_size=args.img_size)
    # the pretrained backbone is a reference .pth: not ported, see _finish
    return _finish(net, args.weights_arcface, "arcface backbone", args, device,
                   {"backbone": net})


def prepare_text_encoder(args, device: torch.device
                         ) -> Tuple[nn.Module, nn.Module]:
    """BERT text encoder and its TextHeading."""
    if args.en_type != "BERT":
        raise NotImplementedError(
            f"en_type={args.en_type!r}: the LSTM path is not ported yet "
            "(ROADMAP.md, Queue 1)")
    dtype = compute_dtype(args)
    enc = M.TextEncoder(bert_type=args.bert_type, dtype=dtype,
                        fused_ln=bool(args.fused_ln),
                        fused_block=str(args.fused_block),
                        fused_dropout=bool(args.fused_dropout))
    head = M.TextHeading(hidden=M.TEXT_ARCHS[args.bert_type].hidden,
                         feat_dim=args.aux_feat_dim_per_granularity,
                         dtype=dtype)
    both = nn.ModuleDict({"model": enc, "head": head})
    _finish(both, args.text_encoder_path, "text encoder", args, device,
            {"model": enc, "head": head})
    return enc, head


def prepare_image_head(args, device: torch.device) -> nn.Module:
    spatial = args.img_size // 8
    head = M.ImageHeading(feat_dim=args.aux_feat_dim_per_granularity,
                          spatial=spatial, dtype=compute_dtype(args))
    return _finish(head, args.image_encoder_path, "image head", args, device,
                   {"image_head": head})


def prepare_fusion_net(args, device: torch.device, load: bool = True
                       ) -> Optional[nn.Module]:
    """The fusion net (None for concat); `load=False` (the stage-2 trainer)
    ignores `fusion_net_path`."""
    dtype = compute_dtype(args)
    feat = args.aux_feat_dim_per_granularity
    if args.fusion_type == "concat":
        return None
    if args.fusion_type == "linear":
        net = M.LinearFusion(in_features=256 + feat,
                             fusion_final_dim=args.fusion_final_dim,
                             dtype=dtype)
    elif args.fusion_type == "fcfm":
        net = M.FCFM(channel_dim=36, feat_dim=feat, dtype=dtype)
    else:
        raise ValueError(f"unknown fusion_type {args.fusion_type!r}")
    return _finish(net, args.fusion_net_path if load else "", "fusion net",
                   args, device, {"net": net})


# --------------------------------------------------------------- dataloader --

def prepare_dataloader(args, split: str):
    """The split's loader and dataset; synthetic captions when the caption
    assets are absent, as the JAX package does."""
    if args.en_type != "BERT":
        raise NotImplementedError(
            f"en_type={args.en_type!r}: the LSTM path is not ported yet "
            "(ROADMAP.md, Queue 1)")
    synthetic = bool(args.synthetic)
    try:
        (tr_n, tr_c, tr_m, va_n, va_c, va_m,
         te_n, te_c, te_m) = load_text_data_bert(args.data_dir, args)
    except (FileNotFoundError, OSError):
        warnings.warn("caption assets missing; generating synthetic "
                      "caption/token data")
        synthetic = True
        tr_n, tr_c, tr_m = _synthetic_bert(args, 64)
        va_n, va_c, va_m = _synthetic_bert(args, 32)
        te_n, te_c, te_m = _synthetic_bert(args, 32)
    data = {"train": (tr_n, tr_c, tr_m), "valid": (va_n, va_c, va_m),
            "test": (te_n, te_c, te_m)}
    names, caps, masks = data[split]
    if split == "train":
        ds = TrainDataset(names, caps, masks, split="train", args=args,
                          synthetic=synthetic, seed=args.manual_seed)
        dl = DataLoader(ds, batch_size=args.batch_size, drop_last=True,
                        shuffle=True, num_workers=args.num_workers,
                        seed=args.manual_seed)
        return dl, ds
    ds = TestDataset(names, caps, masks, split=split, args=args,
                     synthetic=synthetic)
    if args.is_ident and ds.synthetic_pairs:
        # synthetic pair groups: the genuine pair at column 0 of each group
        args.test_sub = len(ds) // 4
    dl = DataLoader(ds, batch_size=args.batch_size, drop_last=False,
                    shuffle=False, num_workers=args.num_workers)
    return dl, ds


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
