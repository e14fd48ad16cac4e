"""The reference's torch weight files -> the JAX package's tree layout.

Counterpart of text_guided_face_recognition_tpu/engine/convert.py, of which
this is the port's own copy (the port imports nothing of the JAX package).
Each converter reads a state_dict under the reference's key names and
returns the flax tree the JAX package would build from it ({"params",
"batch_stats"} of nested dicts of numpy arrays), so that one map,
engine/from_jax.state_dict_from_jax, lands it on a port module. The files:
the frozen backbones (ArcFace arcface_ir18_ms1mv3.pth, AdaFace
adaface_ir18_webface4m.ckpt, MagFace magface_iresnet18_casia_dp.pth), an HF
torch text model of every bert_type (BERT, CLIP, GroupViT, FLAVA), the
reference trainers' text, image-head and fusion bundles, and its LSTM/GRU
caption encoder and LSTM fusion net.

Layout rules (the JAX package's):
  * conv kernels: OIHW -> HWIO
  * dense kernels: (out, in) -> (in, out)
  * a dense layer fed by a flattened conv map: torch flattens (C, H, W),
    the JAX package (and the port, models/iresnet.py) (H, W, C), so the
    kernel's input axis is permuted
  * BatchNorm: weight -> scale, running_{mean,var} -> batch_stats; a
    scale-free BN (`features`) with a torch weight other than 1 takes the
    weight into its running variance: var' = (var + eps) / w^2 - eps
  * PReLU: weight -> alpha
  * torch's nn.LSTM / nn.GRU: gate rows chunked along dim 0 (LSTM i, f,
    g, o; GRU r, z, n) -> one (in, out) kernel per gate and side; the LSTM
    bias is b_ih + b_hh on the hidden side, the GRU's r and z biases are
    b_ih + b_hh on the input side and n keeps b_in and b_hn apart (torch's
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)), flax's GRUCell split)

torch only deserialises (`load_torch_state_dict`); the rest is numpy.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["strip_module", "npify", "load_torch_state_dict",
           "convert_iresnet", "convert_irbackbone", "convert_magface",
           "convert_bert_encoder", "convert_clip_text_encoder",
           "convert_flava_text_encoder", "convert_hf_text_model",
           "convert_text_encoder_bundle", "convert_text_heading",
           "convert_image_heading", "convert_fcfm", "convert_linear_fusion",
           "convert_wordlevel_cfa", "convert_rnn_encoder"]


def strip_module(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop nn.DataParallel's 'module.' key prefix (the reference wraps
    every trained module in DataParallel)."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def npify(obj) -> Dict[str, np.ndarray]:
    """A state_dict (or a module holding one) as {key: numpy array}."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
            else np.asarray(v) for k, v in obj.items()}


def load_torch_state_dict(path: str, key: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    """The state_dict in a reference file (under `key` when the file is a
    dict holding it), as numpy. Read with torch.load(weights_only=False),
    as the JAX package reads these files: AdaFace's Lightning checkpoint
    holds hyper-parameters that weights_only=True refuses. Name only files
    you trust."""
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(obj, dict) and key in obj:
        obj = obj[key]
    return npify(obj)


def _conv(sd, name):
    return np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0))


def _dense(sd, name):
    out = {"kernel": np.transpose(sd[f"{name}.weight"], (1, 0))}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _qkv_fused(sd, qname, kname, vname):
    """torch q/k/v Linear triplet -> the fused qkv Dense ([q | k | v] on
    the output axis)."""
    ks = [np.transpose(sd[f"{n}.weight"], (1, 0)) for n in (qname, kname,
                                                            vname)]
    out = {"kernel": np.concatenate(ks, axis=1)}
    if f"{qname}.bias" in sd:
        out["bias"] = np.concatenate(
            [sd[f"{n}.bias"] for n in (qname, kname, vname)])
    return out


def _dense_from_flattened_conv(sd, name, c, h, w):
    """Permute the input axis of an fc eating a flattened (C, H, W) map into
    the (H, W, C) flatten order."""
    wt = sd[f"{name}.weight"]                     # (out, C*H*W)
    out_f = wt.shape[0]
    wt = wt.reshape(out_f, c, h, w).transpose(2, 3, 1, 0).reshape(
        h * w * c, out_f)
    d = {"kernel": wt}
    if f"{name}.bias" in sd:
        d["bias"] = sd[f"{name}.bias"]
    return d


def _bn(sd, name, scale_free: bool = False, eps: float = 1e-5
        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    mean = sd[f"{name}.running_mean"]
    var = sd[f"{name}.running_var"]
    params: Dict[str, Any] = {}
    if scale_free:
        w = sd.get(f"{name}.weight")
        if w is not None and not np.allclose(w, 1.0):
            # (x - m) / sqrt(var + eps) * w = (x - m) / sqrt(var' + eps)
            var = (var + eps) / np.square(w) - eps
        if f"{name}.bias" in sd:
            params["bias"] = sd[f"{name}.bias"]
    else:
        params["scale"] = sd[f"{name}.weight"]
        params["bias"] = sd[f"{name}.bias"]
    return params, {"mean": mean, "var": var}


# -------------------------------------------------------------- backbones --

def convert_iresnet(sd: Dict[str, np.ndarray], layers=(2, 2, 2, 2)
                    ) -> Dict[str, Any]:
    """ArcFace iresnet state_dict (keys `layer1.0.bn1.weight`, ...; a
    `module.` prefix is dropped) -> {params, batch_stats} of the iResNet."""
    sd = strip_module(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["conv1"] = {"kernel": _conv(sd, "conv1")}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    params["prelu"] = {"alpha": sd["prelu.weight"]}

    for stage, n in enumerate(layers, start=1):
        for i in range(n):
            t = f"layer{stage}.{i}"
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            p["bn1"], s["bn1"] = _bn(sd, f"{t}.bn1")
            p["conv1"] = {"kernel": _conv(sd, f"{t}.conv1")}
            p["bn2"], s["bn2"] = _bn(sd, f"{t}.bn2")
            p["prelu"] = {"alpha": sd[f"{t}.prelu.weight"]}
            p["conv2"] = {"kernel": _conv(sd, f"{t}.conv2")}
            p["bn3"], s["bn3"] = _bn(sd, f"{t}.bn3")
            if f"{t}.downsample.0.weight" in sd:
                p["downsample_conv"] = {
                    "kernel": _conv(sd, f"{t}.downsample.0")}
                p["downsample_bn"], s["downsample_bn"] = _bn(
                    sd, f"{t}.downsample.1")
            params[f"layer{stage}_{i}"] = p
            stats[f"layer{stage}_{i}"] = s

    params["bn2"], stats["bn2"] = _bn(sd, "bn2")
    params["fc"] = _dense_from_flattened_conv(sd, "fc", 512, 7, 7)
    params["features"], stats["features"] = _bn(sd, "features",
                                                scale_free=True)
    return {"params": params, "batch_stats": stats}


def convert_irbackbone(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """AdaFace IR state_dict (the Lightning checkpoint's `state_dict` with
    its `model.` prefix already stripped) -> {params, batch_stats} of
    models/irnet.IRBackbone. The output BN has no affine: its statistics
    are its only leaves."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["input_conv"] = {"kernel": _conv(sd, "input_layer.0")}
    params["input_bn"], stats["input_bn"] = _bn(sd, "input_layer.1")
    params["input_prelu"] = {"alpha": sd["input_layer.2.weight"]}

    n_body = max(int(m.group(1)) for k in sd
                 if (m := re.match(r"body\.(\d+)\.", k))) + 1
    for i in range(n_body):
        t = f"body.{i}"
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        if f"{t}.shortcut_layer.0.weight" in sd:
            p["shortcut_conv"] = {"kernel": _conv(sd, f"{t}.shortcut_layer.0")}
            p["shortcut_bn"], s["shortcut_bn"] = _bn(
                sd, f"{t}.shortcut_layer.1")
        p["res_bn1"], s["res_bn1"] = _bn(sd, f"{t}.res_layer.0")
        p["res_conv1"] = {"kernel": _conv(sd, f"{t}.res_layer.1")}
        p["res_bn2"], s["res_bn2"] = _bn(sd, f"{t}.res_layer.2")
        p["res_prelu"] = {"alpha": sd[f"{t}.res_layer.3.weight"]}
        p["res_conv2"] = {"kernel": _conv(sd, f"{t}.res_layer.4")}
        p["res_bn3"], s["res_bn3"] = _bn(sd, f"{t}.res_layer.5")
        if f"{t}.res_layer.se_block.fc1.weight" in sd:
            p["se"] = {
                "fc1": {"kernel": _conv(sd, f"{t}.res_layer.se_block.fc1")},
                "fc2": {"kernel": _conv(sd, f"{t}.res_layer.se_block.fc2")},
            }
        params[f"body_{i}"] = p
        stats[f"body_{i}"] = s

    params["output_bn"], stats["output_bn"] = _bn(sd, "output_layer.0")
    params["output_fc"] = _dense_from_flattened_conv(sd, "output_layer.3",
                                                     512, 7, 7)
    _, stats["output_features"] = _bn(sd, "output_layer.4", scale_free=True)
    return {"params": params, "batch_stats": stats}


def convert_magface(sd: Dict[str, np.ndarray], layers=(2, 2, 2, 2)
                    ) -> Dict[str, Any]:
    """MagFace checkpoint state_dict: the iresnet under
    `module.features.`; every other key (the margin head's
    `module.fc.weight`) is dropped."""
    stripped = {k[len("module.features."):]: v for k, v in sd.items()
                if k.startswith("module.features.")}
    return convert_iresnet(stripped, layers)


# ------------------------------------------------------------- text tower --

def convert_bert_encoder(sd: Dict[str, np.ndarray],
                         num_layers: Optional[int] = None) -> Dict[str, Any]:
    """HF torch BertModel state_dict (a `bert.` prefix is dropped) -> the
    post-LN TransformerEncoder's params; num_layers from the keys when not
    given. Keys the encoder does not hold (the pooler) are ignored."""
    sd = {re.sub(r"^bert\.", "", k): v for k, v in sd.items()}
    if num_layers is None:
        num_layers = max(int(m.group(1)) for k in sd
                         if (m := re.match(r"encoder\.layer\.(\d+)\.", k))) + 1
    p: Dict[str, Any] = {
        "tok_emb": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "pos_emb": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "emb_ln": {"scale": sd["embeddings.LayerNorm.weight"],
                   "bias": sd["embeddings.LayerNorm.bias"]},
    }
    if "embeddings.token_type_embeddings.weight" in sd:  # absent in BLIP
        p["type_emb"] = {
            "embedding": sd["embeddings.token_type_embeddings.weight"]}
    for i in range(num_layers):
        t = f"encoder.layer.{i}"
        p[f"layer_{i}"] = {
            "attn": {
                "qkv": _qkv_fused(sd, f"{t}.attention.self.query",
                                  f"{t}.attention.self.key",
                                  f"{t}.attention.self.value"),
                "out": _dense(sd, f"{t}.attention.output.dense"),
            },
            "attn_ln": {"scale": sd[f"{t}.attention.output.LayerNorm.weight"],
                        "bias": sd[f"{t}.attention.output.LayerNorm.bias"]},
            "ffn_in": _dense(sd, f"{t}.intermediate.dense"),
            "ffn_out": _dense(sd, f"{t}.output.dense"),
            "ffn_ln": {"scale": sd[f"{t}.output.LayerNorm.weight"],
                       "bias": sd[f"{t}.output.LayerNorm.bias"]},
        }
    return {"params": p}


def _n_layers(sd, pattern: str) -> int:
    return max(int(m.group(1)) for k in sd if (m := re.match(pattern, k))) + 1


def convert_clip_text_encoder(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """HF torch CLIPTextModel / GroupViTTextModel state_dict (a
    `text_model.` prefix is dropped) -> the pre-LN, causal TransformerEncoder's
    params: embeddings.{token,position}_embedding, encoder.layers.N.
    {self_attn.{q,k,v,out}_proj, layer_norm1, layer_norm2, mlp.fc{1,2}},
    final_layer_norm. Keys the encoder does not hold (position_ids) are
    ignored."""
    sd = {re.sub(r"^text_model\.", "", k): v for k, v in sd.items()}
    p: Dict[str, Any] = {
        "tok_emb": {"embedding": sd["embeddings.token_embedding.weight"]},
        "pos_emb": {"embedding": sd["embeddings.position_embedding.weight"]},
        "final_ln": _ln(sd, "final_layer_norm"),
    }
    for i in range(_n_layers(sd, r"encoder\.layers\.(\d+)\.")):
        t = f"encoder.layers.{i}"
        p[f"layer_{i}"] = {
            "attn": {
                "qkv": _qkv_fused(sd, f"{t}.self_attn.q_proj",
                                  f"{t}.self_attn.k_proj",
                                  f"{t}.self_attn.v_proj"),
                "out": _dense(sd, f"{t}.self_attn.out_proj"),
            },
            "attn_ln": _ln(sd, f"{t}.layer_norm1"),
            "ffn_ln": _ln(sd, f"{t}.layer_norm2"),
            "ffn_in": _dense(sd, f"{t}.mlp.fc1"),
            "ffn_out": _dense(sd, f"{t}.mlp.fc2"),
        }
    return {"params": p}


def convert_flava_text_encoder(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """HF torch FlavaTextModel state_dict -> the pre-LN TransformerEncoder's
    params with emb_ln and final_ln: BERT's embeddings over ViT blocks
    (encoder.layer.N.{attention.attention.{query,key,value},
    attention.output.dense, layernorm_before, layernorm_after,
    intermediate.dense, output.dense}) and a trailing `layernorm`. The
    pooler is ignored."""
    p: Dict[str, Any] = {
        "tok_emb": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "pos_emb": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "type_emb": {"embedding":
                     sd["embeddings.token_type_embeddings.weight"]},
        "emb_ln": _ln(sd, "embeddings.LayerNorm"),
        "final_ln": _ln(sd, "layernorm"),
    }
    for i in range(_n_layers(sd, r"encoder\.layer\.(\d+)\.")):
        t = f"encoder.layer.{i}"
        p[f"layer_{i}"] = {
            "attn": {
                "qkv": _qkv_fused(sd, f"{t}.attention.attention.query",
                                  f"{t}.attention.attention.key",
                                  f"{t}.attention.attention.value"),
                "out": _dense(sd, f"{t}.attention.output.dense"),
            },
            "attn_ln": _ln(sd, f"{t}.layernorm_before"),
            "ffn_ln": _ln(sd, f"{t}.layernorm_after"),
            "ffn_in": _dense(sd, f"{t}.intermediate.dense"),
            "ffn_out": _dense(sd, f"{t}.output.dense"),
        }
    return {"params": p}


def convert_hf_text_model(sd: Dict[str, np.ndarray],
                          bert_type: str) -> Dict[str, Any]:
    """Raw HF torch text-model state_dict -> the TransformerEncoder's
    params, by bert_type (the reference's models/models.py:123-140)."""
    if bert_type in ("bert", "align", "blip"):
        return convert_bert_encoder(sd)
    if bert_type == "falva":
        return convert_flava_text_encoder(sd)
    if bert_type in ("clip", "groupvit"):
        return convert_clip_text_encoder(sd)
    raise ValueError(f"unknown bert_type {bert_type!r}")


def convert_text_encoder_bundle(sd: Dict[str, np.ndarray],
                                bert_type: str = "bert") -> Dict[str, Any]:
    """The reference TextEncoder's state_dict (the HF model under
    `model.`) -> the TextEncoder's params ({'params': {'model': ...}})."""
    sd = strip_module(sd)
    sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items()}
    tree = convert_hf_text_model(sd, bert_type)
    return {"params": {"model": tree["params"]}}


# ------------------------------------------------------ trained-head layers --
# The reference trainers' checkpoints: the stage-1 text {'model', 'head'}
# and image {'image_head'} bundles and the stage-2 {'net', ...} bundle.

def _dense_from_conv1x1(sd, name):
    """torch Conv2d(C_in, C_out, 1) -> a Dense over the channel axis."""
    w = sd[f"{name}.weight"]                      # (O, I, 1, 1)
    return {"kernel": w[:, :, 0, 0].T, "bias": sd[f"{name}.bias"]}


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _ln_chw(sd, name):
    """torch LayerNorm([C, H, W]) affine -> LayerNormCHW's (H, W, C)."""
    return {"scale": sd[f"{name}.weight"].transpose(1, 2, 0),
            "bias": sd[f"{name}.bias"].transpose(1, 2, 0)}


def _sa(sd, name):
    """The reference SelfAttention's three 1x1 convs -> SelfAttention2D's
    Dense projections."""
    return {"query_proj": _dense_from_conv1x1(sd, f"{name}.query_proj"),
            "key_proj": _dense_from_conv1x1(sd, f"{name}.key_proj"),
            "value_proj": _dense_from_conv1x1(sd, f"{name}.value_proj")}


def convert_text_heading(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference TextHeading: Bert_Word_Mapping's Conv2d(1, F, (K, E))
    kernels -> the window-stacked Dense kernels. The Conv2d weight
    (F, 1, K, E) contracts token window x embedding; the window stacking
    orders features [offset0-emb, offset1-emb, ...], row k*E + e, which is
    torch's (K, E) row-major flatten."""
    sd = strip_module(sd)
    p: Dict[str, Any] = {"bwm": {}}
    for idx, k in enumerate((2, 3, 4)):
        w = sd[f"bwm.convs1.{idx}.weight"]        # (F, 1, K, E)
        p["bwm"][f"conv_k{k}"] = {
            "kernel": w.reshape(w.shape[0], -1).T,  # (K*E, F)
            "bias": sd[f"bwm.convs1.{idx}.bias"],
        }
    return {"params": p}


def convert_image_heading(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference ImageHeading with its IMIM."""
    sd = strip_module(sd)
    imim: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    imim["bn_img"], stats["bn_img"] = _bn(sd, "imim.bn_img")
    imim["sa"] = _sa(sd, "imim.sa")
    imim["ln"] = _ln_chw(sd, "imim.ln")
    imim["conv1x1_1"] = {"kernel": _conv(sd, "imim.conv1x1_1"),
                         "bias": sd["imim.conv1x1_1.bias"]}
    imim["conv1x1_2"] = {"kernel": _conv(sd, "imim.conv1x1_2"),
                         "bias": sd["imim.conv1x1_2.bias"]}
    imim["project_local"] = {
        "projection": _dense(sd, "imim.project_local.projection")}
    params = {
        "imim": imim,
        "project_global": {
            "projection": _dense(sd, "project_global.projection")},
    }
    return {"params": params, "batch_stats": {"imim": stats}}


def convert_fcfm(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference `Working` FCFM. Its 324 -> 128 linear eats a flattened
    (C, H, W) map, and FCFM flattens in that order too, so the kernel
    converts as a plain dense."""
    sd = strip_module(sd)
    params: Dict[str, Any] = {
        "conv": {"kernel": _conv(sd, "conv"), "bias": sd["conv.bias"]},
        "projection": _dense(sd, "projection"),
        "sa": _sa(sd, "sa"),
        "linear": _dense(sd, "linear"),
        "ln": _ln_chw(sd, "ln"),
        "ln_gl_image": _ln(sd, "ln_gl_image"),
        "ln_sent": _ln(sd, "ln_sent"),
    }
    stats: Dict[str, Any] = {}
    params["bn_img"], stats["bn_img"] = _bn(sd, "bn_img")
    params["bn_word"], stats["bn_word"] = _bn(sd, "bn_word")
    return {"params": params, "batch_stats": stats}


def convert_linear_fusion(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference LinearFusion. Its `ln` member is never called in its
    forward and is dropped."""
    sd = strip_module(sd)
    return {"params": {"fc1": _dense(sd, "fc1")}}


def convert_wordlevel_cfa(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference WordLevelCFA_LSTM. Its `conv` and `bn_img` members are
    never called in its forward and are dropped; `ln1` converts, though
    its output is dropped too (the module keeps that)."""
    sd = strip_module(sd)
    return {"params": {
        "sa": _sa(sd, "sa"),
        "ln1": _ln_chw(sd, "ln1"),
        "ln2": _ln_chw(sd, "ln2"),
        "linear": _dense(sd, "linear"),
    }}


def convert_rnn_encoder(sd: Dict[str, np.ndarray],
                        en_type: str = "LSTM") -> Dict[str, Any]:
    """The reference RNNEncoder (Embedding `encoder` and a one-layer
    bidirectional nn.LSTM / nn.GRU `rnn`) -> the RNNEncoder tree: the
    embedding, and per direction (`fwd`, `_reverse` -> `bwd`) one kernel
    per gate and side (see the module docstring for the biases)."""
    sd = strip_module(sd)
    p: Dict[str, Any] = {"encoder": {"embedding": sd["encoder.weight"]}}
    lstm = en_type.upper() == "LSTM"
    gates = ("i", "f", "g", "o") if lstm else ("r", "z", "n")
    for suffix, ours in (("", "fwd"), ("_reverse", "bwd")):
        wi = sd[f"rnn.weight_ih_l0{suffix}"]
        wh = sd[f"rnn.weight_hh_l0{suffix}"]
        bi = sd[f"rnn.bias_ih_l0{suffix}"]
        bh = sd[f"rnn.bias_hh_l0{suffix}"]
        h = wh.shape[1]
        cell: Dict[str, Any] = {}
        for gi, g in enumerate(gates):
            sl = slice(gi * h, (gi + 1) * h)
            if lstm:
                cell[f"i{g}"] = {"kernel": wi[sl].T}
                cell[f"h{g}"] = {"kernel": wh[sl].T, "bias": bi[sl] + bh[sl]}
            elif g == "n":
                cell["in"] = {"kernel": wi[sl].T, "bias": bi[sl]}
                cell["hn"] = {"kernel": wh[sl].T, "bias": bh[sl]}
            else:
                cell[f"i{g}"] = {"kernel": wi[sl].T, "bias": bi[sl] + bh[sl]}
                cell[f"h{g}"] = {"kernel": wh[sl].T}
        p[ours] = cell
    return {"params": p}
