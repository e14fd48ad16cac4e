"""Typed configuration for the port.

Counterpart of text_guided_face_recognition_tpu/config.py, cut to the fields
the ported paths read (serving, stage-1 training, stage-2 fusion training,
with en_type BERT, LSTM or GRU): every cfg/*.yml
still loads unchanged, and any key without a field here lands in `extras`,
attribute-accessible. Values are coerced to their declared types at load
time; a closed string option with an unknown value fails at construction.

Accepted and ignored (N/A; they land in `extras`): TPU-only knobs that
change how the JAX package schedules the same math on a TPU, not the math:
`stacked_optimizer`, `fused_optimizer`, `stack_max_elems` (how optimizer
updates are batched; the port always runs one multi-tensor update per
group and dtype, engine/optim.py), `xla_opts`, `xla_opts_stage2` (XLA
compiler options), `prng_impl` (which PRNG draws the host dropout bits;
the keep rule is the same), `rnn_unroll` (the unroll factor of the JAX
package's lax.scan over caption steps; the port's RNN is one Python loop
over them, captured whole in the train step's CUDA graph) and the JAX
compile cache. `lazy_embedding_adam`
keeps the JAX package's meaning (the row-sparse update of the embedding
table, engine/optim.py).

`num_devices` (`check_world`, from `check_stage1`, `check_stage2` and
`check_serving`): 0 is the launcher's world size (torchrun's WORLD_SIZE;
1 without a launcher, parallel/mesh.py), any other value must equal it;
training refuses a `batch_size` the ranks do not split evenly. (The JAX
package instead shrinks its mesh until it divides the batch; a launched
world cannot shrink.) `check_stage2` also refuses `fusion_type: concat`
(nothing to train, as the JAX trainer refuses it too). Refused with
ValueError as no model takes them (`check_fusion`, from both and from
`check_serving`): `fusion_type: fcfm`
with en_type GRU (the reference and the JAX package build the LSTM's
fusion net for LSTM only and the BERT one otherwise, which takes no RNN
words), and in stage 2 with en_type LSTM a `fusion_final_dim` other than
768, the width of WordLevelCFA_LSTM's output that the margin head takes.
Both, and `check_serving` at the serving entries, refuse captions longer
than the text arch's position table (`check_caption_length`; the block
kernels take every length it holds), and a backbone the port does not
build (`check_backbone`: AdaFace takes 112 x 112 images only).
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml

__all__ = ["TGFRConfig", "TrainCfg", "TrainSmooth", "check_backbone",
           "check_caption_length", "check_fusion",
           "check_serving", "check_stage1", "check_stage2",
           "check_world",
           "load_yaml", "merge_args_yaml"]

_NUM_PREFIX = re.compile(r"^\s*([+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)")


def _coerce(name: str, value: Any, typ: type) -> Any:
    """Coerce `value` to `typ`, tolerating the reference's YAML typos."""
    if value is None:
        return None
    if typ is float:
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            m = _NUM_PREFIX.match(value)
            if m:
                warnings.warn(
                    f"config field {name!r}: coerced malformed value {value!r} "
                    f"to float {m.group(1)} (reference-compat leniency)")
                return float(m.group(1))
        raise TypeError(f"config field {name!r}: cannot coerce {value!r} to float")
    if typ is int:
        if isinstance(value, bool):
            raise TypeError(f"config field {name!r}: got bool, expected int")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value == int(value):
            return int(value)
        if isinstance(value, str) and value.strip().lstrip("+-").isdigit():
            return int(value.strip())
        raise TypeError(f"config field {name!r}: cannot coerce {value!r} to int")
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise TypeError(f"config field {name!r}: cannot coerce {value!r} to bool")
    if typ is str:
        return str(value)
    return value


@dataclass
class TrainSmooth:
    """DAMSM smoothing temperatures (`TRAIN.SMOOTH` in the YAMLs)."""

    GAMMA1: float = 4.0
    GAMMA2: float = 5.0
    GAMMA3: float = 10.0


@dataclass
class TrainCfg:
    FLAG: bool = True
    SMOOTH: TrainSmooth = field(default_factory=TrainSmooth)


@dataclass
class TGFRConfig:
    """The flag surface of the ported paths, one namespace; defaults follow
    the JAX package's (cfg/train_bert.yml)."""

    # --- paths / artifacts ---
    CONFIG_NAME: str = "Train"
    dataset_name: str = "face2text"
    data_dir: str = "./data/face2text"
    checkpoints_path: str = "./checkpoints"
    weights_adaface: str = "./weights/pretrained/adaface_ir18_webface4m.ckpt"
    weights_arcface: str = "./weights/pretrained/arcface_ir18_ms1mv3.pth"
    weights_magface: str = "./weights/pretrained/magface_iresnet18_casia_dp.pth"
    valid_pair_list: str = "./data/face2text/images/valid_199_sub.txt"
    test_pair_list: str = "./data/face2text/images/test_199_sub.txt"
    text_encoder_path: str = ""
    image_encoder_path: str = ""
    fusion_net_path: str = ""
    resume_epoch: int = 1
    resume_model_path: str = ""

    # --- machine ---
    num_workers: int = 8
    manual_seed: int = 100
    cpu: bool = False      # run on the CPU; otherwise the CUDA card or an error
    num_devices: int = 0   # 0: the launcher's world size (torchrun; 1 without); else it must equal it

    # --- stage-1 losses (graph gates + weights) ---
    is_DAMSM: bool = True
    is_CLIP: bool = True
    is_CMP: bool = False
    is_WRA: bool = False
    is_ident_loss: bool = True
    lambda_clip: float = 2.0
    lambda_id: float = 100.0

    # --- model arch ---
    aux_feat_dim_per_granularity: int = 256
    img_size: int = 112
    model_type: str = "arcface"            # the frozen backbone: arcface | adaface | magface
    ch_size: int = 3
    num_classes: int = 4500

    # --- optimisation ---
    init_lr_bert: float = 7e-5
    min_lr_bert: float = 2e-5
    init_lr_lstm: float = 1e-3             # stage 1, en_type LSTM/GRU: the encoder's first rate
    lr_head: float = 1e-3
    lr_image_train: float = 0.1            # stage 2: metric_fc's SGD
    weight_decay: float = 0.01             # stage 1: encoder Adam; stage 2: metric_fc's SGD
    clip_max_norm: float = 1.0
    apply_grad_clip: bool = False          # False: the reference's behaviour, no clip (its clip runs after the step)

    # --- schedule ---
    batch_size: int = 32
    max_epoch: int = 20
    test_interval: int = 2
    save_interval: int = 1
    TRAIN: TrainCfg = field(default_factory=TrainCfg)

    # --- encoder selection ---
    en_type: str = "BERT"                  # BERT | LSTM | GRU
    bert_words_num: int = 24
    lstm_words_num: int = 18
    embedding_dim: int = 256               # LSTM/GRU: both directions' hidden units
    vocab_size: int = 0                    # LSTM/GRU: filled from the corpus by prepare_dataloader
    captions_per_image: int = 4
    bert_type: str = "bert"
    # the HF tokenizer of each bert_type (data/tokenizers.get_bert_tokenizer)
    bert_config: str = "bert-base-uncased"
    align_config: str = "kakaobrain/align-base"
    clip_config: str = "openai/clip-vit-base-patch32"
    blip_config: str = "Salesforce/blip-image-captioning-base"
    falva_config: str = "facebook/flava-full"  # (sic) the reference's name
    groupvit_config: str = "nvidia/groupvit-gcc-yfcc"

    # --- fusion arch ---
    fusion_type: str = "fcfm"  # fcfm | linear | concat
    fusion_final_dim: int = 640
    easy_margin: bool = False              # stage 2: ArcFace easy margin
    loss: str = "focal_loss"               # stage 2: focal_loss (arcface) | anything else: cross entropy
    do_test: bool = False                  # stage 2: run_test on the valid split after epoch 20

    # --- eval / dumps ---
    roc_file: str = "roc"
    is_roc: bool = False
    is_ident: bool = False
    test_sub: int = 1193

    # --- runtime ---
    cfg_file: Optional[str] = None
    synthetic: bool = False                # generated images/captions
    compute_dtype: str = "bfloat16"        # activation dtype of every model
    fused_ln: bool = False                 # text-tower LayerNorms through the CUDA kernel (ops/layernorm.py)
    fused_block: str = "none"              # text tower through the CUDA kernels (ops/block.py): none | ffn | attn | both (half-layers) | tower (all layers, one launch each way)
    fused_dropout: bool = False            # true: every dropout site from the step's host bits; false: the fused kernels draw theirs in-kernel from seeds (ops/philox.py)
    uint8_images: bool = False             # ship uint8 images; the device normalises (ops/images.py)
    eval_table_mode: bool = False          # run_test through a deduplicated per-sample embedding table
    current_epoch: int = 0
    len_train_dl: int = 0
    compat_frozen_text: bool = False       # reproduce the reference's no-grad text path
    compat_bert_caption_bug: bool = False  # reproduce the reference's caption index (sent_ix, not index * captions_per_image + sent_ix)
    max_steps: int = 0                     # >0: cap steps per epoch (smoke runs)
    keep_last_ckpts: int = 0               # >0: retain only the newest K epoch artifacts
    use_pallas: bool = False               # DAMSM similarity through the CUDA kernel (ops/damsm.py)
    adam_moments_dtype: str = "bfloat16"   # Adam moment storage dtype (engine/optim.py)
    grads_dtype: str = "float32"           # gradients rounded to this dtype before the optimizers
    lazy_embedding_adam: bool = False      # row-sparse Adam for the encoder's embedding table (engine/optim.py)
    frozen_feature_cache: bool = False     # the frozen backbone once an epoch over the train split (engine/feature_cache.py), out of the step
    feature_cache_batch: int = 256         # frozen_feature_cache: the backbone's batch

    # Anything else found in a YAML lands here and is still attribute-accessible.
    extras: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        extras = object.__getattribute__(self, "extras")
        if name in extras:
            return extras[name]
        raise AttributeError(f"TGFRConfig has no field {name!r}")

    def __post_init__(self) -> None:
        # Closed string options: a typo must fail here, not select another
        # path silently.
        _enums = {
            "fused_block": ("none", "ffn", "attn", "both", "tower"),
            "compute_dtype": ("float32", "bfloat16"),
            "adam_moments_dtype": ("float32", "bfloat16"),
            "grads_dtype": ("float32", "bfloat16"),
            "en_type": ("BERT", "LSTM", "GRU"),
        }
        for name, allowed in _enums.items():
            val = getattr(self, name)
            if val not in allowed:
                raise ValueError(f"{name}={val!r} is not one of {allowed}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TGFRConfig":
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        extras: Dict[str, Any] = {}
        for key, value in d.items():
            if key == "TRAIN" and isinstance(value, dict):
                smooth = value.get("SMOOTH", {}) or {}
                kwargs["TRAIN"] = TrainCfg(
                    FLAG=_coerce("TRAIN.FLAG", value.get("FLAG", True), bool),
                    SMOOTH=TrainSmooth(**{
                        g: _coerce(f"TRAIN.SMOOTH.{g}", smooth.get(g, dv),
                                   float)
                        for g, dv in (("GAMMA1", 4.0), ("GAMMA2", 5.0),
                                      ("GAMMA3", 10.0))}))
            elif key in known and key != "extras":
                typ = {"int": int, "float": float, "bool": bool,
                       "str": str}.get(str(known[key].type))
                kwargs[key] = _coerce(key, value, typ) if typ else value
            elif key != "extras":
                extras[key] = value
        extras.update(d.get("extras") or {})
        cfg = cls(**kwargs)
        cfg.extras.update(extras)
        return cfg

    def replace(self, **updates: Any) -> "TGFRConfig":
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        return d


def check_caption_length(cfg: TGFRConfig) -> None:
    """Refuse, before any step, captions longer than `bert_type`'s position
    table (`max_positions`: 77 for clip and groupvit, 512 for the others),
    whatever the mode: the card's embedding lookup would stop on a
    device-side assert (the JAX package reads NaN rows there). The block
    kernels (`fused_block`, ops/block.py) take every length the table
    holds, serving and training, bf16 and f32. An LSTM or GRU caption has
    no position table."""
    if cfg.en_type != "BERT":
        return
    from text_guided_face_recognition_tpu_torch.models.text_bert import (
        TEXT_ARCHS)
    arch = TEXT_ARCHS[cfg.bert_type]
    if cfg.bert_words_num > arch.max_positions:
        raise ValueError(
            f"bert_words_num={cfg.bert_words_num}: bert_type="
            f"{cfg.bert_type!r} has {arch.max_positions} positions; use "
            f"bert_words_num <= {arch.max_positions}.")


def check_backbone(cfg: TGFRConfig) -> None:
    """Refuse, before any step, a backbone the port does not build: a
    model_type other than arcface, adaface or magface, and AdaFace at
    another image size than 112 (its output_fc takes the 512 x 7 x 7 map
    of 112 x 112 input, as the reference's does)."""
    if cfg.model_type not in ("arcface", "adaface", "magface"):
        raise ValueError(f"model_type={cfg.model_type!r} is not one of "
                         "arcface, adaface, magface")
    if cfg.model_type == "adaface" and cfg.img_size != 112:
        raise ValueError(f"model_type='adaface' with img_size={cfg.img_size}"
                         ": the AdaFace backbone takes 112 x 112 images")


def check_fusion(cfg: TGFRConfig, train: bool) -> None:
    """Refuse, before any step, a fusion no model takes: fcfm with GRU
    captions, and (`train`, stage 2) fcfm with LSTM captions unless the
    margin head is as wide as WordLevelCFA_LSTM's 768-wide output."""
    if cfg.fusion_type != "fcfm" or cfg.en_type == "BERT":
        return
    if cfg.en_type == "GRU":
        raise ValueError(
            "fusion_type='fcfm' with en_type='GRU': the fcfm net of RNN "
            "captions (WordLevelCFA_LSTM) is built for en_type LSTM only, as "
            "in the reference and the JAX package; use fusion_type linear "
            "or concat")
    if train and cfg.fusion_final_dim != 768:
        raise ValueError(
            f"fusion_type='fcfm' with en_type='LSTM' and fusion_final_dim="
            f"{cfg.fusion_final_dim}: WordLevelCFA_LSTM's output is 768 "
            "wide, and the margin head takes fusion_final_dim; set "
            "fusion_final_dim: 768")


def check_world(cfg: TGFRConfig, world: Optional[int] = None,
                batch: bool = True) -> int:
    """The world size the run takes, refusing before any step a
    `num_devices` other than 0 and the world size, and (`batch`, the
    trainers) a `batch_size` the ranks do not split evenly. `world`
    defaults to the process group's (parallel/mesh.py; 1 without one)."""
    if world is None:
        from text_guided_face_recognition_tpu_torch.parallel import mesh
        world = mesh.world_size()
    if cfg.num_devices and cfg.num_devices != world:
        raise ValueError(
            f"num_devices={cfg.num_devices} but the run has {world} "
            f"rank(s): launch one process per device with torchrun "
            f"--nproc_per_node {cfg.num_devices}, or set num_devices: 0 "
            "(the launcher's world size)")
    if batch and cfg.batch_size % world:
        raise ValueError(
            f"batch_size={cfg.batch_size} does not split evenly over "
            f"{world} ranks: each rank takes batch_size / world rows of the "
            "global batch; choose a batch_size divisible by the world size "
            "(the JAX package would shrink its mesh instead)")
    return world


def check_serving(cfg: TGFRConfig) -> None:
    """Refuse the serving options the port does not run yet (evaluation
    and embedding extraction)."""
    check_world(cfg, batch=False)
    check_backbone(cfg)
    check_caption_length(cfg)
    check_fusion(cfg, train=False)


def check_stage1(cfg: TGFRConfig) -> None:
    """Refuse the stage-1 options the port does not run yet."""
    check_world(cfg)
    check_backbone(cfg)
    check_caption_length(cfg)


def check_stage2(cfg: TGFRConfig) -> None:
    """Refuse the stage-2 options the port does not run yet."""
    check_world(cfg)
    check_backbone(cfg)
    check_caption_length(cfg)
    if cfg.fusion_type == "concat":
        raise ValueError("stage-2 training requires fusion_type linear|fcfm")
    check_fusion(cfg, train=True)


def load_yaml(filename: str) -> TGFRConfig:
    """Load one YAML config file."""
    with open(filename, "r") as f:
        raw = yaml.safe_load(f) or {}
    return TGFRConfig.from_dict(raw)


def merge_args_yaml(args: Any) -> TGFRConfig:
    """Merge an argparse namespace over its `cfg_file` YAML; argparse values
    that are not None win."""
    opt = {k: v for k, v in vars(args).items() if v is not None}
    cfg_file = opt.get("cfg_file")
    cfg = load_yaml(cfg_file) if cfg_file else TGFRConfig()
    d = cfg.to_dict()
    d.update(opt)
    return TGFRConfig.from_dict(d)
