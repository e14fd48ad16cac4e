"""Typed configuration for the port.

Counterpart of text_guided_face_recognition_tpu/config.py, cut to the fields
the ported path reads: every cfg/*.yml still loads unchanged, and any key
without a field here lands in `extras`, attribute-accessible. Values are
coerced to their declared types at load time; a closed string option with
an unknown value fails at construction.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml

__all__ = ["TGFRConfig", "load_yaml", "merge_args_yaml"]

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
class TGFRConfig:
    """The flag surface of the serving path, one namespace."""

    # --- paths / artifacts ---
    CONFIG_NAME: str = "Train"
    dataset_name: str = "face2text"
    data_dir: str = "./data/face2text"
    checkpoints_path: str = "./checkpoints"
    weights_arcface: str = "./weights/pretrained/arcface_ir18_ms1mv3.pth"
    valid_pair_list: str = "./data/face2text/images/valid_199_sub.txt"
    test_pair_list: str = "./data/face2text/images/test_199_sub.txt"
    text_encoder_path: str = ""
    image_encoder_path: str = ""
    fusion_net_path: str = ""

    # --- machine ---
    num_workers: int = 8
    manual_seed: int = 100
    cpu: bool = False      # run on the CPU; otherwise the CUDA card or an error

    # --- model arch ---
    aux_feat_dim_per_granularity: int = 256
    img_size: int = 112
    model_type: str = "arcface"
    ch_size: int = 3
    num_classes: int = 4500

    # --- schedule ---
    batch_size: int = 32

    # --- encoder selection ---
    en_type: str = "BERT"
    bert_words_num: int = 24
    lstm_words_num: int = 18
    captions_per_image: int = 4
    bert_type: str = "bert"

    # --- fusion arch ---
    fusion_type: str = "fcfm"  # fcfm | linear | concat
    fusion_final_dim: int = 640

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
    fused_block: str = "none"              # text-tower half-layers through the CUDA kernels (ops/block.py): none | ffn | attn | both
    uint8_images: bool = False             # ship uint8 images; the device normalises (ops/images.py)
    eval_table_mode: bool = False          # run_test through a deduplicated per-sample embedding table

    # Anything else found in a YAML lands here and is still attribute-accessible.
    extras: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        extras = object.__getattribute__(self, "extras")
        if name in extras:
            return extras[name]
        raise AttributeError(f"TGFRConfig has no field {name!r}")

    def __post_init__(self) -> None:
        # Closed string options: a typo must fail here, not select another
        # path silently. "tower" is a valid value of the JAX package's
        # config; the port's text encoder rejects it until it is ported.
        _enums = {
            "fused_block": ("none", "ffn", "attn", "both", "tower"),
            "compute_dtype": ("float32", "bfloat16"),
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
            if key in known and key != "extras":
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
