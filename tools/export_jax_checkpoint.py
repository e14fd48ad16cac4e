"""Export a checkpoint of the JAX package (an Orbax directory) to `.npz`.

The PyTorch port reads no Orbax: this tool runs where JAX is, restores the
checkpoint with the JAX package's own loaders, and writes one `.npz` whose
keys are the tree's `/`-joined paths, which the port reads
(`engine/checkpoint.load_jax_export`):

  JAX_PLATFORMS=cpu python tools/export_jax_checkpoint.py <ckpt dir> <out>.npz
  JAX_PLATFORMS=cpu python tools/export_jax_checkpoint.py \\
      <run>/train_state_N <out>.npz --cfg cfg/train_bert.yml [--synthetic]

* A weights artifact (the trainers' `*_image_encoder_N`,
  `*_text_encoder_N`, `fusion_*_N`, `encoder_*_N`) is restored target-less
  with `engine/checkpoint.load_checkpoint`, which also restores a
  checkpoint written on a TPU; its keys are the tree's own (`model/params/...`,
  `image_head/batch_stats/...`, `net/params/...`).
* A train state (`train_state_N`) needs the run's configuration (`--cfg`
  and the same overrides the run had): the tool builds the stage's JAX
  trainer from it and restores the state through
  `engine/checkpoint.load_train_state` with the `like` tree that the
  trainer's `resume_from` builds, so every legacy optimizer format that the
  JAX package migrates comes out in the current one. The optimizer's
  per-group state is unstacked (or unflattened) onto the parameter tree.
  Keys: `params/...`, `batch_stats/...`, `meta/epoch`, `meta/lr/<group>`,
  `opt/<group>/count` (Adam's step count, or the group's count without
  Adam) and `opt/<group>/{mu,nu,trace}/<parameter path>`. A group with no
  state (the frozen encoder of `compat_frozen_text`) is left out. Each
  group's learning rate in the optimizer state must equal `meta/lr`.

bfloat16 leaves (Adam moments in `adam_moments_dtype: bfloat16`) are
written as float32, which holds them exactly. The tool imports the JAX
package and nothing of the port.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

__all__ = ["export", "export_weights", "export_train_state", "main"]

_STD = (np.float16, np.float32, np.float64, np.int8, np.int16, np.int32,
        np.int64, np.uint8, np.uint16, np.uint32, np.uint64, np.bool_)


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a if a.dtype.type in _STD else a.astype(np.float32)


def _flat(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """`tree`'s leaves under `/`-joined keys (empty subtrees vanish)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif hasattr(tree, "shape") or np.isscalar(tree):
        out[prefix] = _np(tree)


def _write(out_path: str, flat: Dict[str, np.ndarray]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = f"{out_path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, out_path)
    return out_path


def export_weights(path: str, out_path: str, tree=None) -> str:
    """A weights artifact at `path` (or its restored `tree`) to `.npz`."""
    if tree is None:
        from text_guided_face_recognition_tpu.engine.checkpoint import (
            load_checkpoint)
        tree = load_checkpoint(path)
    flat: Dict[str, np.ndarray] = {}
    _flat(tree, "", flat)
    return _write(out_path, flat)


def _group_states(opt_state) -> Dict[str, Any]:
    """{group: its optimizer state} of the stacked / flat ({group: state})
    or multi_transform (`inner_states`, masked) layouts."""
    if isinstance(opt_state, dict):
        return dict(opt_state)
    return {g: w.inner_state if type(w).__name__ == "MaskedState" else w
            for g, w in opt_state.inner_states.items()}


def _on_params(tree, group_params, args):
    """A group's moment or trace tree on its parameters' tree: unstacked
    (stacked_optimizer), unflattened (fused_optimizer) or the group's
    subtrees of multi_transform's whole-tree state."""
    import jax

    from text_guided_face_recognition_tpu.engine import optim
    if getattr(args, "stacked_optimizer", False):
        max_elems = int(getattr(args, "stack_max_elems", 0) or 0)
        return optim._unstack_tree(tree, group_params, max_elems)
    if getattr(args, "fused_optimizer", False):
        leaves, treedef = jax.tree_util.tree_flatten(group_params)
        sizes = np.cumsum([np.size(x) for x in leaves])[:-1]
        parts = np.split(np.asarray(tree), sizes)
        return jax.tree_util.tree_unflatten(treedef, [
            p.reshape(x.shape) for p, x in zip(parts, leaves)])
    return {k: tree[k] for k in group_params}


def _optimizer(opt_state, params, group_of, lrs, args
               ) -> Dict[str, Dict[str, Any]]:
    """{group: {count, mu / nu / trace on the parameter tree}}; checks each
    group's learning rate against `lrs` (meta/lr)."""
    from text_guided_face_recognition_tpu.engine import optim
    parts = optim._partition(params, group_of)
    out: Dict[str, Dict[str, Any]] = {}
    for g, gs in _group_states(opt_state).items():
        inj = next((s for n in ("InjectHyperparamsState",
                                "InjectStatefulHyperparamsState")
                    if (s := optim._find_one(gs, n)) is not None), None)
        adam = optim._find_one(gs, "ScaleByAdamState")
        trace = optim._find_one(gs, "TraceState")
        if inj is None and adam is None and trace is None:
            continue                        # a frozen group: no state
        if inj is not None:
            lr = float(np.float32(inj.hyperparams["learning_rate"]))
            if g in lrs and lr != float(np.float32(lrs[g])):
                raise ValueError(f"group {g!r}: the optimizer state's "
                                 f"learning rate {lr} != meta/lr "
                                 f"{float(lrs[g])}")
        count = adam.count if adam is not None else inj.count
        st: Dict[str, Any] = {"count": np.asarray(count, np.int32)}
        gp = parts.get(g, {})
        if adam is not None:
            st["mu"] = _on_params(adam.mu, gp, args)
            st["nu"] = _on_params(adam.nu, gp, args)
        if trace is not None:
            st["trace"] = _on_params(trace.trace, gp, args)
        out[g] = st
    return out


def export_train_state(path: str, out_path: str, args, stage2: bool) -> str:
    """A train state at `path` (of stage 2, or 1) to `.npz`, restored as
    the JAX trainers' `resume_from` restores it, from the run's
    configuration `args` (the JAX package's TGFRConfig)."""
    from text_guided_face_recognition_tpu.engine import optim
    from text_guided_face_recognition_tpu.engine.checkpoint import (
        load_train_state)
    if stage2:
        from text_guided_face_recognition_tpu.engine.stage2 import (
            FusionTrainer as Trainer)
        tx_maker, group_of = optim.make_stage2_tx, optim._stage2_group
    else:
        from text_guided_face_recognition_tpu.engine.stage1 import (
            Stage1Trainer as Trainer)
        tx_maker = (optim.make_stage1_bert_tx if args.en_type == "BERT"
                    else optim.make_stage1_lstm_tx)
        group_of = optim._stage1_group
    import jax.numpy as jnp
    tr = Trainer(args)
    like = {"params": tr.state.params,
            "batch_stats": tr.state.batch_stats,
            "opt_state": tr.state.opt_state,
            "meta": {"epoch": jnp.asarray(0),
                     "lr": {k: jnp.asarray(v) for k, v in tr.lr.items()}}}
    tree = load_train_state(path, like, args, tx_maker, tr.state.params,
                            group_of)
    lrs = {k: np.asarray(v) for k, v in tree["meta"]["lr"].items()}
    flat: Dict[str, np.ndarray] = {}
    _flat(tree["params"], "params", flat)
    _flat(tree["batch_stats"], "batch_stats", flat)
    _flat({"epoch": tree["meta"]["epoch"], "lr": lrs}, "meta", flat)
    _flat(_optimizer(tree["opt_state"], tree["params"], group_of, lrs, args),
          "opt", flat)
    return _write(out_path, flat)


def export(path: str, out_path: str, args=None) -> str:
    """A weights artifact or (with `args`) a train state to `.npz`."""
    from text_guided_face_recognition_tpu.engine.checkpoint import (
        load_checkpoint)
    tree = load_checkpoint(path)
    if "opt_state" not in tree:
        return export_weights(path, out_path, tree)
    if args is None:
        raise ValueError(f"{path} is a train state: pass the run's --cfg "
                         "(and its overrides) to rebuild its trainer")
    return export_train_state(path, out_path, args,
                              "fusion_net" in tree["params"])


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="the Orbax checkpoint directory")
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--cfg", dest="cfg_file", default=None,
                    help="the run's yml (a train state needs it)")
    ap.add_argument("--synthetic", action="store_true", default=None)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--bert_type", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--compute_dtype", default=None)
    ns = ap.parse_args(argv)
    import jax
    if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
        jax.config.update("jax_platforms", "cpu")
    args = None
    if ns.cfg_file:
        from text_guided_face_recognition_tpu.config import merge_args_yaml
        args = merge_args_yaml(argparse.Namespace(
            **{k: v for k, v in vars(ns).items()
               if k not in ("path", "out")}))
    out = export(ns.path, ns.out, args)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
