"""The port's utilities and tools against the JAX package's: utils/misc,
utils/logging (MetricLogger), utils/profiling (maybe_profile, StepTimer,
nan_guard), utils/benching (chain_steps, time_chained_steps,
time_chained_forward), tools/parity_check and tools/profile_step, and the
root tools/identify.py on the port's extraction file.

Small sizes: the tiny post-LN BERT of _torch_port.py with dropout off,
iResNet with one block a stage, batch 4. Tolerances: the extraction's
embeddings 1e-4 (tests/test_torch_serving.py's rule); everything else
exact (the same text, the same numbers). No timing inequality is asserted:
the timers must return finite floats, nothing more (a loaded host makes
any bound flaky).
"""

import dataclasses
import importlib.util
import io
import json
import math
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import extract as jextract
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.utils import benching as jbench
from text_guided_face_recognition_tpu.utils import logging as jlogging
from text_guided_face_recognition_tpu.utils import misc as jmisc
from text_guided_face_recognition_tpu.utils import profiling as jprof
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig)
from text_guided_face_recognition_tpu_torch.engine import extract as pextract
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.tools import (
    parity_check as pparity)
from text_guided_face_recognition_tpu_torch.tools import (
    profile_step as pprofile_step)
from text_guided_face_recognition_tpu_torch.utils import benching as pbench
from text_guided_face_recognition_tpu_torch.utils import logging as plogging
from text_guided_face_recognition_tpu_torch.utils import misc as pmisc
from text_guided_face_recognition_tpu_torch.utils import profiling as pprof
from text_guided_face_recognition_tpu_torch.utils.metrics import (
    calculate_scores)

from _torch_port import TINY, close
from test_torch_parallel import STAGE1
from test_torch_serving import _cfg as serving_cfg
from test_torch_serving import _twins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, monkeypatch=None, args_in_sys=False):
    """(exit code, stdout) of a tool's main."""
    out = io.StringIO()
    code = 0
    with redirect_stdout(out):
        try:
            if args_in_sys:
                monkeypatch.setattr(sys, "argv", ["tool"] + argv)
                main()
            else:
                main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


@pytest.fixture
def tiny_port(monkeypatch):
    arch = ptb.TextArch(**TINY)
    monkeypatch.setitem(ptb.TEXT_ARCHS, "tiny0",
                        dataclasses.replace(arch, dropout=0.0))
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))


# ---------------------------------------------------------------- misc --

def test_save_args_writes_the_jax_yml(tmp_path):
    """The same run config dumps to the same yml on both sides; the port's
    config dumps its scalar, string and list fields (extras among them)."""
    class Args:
        def to_dict(self):
            return {"lr_head": 1e-3, "name": "x", "steps": 3, "on": True,
                    "ks": [4, 44], "nested": {"a": 1}, "none": None}

    pmisc.save_args(str(tmp_path / "p.yml"), Args())
    jmisc.save_args(str(tmp_path / "j.yml"), Args())
    assert (tmp_path / "p.yml").read_text() == (tmp_path / "j.yml").read_text()
    cfg = PConfig().replace(batch_size=7)
    cfg.extras.update(profile_dir="/x")
    pmisc.save_args(str(tmp_path / "cfg.yml"), cfg)
    got = yaml.safe_load((tmp_path / "cfg.yml").read_text())
    assert got["batch_size"] == 7 and got["profile_dir"] == "/x"
    assert set(got) == {k for k, v in cfg.to_dict().items()
                        if isinstance(v, (int, float, str, bool, list))}


@pytest.fixture(scope="module")
def twins():
    """tests/test_torch_serving.py's JAX modules, variables and bridged
    port modules (the tiny arch registered while they are built)."""
    from text_guided_face_recognition_tpu.models import text_bert as jtb
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptb.TEXT_ARCHS, "tiny", ptb.TextArch(**TINY))
        mp.setitem(jtb.TEXT_ARCHS, "tiny", jtb.TextArch(**TINY))
        return _twins()


def test_params_count_of_a_bridged_model_is_the_jax_trees(twins):
    """params_count of the port's modules bridged from JAX variables equals
    the JAX package's count of their params trees; a state dict counts
    every tensor in it (its BatchNorm buffers too)."""
    _, jv, ports = twins
    for v, p in zip(jv, ports):
        assert pmisc.params_count(p) == jmisc.params_count(v["params"])
        buffers = sum(b.numel() for b in p.buffers())
        assert pmisc.params_count(p.state_dict()) == \
            jmisc.params_count(v["params"]) + buffers
    assert pmisc.mkdir_p is not None and len(pmisc.get_time_stamp()) == 19


# ------------------------------------------------------------- logging --

def test_metric_logger_writes_and_echoes_as_jax(tmp_path, capsys):
    rec = {"epoch": 2, "loss": 0.123456789, "steps": 4, "ts": 17.5,
           "pairs_per_sec": 12.0}
    jl = jlogging.MetricLogger(str(tmp_path / "j" / "m.jsonl"), echo=True)
    jl.log(rec)
    jl.close()
    j_out = capsys.readouterr().out
    pl = plogging.MetricLogger(str(tmp_path / "p" / "m.jsonl"), echo=True)
    pl.log(rec)
    pl.log({"loss": 1.0})
    pl.close()
    p_out = capsys.readouterr().out
    assert p_out.splitlines()[0] == j_out.strip() == \
        "epoch 2 | loss 0.123457 | steps 4 | pairs_per_sec 12.0"
    lines = (tmp_path / "p" / "m.jsonl").read_text().splitlines()
    assert lines[0] == (tmp_path / "j" / "m.jsonl").read_text().strip()
    assert set(json.loads(lines[1])) == {"loss", "ts"}


# ----------------------------------------------------------- profiling --

def test_nan_guard_and_step_timer_as_jax():
    for guard in (pprof.nan_guard, jprof.nan_guard):
        guard({"loss": 1.0, "aux": np.float32(2.0), "n": 3}, step=3)
        with pytest.raises(FloatingPointError, match="'idn_loss'=nan at "
                           "step 7"):
            guard({"idn_loss": float("nan")}, step=7)
        with pytest.raises(FloatingPointError):
            guard({"loss": np.float32("inf")})
    with pytest.raises(FloatingPointError, match="at step 2"):
        pprof.nan_guard({"loss": torch.tensor(float("inf"))}, 2)
    from text_guided_face_recognition_tpu_torch.engine import trainer
    assert trainer.nan_guard is pprof.nan_guard
    ticks = iter(range(0, 100, 1))
    means = []
    for timer in (pprof.StepTimer(warmup=2), jprof.StepTimer(warmup=2)):
        timer._time = lambda: float(next(ticks)) ** 2
        for _ in range(5):
            with timer:
                pass
        means.append((timer.count, timer.mean))
    # warm-up steps 1-2 excluded: each later step's (t1^2 - t0^2)
    assert means[0] == (5, (5 ** 2 - 4 ** 2 + 7 ** 2 - 6 ** 2
                            + 9 ** 2 - 8 ** 2) / 3)
    assert means[1][0] == 5 and math.isfinite(means[1][1])


def test_maybe_profile_traces_exactly_the_window(tiny_port, tmp_path,
                                                 capsys):
    """A tiny CPU stage-1 run of 4 steps with profile_start 1 and
    profile_steps 2: one trace, holding steps 1 and 2 alone, and JAX's
    line; without profile_dir nothing is traced."""
    args = STAGE1[2].replace(max_steps=4)
    tr = Stage1Trainer(args, CPU)
    seen = []
    step = tr.train_step

    def marked(*a, **k):
        with torch.profiler.record_function(f"tgfr_step_{len(seen)}"):
            seen.append(1)
            return step(*a, **k)

    tr.train_step = marked
    out_dir = tmp_path / "prof"
    args.extras.update(profile_dir=str(out_dir), profile_start=1,
                       profile_steps=2)
    tr.train_epoch(1)
    assert len(seen) == 4
    traces = list(out_dir.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = {e["name"] for e in events
             if str(e.get("name", "")).startswith("tgfr_step_")}
    assert steps == {"tgfr_step_1", "tgfr_step_2"}
    out = capsys.readouterr().out
    assert f"profiler trace written to {out_dir}" in out
    assert "epoch 1 | " in out          # the MetricLogger's echo
    args.extras.pop("profile_dir")
    with pprof.maybe_profile(args, 1):
        pass
    assert not pprof._session and len(list(out_dir.iterdir())) == 1


# ------------------------------------------------------------ benching --

def test_chain_steps_runs_k_dependent_iterations_as_jax():
    """k chained iterations equal k sequential calls, and JAX's chain of
    the same function."""
    def p_inner(state, key):
        state = state * 1.5 + 1.0
        return state, state.sum()

    def j_inner(state, key):
        state = state * 1.5 + 1.0
        return state, state.sum()

    x = np.arange(4, dtype=np.float32)
    run = pbench.chain_steps(p_inner)
    state, last = run(torch.from_numpy(x), None, 5)
    seq = torch.from_numpy(x)
    for _ in range(5):
        seq, s = p_inner(seq, None)
    assert torch.equal(state, seq) and float(last) == float(s)
    jstate, jlast = jbench.chain_steps(j_inner, donate=False)(
        jnp.asarray(x), jax.random.PRNGKey(0), 5)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert float(last) == float(jlast)
    with pytest.raises(ValueError, match="TPU-only"):
        pbench.chain_steps(p_inner, compiler_options={"xla_x": "1"})


def test_time_chained_steps_and_forward_return_finite_ms():
    """The host clock around eager calls when asked for it; on a host
    without a card the captured timing raises (no eager stand-in), as
    does an XLA option."""
    state = torch.zeros(8)

    def inner(st, key):
        st.mul_(0.5).add_(1.0)
        return st, st.sum()

    ms = pbench.time_chained_steps(inner, state, None, ks=(2, 6),
                                   repeats=3, wall_clock=True)
    assert isinstance(ms, float) and math.isfinite(ms)
    w = torch.randn(16, 16)
    x = torch.randn(4, 16)
    ms = pbench.time_chained_forward(lambda a, b: {"y": a @ b}, (x, w),
                                     ks=(2, 6), repeats=3, wall_clock=True)
    assert isinstance(ms, float) and math.isfinite(ms)
    assert torch.equal(x, x.clone())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pbench.time_chained_steps(inner, state, None)
    with pytest.raises(ValueError, match="TPU-only"):
        pbench.time_chained_steps(inner, state, None, wall_clock=True,
                                  compiler_options={"a": 1})


# --------------------------------------------------------------- tools --

def test_parity_check_as_the_root_tool(tmp_path, monkeypatch):
    """The port's parity_check on the port's is_roc dumps prints what the
    root tool prints and exits as it does: a pass, a score difference, a
    pair-list mismatch."""
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 2, 200)
    score = rng.normal(size=200) + y_true
    paths = {}
    with redirect_stdout(io.StringIO()):
        for name, s, t in (("ref", score, y_true),
                           ("close", score + 1e-6, y_true),
                           ("far", score + rng.normal(size=200) * 1e-2,
                            y_true),
                           ("other", score, 1 - y_true)):
            calculate_scores(s, t, is_roc=True, roc_file=str(tmp_path / name))
            paths[name] = str(tmp_path / f"{name}.npy")
    root = _root_tool("parity_check")
    for ours, code in (("close", 0), ("far", 2), ("other", 1)):
        argv = [paths["ref"], paths[ours]]
        got = _run_main(pparity.main, argv)
        want = _run_main(root.main, argv, monkeypatch, args_in_sys=True)
        assert got == want and got[0] == code, (got, want)


def test_profile_step_cpu_prints_parsable_lines(tiny_port, capsys):
    """The port's profile_step at a tiny size on the CPU: JSON lines with
    the total (a CPU measurement, named so) and the groups."""
    code = pprofile_step.main(["--cpu", "--batch", "4", "--k", "2",
                               "--bert_type", "tiny0", "--top", "5"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert code == 0
    total = lines[0]
    assert total["metric"] == "cpu_total_ms_per_step" and total["k"] == 2
    assert total["value"] > 0 and math.isfinite(total["value"])
    groups = [x for x in lines if "group" in x]
    assert groups and abs(sum(g["pct"] for g in groups) - 100) < 1e-6
    assert sum(1 for x in lines if "op" in x) == 5


def test_identify_reads_the_ports_extraction_as_the_jax_packages(
        twins, tmp_path, monkeypatch):
    """tools/identify.py on the port's extract_embeddings file prints what
    it prints on the JAX package's, both from the same (bridged)
    weights; the files hold the same keys and class ids, and embeddings
    within 1e-4."""
    from text_guided_face_recognition_tpu.models import text_bert as jtb
    monkeypatch.setitem(ptb.TEXT_ARCHS, "tiny", ptb.TextArch(**TINY))
    monkeypatch.setitem(jtb.TEXT_ARCHS, "tiny", jtb.TextArch(**TINY))
    jargs, pargs = serving_cfg()
    jmods, jv, ports = twins
    b = [jprep.Bundle(m, v) for m, v in zip(jmods, jv)]
    monkeypatch.setattr(jprep, "prepare_backbone", lambda *a: b[0])
    monkeypatch.setattr(jprep, "prepare_image_head", lambda *a: b[1])
    monkeypatch.setattr(jprep, "prepare_text_encoder",
                        lambda *a: (b[2], b[3]))
    monkeypatch.setattr(jprep, "prepare_fusion_net", lambda *a: b[4])
    monkeypatch.setattr(pprep, "prepare_backbone", lambda *a: ports[0])
    monkeypatch.setattr(pprep, "prepare_image_head", lambda *a: ports[1])
    monkeypatch.setattr(pprep, "prepare_text_encoder",
                        lambda *a: (ports[2], ports[3]))
    monkeypatch.setattr(pprep, "prepare_fusion_net", lambda *a: ports[4])
    jf, pf = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jextract.extract_embeddings(jargs, "test", jf)
    pextract.extract_embeddings(pargs.replace(cpu=True), "test", pf, CPU)
    with np.load(jf) as j, np.load(pf) as p:
        np.testing.assert_array_equal(p["keys"], j["keys"])
        np.testing.assert_array_equal(p["class_ids"], j["class_ids"])
        close(p["embeddings"], j["embeddings"], 1e-4, "embeddings")
    tool = _root_tool("identify")
    outs = [_run_main(tool.main, [f, "--topk", "3"], monkeypatch,
                      args_in_sys=True) for f in (jf, pf)]
    assert outs[0] == outs[1] and "rank-1" in outs[0][1], outs
