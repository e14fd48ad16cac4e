"""Step timing: chained iterations and the marginal cost between two
chain lengths.

Counterpart of text_guided_face_recognition_tpu/utils/benching.py. The
contract is the JAX package's: run k dependent iterations (each takes the
previous one's state, so none can be skipped or overlapped with the next),
take the median total of `repeats` runs at each of two k, and return the
marginal cost in ms,

    ms_per_step = (t(k_big) - t(k_small)) / (k_big - k_small),

which cancels the fixed cost of starting and finishing a chain. The JAX
package compiles the chain into one device loop; on the card the port
captures one iteration in a CUDA graph (or, for a trainer, uses the
trainer's own captured step) and times k replays between two CUDA events.
A step that cannot be captured raises: nothing is timed eagerly in its
place. On the CPU, and only when the caller asks for it (`wall_clock`),
the host clock is read around k eager calls.

`compiler_options` is an XLA knob of the JAX package (per-program TPU
compiler options): `None` is accepted, anything else raises. `donate`
(XLA buffer donation) has no counterpart: the port's steps update their
state in place.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence, Tuple

import torch

__all__ = ["chain_steps", "time_chained_steps", "time_chained_forward",
           "graph_nodes"]

WARMUP = 3          # eager iterations on the capture stream before capture


def _no_xla(compiler_options) -> None:
    if compiler_options:
        raise ValueError(
            f"compiler_options={compiler_options!r}: per-program XLA "
            "compiler options are TPU-only (the JAX package's "
            "utils/benching.py); the port takes None")


def _check_ks(ks: Sequence[int]) -> None:
    if len(ks) != 2 or not ks[1] > ks[0] >= 1:
        raise ValueError(f"ks must be two increasing counts >= 1, got {ks}")


def chain_steps(inner: Callable[[Any, Any], Tuple[Any, torch.Tensor]],
                donate: bool = True, compiler_options: dict | None = None):
    """`inner(state, key) -> (state, scalar)` as `run(state, key, k)`,
    which runs k chained iterations (each on the previous one's state) and
    returns (state, the last scalar). `key` is handed to every iteration
    (a torch.Generator advances by itself)."""
    _no_xla(compiler_options)

    def run(state, key, k: int):
        last = torch.zeros(())
        for _ in range(int(k)):
            state, last = inner(state, key)
        return state, last

    return run


def _marginal(run_k: Callable[[int], float], ks, repeats: int) -> float:
    totals = []
    for k in ks:
        samples = sorted(run_k(k) for _ in range(max(1, repeats)))
        totals.append(samples[len(samples) // 2])
    return (totals[1] - totals[0]) / (ks[1] - ks[0])


def _wall(fn: Callable[[], Any]) -> Callable[[int], float]:
    def run_k(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn()
        if torch.is_tensor(out):
            float(out.float().sum())
        return (time.perf_counter() - t0) * 1e3
    return run_k


def _events(fn: Callable[[], Any]) -> Callable[[int], float]:
    def run_k(k: int) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(k):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    return run_k


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times a captured step on the CUDA card, "
                           "and CUDA is not available; pass wall_clock=True "
                           "to time eager calls by the host clock")


def _capture(fn: Callable[[], Any]) -> torch.cuda.CUDAGraph:
    """fn warmed up WARMUP times on a side stream, then captured there;
    a capture that fails raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            fn()
    except Exception as e:
        raise RuntimeError(f"the step could not be captured in a CUDA graph "
                           f"(it is not timed eagerly instead): {e}") from e
    return graph


def graph_nodes(fn: Callable[[], Any]) -> list:
    """The node types of a CUDA graph of one call of fn (captured on a side
    stream after a warm-up call there), read with libcuda's cuGraphGetNodes
    and cuGraphNodeGetType (type 0: a kernel). Unlike torch.profiler's
    records, which a profiling run may lose, the capture holds every device
    operation the call enqueues."""
    import ctypes

    if not torch.cuda.is_available():
        raise RuntimeError("graph_nodes captures a CUDA graph, and CUDA is "
                           "not available")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    g, n = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and drv.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if drv.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return kinds


def _is_trainer(state) -> bool:
    return hasattr(state, "train_step") and hasattr(state, "graph")


def time_chained_steps(inner, state, key, ks: Sequence[int] = (4, 44),
                       donate: bool = True, repeats: int = 5,
                       compiler_options: dict | None = None,
                       wall_clock: bool = False) -> float:
    """Per-step milliseconds of `inner(state, key) -> (state, scalar)`,
    the marginal cost between the chains of ks[0] and ks[1] iterations
    (median of `repeats` each).

    On the card: when `state` is a trainer (engine/trainer.py) and inner
    calls its train_step, the trainer's own captured step is warmed up
    and captured first (a trainer made with eager=True raises) and each
    iteration is one of its replays; otherwise one call of inner is
    captured here, which must update the state in place (the state it
    returns is the one it was given), and each iteration is a replay.
    With `wall_clock`: the host clock around eager calls."""
    _no_xla(compiler_options)
    _check_ks(ks)
    box = [state]

    def step():
        box[0], last = inner(box[0], key)
        return last

    if wall_clock:
        step()
        return _marginal(_wall(step), ks, repeats)
    _need_card("time_chained_steps")
    if _is_trainer(state):
        if state.eager:
            raise RuntimeError(
                f"{type(state).__name__} was made with eager=True: its step "
                "is not captured, and time_chained_steps does not time "
                "eager steps on the card")
        while state.graph is None:
            step()
        return _marginal(_events(step), ks, repeats)

    def once():
        new, last = inner(state, key)
        if new is not state:
            raise ValueError("time_chained_steps captures one call of inner: "
                             "it must update its state in place and return "
                             "the state it was given")
        return last

    graph = _capture(once)
    return _marginal(_events(graph.replay), ks, repeats)


def time_chained_forward(fwd: Callable[..., Any], args: Tuple,
                         ks: Sequence[int] = (4, 44), repeats: int = 5,
                         wall_clock: bool = False) -> float:
    """Per-call milliseconds of a pure forward `fwd(*args)`.

    Iterations are chained by feeding 1e-37 times the f32 sum of the
    output's tensors back into the first (float) argument: a real data
    dependence, far below f32's effect on normalised inputs. The first
    argument is copied, never changed. On the card one iteration is
    captured and replayed; with `wall_clock` eager calls by the host
    clock."""
    _check_ks(ks)
    x = args[0].clone()
    rest = args[1:]

    def leaf_sum(out):
        if torch.is_tensor(out):
            return out.float().sum()
        if isinstance(out, dict):
            out = list(out.values())
        return sum(leaf_sum(o) for o in out)

    def once():
        s = leaf_sum(fwd(x, *rest))
        x.add_((s * 1e-37).to(x.dtype))
        return s

    if wall_clock:
        with torch.no_grad():
            once()
            return _marginal(_wall(once), ks, repeats)
    _need_card("time_chained_forward")
    with torch.no_grad():
        graph = _capture(once)
    return _marginal(_events(graph.replay), ks, repeats)

