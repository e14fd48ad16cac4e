"""The port's kernel modules (ops/layernorm.py, ops/block.py) against the JAX
package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX
functions run in Pallas interpret mode (`interpret=True`). Same inputs from
a numpy seed on both sides. Tolerances (assert_allclose, rtol = atol): f32
5e-5, bf16 2e-2 -- those of tests/test_block_pallas.py for the JAX kernels
against flax. The f32 gap is summation order and the TPU kernel's
Abramowitz-Stegun erf (7.2e-7 from erf); in bf16, roundings that land on
the other side of a bf16 step.

The `cuda`-marked cases hold each CUDA kernel against its plain version on
a card and skip elsewhere. The JAX package is imported inside the `jx`
fixture, so on a machine with a card and no JAX the `cuda` cases run alone:
  python -m pytest tests/test_torch_ops.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch.ops import block, layernorm

# The first call of ATen's vectorised exp in a process (through torch.exp,
# torch.erf, the softmax) can come back off by up to 1.6e-4 relative on one
# OpenMP thread's chunk when the host's cores are contended, as under a
# 6-worker xdist run: about one fresh process in 25, with no JAX in the
# process; every later call is exact. The plain GELU's erf then moved the
# f32 FFN block by 1.4e-4 against the 5e-5 it is held to. One parallel call
# of each at import, before any test, takes the first call out of the
# comparisons.
torch.exp(torch.linspace(-4.0, 4.0, 1 << 16))
torch.erf(torch.linspace(-4.0, 4.0, 1 << 16))

B, T, H, HEADS = 4, 12, 256, 4        # d_head = 64, as the kernels require
DTYPES = [("float32", torch.float32, 5e-5), ("bfloat16", torch.bfloat16, 2e-2)]


class _Jax:
    """The JAX side: its Pallas kernels, run in interpret mode."""

    def __init__(self):
        import jax.numpy as jnp
        from text_guided_face_recognition_tpu.ops import block_pallas
        from text_guided_face_recognition_tpu.ops.layernorm_pallas import (
            layernorm_fused)
        self.jnp = jnp
        self.layernorm = layernorm_fused
        self.ffn_block = block_pallas.ffn_block
        self.attn_block = block_pallas.attn_block
        self.bits = jnp.zeros((8, 128), jnp.uint32)   # dropout off: dummies
        self.seed = jnp.zeros((1, 1), jnp.int32)

    def a(self, x, dtype="float32"):
        return self.jnp.asarray(x, dtype)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    return _Jax()


def ragged_mask(b: int, t: int, seed: int = 0) -> np.ndarray:
    """(b, t) int32 key masks with ragged lengths >= 2; row 0 full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, t + 1, size=b)
    lens[0] = t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def close(port, ref, tol: float) -> None:
    """port against ref at rtol = atol = tol. A failure names the worst
    |port - ref|, where it lies, and the torch thread count."""
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    err = np.abs(got - want)
    at = np.unravel_index(int(np.argmax(err)), err.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=(
        f"worst |port - ref| {err[at]:.3g} at {tuple(map(int, at))} (port "
        f"{got[at]:.7g}, ref {want[at]:.7g}); torch threads "
        f"{torch.get_num_threads()}"))


def done(ref) -> np.ndarray:
    """A JAX result as numpy, computed to the end before the port runs:
    JAX dispatches asynchronously, and its CPU work must not overlap the
    port's under test."""
    return np.asarray(ref, np.float32)


def _params(i_dim, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(B * T, H)).astype(f),
        wqkv=(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(f),
        bqkv=rng.normal(0, 0.1, 3 * H).astype(f),
        wo=(rng.normal(size=(H, H)) / np.sqrt(H)).astype(f),
        bo=rng.normal(0, 0.1, H).astype(f),
        w1=(rng.normal(size=(H, i_dim)) / np.sqrt(H)).astype(f),
        c1=rng.normal(0, 0.1, i_dim).astype(f),
        w2=(rng.normal(size=(i_dim, H)) / np.sqrt(i_dim)).astype(f),
        c2=rng.normal(0, 0.1, H).astype(f),
        g=(1 + rng.normal(0, 0.1, H)).astype(f),
        b=rng.normal(0, 0.1, H).astype(f))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_layernorm_matches_jax(jx, jdt, tdt, tol):
    p = _params(512)
    x = p["x"].reshape(B, T, H) * 3.0 + 1.0
    ref = done(jx.layernorm(jx.a(x, jdt), jx.a(p["g"]), jx.a(p["b"]), 1e-12,
                            True))
    out = layernorm.layernorm_fused(t(x, tdt), t(p["g"]), t(p["b"]), 1e-12)
    assert out.dtype == tdt and out.shape == (B, T, H)
    close(out, ref, tol)


# (rows, H) the LayerNorm kernels' paths serve: H not a multiple of the
# 16-byte vector (389: the scalar path), the flagship 768 x 768, the widest
# row (1024), a row narrower than a warp's vectors (8)
LN_SHAPES = [(37, 389), (768, 768), (50, 1024), (9, 8)]


def ln_data(rows: int, h: int, seed: int = 0):
    """x (rows, h) off zero mean and unit scale, gamma, beta, dy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(rows, h)).astype(f) * 3.0 + 1.0,
            (1 + rng.normal(0, 0.1, h)).astype(f),
            rng.normal(0, 0.1, h).astype(f),
            rng.normal(size=(rows, h)).astype(f))


@pytest.mark.parametrize("rows,h", LN_SHAPES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_layernorm_matches_jax_at_kernel_shapes(jx, jdt, tdt, tol, rows, h):
    x, g, b, _ = ln_data(rows, h)
    ref = done(jx.layernorm(jx.a(x, jdt), jx.a(g), jx.a(b), 1e-12, True))
    out = layernorm.layernorm_fused(t(x, tdt), t(g), t(b), 1e-12)
    assert out.dtype == tdt and out.shape == (rows, h)
    close(out, ref, tol)


# I = 1024: the JAX FFN kernel streams it in two 512-wide blocks (the
# grid-accumulation path); I = 256: one block
@pytest.mark.parametrize("i_dim", [1024, 256])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_ffn_block_matches_jax(jx, jdt, tdt, tol, i_dim):
    p = _params(i_dim)
    ref = done(jx.ffn_block(jx.a(p["x"], jdt), *(jx.a(p[k]) for k in (
        "w1", "c1", "w2", "c2", "g", "b")), jx.bits, jx.seed, 0.0, 1e-12,
        False, True))
    out = block.ffn_block(t(p["x"], tdt), t(p["w1"]), t(p["c1"]), t(p["w2"]),
                          t(p["c2"]), t(p["g"]), t(p["b"]), 0.0, 1e-12)
    close(out, ref, tol)
    # an nn.Linear weight seen through .t() is the same function
    out_t = block.ffn_block(t(p["x"], tdt), t(p["w1"].T).t(), t(p["c1"]),
                            t(p["w2"].T).t(), t(p["c2"]), t(p["g"]),
                            t(p["b"]), 0.0, 1e-12)
    torch.testing.assert_close(out_t, out, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_attn_block_matches_jax(jx, jdt, tdt, tol, seed):
    p = _params(512, seed)
    mask = ragged_mask(B, T, seed)
    ref = jx.attn_block(jx.a(p["x"], jdt), jx.a(mask, "int32"), *(
        jx.a(p[k]) for k in ("wqkv", "bqkv", "wo", "bo", "g", "b")),
        jx.bits, jx.bits, jx.seed, B, T, HEADS, 0.0, 1e-12, False, True)
    ref = done(ref)
    out = block.attn_block(t(p["x"], tdt), t(mask), t(p["wqkv"]),
                           t(p["bqkv"]), t(p["wo"]), t(p["bo"]), t(p["g"]),
                           t(p["b"]), B, T, HEADS, 0.0, 1e-12)
    close(out, ref, tol)


@pytest.mark.parametrize("threads", range(1, 9))
def test_plain_blocks_ignore_the_weight_layout(threads):
    """The plain FFN and attention blocks, forward and backward, give the
    same bits whether a weight is held contiguous (in, out) or as the .t()
    view of a contiguous (out, in) tensor, the kernels' layout, at each
    torch thread count from 1 to 8 (a CPU product's summation order follows
    its operands' layout and the thread count; ops/block.kernel_layout)."""
    p = _params(1024)
    mask = ragged_mask(B, T, 0)
    keep = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for tdt in (torch.float32, torch.bfloat16):
            outs = []
            for view in (lambda a: t(a), lambda a: t(a.T).t()):
                x = t(p["x"], tdt).requires_grad_()
                ws = {k: view(p[k]).requires_grad_()
                      for k in ("w1", "w2", "wqkv", "wo")}
                y = block.attn_block(x, t(mask), ws["wqkv"], t(p["bqkv"]),
                                     ws["wo"], t(p["bo"]), t(p["g"]),
                                     t(p["b"]), B, T, HEADS, 0.0, 1e-12)
                z = block.ffn_block(y, ws["w1"], t(p["c1"]), ws["w2"],
                                    t(p["c2"]), t(p["g"]), t(p["b"]), 0.0,
                                    1e-12)
                z.float().square().sum().backward()
                outs.append([z, x.grad] + [ws[k].grad for k in sorted(ws)])
            assert outs[0][0].dtype == tdt
            for a, b in zip(*outs):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        torch.set_num_threads(keep)


# captions longer than the port's f32 and training kernels take: the bf16
# forward's tensor-core attention takes T up to 512 on the card; here its
# plain version against the JAX kernel, keys padded in every caption but
# the first
LONG_B, LONG_T, LONG_H, LONG_HEADS = 2, 200, 128, 2


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_attn_block_matches_jax_at_long_captions(jx, jdt, tdt, tol):
    rng = np.random.default_rng(7)
    f = np.float32
    h, r = LONG_H, LONG_B * LONG_T
    x = rng.normal(size=(r, h)).astype(f)
    w = dict(wqkv=(rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(f),
             bqkv=rng.normal(0, 0.1, 3 * h).astype(f),
             wo=(rng.normal(size=(h, h)) / np.sqrt(h)).astype(f),
             bo=rng.normal(0, 0.1, h).astype(f),
             g=(1 + rng.normal(0, 0.1, h)).astype(f),
             b=rng.normal(0, 0.1, h).astype(f))
    mask = ragged_mask(LONG_B, LONG_T, 7)
    assert mask.sum() < mask.size
    ref = done(jx.attn_block(jx.a(x, jdt), jx.a(mask, "int32"), *(
        jx.a(w[k]) for k in ("wqkv", "bqkv", "wo", "bo", "g", "b")),
        jx.bits, jx.bits, jx.seed, LONG_B, LONG_T, LONG_HEADS, 0.0, 1e-12,
        False, True))
    out = block.attn_block_ref(t(x, tdt), t(mask), *(t(w[k]) for k in (
        "wqkv", "bqkv", "wo", "bo", "g", "b")), LONG_B, LONG_T, LONG_HEADS,
        0.0, 1e-12)
    close(out, ref, tol)


@pytest.mark.parametrize("grad_mode", ["enabled", "no_grad", "inference"])
@pytest.mark.parametrize("kernel", ["ffn", "attn", "tower"])
def test_residuals_are_saved_only_when_a_gradient_can_flow(monkeypatch,
                                                           kernel,
                                                           grad_mode):
    """The autograd wrappers ask their forward kernel for the backward's
    residuals (`save`) only with grad mode on where they are called and an
    input that requires a gradient: serving runs in inference mode with
    parameters that require one, and must take the kernels' paths without
    residuals (K5's tensor-core attention, captions up to 512 tokens)."""
    p = _params(256)
    ws = {k: t(p[k]).requires_grad_() for k in p if k != "x"}
    x = t(p["x"])
    seen = []
    names = {"ffn": "ffn_block_fwd", "attn": "attn_block_fwd",
             "tower": "tower_block_fwd"}
    real = getattr(block, names[kernel])

    def spy(*a, **k):
        seen.append(a[-1])                  # save, the last positional
        return real(*a, **k)

    monkeypatch.setattr(block, names[kernel], spy)
    ctx = {"enabled": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[grad_mode]
    with ctx():
        if kernel == "ffn":
            block.ffn_block(x, *(ws[k] for k in ("w1", "c1", "w2", "c2", "g",
                                                 "b")))
        elif kernel == "attn":
            block.attn_block(x, t(ragged_mask(B, T)), *(ws[k] for k in (
                "wqkv", "bqkv", "wo", "bo", "g", "b")), B, T, HEADS)
        else:
            h, inter = H, 256

            def stack(v, shape):
                return v.detach().reshape(shape)[None].requires_grad_()

            leaves = [stack(ws["wqkv"], (h, 3 * h)),
                      stack(ws["bqkv"], (1, 3 * h)), stack(ws["wo"], (h, h)),
                      stack(ws["bo"], (1, h)), stack(ws["g"], (1, h)),
                      stack(ws["b"], (1, h)), stack(ws["w1"], (h, inter)),
                      stack(ws["c1"], (1, inter)),
                      stack(ws["w2"], (inter, h)), stack(ws["c2"], (1, h)),
                      stack(ws["g"], (1, h)), stack(ws["b"], (1, h))]
            block.tower_block(x, t(ragged_mask(B, T)), *leaves, B, T, HEADS)
    assert seen == [grad_mode == "enabled"]


def test_dropout_and_devices_are_refused():
    p = _params(256)
    args = (t(p["x"]), t(p["w1"]), t(p["c1"]), t(p["w2"]), t(p["c2"]),
            t(p["g"]), t(p["b"]))
    # dropout takes host bits: rate > 0 without them is refused
    with pytest.raises(ValueError, match="dropout bits"):
        block.ffn_block(*args, rate=0.1)
    with pytest.raises(ValueError, match="dropout bits"):
        block.attn_block(t(p["x"]), t(ragged_mask(B, T)), t(p["wqkv"]),
                         t(p["bqkv"]), t(p["wo"]), t(p["bo"]), t(p["g"]),
                         t(p["b"]), B, T, HEADS, rate=0.1)
    meta = torch.empty((B * T, H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layernorm.layernorm_fused(meta, t(p["g"]), t(p["b"]))
    with pytest.raises(ValueError, match="unsupported device"):
        block.ffn_block(meta, *args[1:])


def test_cpu_path_launches_no_kernel():
    p = _params(256)
    before = (layernorm.layernorm_fused.launches, block.ffn_block.launches)
    layernorm.layernorm_fused(t(p["x"]), t(p["g"]), t(p["b"]))
    block.ffn_block(t(p["x"]), t(p["w1"]), t(p["c1"]), t(p["w2"]),
                    t(p["c2"]), t(p["g"]), t(p["b"]))
    assert (layernorm.layernorm_fused.launches,
            block.ffn_block.launches) == before


# --------------------------------------------------------- on a CUDA card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# on the card in f32 the plain version is full f32 (TF32 off): 1e-4
CUDA_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _on(dev, p):
    """p on the card, each weight as the .t() view of a contiguous (out, in)
    tensor: the layout the kernels take, as the model passes its nn.Linear
    weights."""
    out = {k: t(v).to(dev) for k, v in p.items()}
    for k in ("wqkv", "wo", "w1", "w2"):
        out[k] = out[k].t().contiguous().t()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_matches_plain(cuda, tdt, tol):
    p = _on(cuda, _params(256))
    x = p["x"].to(tdt)
    n = layernorm.layernorm_fused.launches
    out = layernorm.layernorm_fused(x, p["g"], p["b"])
    assert layernorm.layernorm_fused.launches == n + 1
    torch.testing.assert_close(out.float(), layernorm.layernorm_ref(
        x, p["g"], p["b"]).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", LN_SHAPES)
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_matches_plain_at_kernel_shapes(cuda, tdt, tol, rows,
                                                       h):
    x, g, b, _ = (t(a).to(cuda) for a in ln_data(rows, h))
    x = x.to(tdt)
    n = layernorm.layernorm_fused.launches
    out = layernorm.layernorm_fused(x, g, b)
    assert layernorm.layernorm_fused.launches == n + 1
    torch.testing.assert_close(out.float(), layernorm.layernorm_ref(
        x, g, b).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_takes_unaligned_rows(cuda, tdt, tol):
    # x one element into its storage: not 16-byte aligned, the scalar path
    x, g, b, _ = (t(a).to(cuda) for a in ln_data(64, 768))
    xs = torch.empty(64 * 768 + 1, dtype=tdt, device=cuda)[1:].view(64, 768)
    xs.copy_(x)
    torch.testing.assert_close(
        layernorm.layernorm_fused(xs, g, b).float(),
        layernorm.layernorm_ref(xs, g, b).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_ffn_block_matches_plain(cuda, tdt, tol):
    p = _on(cuda, _params(1024))
    x = p["x"].to(tdt)
    args = (p["w1"], p["c1"], p["w2"], p["c2"], p["g"], p["b"])
    torch.testing.assert_close(block.ffn_block(x, *args).float(),
                               block.ffn_block_ref(x, *args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_attn_block_matches_plain(cuda, tdt, tol):
    p = _on(cuda, _params(256))
    x = p["x"].to(tdt)
    mask = t(ragged_mask(B, T)).to(cuda)
    args = (mask, p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["g"], p["b"],
            B, T, HEADS)
    torch.testing.assert_close(block.attn_block(x, *args).float(),
                               block.attn_block_ref(x, *args).float(),
                               rtol=tol, atol=tol)


# the flagship shapes: B 32 captions of T 24, bert-base's H 768, 12 heads,
# I 3072
FB, FT, FH, FHEADS, FI = 32, 24, 768, 12, 3072


def _flagship(dev, t=FT, b=FB, seed=11):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    h, i = FH, FI
    p = dict(x=rn(b * t, h), g=1.0 + rn(h, std=0.1), b=rn(h, std=0.1),
             wqkv=rn(3 * h, h, std=h ** -0.5).t(), bqkv=rn(3 * h, std=0.1),
             wo=rn(h, h, std=h ** -0.5).t(), bo=rn(h, std=0.1),
             w1=rn(i, h, std=h ** -0.5).t(), c1=rn(i, std=0.1),
             w2=rn(h, i, std=i ** -0.5).t(), c2=rn(h, std=0.1))
    lens = torch.randint(2, t + 1, (b,), generator=g)
    lens[0] = t
    p["mask"] = (torch.arange(t)[None] < lens[:, None]).to(dev, torch.int32)
    p["bits_p"] = torch.randint(-2 ** 31, 2 ** 31 - 1, (FHEADS * b, t, t),
                                generator=g, dtype=torch.int32).to(dev)
    p["bits_h"] = torch.randint(-2 ** 31, 2 ** 31 - 1, (b * t, h),
                                generator=g, dtype=torch.int32).to(dev)
    p["seed"] = torch.tensor([5], dtype=torch.int32, device=dev)
    return p


def _hold(name, a, b, tol, what):
    """A forward output of the kernel against its plain version: element-
    wise at rtol = atol = tol, but the pre-LN sum r (x plus the block's
    output) to tol times its largest element, as chip_smoke.py holds the
    tower's r1 and r2: where the two addends nearly cancel, a bf16 step of
    the addend (the two add their GEMMs' products in other orders) is a
    step of an element near zero."""
    a, b = a.float(), b.float()
    if name == "r":
        err = (a - b).abs().max().item()
        assert err <= tol * max(1.0, b.abs().max().item()), (what, err)
    else:
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=what)


def _modes(p, attn):
    """(name, keyword arguments) of eval, host-bits and prng mode."""
    bits = (dict(bits_p=p["bits_p"], bits_h=p["bits_h"]) if attn
            else dict(bits=p["bits_h"]))
    return [("eval", dict(rate=0.0)), ("host", dict(rate=0.1, **bits)),
            ("prng", dict(rate=0.1, seed=p["seed"]))]


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_ffn_block_matches_plain_at_flagship_shapes(cuda, tdt, tol):
    p = _flagship(cuda)
    x = p["x"].to(tdt)
    w = (p["w1"], p["c1"], p["w2"], p["c2"], p["g"], p["b"])
    for mode, kw in _modes(p, False):
        n = block.ffn_block.launches
        got = block.ffn_block_fwd(x, *w, **kw)
        assert block.ffn_block.launches == n + 1
        for name, a, b in zip(("z", "f", "act", "r"), got,
                              block.ffn_block_fwd_ref(x, *w, **kw)):
            _hold(name, a, b, tol, f"{mode} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_attn_block_matches_plain_at_flagship_shapes(cuda, tdt, tol):
    p = _flagship(cuda)
    x = p["x"].to(tdt)
    args = (p["mask"], p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["g"],
            p["b"], FB, FT, FHEADS)
    # with the residuals (training: the scalar tile the tower runs) and,
    # in bf16, without them (serving: the tensor-core tile)
    for save in (True, False):
        for mode, kw in _modes(p, True):
            n = block.attn_block.launches
            got = block.attn_block_fwd(x, *args, save=save, **kw)
            assert block.attn_block.launches == n + 1
            assert (got[2] is None) == (not save)
            for name, a, b in zip(("y", "qkv", "p", "o", "r"), got,
                                  block.attn_block_fwd_ref(x, *args, **kw)):
                if a is not None:
                    _hold(name, a, b, tol, f"{mode} save={save} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [24, 129, 200, 512])
def test_cuda_attn_block_takes_long_captions_in_bf16(cuda, t_len):
    """The bf16 forward at T up to 512, keys padded in every caption but the
    first, without residuals (serving) and with them (training: p included;
    the tensor-core tile past 128); in f32 the limit stays 128, and 64 with
    residuals."""
    p = _flagship(cuda, t=t_len, b=2, seed=t_len)
    x = p["x"].bfloat16()
    args = (p["mask"], p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["g"],
            p["b"], 2, t_len, FHEADS)
    for kw in (dict(rate=0.0), dict(rate=0.1, seed=p["seed"])):
        want = block.attn_block_fwd_ref(x, *args, **kw)
        got = block.attn_block_fwd(x, *args, save=False, **kw)[0]
        torch.testing.assert_close(got.float(), want[0].float(), rtol=2e-2,
                                   atol=2e-2)
        for name, a, b in zip(("y", "qkv", "p", "o", "r"),
                              block.attn_block_fwd(x, *args, **kw), want):
            _hold(name, a, b, 2e-2, f"t={t_len} {kw['rate']} {name}")
    if t_len > block.MAX_T_BWD:
        with pytest.raises(ValueError, match=f"t <= {block.MAX_T_BWD}"):
            block.attn_block_fwd(p["x"], *args)
    if t_len > block.MAX_T_FWD_SCALAR:
        with pytest.raises(ValueError, match="t <= 128"):
            block.attn_block_fwd(p["x"], *args, save=False)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs(cuda):
    p = _on(cuda, _params(256))
    with pytest.raises(ValueError, match="contiguous"):
        layernorm.layernorm_fused(p["x"].t(), p["g"][:1], p["b"][:1])
    with pytest.raises(ValueError, match="w1"):
        block.ffn_block(p["x"], p["w1"].double(), p["c1"], p["w2"],
                        p["c2"], p["g"], p["b"])
    with pytest.raises(ValueError, match=r"\.t\(\) view"):
        block.ffn_block(p["x"], p["w1"].contiguous(), p["c1"], p["w2"],
                        p["c2"], p["g"], p["b"])
    with pytest.raises(ValueError, match="width 64"):
        block.attn_block(p["x"], t(ragged_mask(B, T)).to(cuda), p["wqkv"],
                         p["bqkv"], p["wo"], p["bo"], p["g"], p["b"], B, T,
                         HEADS + 1)
