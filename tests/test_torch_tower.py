"""The whole-tower kernels' module (ops/block.py `tower_block`, K7 and K8)
and `TransformerEncoder(fused_block="tower")` against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
`tower_block` runs its Pallas kernels in interpret mode with host dropout
bits (`use_prng=False`), the same uint32 bits on both sides (int32-held on
the port's). Small sizes: the tiny arch of tests/test_block_pallas.py
(2 layers, H 256, 4 heads of 64, I 1024) at B 3, T 12 for the kernel
functions and T 10 for the encoder.

Tolerances (assert_allclose, rtol = atol): f32 5e-5, bf16 2e-2, as
tests/test_torch_ops.py (summation order, the TPU kernel's A-S erf; in
bf16 a rounding that falls on the other side of a step). In f32 the
forward and dx are held element by element. In bf16 they are held to the
tolerance times the output's largest element (about 4): a rounding that
flips in layer 0's output, one bf16 step of 2^-6 at |x| >= 2, is carried
through layer 1 and its two LayerNorms, which a single half-layer's
element-wise 2e-2 does not have to absorb. A stacked weight or bias
gradient, a sum over the 36 rows, is held to the tolerance times its
largest element in both types. The encoder's parameter
gradients: 2e-4 of the largest element, as the JAX package's own tower
test. `tower` against `both` inside the port, same weights and bits:
values 5e-5, gradients 2e-4 of the largest element (f32, where the tower's
rounding of its gradients to the leaves' dtype is the identity).

The `cuda`-marked cases hold K7 and K8 against their plain versions on a
card and skip elsewhere; the JAX package is imported inside fixtures, so on
a machine with a card and no JAX they run alone:
  python -m pytest tests/test_torch_tower.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.ops import block
from text_guided_face_recognition_tpu_torch.ops.dropout import total_elems

L, B, T, H, HEADS, I = 2, 3, 12, 256, 4, 1024    # d_head = 64
R = B * T
RATE = 0.1
DTYPES = [("float32", torch.float32, 5e-5), ("bfloat16", torch.bfloat16, 2e-2)]
ARCH = dict(vocab_size=100, hidden=H, layers=L, heads=HEADS, intermediate=I,
            max_positions=32)
WEIGHTS = ("wqkv", "wo", "w1", "w2")


class _Jax:
    def __init__(self):
        import jax
        import jax.numpy as jnp
        from text_guided_face_recognition_tpu.models import text_bert
        from text_guided_face_recognition_tpu.ops import block_pallas
        self.jax, self.jnp, self.bp, self.tb = jax, jnp, block_pallas, text_bert
        self.dummy = jnp.zeros((8, 128), jnp.uint32)
        self.seed = jnp.zeros((1, 1), jnp.int32)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    return _Jax()


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def bits(u32: np.ndarray) -> torch.Tensor:
    return t(u32.view(np.int32))


def close(port, ref, tol, scaled=False, what=""):
    ref = np.asarray(ref, np.float32)
    atol = tol * max(1.0, float(np.abs(ref).max())) if scaled else tol
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=tol,
                               atol=atol, err_msg=what)


def ragged_mask(b, t_, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, t_ + 1, size=b)
    lens[0] = t_
    return (np.arange(t_)[None, :] < lens[:, None]).astype(np.int32)


def _leaves(seed=0, layers=L, h=H, inter=I):
    """The 12 stacked leaves in the JAX layout, f32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def n(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.normal(size=(layers,) + shape)).astype(f)

    return dict(
        wqkv=n(h, 3 * h, std=h ** -0.5), bqkv=n(1, 3 * h, std=0.1),
        wo=n(h, h, std=h ** -0.5), bo=n(1, h, std=0.1),
        g1=n(1, h, std=0.1, mean=1.0), b1=n(1, h, std=0.1),
        w1=n(h, inter, std=h ** -0.5), c1=n(1, inter, std=0.1),
        w2=n(inter, h, std=inter ** -0.5), c2=n(1, h, std=0.1),
        g2=n(1, h, std=0.1, mean=1.0), b2=n(1, h, std=0.1))


def _data(seed=0, b=B, t_=T, h=H, layers=L, heads=HEADS):
    rng = np.random.default_rng(seed + 100)
    r = b * t_
    return dict(
        x=rng.normal(size=(r, h)).astype(np.float32),
        dz=rng.normal(size=(r, h)).astype(np.float32),
        mask=ragged_mask(b, t_, seed),
        bits_p=rng.integers(0, 1 << 32, (layers, heads * b, t_, t_),
                            dtype=np.uint32),
        bits_h=rng.integers(0, 1 << 32, (layers, r, h), dtype=np.uint32),
        bits_f=rng.integers(0, 1 << 32, (layers, r, h), dtype=np.uint32))


def _port_leaves(lv, dtype, dev="cpu"):
    """Stacked leaves as the model hands them over: already in `dtype`,
    weights the .transpose(1, 2) view of a contiguous (L, out, in) stack."""
    out = []
    for name in block.TOWER_LEAVES:
        a = t(lv[name]).to(dev, dtype)
        if name in WEIGHTS:
            a = a.transpose(1, 2).contiguous().transpose(1, 2)
        out.append(a.requires_grad_(True))
    return out


# ----------------------------------------------- plain version against JAX --

@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_tower_block_matches_jax_pallas(jx, jdt, tdt, tol, rate):
    """Forward and jax.vjp of the JAX tower (interpret mode, host bits)
    against the port's autograd Function over the plain versions."""
    lv, d = _leaves(), _data()
    jnp = jx.jnp
    jl = [jnp.asarray(lv[k], jdt) for k in block.TOWER_LEAVES]
    jb = ([jnp.asarray(d[k]) for k in ("bits_p", "bits_h", "bits_f")]
          if rate else [jx.dummy] * 3)

    def jf(x_, *leaves):
        return jx.bp.tower_block(x_, jnp.asarray(d["mask"]), *leaves, *jb,
                                 jx.seed, B, T, HEADS, rate, 1e-12, False,
                                 True)

    z_j, vjp = jx.jax.vjp(jf, jnp.asarray(d["x"], jdt), *jl)
    g_j = vjp(jnp.asarray(d["dz"], jdt))

    x = t(d["x"], tdt).requires_grad_(True)
    pl = _port_leaves(lv, tdt)
    pb = ([bits(d[k]) for k in ("bits_p", "bits_h", "bits_f")] if rate
          else [None] * 3)
    z_p = block.tower_block(x, t(d["mask"]), *pl, B, T, HEADS, rate, 1e-12,
                            *pb)
    assert z_p.dtype == tdt
    carried = tdt == torch.bfloat16      # see the module docstring
    close(z_p, z_j, tol, scaled=carried, what="z")
    g_p = torch.autograd.grad(z_p, [x] + pl, t(d["dz"], tdt))
    close(g_p[0], g_j[0], tol, scaled=carried, what="dx")
    for name, gp, gj in zip(block.TOWER_LEAVES, g_p[1:], g_j[1:]):
        # the stacked gradients come back in the stacked leaves' dtype
        assert gp.dtype == tdt and str(gj.dtype) == jdt, name
        assert tuple(gp.shape) == tuple(gj.shape), name
        close(gp, gj, tol, scaled=True, what=name)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_tower_block_matches_jax_at_a_long_caption(jx, jdt, tdt, tol):
    """The tower at T 160, past the 128 of the scalar forward tile and the
    64 the tower kernels took before (B 2, a ragged mask, dropout 0.1 from
    host bits): forward and jax.vjp of the JAX tower (interpret mode)
    against the port's autograd Function, at the tolerances above."""
    b, t_ = 2, 160
    lv, d = _leaves(4), _data(4, b=b, t_=t_)
    jnp = jx.jnp
    jl = [jnp.asarray(lv[k], jdt) for k in block.TOWER_LEAVES]
    jb = [jnp.asarray(d[k]) for k in ("bits_p", "bits_h", "bits_f")]

    def jf(x_, *leaves):
        return jx.bp.tower_block(x_, jnp.asarray(d["mask"]), *leaves, *jb,
                                 jx.seed, b, t_, HEADS, RATE, 1e-12, False,
                                 True)

    z_j, g_j = jx.jax.jit(lambda x_, ls, dz: (
        lambda z, vjp: (z, vjp(dz)))(*jx.jax.vjp(jf, x_, *ls)))(
        jnp.asarray(d["x"], jdt), jl, jnp.asarray(d["dz"], jdt))
    x = t(d["x"], tdt).requires_grad_(True)
    pl = _port_leaves(lv, tdt)
    pb = [bits(d[k]) for k in ("bits_p", "bits_h", "bits_f")]
    z_p = block.tower_block(x, t(d["mask"]), *pl, b, t_, HEADS, RATE, 1e-12,
                            *pb)
    carried = tdt == torch.bfloat16
    close(z_p, z_j, tol, scaled=carried, what="z")
    g_p = torch.autograd.grad(z_p, [x] + pl, t(d["dz"], tdt))
    close(g_p[0], g_j[0], tol, scaled=carried, what="dx")
    for name, gp, gj in zip(block.TOWER_LEAVES, g_p[1:], g_j[1:]):
        assert gp.dtype == tdt and tuple(gp.shape) == tuple(gj.shape), name
        close(gp, gj, tol, scaled=True, what=name)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_tower_block_residuals_match_jax(jx, rate):
    """The residuals the forward saves, against the JAX kernel's."""
    lv, d = _leaves(1), _data(1)
    jnp = jx.jnp
    jl = [jnp.asarray(lv[k]) for k in block.TOWER_LEAVES]
    jb = ([jnp.asarray(d[k]) for k in ("bits_p", "bits_h", "bits_f")]
          if rate else [jx.dummy] * 3)
    z_j, res = jx.bp._tower_fwd(jnp.asarray(d["x"]), jnp.asarray(d["mask"]),
                                *jl, *jb, jx.seed, B, T, HEADS, rate, 1e-12,
                                False, True)
    pl = [a.detach() for a in _port_leaves(lv, torch.float32)]
    pb = ([bits(d[k]) for k in ("bits_p", "bits_h", "bits_f")] if rate
          else [None] * 3)
    got = block.tower_block_fwd(t(d["x"]), t(d["mask"]), *pl, B, T, HEADS,
                                *pb, rate)
    close(got[0], z_j, 5e-5, what="z")
    for name, a, b_ in zip(("xin", "qkv", "p", "o", "r1", "f", "r2"),
                           got[1:], res[-7:]):
        close(a, b_, 5e-5, what=name)


# ------------------------------------------------------- the encoder --

def _encoders(jx, fused, dtype):
    jarch = jx.tb.TextArch(**ARCH)
    parch = ptb.TextArch(**ARCH)
    jdt = {"float32": jx.jnp.float32, "bfloat16": jx.jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jenc = jx.tb.TransformerEncoder(jarch, jdt, False, True, fused,
                                    name="model")
    penc = ptb.TransformerEncoder(parch, tdt, False, fused,
                                  fused_dropout=True)
    return jenc, penc


def _ids(bt=10, n=3):
    ids = (np.arange(n * bt).reshape(n, bt) % 90).astype(np.int32)
    mask = np.array([[1] * bt, [1] * (bt - 3) + [0] * 3,
                     [1] * (bt - 1) + [0]], np.int32)
    return ids, mask


def _bridge(jx, penc, params):
    from text_guided_face_recognition_tpu_torch.engine.from_jax import (
        state_dict_from_jax)
    tree = jx.jax.tree_util.tree_map(np.asarray, jx.jax.device_get(params))
    penc.load_state_dict(state_dict_from_jax(tree["params"], None,
                                             module=penc))
    return penc


@pytest.mark.parametrize("train", [False, True])
def test_encoder_tower_matches_jax(jx, monkeypatch, train):
    """TransformerEncoder(fused_block="tower"), values and every parameter
    gradient, eval mode and train mode (dropout 0.1 from the JAX plan's
    recorded bits, fused_dropout on both sides)."""
    jax, jnp = jx.jax, jx.jnp
    recorded = []

    class Recording(jx.tb._DropPlan):
        def __init__(self, bits_, rate):
            super().__init__(bits_, rate)
            recorded.append(np.asarray(bits_))

    monkeypatch.setattr(jx.tb, "_DropPlan", Recording)
    ids, mask = _ids()
    jenc, penc = _encoders(jx, "tower", "float32")
    params = jenc.init(jax.random.PRNGKey(5), jnp.asarray(ids),
                       jnp.asarray(mask))
    co = np.random.default_rng(6).normal(size=(3, 10, H)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(9)}

    def loss(p):
        out = jenc.apply(p, jnp.asarray(ids), jnp.asarray(mask), not train,
                         rngs=rngs)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(co)), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    _bridge(jx, penc, params).train(train)
    drop = None
    if train:
        assert recorded[-1].shape == (total_elems(H, L, HEADS, 3, 10),)
        drop = bits(recorded[-1].copy())
    out_p = penc(t(ids), t(mask), drop)
    close(out_p, out_j, 5e-5, what="hidden states")
    (out_p.float() * t(co)).sum().backward()
    from text_guided_face_recognition_tpu_torch.engine.from_jax import (
        state_dict_from_jax)
    gsd = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(g_j))["params"],
        None, module=penc)
    for name, p in penc.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        close(p.grad, gsd[name].numpy(), 2e-4, scaled=True, what=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_equals_both_in_port(dtype):
    """Same weights, same host bits (fused_dropout): `tower` reproduces
    `both`, values and gradients. In f32 to summation noise; in bf16 the tower's gradients
    are the half-layers' f32 ones rounded to bf16 (one bf16 step)."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    arch = ptb.TextArch(**ARCH)
    ids, mask = _ids()
    torch.manual_seed(0)
    both = ptb.TransformerEncoder(arch, tdt, False, "both",
                                  fused_dropout=True).train()
    tower = ptb.TransformerEncoder(arch, tdt, False, "tower",
                                   fused_dropout=True).train()
    with torch.no_grad():
        for p in both.parameters():
            p.copy_(torch.randn_like(p) * (0.05 if p.dim() > 1 else 0.1))
    tower.load_state_dict(both.state_dict())
    n = total_elems(H, L, HEADS, 3, 10)
    drop = bits(np.random.default_rng(3).integers(0, 1 << 32, n,
                                                  dtype=np.uint32))
    co = torch.randn(3, 10, H)
    outs = []
    for enc in (both, tower):
        out = enc(t(ids), t(mask), drop)
        (out.float() * co).sum().backward()
        outs.append(out)
    tol = 5e-5 if dtype == "float32" else 0.0
    torch.testing.assert_close(outs[1].float(), outs[0].float(), rtol=tol,
                               atol=tol)
    gtol = 2e-4 if dtype == "float32" else 2.0 ** -7
    for (name, a), (_, b_) in zip(both.named_parameters(),
                                  tower.named_parameters()):
        assert b_.grad.dtype == torch.float32, name
        err = (a.grad - b_.grad).abs().max().item()
        assert err <= gtol * max(1.0, a.grad.abs().max().item()), (name, err)
        if dtype == "bfloat16" and name.startswith("layer_"):
            # exactly the f32 gradient rounded to bf16, widened again
            torch.testing.assert_close(
                b_.grad, a.grad.bfloat16().float(), rtol=0, atol=0, msg=name)


def test_state_dict_keys_identical_for_none_and_tower():
    arch = ptb.TextArch(**ARCH)
    a = ptb.TransformerEncoder(arch, torch.float32, False, "none")
    b_ = ptb.TransformerEncoder(arch, torch.float32, True, "tower")
    assert list(a.state_dict()) == list(b_.state_dict())
    assert [n for n, _ in a.named_modules()] == [n for n, _ in
                                                 b_.named_modules()]
    for (k, v), w in zip(a.state_dict().items(), b_.state_dict().values()):
        assert v.shape == w.shape, k


def test_tower_eval_matches_unfused_and_saves_nothing():
    """Eval mode: `tower` against the ordinary modules, and the autograd
    Function keeps no residual when no gradient is needed."""
    arch = ptb.TextArch(**ARCH)
    ids, mask = _ids()
    torch.manual_seed(1)
    none = ptb.TransformerEncoder(arch, torch.float32, False, "none").eval()
    tower = ptb.TransformerEncoder(arch, torch.float32, False, "tower").eval()
    tower.load_state_dict(none.state_dict())
    with torch.no_grad():
        a, b_ = none(t(ids), t(mask)), tower(t(ids), t(mask))
    assert not b_.requires_grad
    torch.testing.assert_close(b_, a, rtol=5e-5, atol=5e-5)


def test_tower_wrapper_refuses_bad_inputs():
    lv, d = _leaves(), _data()
    pl = [a.detach() for a in _port_leaves(lv, torch.float32)]
    with pytest.raises(ValueError, match="bits"):
        block.tower_block(t(d["x"]), t(d["mask"]), *pl, B, T, HEADS, RATE)
    with pytest.raises(ValueError, match="rate"):
        block.tower_block(t(d["x"]), t(d["mask"]), *pl, B, T, HEADS, 1.5)
    with pytest.raises(ValueError, match="fused_block"):
        ptb.TransformerEncoder(ptb.TextArch(**ARCH), fused_block="towre")


# ------------------------------------------------------------- on a card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _close_cuda(a, b_, tol, scaled, what=""):
    a, b_ = a.float(), b_.float()
    if scaled:   # the chip_smoke.py rule for backward outputs
        err = (a - b_).abs().max().item()
        assert err <= tol * max(1.0, b_.abs().max().item()), (what, err)
    else:
        torch.testing.assert_close(a, b_, rtol=tol, atol=tol, msg=what)


def _flat_bits(d, dev):
    """The three bit arrays as strided views of one flat draw, per layer
    p | h | f, as the model passes them."""
    n_p, n_h = HEADS * B * T * T, R * H
    flat = torch.cat([torch.cat([bits(d[k][j]).reshape(-1)
                                 for k in ("bits_p", "bits_h", "bits_f")])
                      for j in range(L)]).to(dev).view(L, n_p + 2 * n_h)
    return (flat[:, :n_p].unflatten(1, (HEADS * B, T, T)),
            flat[:, n_p:n_p + n_h].unflatten(1, (R, H)),
            flat[:, n_p + n_h:].unflatten(1, (R, H)))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_tower_matches_plain(cuda, tdt, tol, rate):
    lv, d = _leaves(2), _data(2)
    pl = [a.detach() for a in _port_leaves(lv, tdt, cuda)]
    x, dz = t(d["x"], tdt).to(cuda), t(d["dz"], tdt).to(cuda)
    mask = t(d["mask"]).to(cuda)
    pb = _flat_bits(d, cuda) if rate else (None, None, None)
    n7, n8 = block.tower_block.launches, block.tower_block_bwd.launches
    got = block.tower_block_fwd(x, mask, *pl, B, T, HEADS, *pb, rate)
    assert block.tower_block.launches == n7 + 1
    ref = block.tower_block_fwd_ref(x, mask, *pl, B, T, HEADS, *pb, rate)
    names = ("z", "xin", "qkv", "p", "o", "r1", "f", "r2")
    for name, a, b_ in zip(names, got, ref):
        _close_cuda(a, b_, tol, False, name)
    # eval mode: no residuals, the same z
    z_eval = block.tower_block_fwd(x, mask, *pl, B, T, HEADS, *pb, rate,
                                   save=False)
    assert all(r is None for r in z_eval[1:])
    _close_cuda(z_eval[0], ref[0], tol, False, "z (no residuals)")
    by = dict(zip(block.TOWER_LEAVES, pl))
    args = (*ref[1:], *(by[k] for k in ("wqkv", "wo", "g1", "b1", "w1", "w2",
                                        "g2")), B, T, HEADS, *pb, rate)
    grads = block.tower_block_bwd(dz, mask, *args)
    assert block.tower_block_bwd.launches == n8 + 1
    want = block.tower_block_bwd_ref(dz, mask, *args)
    for name, a, b_ in zip(("dx",) + block.TOWER_LEAVES, grads, want):
        assert a.dtype == tdt and a.shape == b_.shape, name
        _close_cuda(a, b_, tol, True, name)


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [129, 512])
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_tower_matches_plain_at_long_captions(cuda, tdt, tol, t_len):
    """K7 and K8 at T past 128 and at bert-base's 512 (B 2, dropout from
    host bits): the forward with and without residuals (bf16: the
    tensor-core attention tile, f32: the strip tile) and the backward,
    against their plain versions, as above; in bf16 the two residual sums
    r1, r2 and the output z to the tolerance times their largest element,
    as chip_smoke.py holds K7 (where the addends of r nearly cancel, a
    flipped bf16 rounding of one addend is a step at an element near
    zero, and layer 0's flips are carried into layer 1)."""
    b = 2
    lv, d = _leaves(5), _data(5, b=b, t_=t_len)
    pl = [a.detach() for a in _port_leaves(lv, tdt, cuda)]
    x, dz = t(d["x"], tdt).to(cuda), t(d["dz"], tdt).to(cuda)
    mask = t(d["mask"]).to(cuda)
    pb = [bits(d[k]).to(cuda) for k in ("bits_p", "bits_h", "bits_f")]
    got = block.tower_block_fwd(x, mask, *pl, b, t_len, HEADS, *pb, RATE)
    ref = block.tower_block_fwd_ref(x, mask, *pl, b, t_len, HEADS, *pb, RATE)
    carried = tdt == torch.bfloat16
    for name, a, b_ in zip(("z", "xin", "qkv", "p", "o", "r1", "f", "r2"),
                           got, ref):
        _close_cuda(a, b_, tol, carried and name in ("z", "r1", "r2"), name)
    z_eval = block.tower_block_fwd(x, mask, *pl, b, t_len, HEADS, *pb, RATE,
                                   save=False)[0]
    _close_cuda(z_eval, ref[0], tol, carried, "z (no residuals)")
    by = dict(zip(block.TOWER_LEAVES, pl))
    args = (*ref[1:], *(by[k] for k in ("wqkv", "wo", "g1", "b1", "w1", "w2",
                                        "g2")), b, t_len, HEADS, *pb, RATE)
    grads = block.tower_block_bwd(dz, mask, *args)
    want = block.tower_block_bwd_ref(dz, mask, *args)
    for name, a, b_ in zip(("dx",) + block.TOWER_LEAVES, grads, want):
        _close_cuda(a, b_, tol, True, name)


@pytest.mark.cuda
def test_cuda_tower_autograd_and_refusals(cuda):
    lv, d = _leaves(3), _data(3)
    pl = _port_leaves(lv, torch.float32, cuda)
    x = t(d["x"]).to(cuda).requires_grad_(True)
    mask = t(d["mask"]).to(cuda)
    z = block.tower_block(x, mask, *pl, B, T, HEADS)
    g = torch.autograd.grad(z, [x] + pl, t(d["dz"]).to(cuda))
    xr = x.detach().clone().requires_grad_(True)
    plr = [a.detach().clone().requires_grad_(True) for a in pl]
    zr = block.tower_block_ref(xr, mask, *plr, B, T, HEADS)
    gr = torch.autograd.grad(zr, [xr] + plr, t(d["dz"]).to(cuda))
    for a, b_ in zip(g, gr):
        _close_cuda(a, b_, 1e-4, True)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(pl)
        bad[0] = pl[0].detach().contiguous()       # (L, in, out) storage
        block.tower_block_fwd(x.detach(), mask, *bad, B, T, HEADS)
    with pytest.raises(ValueError, match=f"t <= {block.MAX_T}"):
        block.tower_block_fwd(torch.randn(2 * 513, H, device=cuda),
                              torch.ones((2, 513), dtype=torch.int32,
                                         device=cuda),
                              *[a.detach() for a in pl], 2, 513, HEADS)
