"""The training slice's kernel modules and losses against the JAX package:
the plain backwards of K2 (ops/layernorm.py), K4 and K6 (ops/block.py), the
train-mode forwards of K3 and K5 with their residuals, K9's plain version
and its gradient (ops/damsm.py), the losses (ops/losses.py), ArcFace
margins (ops/margins.py), dropout (ops/dropout.py) and train-mode
BatchNorm / ImageHeading (models/).

On the CPU each port wrapper runs its plain PyTorch version; the JAX
kernels run in Pallas interpret mode with host dropout bits
(`use_prng=False`), the same uint32 bits on both sides (int32-held on the
port's). Gradients are held through the port's autograd Functions against
`jax.vjp` of the JAX custom VJPs. Tolerances (assert_allclose,
rtol = atol): f32 5e-5, bf16 2e-2 for the kernels, as tests/test_torch_ops.py
(summation order, the TPU kernel's A-S erf; in bf16 roundings on the other
side of a step); a weight or bias gradient, a sum over the 48 rows, is held
to the same tolerance times its largest element. DAMSM 2e-5 (the Pallas
kernel's eps clamps against the plain function, as tests/test_pallas.py);
losses, margins and BatchNorm values 1e-5 (f32), the losses' and margins'
gradients 1e-4 (times their largest element: f32 sums over B x B terms
of magnitude up to 500).

The `cuda`-marked cases hold each new CUDA kernel against its plain version
on a card (K9 at DAMSM_ATOL, absolute) and skip elsewhere; the JAX package is imported inside fixtures,
so on a machine with a card and no JAX they run alone:
  python -m pytest tests/test_torch_train_ops.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch.ops import (
    attention, block, damsm, dropout, layernorm, losses, margins)

B, T, H, HEADS, I = 4, 12, 256, 4, 512    # d_head = 64, as the kernels take
R = B * T
RATE = 0.1
DTYPES = [("float32", torch.float32, 5e-5), ("bfloat16", torch.bfloat16, 2e-2)]


class _Jax:
    """The JAX side: its Pallas kernels in interpret mode, host bits."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from text_guided_face_recognition_tpu.ops import block_pallas
        from text_guided_face_recognition_tpu.ops.layernorm_pallas import (
            layernorm_fused)
        self.jax, self.jnp = jax, jnp
        self.layernorm = layernorm_fused
        self.bp = block_pallas
        self.dummy = jnp.zeros((8, 128), jnp.uint32)
        self.seed = jnp.zeros((1, 1), jnp.int32)

    def a(self, x, dtype="float32"):
        return self.jnp.asarray(x, dtype)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    return _Jax()


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def close(port, ref, tol: float, scaled: bool = False, what: str = ""):
    ref = np.asarray(ref, np.float32)
    atol = tol * max(1.0, float(np.abs(ref).max())) if scaled else tol
    np.testing.assert_allclose(port.detach().float().numpy(), ref,
                               rtol=tol, atol=atol, err_msg=what)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(R, H)).astype(f),
        dy=rng.normal(size=(R, H)).astype(f),
        wqkv=(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(f),
        bqkv=rng.normal(0, 0.1, 3 * H).astype(f),
        wo=(rng.normal(size=(H, H)) / np.sqrt(H)).astype(f),
        bo=rng.normal(0, 0.1, H).astype(f),
        w1=(rng.normal(size=(H, I)) / np.sqrt(H)).astype(f),
        c1=rng.normal(0, 0.1, I).astype(f),
        w2=(rng.normal(size=(I, H)) / np.sqrt(I)).astype(f),
        c2=rng.normal(0, 0.1, H).astype(f),
        g=(1 + rng.normal(0, 0.1, H)).astype(f),
        b=rng.normal(0, 0.1, H).astype(f),
        bits_p=rng.integers(0, 1 << 32, (HEADS * B, T, T), dtype=np.uint32),
        bits_h=rng.integers(0, 1 << 32, (R, H), dtype=np.uint32))


def ragged_mask(b: int, t_: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, t_ + 1, size=b)
    lens[0] = t_
    return (np.arange(t_)[None, :] < lens[:, None]).astype(np.int32)


def bits(u32: np.ndarray) -> torch.Tensor:
    """uint32 bits as the port holds them: int32 patterns."""
    return t(u32.view(np.int32))


def _grads(out, inputs, cot):
    return torch.autograd.grad(out, inputs, cot)


# ---------------------------------------------------------------- K2 --

@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_layernorm_backward_matches_jax(jx, jdt, tdt, tol):
    p = _params()
    x = p["x"] * 3.0 + 1.0
    y, vjp = jx.jax.vjp(lambda x_, g_, b_: jx.layernorm(x_, g_, b_, 1e-12,
                                                        True),
                        jx.a(x, jdt), jx.a(p["g"]), jx.a(p["b"]))
    dx_j, dg_j, db_j = vjp(jx.a(p["dy"], jdt))
    # the plain backward
    dx, dg, db = layernorm.layernorm_bwd_ref(t(p["dy"], tdt), t(x, tdt),
                                             t(p["g"]))
    close(dx, dx_j, tol)
    close(dg, dg_j, tol, scaled=True)
    close(db, db_j, tol, scaled=True)
    # and through the autograd Function
    xs, gs, bs = (t(x, tdt).requires_grad_(), t(p["g"]).requires_grad_(),
                  t(p["b"]).requires_grad_())
    out = layernorm.layernorm_fused(xs, gs, bs)
    close(out, y, tol)
    for a, b in zip(_grads(out, (xs, gs, bs), t(p["dy"], tdt)),
                    (dx_j, dg_j, db_j)):
        close(a, b, tol, scaled=True)


# (rows, H) the LayerNorm kernels' paths serve: H not a multiple of the
# 16-byte vector (389: the scalar path), the flagship 768 x 768, the widest
# row (1024), a row narrower than a warp's vectors (8)
LN_SHAPES = [(37, 389), (768, 768), (50, 1024), (9, 8)]


def ln_data(rows: int, h: int, seed: int = 0):
    """x (rows, h) off zero mean and unit scale, gamma, dy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(rows, h)).astype(f) * 3.0 + 1.0,
            (1 + rng.normal(0, 0.1, h)).astype(f),
            rng.normal(size=(rows, h)).astype(f))


@pytest.mark.parametrize("rows,h", LN_SHAPES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_layernorm_backward_matches_jax_at_kernel_shapes(jx, jdt, tdt, tol,
                                                         rows, h):
    x, g, dy = ln_data(rows, h)
    beta = np.zeros(h, np.float32)
    _, vjp = jx.jax.vjp(lambda x_, g_, b_: jx.layernorm(x_, g_, b_, 1e-12,
                                                        True),
                        jx.a(x, jdt), jx.a(g), jx.a(beta))
    want = [np.asarray(a, np.float32) for a in vjp(jx.a(dy, jdt))]
    dx, dg, db = layernorm.layernorm_bwd_ref(t(dy, tdt), t(x, tdt), t(g))
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    close(dx, want[0], tol, what="dx")
    close(dg, want[1], tol, scaled=True, what="dgamma")
    close(db, want[2], tol, scaled=True, what="dbeta")


def test_ln_bwd_parts_counts_blocks_and_groups():
    # a partial row per block of 8 rows, then one per group of blocks
    assert [layernorm.ln_bwd_parts(r) for r in (1, 8, 9, 384, 768, 1025)] \
        == [9, 9, 10, 56, 104, 137]


# ---------------------------------------------------------------- K4 --

@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_ffn_block_train_matches_jax(jx, jdt, tdt, tol, rate):
    p = _params(1)
    names = ("w1", "c1", "w2", "c2", "g", "b")
    jb = jx.a(p["bits_h"], "uint32") if rate else jx.dummy
    tb = bits(p["bits_h"]) if rate else None

    def f(x_, *w):
        return jx.bp.ffn_block(x_, *w, jb, jx.seed, rate, 1e-12, False, True)

    args_j = (jx.a(p["x"], jdt), *(jx.a(p[k]) for k in names))
    z_j, vjp = jx.jax.vjp(f, *args_j)
    grads_j = vjp(jx.a(p["dy"], jdt))
    _, (_, f_j, r_j, *_) = jx.bp._ffn_fwd(*args_j, jb, jx.seed, rate, 1e-12,
                                          False, True)
    # forward residuals: (z, f, act, r)
    z, f_p, act, r = block.ffn_block_fwd_ref(
        t(p["x"], tdt), *(t(p[k]) for k in names), tb, rate)
    for a, b in ((z, z_j), (f_p, f_j), (r, r_j)):
        close(a, b, tol)
    # the plain backward and the autograd Function
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in names]
    out = block.ffn_block(*ins, rate=rate, bits=tb)
    close(out, z_j, tol)
    # (on the CPU the Function's backward is ffn_block_bwd_ref)
    got = _grads(out, ins, t(p["dy"], tdt))
    for i, (a, b) in enumerate(zip(got, grads_j)):
        close(a, b, tol, scaled=i > 0, what=f"grad {i}")


# ---------------------------------------------------------------- K6 --

@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_attn_block_train_matches_jax(jx, jdt, tdt, tol, rate):
    p = _params(2)
    mask = ragged_mask(B, T, 2)
    names = ("wqkv", "bqkv", "wo", "bo", "g", "b")
    jbp = jx.a(p["bits_p"], "uint32") if rate else jx.dummy
    jbh = jx.a(p["bits_h"], "uint32") if rate else jx.dummy
    tbp = bits(p["bits_p"]) if rate else None
    tbh = bits(p["bits_h"]) if rate else None
    jmask = jx.a(mask, "int32")

    def f(x_, *w):
        return jx.bp.attn_block(x_, jmask, *w, jbp, jbh, jx.seed, B, T,
                                HEADS, rate, 1e-12, False, True)

    args_j = (jx.a(p["x"], jdt), *(jx.a(p[k]) for k in names))
    y_j, vjp = jx.jax.vjp(f, *args_j)
    grads_j = vjp(jx.a(p["dy"], jdt))
    _, (_, _, qkv_j, p_j, o_j, r_j, *_) = jx.bp._attn_fwd(
        args_j[0], jmask, *args_j[1:], jbp, jbh, jx.seed, B, T, HEADS, rate,
        1e-12, False, True)
    y, qkv, pp, o, r = block.attn_block_fwd_ref(
        t(p["x"], tdt), t(mask), *(t(p[k]) for k in names), B, T, HEADS,
        tbp, tbh, rate)
    for a, b in ((y, y_j), (qkv, qkv_j), (pp, p_j), (o, o_j), (r, r_j)):
        close(a, b, tol)
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in names]
    out = block.attn_block(ins[0], t(mask), *ins[1:], B, T, HEADS, rate,
                           bits_p=tbp, bits_h=tbh)
    close(out, y_j, tol)
    got = _grads(out, ins, t(p["dy"], tdt))
    assert len(got) == len(grads_j) == 7
    for i, (a, b) in enumerate(zip(got, grads_j)):
        close(a, b, tol, scaled=i > 0, what=f"grad {i}")


@pytest.mark.parametrize("t_len", [72, 160])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_attn_block_train_matches_jax_at_a_long_caption(jx, jdt, tdt, tol,
                                                        t_len):
    """attn_block with its residuals and gradients at a caption longer
    than the 64 tokens the bf16 training kernels took before, and at 160,
    past the 128 of the scalar forward tile and the f32 tiles of before
    (2 captions, H 128, 2 heads, a ragged mask), host bits, against the JAX
    kernel (`_attn_fwd`, `_attn_bwd` through its VJP) in Pallas interpret
    mode."""
    b, h, heads = 2, 128, 2
    rng = np.random.default_rng(t_len)
    f = np.float32
    r = b * t_len
    p = dict(x=rng.normal(size=(r, h)).astype(f),
             dy=rng.normal(size=(r, h)).astype(f),
             wqkv=(rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(f),
             bqkv=rng.normal(0, 0.1, 3 * h).astype(f),
             wo=(rng.normal(size=(h, h)) / np.sqrt(h)).astype(f),
             bo=rng.normal(0, 0.1, h).astype(f),
             g=(1 + rng.normal(0, 0.1, h)).astype(f),
             b=rng.normal(0, 0.1, h).astype(f))
    bp = rng.integers(0, 1 << 32, (heads * b, t_len, t_len), dtype=np.uint32)
    bh = rng.integers(0, 1 << 32, (r, h), dtype=np.uint32)
    mask = ragged_mask(b, t_len, 5)
    names = ("wqkv", "bqkv", "wo", "bo", "g", "b")
    jmask = jx.a(mask, "int32")
    jbp, jbh = jx.a(bp, "uint32"), jx.a(bh, "uint32")

    def fj(x_, *w):
        return jx.bp.attn_block(x_, jmask, *w, jbp, jbh, jx.seed, b, t_len,
                                heads, RATE, 1e-12, False, True)

    args_j = (jx.a(p["x"], jdt), *(jx.a(p[k]) for k in names))
    y_j, vjp = jx.jax.vjp(fj, *args_j)
    grads_j = vjp(jx.a(p["dy"], jdt))
    _, (_, _, qkv_j, p_j, o_j, r_j, *_) = jx.bp._attn_fwd(
        args_j[0], jmask, *args_j[1:], jbp, jbh, jx.seed, b, t_len, heads,
        RATE, 1e-12, False, True)
    got = block.attn_block_fwd_ref(
        t(p["x"], tdt), t(mask), *(t(p[k]) for k in names), b, t_len, heads,
        bits(bp), bits(bh), RATE)
    for a, c in zip(got, (y_j, qkv_j, p_j, o_j, r_j)):
        close(a, c, tol)
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in names]
    out = block.attn_block(ins[0], t(mask), *ins[1:], b, t_len, heads, RATE,
                           bits_p=bits(bp), bits_h=bits(bh))
    close(out, y_j, tol)
    for i, (a, c) in enumerate(zip(_grads(out, ins, t(p["dy"], tdt)),
                                   grads_j)):
        close(a, c, tol, scaled=i > 0, what=f"grad {i}")


def test_dropout_matches_the_jax_plan(jx):
    from text_guided_face_recognition_tpu.models.text_bert import _DropPlan
    rng = np.random.default_rng(3)
    u32 = rng.integers(0, 1 << 32, (2, 1000), dtype=np.uint32)
    x = rng.normal(size=(2, 1000)).astype(np.float32)
    for jdt, tdt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        plan = _DropPlan(jx.a(u32.reshape(-1), "uint32"), RATE)
        want = np.asarray(plan.take(jx.a(x, jdt)), np.float32)
        got = dropout.dropout(t(x, tdt), bits(u32), RATE).float().numpy()
        np.testing.assert_array_equal(got, want)
    assert dropout.threshold(RATE) == int(plan.threshold)


# ---------------------------------------------------------------- K9 --

def _damsm_data(seed=0, b=6, d=32, t_=7, r=49):
    rng = np.random.default_rng(seed)
    words = rng.normal(size=(b, d, t_)).astype(np.float32)
    regions = rng.normal(size=(b, d, r)).astype(np.float32)
    lens = rng.integers(min(2, t_), t_ + 1, b)
    return words, regions, np.arange(t_)[None, :] < lens[:, None]


@pytest.mark.parametrize("masked", [True, False])
def test_damsm_plain_matches_pallas_kernel(jx, masked):
    from text_guided_face_recognition_tpu.ops.damsm_pallas import (
        damsm_similarity_pallas)
    words, regions, mask = _damsm_data(0)
    jm = jx.jnp.asarray(mask) if masked else None
    want = damsm_similarity_pallas(jx.a(words), jx.a(regions), 4.0, 5.0, jm,
                                   interpret=True)
    got = attention.damsm_similarity(t(words), t(regions), 4.0, 5.0,
                                     t(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_func_attention_and_plain_damsm_match_jax(jx, masked):
    """The plain ops of module ops/attention.py against the JAX package's
    (f32, 1e-5)."""
    from text_guided_face_recognition_tpu.ops import attention as JA
    words, regions, mask = _damsm_data(2, r=16)
    jm = jx.jnp.asarray(mask) if masked else None
    tm = t(mask) if masked else None
    regions4 = regions.reshape(*regions.shape[:2], 4, 4)
    for got, want in zip(
            attention.func_attention(t(words), t(regions4), 4.0, tm),
            JA.func_attention(jx.a(words), jx.a(regions4), 4.0, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    got = attention.damsm_similarity(t(words), t(regions), 4.0, 5.0, tm)
    want = JA.damsm_similarity(jx.a(words), jx.a(regions), 4.0, 5.0, jm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_damsm_plain_matches_pallas_kernel_past_5120_pairs(jx, masked):
    """Regions x words 196 x 40 = 7840, past the 5120 that K9 once took:
    the plain version K9 is held to against the JAX kernel (interpret
    mode), which has no such limit (2e-5, as above)."""
    from text_guided_face_recognition_tpu.ops.damsm_pallas import (
        damsm_similarity_pallas)
    words, regions, mask = _damsm_data(3, b=2, d=16, t_=40, r=196)
    jm = jx.jnp.asarray(mask) if masked else None
    want = damsm_similarity_pallas(jx.a(words), jx.a(regions), 4.0, 5.0, jm,
                                   interpret=True)
    got = attention.damsm_similarity(t(words), t(regions), 4.0, 5.0,
                                     t(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d,gamma1", [(640, 4.0), (32, 80.0), (32, -80.0)])
def test_damsm_plain_matches_pallas_kernel_at_any_width_and_gamma1(
        jx, d, gamma1):
    """The plain version K9 is held to, against the JAX kernel (interpret
    mode), past the kernel's bounds of before: D 640 (the wide path on the
    card) and |GAMMA1| 80 (its running maximum), B 4, T 8, R 16, masked;
    1e-4 (the JAX kernel subtracts the true maximum, the plain version
    softmaxes)."""
    from text_guided_face_recognition_tpu.ops.damsm_pallas import (
        damsm_similarity_pallas)
    words, regions, mask = _damsm_data(4, b=4, d=d, t_=8, r=16)
    want = damsm_similarity_pallas(jx.a(words), jx.a(regions), gamma1, 5.0,
                                   jx.jnp.asarray(mask), interpret=True)
    got = attention.damsm_similarity(t(words), t(regions), gamma1, 5.0,
                                     t(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d", [64, 256, 512])
def test_damsm_plan_fits_and_takes_the_long_path_where_words_do_not_fit(d):
    """K9's launch plan for every caption length up to bert-base's 512
    tokens and 7 x 7, 14 x 14 and 28 x 28 regions: its shared memory fits
    a block (232,448 bytes on the H100), and it takes the long path
    exactly where one caption's words do not fit in a block's word
    columns; the short path's captions fit, the long path's chunks cover
    the caption, and the grid covers every (caption, image) pair."""
    assert damsm.SMEM_LIMIT == 232448
    for r in (49, 196, 784):
        for t_ in range(1, 513):
            p = damsm.damsm_plan(32, d, t_, r)
            assert p["smem"] <= damsm.SMEM_LIMIT, (d, r, t_, p)
            assert p["smem"] == damsm.damsm_smem(p["dp"], p["n"])
            assert p["long"] == (t_ > p["n"]), (d, r, t_, p)
            assert p["slices"] == 1
            if p["long"]:
                assert p["g"] == 1 and p["grid"] == (32, 32, 1)
                assert (p["word_chunks"] - 1) * p["n"] < t_ <= \
                    p["word_chunks"] * p["n"]
            else:
                assert 1 <= p["g"] and p["g"] * t_ <= p["n"]
                assert p["grid"][0] * p["g"] >= 32 and p["grid"][1] == 32
                assert p["g"] == 32 or (p["g"] + 1) * t_ > p["n"]
    # one feature past the block's 512: the wide path, two slices
    p = damsm.damsm_plan(32, 513, 22, 196)
    assert p["slices"] == 2 and p["long"] and p["grid"] == (32, 32, 2)
    with pytest.raises(ValueError, match="empty"):
        damsm.damsm_plan(32, 256, 0, 196)


@pytest.mark.parametrize("t_", [1, 22, 33, 510])
def test_damsm_plan_takes_every_width_up_to_2048(t_):
    """K9's plan for every feature width D from 1 to 2048 (B 32, R 196):
    its shared memory fits a block and is the layout's (damsm_smem); up to
    SLICE_D features a block holds the whole of D, past it D is split into
    ceil(D / SLICE_D) slices of equal rounded rows that cover D, each a
    block's (the wide path: one caption a block, in chunks of 32 words)."""
    for d in range(1, 2049):
        p = damsm.damsm_plan(32, d, t_, 196)
        assert p["smem"] <= damsm.SMEM_LIMIT, (d, t_, p)
        assert p["smem"] == damsm.damsm_smem(p["dp"], p["n"]), (d, p)
        assert p["slices"] == -(-d // damsm.SLICE_D), (d, p)
        assert p["dp"] % 16 == 0 and p["dp"] <= damsm.SLICE_D, (d, p)
        assert (p["slices"] - 1) * p["dp"] < d <= p["slices"] * p["dp"]
        assert p["grid"][1:] == (32, p["slices"]), (d, p)
        if p["slices"] == 1:
            assert p["dp"] == -(-d // 16) * 16
            assert p["n"] == (96 if p["dp"] <= 256 else 32)
        else:
            assert p["dp"] > 256 and p["n"] == 32 and p["long"], (d, p)
            assert p["g"] == 1 and p["grid"][0] == 32
            assert p["word_chunks"] == -(-t_ // 32)


def test_damsm_kernel_limits_refused_at_the_config_check():
    """With use_pallas, K9 takes any word-feature width and any GAMMA1, as
    the JAX kernel does: check_stage1 passes at D 513, 1024 and 2048 and
    at GAMMA1 +-100 (past the 60 where the kernel's gamma1 softmax turns
    to its running maximum), in bf16 and f32, with fused_block both and
    tower, and with use_pallas off."""
    from text_guided_face_recognition_tpu_torch import config as pconfig
    base = pconfig.TGFRConfig().replace(use_pallas=True)
    smooth = base.TRAIN.SMOOTH
    for dtype in ("bfloat16", "float32"):
        for fb in ("both", "tower"):
            cfg = base.replace(compute_dtype=dtype, fused_block=fb)
            for d in (512, 513, 1024, 2048):
                pconfig.check_stage1(
                    cfg.replace(aux_feat_dim_per_granularity=d))
            for g1 in (60.0, -60.0, 100.0, -100.0):
                train = pconfig.TrainCfg(SMOOTH=pconfig.TrainSmooth(
                    GAMMA1=g1, GAMMA2=smooth.GAMMA2, GAMMA3=smooth.GAMMA3))
                pconfig.check_stage1(cfg.replace(TRAIN=train))
                pconfig.check_stage1(cfg.replace(
                    TRAIN=train, aux_feat_dim_per_granularity=1024,
                    bert_words_num=512))
                pconfig.check_stage1(cfg.replace(TRAIN=train,
                                                 use_pallas=False))
    assert not hasattr(pconfig, "check_damsm")


def test_damsm_gradient_matches_jax_custom_vjp(jx, monkeypatch):
    from text_guided_face_recognition_tpu.ops import damsm_pallas as DP
    orig = DP.damsm_similarity_pallas
    monkeypatch.setattr(DP, "damsm_similarity_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    words, regions, mask = _damsm_data(1)
    jm = jx.jnp.asarray(mask)
    tanh = jx.jnp.tanh

    def loss(w, r):
        return jx.jnp.sum(tanh(DP.damsm_similarity_fused(w, r, 4.0, 5.0,
                                                         jm)))

    val, (gw, gr) = jx.jax.value_and_grad(loss, argnums=(0, 1))(
        jx.a(words), jx.a(regions))
    w, r = t(words).requires_grad_(), t(regions).requires_grad_()
    out = torch.tanh(damsm.damsm_similarity_fused(w, r, 4.0, 5.0,
                                                  t(mask))).sum()
    out.backward()
    np.testing.assert_allclose(float(out), float(val), rtol=2e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), atol=2e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), atol=2e-5)


# ----------------------------------------------------- losses, margins --

def _loss_inputs(seed=4, b=6, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32),
            np.array([0, 1, 1, 2, 3, 3], np.int32))


def test_losses_match_jax(jx):
    from text_guided_face_recognition_tpu.ops import losses as JL
    a, b_, cls = _loss_inputs()
    labels = np.arange(len(cls))
    words, regions, mask = _damsm_data(5, b=6, d=16, t_=5, r=16)
    regions4 = regions.reshape(6, 16, 4, 4)
    jfns = {
        "sent": lambda x, y: sum(JL.sent_loss(x, y, jx.jnp.asarray(labels),
                                              jx.jnp.asarray(cls), 10.0)),
        "global": lambda x, y: JL.global_loss(x, y),
        "cosine": lambda x, y: jx.jnp.sum(JL.cosine_similarity(x, y)),
        "words": lambda x, y: sum(JL.words_loss(
            x, y, jx.jnp.asarray(labels), 4.0, 5.0, 10.0,
            word_mask=jx.jnp.asarray(mask))),
        "focal": lambda x, y: JL.focal_loss(x @ y.T, jx.jnp.asarray(labels)),
    }
    tfns = {
        "sent": lambda x, y: sum(losses.sent_loss(x, y, t(labels), t(cls),
                                                  10.0)),
        "global": lambda x, y: losses.global_loss(x, y),
        "cosine": lambda x, y: losses.cosine_similarity(x, y).sum(),
        "words": lambda x, y: sum(losses.words_loss(
            x, y, t(labels), 4.0, 5.0, 10.0, word_mask=t(mask))),
        "focal": lambda x, y: losses.focal_loss(x @ y.t(), t(labels)),
    }
    for name in jfns:
        xs, ys = (regions4, words) if name == "words" else (a, b_)
        val, grads = jx.jax.value_and_grad(jfns[name], argnums=(0, 1))(
            jx.a(xs), jx.a(ys))
        xt, yt = t(xs).requires_grad_(), t(ys).requires_grad_()
        out = tfns[name](xt, yt)
        out.backward()
        np.testing.assert_allclose(float(out), float(val), rtol=1e-5,
                                   err_msg=name)
        for g, want in zip((xt.grad, yt.grad), grads):
            close(g, want, 1e-4, scaled=True, what=name)


def test_arc_margin_matches_jax_and_guards_the_nan_cliff(jx):
    from text_guided_face_recognition_tpu.ops import margins as JM
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    weight = rng.normal(size=(5, 8)).astype(np.float32)
    label = np.array([0, 2, 4, 1], np.int32)
    for s, m in ((30.0, 0.5), (35.0, 0.5)):
        def jloss(e, w):
            return jx.jnp.sum(JM.arc_margin_logits(e, w, jx.jnp.asarray(
                label), s=s, m=m) ** 2)
        val, (ge, gw) = jx.jax.value_and_grad(jloss, argnums=(0, 1))(
            jx.a(emb), jx.a(weight))
        et, wt = t(emb).requires_grad_(), t(weight).requires_grad_()
        out = (margins.arc_margin_logits(et, wt, t(label), s=s, m=m) ** 2
               ).sum()
        out.backward()
        np.testing.assert_allclose(float(out), float(val), rtol=1e-5)
        close(et.grad, ge, 1e-4, scaled=True)
        close(wt.grad, gw, 1e-4, scaled=True)
    # a target cosine of exactly 1: without the floor under 1 - cos^2 the
    # backward would be 0 * inf = NaN
    weight[2] = emb[1] * 3.0
    et, wt = t(emb).requires_grad_(), t(weight).requires_grad_()
    margins.arc_margin_logits(et, wt, t(label)).sum().backward()
    assert torch.isfinite(et.grad).all() and torch.isfinite(wt.grad).all()


# ------------------------------------------------ train-mode BatchNorm --

@pytest.mark.parametrize("jdt,tdt,tol", [("float32", torch.float32, 1e-5),
                                         ("bfloat16", torch.bfloat16, 2e-2)])
def test_batchnorm_train_matches_flax(jx, jdt, tdt, tol):
    from flax import linen as nn
    from text_guided_face_recognition_tpu_torch.models.layers import (
        BatchNorm)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4, 5, 5, 6)) * 2.0 + 0.5).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jdt)
    v = bn.init(jx.jax.random.PRNGKey(0), jx.a(x))
    scale = (1 + rng.normal(0, 0.1, 6)).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    mean0 = rng.normal(0, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    params = {"scale": jx.a(scale), "bias": jx.a(bias)}
    stats = {"mean": jx.a(mean0), "var": jx.a(var0)}
    del v

    def f(prm, xx):
        y, upd = bn.apply({"params": prm, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jx.jnp.sum(y.astype(jx.jnp.float32) ** 2), (y, upd)

    (val, (y_j, upd)), (gp, gx) = jx.jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jx.a(x))
    port = BatchNorm(6, dtype=tdt).train()
    with torch.no_grad():
        port.weight.copy_(t(scale))
        port.bias.copy_(t(bias))
        port.running_mean.copy_(t(mean0))
        port.running_var.copy_(t(var0))
    xt = t(x.transpose(0, 3, 1, 2)).requires_grad_()
    y = port(xt)
    (y.float() ** 2).sum().backward()
    close(y.permute(0, 2, 3, 1), y_j, tol)
    new = upd["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5, atol=1e-6)
    close(port.weight.grad, gp["scale"], tol, scaled=True)
    close(port.bias.grad, gp["bias"], tol, scaled=True)
    close(xt.grad.permute(0, 2, 3, 1), gx, tol, scaled=True)


def test_image_heading_train_matches_jax(jx):
    from text_guided_face_recognition_tpu import models as JMod
    from text_guided_face_recognition_tpu_torch import models as PMod
    from _torch_port import bridge, randomize_stats
    head = JMod.ImageHeading(feat_dim=64)
    z = jx.jnp.zeros
    v = randomize_stats(head.init(jx.jax.random.PRNGKey(0), z((1, 512)),
                                  z((1, 7, 7, 32))), 8)
    rng = np.random.default_rng(9)
    g = rng.normal(size=(3, 512)).astype(np.float32)
    l_ = rng.normal(size=(3, 7, 7, 32)).astype(np.float32)
    (gf, lf), upd = head.apply(v, jx.a(g), jx.a(l_), train=True,
                               mutable=["batch_stats"])
    port = bridge(PMod.ImageHeading(feat_dim=64, local_channels=32,
                                    spatial=7), v).train()
    pg, pl = port(t(g), t(l_.transpose(0, 3, 1, 2)))
    close(pg, gf, 1e-5)
    close(pl.permute(0, 2, 3, 1), lf, 1e-5)
    bn = port.imim.bn_img
    new = upd["batch_stats"]["imim"]["bn_img"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- on a CUDA card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, p):
    """p on the card, each weight as the .t() view of a contiguous (out, in)
    tensor, as the model passes its nn.Linear weights."""
    out = {k: (bits(v) if v.dtype == np.uint32 else t(v)).to(dev)
           for k, v in p.items()}
    for k in ("wqkv", "wo", "w1", "w2"):
        out[k] = out[k].t().contiguous().t()
    return out


CUDA_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _close_cuda(a, b, tol, scaled):
    a, b = a.float(), b.float()
    if scaled:   # the chip_smoke.py rule for backward outputs
        assert (a - b).abs().max() <= tol * max(1.0, b.abs().max().item())
    else:
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_bwd_matches_plain(cuda, tdt, tol):
    p = _on(cuda, _params())
    x, dy = p["x"].to(tdt), p["dy"].to(tdt)
    n = layernorm.layernorm_bwd.launches
    got = layernorm.layernorm_bwd(dy, x, p["g"])
    assert layernorm.layernorm_bwd.launches == n + 1
    for a, b in zip(got, layernorm.layernorm_bwd_ref(dy, x, p["g"])):
        _close_cuda(a, b, tol, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", LN_SHAPES)
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_bwd_matches_plain_at_kernel_shapes(cuda, tdt, tol,
                                                           rows, h):
    x, g, dy = (t(a).to(cuda) for a in ln_data(rows, h))
    x, dy = x.to(tdt), dy.to(tdt)
    for a, b in zip(layernorm.layernorm_bwd(dy, x, g),
                    layernorm.layernorm_bwd_ref(dy, x, g)):
        _close_cuda(a, b, tol, True)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_bwd_takes_unaligned_rows(cuda, tdt, tol):
    # x and dy one element into their storage: the scalar path
    x, g, dy = (t(a).to(cuda) for a in ln_data(64, 768))
    xs, dys = (torch.empty(64 * 768 + 1, dtype=tdt, device=cuda)[1:].view(
        64, 768).copy_(a) for a in (x, dy))
    for a, b in zip(layernorm.layernorm_bwd(dys, xs, g),
                    layernorm.layernorm_bwd_ref(dys, xs, g)):
        _close_cuda(a, b, tol, True)


@pytest.mark.cuda
def test_cuda_ln_bwd_parts_match_the_kernel(cuda):
    import ctypes
    from text_guided_face_recognition_tpu_torch.ops import _cuda
    fn = _cuda.function("layernorm", "tgfr_ln_bwd_parts", (ctypes.c_int,))
    for rows in (1, 9, 37, 64, 65, 384, 768, 1024, 1025, 100000):
        assert fn(rows) == layernorm.ln_bwd_parts(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_bwd_sums_are_deterministic(cuda, tdt):
    # two calls, and the FFN half-layer's three LN sums twice: bit for bit
    x, g, dy = (t(a).to(cuda) for a in ln_data(768, 768))
    x, dy = x.to(tdt), dy.to(tdt)
    first, second = (layernorm.layernorm_bwd(dy, x, g) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    p = _on(cuda, _params(1))
    w = (p["w1"], p["c1"], p["w2"], p["c2"], p["g"], p["b"])
    xh, dyh = p["x"].to(tdt), p["dy"].to(tdt)
    _, f, act, r = block.ffn_block_fwd_ref(xh, *w, p["bits_h"], RATE)
    one, two = (block.ffn_block_bwd(dyh, xh, f, act, r, p["w1"], p["w2"],
                                    p["g"], p["bits_h"], RATE)
                for _ in range(2))
    for a, b in zip(one[4:], two[4:]):      # dc2, dgamma, dbeta
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_layernorm_bwd_back_to_back_row_counts(cuda, tdt, tol):
    # the arrival counter is back at 0 after every call
    for rows in (768, 37, 768, 9, 1500):
        x, g, dy = (t(a).to(cuda) for a in ln_data(rows, 768, seed=rows))
        x, dy = x.to(tdt), dy.to(tdt)
        for a, b in zip(layernorm.layernorm_bwd(dy, x, g),
                        layernorm.layernorm_bwd_ref(dy, x, g)):
            _close_cuda(a, b, tol, True)
    assert not layernorm.ln_bwd_counter(cuda).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_bwd_graph_replay_equals_eager(cuda, tdt):
    x, g, dy = (t(a).to(cuda) for a in ln_data(768, 768))
    x, dy = x.to(tdt), dy.to(tdt)
    eager = layernorm.layernorm_bwd(dy, x, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layernorm.layernorm_bwd(dy, x, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream, which has its arrival counters
    with torch.cuda.graph(graph, stream=side):
        out = layernorm.layernorm_bwd(dy, x, g)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_ffn_block_train_matches_plain(cuda, tdt, tol, rate):
    p = _on(cuda, _params(1))
    x, dy = p["x"].to(tdt), p["dy"].to(tdt)
    w = (p["w1"], p["c1"], p["w2"], p["c2"], p["g"], p["b"])
    bt = p["bits_h"] if rate else None
    fwd = block.ffn_block_fwd(x, *w, bt, rate)
    ref = block.ffn_block_fwd_ref(x, *w, bt, rate)
    for a, b in zip(fwd, ref):
        _close_cuda(a, b, tol, False)
    z, f, act, r = ref
    got = block.ffn_block_bwd(dy, x, f, act, r, p["w1"], p["w2"], p["g"], bt,
                              rate)
    want = block.ffn_block_bwd_ref(dy, x, f, r, p["w1"], p["w2"], p["g"], bt,
                                   rate)
    for a, b in zip(got, want):
        _close_cuda(a, b, tol, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_attn_block_train_matches_plain(cuda, tdt, tol, rate):
    p = _on(cuda, _params(2))
    x, dy = p["x"].to(tdt), p["dy"].to(tdt)
    mask = t(ragged_mask(B, T, 2)).to(cuda)
    w = (p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["g"], p["b"])
    bp, bh = (p["bits_p"], p["bits_h"]) if rate else (None, None)
    fwd = block.attn_block_fwd(x, mask, *w, B, T, HEADS, bp, bh, rate)
    ref = block.attn_block_fwd_ref(x, mask, *w, B, T, HEADS, bp, bh, rate)
    for a, b in zip(fwd, ref):
        _close_cuda(a, b, tol, False)
    _, qkv, pp, o, r = ref
    args = (p["wqkv"], p["wo"], p["g"], B, T, HEADS, bp, bh, rate)
    got = block.attn_block_bwd(dy, x, qkv, pp, o, r, *args)
    want = block.attn_block_bwd_ref(dy, x, qkv, pp, o, r, *args)
    for a, b in zip(got, want):
        _close_cuda(a, b, tol, True)


def _long(dev, t_len, seed):
    """bert-base's widths (H 768, 12 heads, I 3072) at B 2 captions of
    t_len tokens, the second caption's keys padded past a third."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    h, i, b = 768, 3072, 2
    p = dict(x=rn(b * t_len, h), dy=rn(b * t_len, h), g=1.0 + rn(h, std=0.1),
             b=rn(h, std=0.1), wqkv=rn(3 * h, h, std=h ** -0.5).t(),
             bqkv=rn(3 * h, std=0.1), wo=rn(h, h, std=h ** -0.5).t(),
             bo=rn(h, std=0.1), w1=rn(i, h, std=h ** -0.5).t(),
             c1=rn(i, std=0.1), w2=rn(h, i, std=i ** -0.5).t(),
             c2=rn(h, std=0.1))
    mask = torch.ones(b, t_len, dtype=torch.int32)
    mask[1, max(1, t_len // 3):] = 0
    p["mask"] = mask.to(dev)
    p["bits_p"] = torch.randint(-2 ** 31, 2 ** 31 - 1, (12 * b, t_len, t_len),
                                generator=g, dtype=torch.int32).to(dev)
    p["bits_h"] = torch.randint(-2 ** 31, 2 ** 31 - 1, (b * t_len, h),
                                generator=g, dtype=torch.int32).to(dev)
    p["seed"] = torch.tensor([9], dtype=torch.int32, device=dev)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [24, 64, 65, 200, 512])
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_half_layer_bwds_at_caption_lengths(cuda, tdt, tol, t_len):
    """K4 and K6 against their plain versions at bert-base's widths and
    T from 24 to 512, host bits and prng mode, each from the plain
    forward's residuals, in bf16 and in f32 (the strip attention tiles);
    past 512, the position table, K6 refuses."""
    p = _long(cuda, t_len, seed=t_len)
    x, dy = p["x"].to(tdt), p["dy"].to(tdt)
    aw = (p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["g"], p["b"])
    fw = (p["w1"], p["c1"], p["w2"], p["c2"], p["g"], p["b"])
    if t_len == block.MAX_T:
        past = torch.zeros(2 * (t_len + 1), 768, dtype=tdt, device=cuda)
        with pytest.raises(ValueError, match=f"t <= {block.MAX_T}"):
            block.attn_block_bwd(past, past, None, None, None, None,
                                 p["wqkv"], p["wo"], p["g"], 2, t_len + 1, 12)
    for mode, akw, fkw in (
            ("host", dict(bits_p=p["bits_p"], bits_h=p["bits_h"]),
             dict(bits=p["bits_h"])),
            ("prng", dict(seed=p["seed"]), dict(seed=p["seed"]))):
        res = block.attn_block_fwd_ref(x, p["mask"], *aw, 2, t_len, 12,
                                       rate=RATE, **akw)
        args = (dy, x, *res[1:], p["wqkv"], p["wo"], p["g"], 2, t_len, 12)
        for k, (a, b) in enumerate(zip(
                block.attn_block_bwd(*args, rate=RATE, **akw),
                block.attn_block_bwd_ref(*args, rate=RATE, **akw))):
            assert (a - b).float().abs().max() <= tol * max(
                1.0, b.float().abs().max().item()), (mode, "K6", k)
        _, f, act, r = block.ffn_block_fwd_ref(x, *fw, rate=RATE, **fkw)
        got = block.ffn_block_bwd(dy, x, f, act, r, p["w1"], p["w2"],
                                  p["g"], rate=RATE, **fkw)
        want = block.ffn_block_bwd_ref(dy, x, f, r, p["w1"], p["w2"],
                                       p["g"], rate=RATE, **fkw)
        for k, (a, b) in enumerate(zip(got, want)):
            assert (a - b).float().abs().max() <= tol * max(
                1.0, b.float().abs().max().item()), (mode, "K4", k)


# K9 on the card against its plain version in f32 (TF32 off): absolute.
# At these cases the kernel (3xTF32) reads at most 9.5e-7 and the plain
# version with its contractions at single TF32 3.6e-5 or more where it
# differs at all (PERF.md, K9), so a kernel at single TF32 fails.
DAMSM_ATOL = 5e-6


def _damsm_held(record_property, w, rg, gamma1, m):
    """K9 within DAMSM_ATOL of its plain version; the kernel's error and
    the single-TF32 plain version's are recorded (junit properties)."""
    got = damsm.damsm_similarity_cuda(w, rg, gamma1, 5.0, m)
    want = attention.damsm_similarity(w, rg, gamma1, 5.0, m)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = attention.damsm_similarity(w, rg, gamma1, 5.0, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    record_property("max_abs_err", (got - want).abs().max().item())
    record_property("max_abs_err_plain_tf32",
                    (tf32 - want).abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=DAMSM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_cuda_damsm_matches_plain(cuda, masked, record_property):
    words, regions, mask = _damsm_data(0, b=8, d=64, t_=22, r=196)
    w, r = t(words).to(cuda), t(regions).to(cuda)
    m = t(mask).to(cuda) if masked else None
    _damsm_held(record_property, w, r, 4.0, m)


# (b, d, t, r, gamma1, masked): the flagship (B 32, D 256, T 22, R 196);
# bert_words_num 512 (T 510, the long path); ragged widths and lengths
# (D 200, T 1 and 7, R 49); the long path in two, five and three word
# chunks (D 256, 64 and 384); gamma1 50; each of the kernel's tilings
# (D 100, 384, 512)
DAMSM_SHAPES = [(32, 256, 22, 196, 4.0, False), (32, 256, 22, 196, 4.0, True),
                (3, 256, 510, 196, 4.0, False), (3, 256, 510, 196, 4.0, True),
                (5, 200, 1, 49, 4.0, True), (5, 200, 7, 49, 4.0, False),
                (5, 200, 7, 49, 4.0, True), (4, 256, 150, 49, 4.0, True),
                (3, 64, 400, 49, 4.0, True), (6, 64, 22, 196, 50.0, True),
                (9, 100, 22, 196, 4.0, True), (4, 384, 30, 49, 4.0, True),
                (4, 512, 22, 196, 4.0, True), (3, 384, 70, 49, 4.0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,t_,r,gamma1,masked", DAMSM_SHAPES)
def test_cuda_damsm_matches_plain_at_shapes(cuda, b, d, t_, r, gamma1,
                                            masked, record_property):
    """K9 against its plain version (DAMSM_ATOL), on both paths and every
    tiling; no limit on R x T."""
    words, regions, mask = _damsm_data(d + t_, b=b, d=d, t_=t_, r=r)
    w, rg = t(words).to(cuda), t(regions).to(cuda)
    m = t(mask).to(cuda) if masked else None
    _damsm_held(record_property, w, rg, gamma1, m)


# (b, d, t, r, gamma1, masked) past the kernel's bounds of before: the wide
# path (D 513, 640, 768, 1024, 2048: two to four slices of D), the running
# gamma1 maximum (|gamma1| 80 and 100: short, long and wide paths).
# Tolerance: |k - p| <= 1e-4 + 1e-4 |p|, the f32 kernel rule: the wide
# path's logits are f32 FMA sums over D in another order, and at |gamma1|
# 100 the exponent's f32 rounding is scaled by gamma1 log2 e.
WIDE_SHAPES = [(4, 513, 22, 49, 4.0, True), (4, 640, 22, 49, 4.0, False),
               (3, 768, 22, 196, 4.0, True), (3, 1024, 40, 49, 4.0, True),
               (2, 2048, 22, 49, 4.0, True), (4, 256, 22, 196, 100.0, True),
               (4, 256, 22, 196, -100.0, False),
               (3, 256, 150, 49, -80.0, True),
               (3, 768, 22, 196, 100.0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,t_,r,gamma1,masked", WIDE_SHAPES)
def test_cuda_damsm_matches_plain_at_any_width_and_gamma1(
        cuda, b, d, t_, r, gamma1, masked, record_property):
    """K9 against its plain version at any D and gamma1."""
    words, regions, mask = _damsm_data(d + t_, b=b, d=d, t_=t_, r=r)
    w, rg = t(words).to(cuda), t(regions).to(cuda)
    m = t(mask).to(cuda) if masked else None
    got = damsm.damsm_similarity_cuda(w, rg, gamma1, 5.0, m)
    want = attention.damsm_similarity(w, rg, gamma1, 5.0, m)
    record_property("max_abs_err", (got - want).abs().max().item())
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_damsm_plan_smem_is_the_kernels_layout(cuda):
    """The plan's shared memory (damsm_smem, which the CPU plan test holds
    under the block's limit) is the layout the launcher takes
    (csrc/damsm.cu `tgfr_damsm_smem`) at every width up to 2048 (past
    SLICE_D a slice's); no tiling takes another word-column count or a
    block of more than SLICE_D features."""
    import ctypes

    from text_guided_face_recognition_tpu_torch.ops import _cuda
    smem = _cuda.function("damsm", "tgfr_damsm_smem",
                          (ctypes.c_int, ctypes.c_int))
    for d in range(1, 2049):
        p = damsm.damsm_plan(32, d, 22, 196)
        assert smem(p["dp"], p["n"]) == p["smem"], (d, p)
    for dp, n in ((128, 32), (256, 32), (272, 96), (528, 32), (64, 64)):
        assert smem(dp, n) == 0, (dp, n)


@pytest.mark.cuda
@pytest.mark.parametrize("t_", [22, 510])
def test_cuda_damsm_is_deterministic_and_graph_safe(cuda, t_):
    """Two calls give the same bits (no float atomics, sums in a fixed
    order), and so does a CUDA graph's replay of one call."""
    words, regions, mask = _damsm_data(t_, b=8, d=256, t_=t_, r=196)
    w, rg, m = (t(x).to(cuda) for x in (words, regions, mask))
    one = damsm.damsm_similarity_cuda(w, rg, 4.0, 5.0, m)
    two = damsm.damsm_similarity_cuda(w, rg, 4.0, 5.0, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = damsm.damsm_similarity_cuda(w, rg, 4.0, 5.0, m)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert torch.equal(out, one)


@pytest.mark.cuda
def test_cuda_training_wrappers_refuse_bad_inputs(cuda):
    p = _on(cuda, _params())
    x = p["x"]
    with pytest.raises(ValueError, match="dy"):
        layernorm.layernorm_bwd(x[:, :128].contiguous(), x, p["g"])
    with pytest.raises(ValueError, match="bits"):
        block.ffn_block_fwd(x, p["w1"], p["c1"], p["w2"], p["c2"], p["g"],
                            p["b"], p["bits_h"][:8], RATE)
    with pytest.raises(ValueError, match="t <= 64"):
        block.attn_block_fwd(torch.randn(4 * 96, H, device=cuda),
                             torch.ones((4, 96), dtype=torch.int32,
                                        device=cuda), *(
                                 p[k] for k in ("wqkv", "bqkv", "wo", "bo",
                                                "g", "b")), 4, 96, HEADS)
    with pytest.raises(ValueError, match="float32"):
        damsm.damsm_similarity_cuda(t(np.zeros((2, 4, 3))).to(cuda),
                                    t(np.zeros((2, 4, 5))).to(cuda), 4.0, 5.0)
