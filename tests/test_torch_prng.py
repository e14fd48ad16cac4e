"""The in-kernel dropout streams (ops/philox.py) and the prng mode of the
fused-block kernels (ops/block.py `seed=`; K3-K8) and of the text encoder,
against the JAX package.

The JAX package's prng mode draws the Mosaic PRNG, which has no CPU
lowering and whose values no GPU can give. What the port keeps is the
contract (ops/philox.py): the keep rule, the streams per site, the
tower's reseed per layer, and prng mode == host mode fed the dump of the
same seed. So the JAX side runs its host-bits mode (`use_prng=False`, its
Pallas kernels in interpret mode) fed the port's plain dump of the seed
(K10-K12), and the port runs its plain prng mode given the seed alone.

Small sizes: the tiny arch of tests/test_block_pallas.py (2 layers, H 256,
4 heads of 64, I 1024) at B 3, T 12; the encoder at T 10.

Tolerances: Philox bit for bit against the Random123 answers and a
pure-Python Philox; the dumps bit for bit against slices of the stream;
prng mode against host mode fed the dump inside the port bit for bit
(f32 and bf16). Against JAX (assert_allclose, rtol = atol): f32 5e-5,
bf16 2e-2, as tests/test_torch_train_ops.py; gradients of weights and
biases (sums over the 36 rows) to the tolerance times their largest
element; the tower in bf16 with the rules of tests/test_torch_tower.py
(forward and dx to the tolerance times the largest element, since a
flipped rounding of layer 0 is carried through layer 1). The encoder's
hidden states 5e-5 and its parameter gradients 2e-4 of their largest
element (f32), as tests/test_torch_tower.py.

The `cuda`-marked cases hold each kernel's prng mode against its plain
prng mode and K10-K12 against their plain versions on a card and skip
elsewhere; the JAX package is imported inside fixtures, so on a machine
with a card and no JAX they run alone:
  python -m pytest tests/test_torch_prng.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.ops import block, philox
from text_guided_face_recognition_tpu_torch.ops.dropout import total_elems
from text_guided_face_recognition_tpu_torch.utils.benching import graph_nodes

L, B, T, H, HEADS, I = 2, 3, 12, 256, 4, 1024    # d_head = 64
R = B * T
N_P = HEADS * B * T * T
RATE = 0.1
DTYPES = [("float32", torch.float32, 5e-5), ("bfloat16", torch.bfloat16, 2e-2)]
SEED = 1234
_M = 0xFFFFFFFF


class _Jax:
    def __init__(self):
        import jax
        import jax.numpy as jnp
        from text_guided_face_recognition_tpu.models import text_bert
        from text_guided_face_recognition_tpu.ops import block_pallas
        self.jax, self.jnp, self.bp, self.tb = jax, jnp, block_pallas, text_bert
        self.dummy = jnp.zeros((8, 128), jnp.uint32)
        self.seed = jnp.zeros((1, 1), jnp.int32)

    def u32(self, bits: torch.Tensor):
        """int32-held bits -> the same uint32 patterns for JAX."""
        return self.jnp.asarray(bits.numpy().view(np.uint32))


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    return _Jax()


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def seed_t(s: int = SEED, dev="cpu") -> torch.Tensor:
    return torch.tensor([s], dtype=torch.int32, device=dev)


def close(port, ref, tol, scaled=False, what=""):
    ref = np.asarray(ref, np.float32)
    atol = tol * max(1.0, float(np.abs(ref).max())) if scaled else tol
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=tol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------- Philox --

def _py_philox(ctr, key):
    """Random123 philox4x32-10 in plain Python integers."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & _M, (k[1] + 0xBB67AE85) & _M]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _M, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & _M]
    return c


def _py_words(seed: int, n: int, offset: int) -> np.ndarray:
    out, cache = [], {}
    for i in range(offset, offset + n):
        q = i >> 2
        if q not in cache:
            cache[q] = _py_philox([q & _M, q >> 32, 0, 0], [seed & _M, 0])
        out.append(cache[q][i & 3])
    return np.array(out, np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((_M,) * 4, (_M,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1")])
def test_philox_known_answers(ctr, key, want):
    """Random123's known answers for a full 4-word block."""
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = philox.philox4x32_10(*c, key[0], key[1])
    assert " ".join(f"{int(v):08x}" for v in got) == want
    assert " ".join(f"{v:08x}" for v in _py_philox(ctr, key)) == want


@pytest.mark.parametrize("seed,offset", [
    (SEED, 1), (0x7FFFFFFE, 12347), (5, (1 << 32) - 4999),
    (0x5BD1E995, (1 << 34) - 5001)])
def test_stream_matches_pure_python(seed, offset):
    """10^4 words at odd offsets, one across word 2^32 and one across
    counter 2^32 (the counter's high word), int and tensor seeds alike."""
    want = _py_words(seed, 10 ** 4, offset)
    np.testing.assert_array_equal(
        philox.stream_bits(seed, 10 ** 4, offset).numpy(), want)
    np.testing.assert_array_equal(
        philox.stream_bits(seed_t(seed), 10 ** 4, offset).numpy(), want)


def test_dumps_are_the_site_streams():
    """K10-K12's plain versions slice the streams the contract names: the
    attention probabilities then output of stream s, the FFN output of
    s ^ 0x5BD1E995, the tower's three sites of s + j (int32 wrap)."""
    s = seed_t()
    bp, bh = philox.attn_stream_bits_ref(s, B, T, H, HEADS)
    assert bp.shape == (HEADS * B, T, T) and bh.shape == (R, H)
    assert bp.dtype == bh.dtype == torch.int32
    torch.testing.assert_close(bp.reshape(-1), philox.stream_bits(SEED, N_P))
    torch.testing.assert_close(bh.reshape(-1),
                               philox.stream_bits(SEED, R * H, N_P))
    bf = philox.ffn_stream_bits_ref(s, R, H)
    torch.testing.assert_close(bf.reshape(-1), philox.stream_bits(
        SEED ^ 0x5BD1E995, R * H))
    assert not torch.equal(bf, bh)
    top = 0x7FFFFFFF - 1                  # layer 2's stream wraps to 2^31
    tp, th, tf = philox.tower_stream_bits_ref(seed_t(top), 3, B, T, H, HEADS)
    assert tp.shape == (3, HEADS * B, T, T) and tf.shape == (3, R, H)
    for j in range(3):
        key = (top + j) & _M
        lp, lh = philox.attn_stream_bits_ref(key, B, T, H, HEADS)
        torch.testing.assert_close(tp[j], lp)
        torch.testing.assert_close(th[j], lh)
        torch.testing.assert_close(tf[j].reshape(-1), philox.stream_bits(
            key, R * H, N_P + R * H))
    # the wrappers take their plain versions for a CPU seed
    for got, want in ((philox.attn_stream_bits(s, B, T, H, HEADS), (bp, bh)),
                      ((philox.ffn_stream_bits(s, R, H),), (bf,))):
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)


def test_kept_share_and_seed_range():
    bits = philox.stream_bits(seed_t(), 200_000)
    keep = ((bits.long() & _M) >= round(RATE * 2 ** 32)).float().mean()
    assert abs(keep.item() - (1 - RATE)) < 5 * (RATE * (1 - RATE) / 2e5) ** .5
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw_seeds
    seeds = draw_seeds(1000, torch.Generator().manual_seed(0), "cpu")
    assert seeds.dtype == torch.int32 and seeds.shape == (1000,)
    assert 0 <= seeds.min() and seeds.max() < 2 ** 31 - 1


# Dump shapes whose rows are not whole Philox blocks (the kernel's vector
# and word-by-word stores): the FFN dump's (rows, h), rows of 1, 2, 3, 5,
# 21, 22 and 15 words; the attention and tower dumps' (b, t, h, heads),
# rows of n_p + n_h = 2, 3, 5, 15, 8 and n_p + 2 n_h = 3, 5, 9, 21, 14 words
FFN_ODD = [(1, 1), (1, 2), (1, 3), (1, 5), (3, 7), (2, 11), (5, 3)]
BLOCK_ODD = [(1, 1, 1, 1), (1, 1, 2, 1), (1, 1, 4, 1), (1, 3, 2, 1),
             (2, 1, 3, 1)]
TOP = 0x7FFFFFFE            # seed + j wraps past 2^31 - 1 from layer 2


def _words(seed: int, n: int) -> torch.Tensor:
    return torch.from_numpy(_py_words(seed, n, 0))


@pytest.mark.parametrize("rows,h", FFN_ODD)
def test_plain_ffn_dump_at_odd_lengths(rows, h):
    """K11's plain version at rows that end inside a Philox block: the
    stream seed ^ 0x5BD1E995, against the pure-Python Philox."""
    for s in (SEED, TOP):
        got = philox.ffn_stream_bits_ref(seed_t(s), rows, h)
        assert got.shape == (rows, h)
        assert torch.equal(got.reshape(-1), _words(s ^ 0x5BD1E995, rows * h))


@pytest.mark.parametrize("layers", [1, 2, 12])
@pytest.mark.parametrize("shape", BLOCK_ODD)
def test_plain_block_dumps_at_odd_lengths_and_layers(shape, layers):
    """K10's and K12's plain versions at odd row lengths, and K12 at 2 and
    12 layers from a seed whose seed + j wraps past 2^31 - 1: layer j is
    stream (seed + j) mod 2^32, against the pure-Python Philox."""
    b, t, h, heads = shape
    n_p, n_h = heads * b * t * t, b * t * h
    ap, ah = philox.attn_stream_bits_ref(seed_t(TOP), b, t, h, heads)
    assert torch.equal(torch.cat([ap.reshape(-1), ah.reshape(-1)]),
                       _words(TOP, n_p + n_h))
    tp, th, tf = philox.tower_stream_bits_ref(seed_t(TOP), layers, b, t, h,
                                              heads)
    assert tp.shape == (layers, heads * b, t, t) and tf.shape == (
        layers, b * t, h)
    for j in range(layers):
        row = torch.cat([tp[j].reshape(-1), th[j].reshape(-1),
                         tf[j].reshape(-1)])
        assert torch.equal(row, _words((TOP + j) & _M, n_p + 2 * n_h)), j


@pytest.mark.parametrize("layers,per", [(0, 4), (65536, 4), (1, 0),
                                        (1, 4 * _M + 1)])
def test_dump_refuses_what_the_kernel_cannot_index(layers, per):
    """The kernel's rows are its grid's y dimension (at most 65535) and a
    row's Philox blocks a 32-bit counter: the wrapper refuses the rest
    before it launches anything."""
    with pytest.raises(ValueError, match="65535 rows"):
        philox._dump("dump", seed_t(), layers, per)


# -------------------------------------------------- kernels against JAX --

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
        b=rng.normal(0, 0.1, H).astype(f))


def _mask(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, T + 1, size=B)
    lens[0] = T
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)


FFN_W = ("w1", "c1", "w2", "c2", "g", "b")
ATTN_W = ("wqkv", "bqkv", "wo", "bo", "g", "b")


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_ffn_prng_mode_matches_jax(jx, jdt, tdt, tol):
    """The port's plain prng-mode ffn_block (K3/K4) given the layer seed,
    against the JAX kernel fed the port's dump of that seed (K11)."""
    p = _params(1)
    jb = jx.u32(philox.ffn_stream_bits(seed_t(), R, H))
    z_j, vjp = jx.jax.vjp(
        lambda x_, *w: jx.bp.ffn_block(x_, *w, jb, jx.seed, RATE, 1e-12,
                                       False, True),
        jx.jnp.asarray(p["x"], jdt), *(jx.jnp.asarray(p[k]) for k in FFN_W))
    g_j = vjp(jx.jnp.asarray(p["dy"], jdt))
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in FFN_W]
    z = block.ffn_block(*ins, rate=RATE, seed=seed_t())
    close(z, z_j, tol, what="z")
    for i, (a, b_) in enumerate(zip(torch.autograd.grad(z, ins,
                                                        t(p["dy"], tdt)),
                                    g_j)):
        close(a, b_, tol, scaled=i > 0, what=f"grad {i}")


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_attn_prng_mode_matches_jax(jx, jdt, tdt, tol):
    """The port's plain prng-mode attn_block (K5/K6) given the layer seed,
    against the JAX kernel fed the port's dump of that seed (K10)."""
    p, mask = _params(2), _mask(2)
    jbp, jbh = (jx.u32(a) for a in philox.attn_stream_bits(
        seed_t(), B, T, H, HEADS))
    jmask = jx.jnp.asarray(mask)
    y_j, vjp = jx.jax.vjp(
        lambda x_, *w: jx.bp.attn_block(x_, jmask, *w, jbp, jbh, jx.seed, B,
                                        T, HEADS, RATE, 1e-12, False, True),
        jx.jnp.asarray(p["x"], jdt), *(jx.jnp.asarray(p[k]) for k in ATTN_W))
    g_j = vjp(jx.jnp.asarray(p["dy"], jdt))
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in ATTN_W]
    y = block.attn_block(ins[0], t(mask), *ins[1:], B, T, HEADS, RATE,
                         seed=seed_t())
    close(y, y_j, tol, what="y")
    got = torch.autograd.grad(y, ins, t(p["dy"], tdt))
    assert len(got) == len(g_j) == 7
    for i, (a, b_) in enumerate(zip(got, g_j)):
        close(a, b_, tol, scaled=i > 0, what=f"grad {i}")


def _leaves(seed=0):
    """The tower's 12 stacked leaves in the JAX layout, f32."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def n(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.normal(size=(L,) + shape)).astype(f)

    return dict(
        wqkv=n(H, 3 * H, std=H ** -0.5), bqkv=n(1, 3 * H, std=0.1),
        wo=n(H, H, std=H ** -0.5), bo=n(1, H, std=0.1),
        g1=n(1, H, std=0.1, mean=1.0), b1=n(1, H, std=0.1),
        w1=n(H, I, std=H ** -0.5), c1=n(1, I, std=0.1),
        w2=n(I, H, std=I ** -0.5), c2=n(1, H, std=0.1),
        g2=n(1, H, std=0.1, mean=1.0), b2=n(1, H, std=0.1))


def _port_leaves(lv, dtype, dev="cpu"):
    """As the model hands them over: in dtype, weights the .transpose(1, 2)
    view of a contiguous (L, out, in) stack."""
    out = []
    for name in block.TOWER_LEAVES:
        a = t(lv[name]).to(dev, dtype)
        if name.startswith("w"):
            a = a.transpose(1, 2).contiguous().transpose(1, 2)
        out.append(a.requires_grad_(True))
    return out


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_tower_prng_mode_matches_jax(jx, jdt, tdt, tol):
    """The port's plain prng-mode tower_block (K7/K8) given the one seed,
    against the JAX tower fed the port's dump of that seed (K12): layer j
    from stream seed + j."""
    lv, p, mask = _leaves(), _params(3), _mask(3)
    jb = [jx.u32(a) for a in philox.tower_stream_bits(seed_t(), L, B, T, H,
                                                       HEADS)]
    jl = [jx.jnp.asarray(lv[k], jdt) for k in block.TOWER_LEAVES]
    jmask = jx.jnp.asarray(mask)
    z_j, vjp = jx.jax.vjp(
        lambda x_, *leaves: jx.bp.tower_block(
            x_, jmask, *leaves, *jb, jx.seed, B, T, HEADS, RATE, 1e-12, False,
            True), jx.jnp.asarray(p["x"], jdt), *jl)
    g_j = vjp(jx.jnp.asarray(p["dy"], jdt))
    x = t(p["x"], tdt).requires_grad_(True)
    pl = _port_leaves(lv, tdt)
    z = block.tower_block(x, t(mask), *pl, B, T, HEADS, RATE, seed=seed_t())
    carried = tdt == torch.bfloat16     # tests/test_torch_tower.py's rule
    close(z, z_j, tol, scaled=carried, what="z")
    got = torch.autograd.grad(z, [x] + pl, t(p["dy"], tdt))
    close(got[0], g_j[0], tol, scaled=carried, what="dx")
    for name, a, b_ in zip(block.TOWER_LEAVES, got[1:], g_j[1:]):
        assert a.dtype == tdt and tuple(a.shape) == tuple(b_.shape), name
        close(a, b_, tol, scaled=True, what=name)


# ------------------------------------------------------ inside the port --

def _run_ffn(p, tdt, **drop):
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in FFN_W]
    z = block.ffn_block(*ins, rate=RATE, **drop)
    return (z, *torch.autograd.grad(z, ins, t(p["dy"], tdt)))


def _run_attn(p, tdt, mask, **drop):
    ins = [t(p["x"], tdt).requires_grad_()] + [
        t(p[k]).requires_grad_() for k in ATTN_W]
    y = block.attn_block(ins[0], t(mask), *ins[1:], B, T, HEADS, RATE, **drop)
    return (y, *torch.autograd.grad(y, ins, t(p["dy"], tdt)))


def _run_tower(p, lv, tdt, mask, **drop):
    x = t(p["x"], tdt).requires_grad_(True)
    pl = _port_leaves(lv, tdt)
    z = block.tower_block(x, t(mask), *pl, B, T, HEADS, RATE, **drop)
    return (z, *torch.autograd.grad(z, [x] + pl, t(p["dy"], tdt)))


def _same(a, b_):
    return all(torch.equal(x, y) for x, y in zip(a, b_))


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_prng_mode_equals_host_mode_fed_the_dump(tdt):
    """Values and every gradient, bit for bit, for the three kernel pairs;
    and the comparison fails when the backward runs under another seed."""
    p, mask, lv = _params(4), _mask(4), _leaves(4)
    s = seed_t()
    ffn = _run_ffn(p, tdt, seed=s)
    assert _same(ffn, _run_ffn(p, tdt, bits=philox.ffn_stream_bits(s, R, H)))
    bp, bh = philox.attn_stream_bits(s, B, T, H, HEADS)
    attn = _run_attn(p, tdt, mask, seed=s)
    assert _same(attn, _run_attn(p, tdt, mask, bits_p=bp, bits_h=bh))
    tb = philox.tower_stream_bits(s, L, B, T, H, HEADS)
    tower = _run_tower(p, lv, tdt, mask, seed=s)
    assert _same(tower, _run_tower(p, lv, tdt, mask, bits_p=tb[0],
                                   bits_h=tb[1], bits_f=tb[2]))
    # the wrong-seed control: a backward under another seed
    x, dz = t(p["x"], tdt), t(p["dy"], tdt)
    w = [t(p[k]) for k in FFN_W]
    _, f, act, r = block.ffn_block_fwd(x, *w, rate=RATE, seed=s)
    bwd = [block.ffn_block_bwd(dz, x, f, act, r, w[0], w[2], w[4],
                               rate=RATE, seed=sd)
           for sd in (s, seed_t(SEED + 1))]
    assert _same(bwd[0], ffn[1:])
    assert not torch.equal(bwd[0][0], bwd[1][0])
    aw = [t(p[k]) for k in ATTN_W]
    _, qkv, pp, o, r = block.attn_block_fwd(x, t(mask), *aw, B, T, HEADS,
                                            rate=RATE, seed=s)
    bwd = [block.attn_block_bwd(dz, x, qkv, pp, o, r, aw[0], aw[2], aw[4], B,
                                T, HEADS, rate=RATE, seed=sd)
           for sd in (s, seed_t(SEED + 1))]
    assert _same(bwd[0], attn[1:])
    assert not torch.equal(bwd[0][0], bwd[1][0])
    pl = [a.detach() for a in _port_leaves(lv, tdt)]
    by = dict(zip(block.TOWER_LEAVES, pl))
    _, *res = block.tower_block_fwd(x, t(mask), *pl, B, T, HEADS, rate=RATE,
                                    seed=s)
    bwd = [block.tower_block_bwd(
        dz, t(mask), *res, *(by[k] for k in ("wqkv", "wo", "g1", "b1", "w1",
                                             "w2", "g2")),
        B, T, HEADS, rate=RATE, seed=sd) for sd in (s, seed_t(SEED + 1))]
    assert _same(bwd[0], tower[1:])
    assert not _same(bwd[1], tower[1:])


def test_dropout_sources_are_checked():
    p = _params()
    x, w = t(p["x"]), [t(p[k]) for k in FFN_W]
    bits = philox.ffn_stream_bits(seed_t(), R, H)
    with pytest.raises(ValueError, match="not both"):
        block.ffn_block(x, *w, RATE, bits=bits, seed=seed_t())
    with pytest.raises(ValueError, match="bits.*or a seed"):
        block.ffn_block(x, *w, RATE)
    with pytest.raises(ValueError, match="bits.*or a seed"):
        block.attn_block(x, t(_mask()), *(t(p[k]) for k in ATTN_W), B, T,
                         HEADS, RATE, bits_p=philox.attn_stream_bits(
                             seed_t(), B, T, H, HEADS)[0])
    # rate 0: no source needed, and a seed is ignored
    torch.testing.assert_close(block.ffn_block(x, *w, 0.0, seed=seed_t()),
                               block.ffn_block(x, *w, 0.0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed must be"):
        philox.check_seed("k", torch.tensor([1], dtype=torch.int64), "cpu")
    with pytest.raises(ValueError, match="seed must be"):
        philox.check_seed("k", torch.tensor([1, 2], dtype=torch.int32),
                          torch.device("cpu"))


# --------------------------------------------------------- the encoder --

ARCH = dict(vocab_size=100, hidden=H, layers=L, heads=HEADS, intermediate=I,
            max_positions=32)
BT = 10


def _ids(n=3):
    ids = (np.arange(n * BT).reshape(n, BT) % 90).astype(np.int32)
    mask = np.array([[1] * BT, [1] * (BT - 3) + [0] * 3,
                     [1] * (BT - 1) + [0]], np.int32)
    return ids, mask


def test_drop_counts_per_mode():
    """Host words and seeds a step takes; at the stage-1 shape (bert-base,
    B 32, T 24) prng mode draws only the embeddings' 589,824 words against
    17,399,808 in host mode."""
    arch = ptb.TextArch(**ARCH)
    n_h, n_p = 3 * BT * H, 3 * HEADS * BT * BT
    want = {"none": (n_h + L * (n_p + 2 * n_h), 0),
            "attn": (n_h + L * n_h, L), "ffn": (n_h + L * (n_p + n_h), L),
            "both": (n_h, L), "tower": (n_h, 1)}
    for fb, counts in want.items():
        enc = ptb.TransformerEncoder(arch, fused_block=fb)
        assert enc.drop_counts(3, BT) == counts, fb
        host = ptb.TransformerEncoder(arch, fused_block=fb,
                                      fused_dropout=True)
        assert host.drop_counts(3, BT) == (want["none"][0], 0), fb
    bert = ptb.TEXT_ARCHS["bert"]
    assert ptb.drop_elems(bert, 32, 24, "both", False) == 589_824
    assert ptb.drop_elems(bert, 32, 24, "tower", True) == 17_399_808
    assert total_elems(768, 12, 12, 32, 24) == 17_399_808


def test_encoder_refuses_wrong_drop_inputs():
    arch = ptb.TextArch(**ARCH)
    enc = ptb.TransformerEncoder(arch, fused_block="both").train()
    ids, mask = _ids()
    n, k = enc.drop_counts(3, BT)
    bits = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="drop_seeds"):
        enc(t(ids), t(mask), bits)
    with pytest.raises(ValueError, match="drop_seeds"):
        enc(t(ids), t(mask), bits, torch.zeros(k, dtype=torch.int64))
    with pytest.raises(ValueError, match="drop_bits"):
        enc(t(ids), t(mask), torch.zeros(n + 1, dtype=torch.int32),
            torch.zeros(k, dtype=torch.int32))


def _train_inputs(enc, seed=0):
    n, k = enc.drop_counts(3, BT)
    gen = torch.Generator().manual_seed(seed)
    from text_guided_face_recognition_tpu_torch.ops.dropout import (
        draw, draw_seeds)
    return draw(n, gen, "cpu"), (draw_seeds(k, gen, "cpu") if k else None)


@pytest.mark.parametrize("fused_block", ["attn", "ffn", "both", "tower"])
def test_encoder_prng_mode_equals_host_mode_fed_the_composed_stream(
        fused_block):
    """Inside the port, bit for bit: the prng-mode encoder against the same
    weights in host mode (fused_dropout) fed `compose_drop_bits`, values
    and every parameter gradient; and compose_drop_bits of host mode is
    the draw itself."""
    arch = ptb.TextArch(**ARCH)
    ids, mask = _ids()
    torch.manual_seed(2)
    prng = ptb.TransformerEncoder(arch, fused_block=fused_block).train()
    host = ptb.TransformerEncoder(arch, fused_block=fused_block,
                                  fused_dropout=True).train()
    host.load_state_dict(prng.state_dict())
    bits, seeds = _train_inputs(prng)
    full = philox.compose_drop_bits(arch, 3, BT, fused_block, bits, seeds)
    assert full.numel() == host.drop_counts(3, BT)[0]
    assert torch.equal(philox.compose_drop_bits(arch, 3, BT, fused_block, full,
                                             None), full)
    co = torch.randn(3, BT, H)
    outs = []
    for enc, args in ((prng, (bits, seeds)), (host, (full,))):
        out = enc(t(ids), t(mask), *args)
        (out * co).sum().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    for (name, a), (_, b_) in zip(prng.named_parameters(),
                                  host.named_parameters()):
        assert torch.equal(a.grad, b_.grad), name


def _jax_order(arch, fused_block, stream: np.ndarray) -> np.ndarray:
    """The port's composed stream in the JAX plan's layout: the JAX unfused
    attention draws its probability bits (B, heads, T, T), the port's
    modules read every layout as the kernels' (heads, B, T, T)."""
    out = stream.copy()
    if fused_block in ("ffn", "none"):
        n_h, n_p = 3 * BT * arch.hidden, 3 * arch.heads * BT * BT
        for j in range(arch.layers):
            ofs = n_h + j * (n_p + 2 * n_h)
            out[ofs:ofs + n_p] = stream[ofs:ofs + n_p].reshape(
                arch.heads, 3, BT, BT).transpose(1, 0, 2, 3).reshape(-1)
    return out


@pytest.mark.parametrize("fused_block", ["attn", "ffn", "both", "tower"])
def test_encoder_prng_mode_matches_jax(jx, monkeypatch, fused_block):
    """TransformerEncoder in prng mode (fused_dropout false: host bits for
    the embeddings and the unfused halves, seeds for the fused ones),
    against the JAX encoder with fused_dropout whose `_DropPlan` is handed
    the port's composed stream (the host sites' bits and the dumps, in the
    plan's site order): hidden states and every parameter gradient."""
    jax, jnp = jx.jax, jx.jnp
    jarch, parch = jx.tb.TextArch(**ARCH), ptb.TextArch(**ARCH)
    ids, mask = _ids()
    penc = ptb.TransformerEncoder(parch, torch.float32, False,
                                  fused_block).train()
    bits, seeds = _train_inputs(penc, 1)
    stream = _jax_order(jarch, fused_block, philox.compose_drop_bits(
        parch, 3, BT, fused_block, bits, seeds).numpy().view(np.uint32))
    assert stream.shape == (jx.tb._DropPlan.total_elems(jarch, 3, BT),)

    class Composed(jx.tb._DropPlan):
        def __init__(self, bits_, rate):
            assert bits_.shape == stream.shape
            super().__init__(jnp.asarray(stream), rate)

    monkeypatch.setattr(jx.tb, "_DropPlan", Composed)
    jenc = jx.tb.TransformerEncoder(jarch, jnp.float32, False, True,
                                    fused_block, name="model")
    params = jenc.init(jax.random.PRNGKey(5), jnp.asarray(ids),
                       jnp.asarray(mask))
    co = np.random.default_rng(6).normal(size=(3, BT, H)).astype(np.float32)

    def loss(p_):
        out = jenc.apply(p_, jnp.asarray(ids), jnp.asarray(mask), False,
                         rngs={"dropout": jax.random.PRNGKey(9)})
        return jnp.sum(out * jnp.asarray(co)), out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    from text_guided_face_recognition_tpu_torch.engine.from_jax import (
        state_dict_from_jax)

    def sd(tree):
        return state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jax.device_get(tree))[
                "params"], None, module=penc)

    penc.load_state_dict(sd(params))
    out_p = penc(t(ids), t(mask), bits, seeds)
    close(out_p, out_j, 5e-5, what="hidden states")
    (out_p * t(co)).sum().backward()
    gsd = sd(g_j)
    for name, p_ in penc.named_parameters():
        close(p_.grad, gsd[name].numpy(), 2e-4, scaled=True, what=name)


def test_verify_tool_runs_on_cpu(capsys):
    """The port's verify_block_prng at the tiny arch on the CPU (plain
    versions): every check passes and the report names them."""
    from text_guided_face_recognition_tpu_torch.tools import (
        verify_block_prng as tool)
    assert tool.main(["--cpu", "--batch", "2", "--words", "8", "--layers",
                      "2", "--hidden", "128", "--heads", "2",
                      "--intermediate", "256"]) == 0
    out = capsys.readouterr().out
    assert "verify_block_prng: ALL PASS" in out
    report = tool.verify("cpu", 2, 8, 128, 2, 256, 2, RATE,
                         dtypes=(torch.float32,), log=lambda s: None)
    for case in ("ffn", "attn", "tower"):
        got = report[case]["float32"]
        assert got["prng_equals_host"] and got["wrong_seed_differs"]
        assert all(v["sigma_from_expected"] <= 5 for v in got["kept"].values())


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


@pytest.mark.cuda
def test_cuda_dumps_equal_plain(cuda):
    """K10-K12 against their plain versions, bit for bit, with counters: at
    this file's shapes, at the odd row lengths (the last block's word by
    word stores), at 2 and 12 layers from a seed whose seed + j wraps past
    2^31 - 1, and at the full-width prng shapes (B 32, T 24, H 768, 12
    heads); and the kernel itself at 1, 2 and 12 rows."""
    s = seed_t(TOP, cuda)
    n = [philox.attn_stream_bits.launches, philox.ffn_stream_bits.launches,
         philox.tower_stream_bits.launches]
    for got, want in (
            (philox.attn_stream_bits(s, B, T, H, HEADS),
             philox.attn_stream_bits_ref(s, B, T, H, HEADS)),
            ((philox.ffn_stream_bits(s, R, H),),
             (philox.ffn_stream_bits_ref(s, R, H),)),
            (philox.tower_stream_bits(s, 3, B, T, H, HEADS),
             philox.tower_stream_bits_ref(s, 3, B, T, H, HEADS))):
        for a, b_ in zip(got, want):
            assert a.is_cuda and torch.equal(a, b_)
    assert [philox.attn_stream_bits.launches, philox.ffn_stream_bits.launches,
            philox.tower_stream_bits.launches] == [v + 1 for v in n]
    for rows, h in FFN_ODD + [(32 * 24, 768)]:
        assert torch.equal(philox.ffn_stream_bits(s, rows, h),
                           philox.ffn_stream_bits_ref(s, rows, h)), (rows, h)
    for shape in BLOCK_ODD + [(32, 24, 768, 12)]:
        pairs = [(philox.attn_stream_bits(s, *shape),
                  philox.attn_stream_bits_ref(s, *shape))]
        pairs += [(philox.tower_stream_bits(s, layers, *shape),
                   philox.tower_stream_bits_ref(s, layers, *shape))
                  for layers in (2, 12)]
        for got, want in pairs:
            for a, b_ in zip(got, want):
                assert torch.equal(a, b_), shape
    # the kernel itself: row j is stream (seed ^ key_xor) + j
    for layers, per, key_xor in ((1, 1, 0), (1, 5, philox.FFN_XOR),
                                 (2, 21, 0), (12, 15, 0),
                                 (1, 32 * 24 * 768, philox.FFN_XOR),
                                 (12, 12 * 32 * 24 * 24 + 2 * 32 * 24 * 768,
                                  0)):
        want = torch.stack([philox.stream_bits(torch.tensor(
            [((TOP ^ key_xor) + j) & _M], device=cuda), per)
            for j in range(layers)])
        got = philox._dump("dump", s, layers, per, key_xor)
        assert torch.equal(got, want), (layers, per, key_xor)


@pytest.mark.cuda
def test_cuda_ffn_dump_is_one_kernel(cuda):
    """A call of K11 enqueues one device operation, the dump (the FFN
    site's xor is the kernel's): a CUDA graph of one call holds one node,
    a kernel (type 0)."""
    s = seed_t(SEED, cuda)
    assert graph_nodes(lambda: philox.ffn_stream_bits(s, R, H)) == [0]


def _on(dev, p):
    out = {k: t(v).to(dev) for k, v in p.items()}
    for k in ("wqkv", "wo", "w1", "w2"):
        out[k] = out[k].t().contiguous().t()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_half_layers_prng_match_plain(cuda, tdt, tol):
    """K3-K6 in prng mode against their plain prng mode, and bit for bit
    against their own host mode fed the dumps."""
    p = _on(cuda, _params(5))
    s = seed_t(SEED, cuda)
    x, dy = p["x"].to(tdt), p["dy"].to(tdt)
    mask = t(_mask(5)).to(cuda)
    fw = [p[k] for k in FFN_W]
    got = block.ffn_block_fwd(x, *fw, rate=RATE, seed=s)
    ref = block.ffn_block_fwd_ref(x, *fw, rate=RATE, seed=s)
    for name, a, b_ in zip(("z", "f", "act", "r"), got, ref):
        _close_cuda(a, b_, tol, False, name)
    host = block.ffn_block_fwd(x, *fw, philox.ffn_stream_bits(s, R, H), RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, host))
    _, f, act, r = ref
    args = (dy, x, f, act, r, p["w1"], p["w2"], p["g"])
    g = block.ffn_block_bwd(*args, rate=RATE, seed=s)
    want = block.ffn_block_bwd_ref(dy, x, f, r, p["w1"], p["w2"], p["g"],
                                   rate=RATE, seed=s)
    for a, b_ in zip(g, want):
        _close_cuda(a, b_, tol, True)
    gh = block.ffn_block_bwd(*args, philox.ffn_stream_bits(s, R, H), RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(g, gh))
    aw = [p[k] for k in ATTN_W]
    got = block.attn_block_fwd(x, mask, *aw, B, T, HEADS, rate=RATE, seed=s)
    ref = block.attn_block_fwd_ref(x, mask, *aw, B, T, HEADS, rate=RATE,
                                   seed=s)
    for a, b_ in zip(got, ref):
        _close_cuda(a, b_, tol, False)
    bp, bh = philox.attn_stream_bits(s, B, T, H, HEADS)
    host = block.attn_block_fwd(x, mask, *aw, B, T, HEADS, bp, bh, RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, host))
    _, qkv, pp, o, r = ref
    args = (dy, x, qkv, pp, o, r, p["wqkv"], p["wo"], p["g"], B, T, HEADS)
    g = block.attn_block_bwd(*args, rate=RATE, seed=s)
    for a, b_ in zip(g, block.attn_block_bwd_ref(*args, rate=RATE, seed=s)):
        _close_cuda(a, b_, tol, True)
    gh = block.attn_block_bwd(*args, bp, bh, RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(g, gh))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt,tol", CUDA_DTYPES)
def test_cuda_tower_prng_matches_plain(cuda, tdt, tol):
    """K7/K8 in prng mode against their plain prng mode (layer by layer
    would be chip_smoke.py's; here 2 layers end to end, bf16 to the
    tolerance times the largest element), and bit for bit against their
    own host mode fed K12's dump."""
    lv, p, mask = _leaves(6), _on(cuda, _params(6)), t(_mask(6)).to(cuda)
    s = seed_t(SEED, cuda)
    pl = [a.detach() for a in _port_leaves(lv, tdt, cuda)]
    x, dz = p["x"].to(tdt), p["dy"].to(tdt)
    got = block.tower_block_fwd(x, mask, *pl, B, T, HEADS, rate=RATE, seed=s)
    ref = block.tower_block_fwd_ref(x, mask, *pl, B, T, HEADS, rate=RATE,
                                    seed=s)
    scaled = tdt == torch.bfloat16
    for name, a, b_ in zip(("z", "xin", "qkv", "p", "o", "r1", "f", "r2"),
                           got, ref):
        _close_cuda(a, b_, tol, scaled, name)
    tb = philox.tower_stream_bits(s, L, B, T, H, HEADS)
    host = block.tower_block_fwd(x, mask, *pl, B, T, HEADS, *tb, RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, host))
    by = dict(zip(block.TOWER_LEAVES, pl))
    w7 = [by[k] for k in ("wqkv", "wo", "g1", "b1", "w1", "w2", "g2")]
    g = block.tower_block_bwd(dz, mask, *ref[1:], *w7, B, T, HEADS,
                              rate=RATE, seed=s)
    want = block.tower_block_bwd_ref(dz, mask, *ref[1:], *w7, B, T, HEADS,
                                     rate=RATE, seed=s)
    for name, a, b_ in zip(("dx",) + block.TOWER_LEAVES, g, want):
        _close_cuda(a, b_, tol, True, name)
    gh = block.tower_block_bwd(dz, mask, *ref[1:], *w7, B, T, HEADS, *tb,
                               RATE)
    assert all(torch.equal(a, b_) for a, b_ in zip(g, gh))
    wrong = block.tower_block_bwd(dz, mask, *ref[1:], *w7, B, T, HEADS,
                                  rate=RATE, seed=seed_t(SEED + 1, cuda))
    assert not all(torch.equal(a, b_) for a, b_ in zip(g, wrong))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_block", ["attn", "ffn", "both", "tower"])
def test_cuda_encoder_prng_equals_host(cuda, fused_block):
    """On the card, bit for bit: the prng-mode encoder against host mode
    fed the composed stream (the dumps made by K10-K12)."""
    arch = ptb.TextArch(**ARCH)
    ids, mask = (t(a).to(cuda) for a in _ids())
    torch.manual_seed(3)
    prng = ptb.TransformerEncoder(arch, torch.bfloat16, True,
                                  fused_block).to(cuda).train()
    host = ptb.TransformerEncoder(arch, torch.bfloat16, True, fused_block,
                                  fused_dropout=True).to(cuda).train()
    host.load_state_dict(prng.state_dict())
    n, k = prng.drop_counts(3, BT)
    gen = torch.Generator(device=cuda).manual_seed(0)
    from text_guided_face_recognition_tpu_torch.ops.dropout import (
        draw, draw_seeds)
    bits, seeds = draw(n, gen, cuda), draw_seeds(k, gen, cuda)
    full = philox.compose_drop_bits(arch, 3, BT, fused_block, bits, seeds)
    a = prng(ids, mask, bits, seeds)
    b_ = host(ids, mask, full)
    assert torch.equal(a, b_)
    a.float().sum().backward()
    b_.float().sum().backward()
    for (name, x), (_, y) in zip(prng.named_parameters(),
                                 host.named_parameters()):
        assert torch.equal(x.grad, y.grad), name
