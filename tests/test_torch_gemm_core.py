"""The GEMM core of the port's kernels (csrc/common.cuh) on its own, on a
card: every operand layout the kernels use, at every tile width, against
torch.matmul of the same (rounded) operands.

bf16 runs the wgmma core (128-byte-swizzled shared memory, K-major and
MN-major operands, a cp.async ring, f32 weights rounded as they are
staged); f32 the FMA tile. The shapes are ragged against every tile: M 72
rows (a partial 64-row tile), N 200 (no width divides it), K 200 (a
partial 64-deep step), and K 72 token rows for the weight gradients, whose
A is stored (K, M). Tolerance: the products of bf16 operands are exact in
f32 and only the order of the f32 sums differs, so 1e-4 of the output's
largest element (f32: the same, full f32 both sides, TF32 off).

The half-layer route (the bf16 GEMMs of K3 and K5: 128-row tiles by two
consumer warpgroups, a producer warpgroup that has the Tensor Memory
Accelerator copy A and the f32 weight and rounds the weight into the
stages) is held the same way at every width it takes and at the shapes K3
and K5 give it, ragged ones too; its sums must be the same bits as the core
above (what keeps the half-layer chains equal to the tower kernels) and
over repeated calls and a CUDA graph's replay.

The backward route (the bf16 GEMMs of K4 and K6, on the same design) is
held the same way: the data gradients (A bf16 row-major, the f32 master stored
(k, n) used untransposed, rounded into MN-major stages) and the weight
gradients (both operands bf16 stored (k, m) and (k, n), with the column
sums of the first operand, the bias gradient, in the same launch), each at
the shapes K4 and K6 give it and at ragged ones, and bit for bit equal to
the core's sums in the same operand layouts (what keeps the backward chain
of half-layers in step with the whole-tower kernel K8).

The cases carry the `cuda` marker and skip without a card; they import no
JAX, so on the card:
  python -m pytest tests/test_torch_gemm_core.py -m cuda --noconftest -q
"""

import ctypes

import pytest
import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda

# common.cuh ALayout / BLayout
A_ROW, A_TRANS = 0, 1
B_WEIGHT_NK, B_WEIGHT_KN, B_ACT_KN, B_ACT_NK = 0, 1, 2, 3
LAYOUTS = [(A_ROW, B_WEIGHT_NK), (A_ROW, B_WEIGHT_KN), (A_ROW, B_ACT_NK),
           (A_ROW, B_ACT_KN), (A_TRANS, B_ACT_KN)]
WIDTHS = [48, 96]
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def gemm(a, b, m, n, k, al, bl, bn, lib="gemm"):
    """out (m, n) f32 = A . B through csrc/gemm.cu, the operands stored as
    the layouts al, bl say."""
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _cuda.function(lib, "tgfr_gemm", (_P,) * 3 + (_I,) * 7 + (_P,))
    _cuda.launch(fn, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, al,
                 bl, bn, _cuda.dtype_code(a.dtype))
    return out


def operands(m, n, k, al, bl, dt, dev, seed=0):
    """(A stored, B stored, reference A . B in f32) for the layouts."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g).to(dev, dt)
    w = torch.randn(k, n, generator=g).to(dev)         # logical B (K, N)
    if bl in (B_ACT_KN, B_ACT_NK):
        w = w.to(dt)
    b = {B_WEIGHT_NK: w.t(), B_WEIGHT_KN: w, B_ACT_KN: w,
         B_ACT_NK: w.t()}[bl].contiguous()
    stored_a = a if al == A_ROW else a.t().contiguous()
    ref = a.float() @ w.to(dt).float()
    return stored_a, b, ref


def shape(al):
    # (m, n, k): the weight gradients contract over 72 token rows
    return (192, 200, 72) if al == A_TRANS else (72, 200, 200)


def check(out, ref):
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("bn", WIDTHS)
@pytest.mark.parametrize("al,bl", LAYOUTS)
def test_cuda_wgmma_core_matches_matmul(cuda, al, bl, bn):
    m, n, k = shape(al)
    a, b, ref = operands(m, n, k, al, bl, torch.bfloat16, cuda)
    check(gemm(a, b, m, n, k, al, bl, bn), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("al,bl", LAYOUTS)
def test_cuda_fma_core_matches_matmul(cuda, al, bl):
    m, n, k = shape(al)
    if al == A_TRANS:
        m = 192                                   # the FMA tile: M % 64
    a, b, ref = operands(m, n, k, al, bl, torch.float32, cuda)
    check(gemm(a, b, m, n, k, al, bl, 0), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("al,bl", LAYOUTS)
def test_cuda_wgmma_core_at_flagship_shapes(cuda, al, bl):
    """R = 768 and 384 token rows, H 768, I 3072, the width gemm_width
    picks on this card."""
    for m, n, k in ((768, 2304, 768), (384, 768, 3072)):
        if al == A_TRANS:
            m, k = n // 3 if n == 2304 else n, m
        a, b, ref = operands(m, n, k, al, bl, torch.bfloat16, cuda)
        check(gemm(a, b, m, n, k, al, bl, 0), ref)


def hl_gemm(a, w, m, n, k, bn):
    """out (m, n) f32 = A . W^T through the half-layer route: A (m, k)
    bf16, W (n, k) f32; bn 0 for the route's own choice."""
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    fn = _cuda.function("gemm", "tgfr_hl_gemm", (_P,) * 3 + (_I,) * 4 + (_P,))
    _cuda.launch(fn, a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bn)
    return out


def route_operands(m, n, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(n, k, generator=g).to(dev)
    return a, w, a.float() @ w.bfloat16().float().t()


# (m, n, k): K3's up and down GEMMs and K5's QKV and Wo GEMMs at R = 768
# token rows, and ragged shapes: a partial 128-row tile, N that no width
# divides, a partial 64-deep step
ROUTE_SHAPES = [(768, 3072, 768), (768, 768, 3072), (768, 2304, 768),
                (768, 768, 768), (72, 200, 200), (200, 136, 3000),
                (130, 264, 2120)]


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 96, 48])
@pytest.mark.parametrize("m,n,k", ROUTE_SHAPES)
def test_cuda_hl_route_matches_matmul(cuda, m, n, k, bn):
    a, w, ref = route_operands(m, n, k, cuda)
    check(hl_gemm(a, w, m, n, k, bn), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(768, 768, 3072), (768, 3072, 768),
                                   (200, 136, 3000)])
def test_cuda_hl_route_equals_the_core_bit_for_bit(cuda, m, n, k):
    """The route and the 64-row core (fed the weight rounded to bf16, as
    the tower holds it) add the same products in the same order: the same
    bits, whatever the widths; so the chain of half-layers equals the
    whole-tower kernel."""
    a, w, _ = route_operands(m, n, k, cuda)
    wb = w.bfloat16().contiguous()
    for bn in (128, 96, 48):
        got = hl_gemm(a, w, m, n, k, bn)
        for core_bn in WIDTHS:
            assert torch.equal(gemm(a, wb, m, n, k, A_ROW, B_ACT_NK,
                                    core_bn), got), (bn, core_bn)


@pytest.mark.cuda
def test_cuda_hl_route_is_the_same_bits_over_calls_and_a_graph(cuda):
    """K3's down GEMM shape: repeated calls and a CUDA graph's replays give
    the same bits."""
    m, n, k = 768, 768, 3072
    a, w, ref = route_operands(m, n, k, cuda, seed=3)
    first = hl_gemm(a, w, m, n, k, 0)
    check(first, ref)
    for _ in range(3):
        assert torch.equal(hl_gemm(a, w, m, n, k, 0), first)
    out = torch.empty_like(first)
    fn = _cuda.function("gemm", "tgfr_hl_gemm", (_P,) * 3 + (_I,) * 4 + (_P,))

    def call():
        _cuda.launch(fn, a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                     0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


def hl_bwd_gemm(a, b, m, n, k, mode, bn, colsum=False):
    """The backward route: mode 1, out (m, n) f32 = A . W, A (m, k) bf16,
    W (k, n) f32; mode 2, out = G^T . X, G (k, m), X (k, n) bf16, and with
    `colsum` also G's column sums (m,). bn 0: the route's choice."""
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    sums = (torch.full((m,), float("nan"), device=a.device) if colsum
            else None)
    fn = _cuda.function("gemm", "tgfr_hl_bwd_gemm",
                        (_P,) * 4 + (_I,) * 5 + (_P,))
    _cuda.launch(fn, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if sums is None else sums.data_ptr(), m, n, k, mode,
                 bn)
    return out, sums


HL_DGRAD, HL_WGRAD = 1, 2
# (m, n, k) of the data gradients: K4's df = dgg . W2 and dx = df . W1, K6's
# do = dh . Wo and dx = dqkv . Wqkv at R = 768 token rows; ragged ones
DGRAD_SHAPES = [(768, 3072, 768), (768, 768, 3072), (768, 768, 768),
                (768, 768, 2304), (72, 200, 200), (200, 136, 3000)]
# (m, n, k) of the weight gradients: dW2, dW1, dWo, dWqkv over R = 768
# token rows; ragged ones (m, n multiples of 8)
WGRAD_SHAPES = [(768, 3072, 768), (3072, 768, 768), (768, 768, 768),
                (2304, 768, 768), (200, 136, 72), (72, 264, 130)]


def dgrad_operands(m, n, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(k, n, generator=g).to(dev)
    return a, w, a.float() @ w.bfloat16().float()


def wgrad_operands(m, n, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(k, m, generator=g).to(dev, torch.bfloat16)
    x = torch.randn(k, n, generator=g).to(dev, torch.bfloat16)
    return a, x, a.float().t() @ x.float()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", DGRAD_SHAPES)
def test_cuda_hl_dgrad_matches_matmul(cuda, m, n, k):
    a, w, ref = dgrad_operands(m, n, k, cuda)
    check(hl_bwd_gemm(a, w, m, n, k, HL_DGRAD, 0)[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", DGRAD_SHAPES)
def test_cuda_hl_dgrad_equals_the_core_bit_for_bit(cuda, m, n, k):
    """The data gradients add the core's products in the core's order: the
    same bits as the 64-row core at each of its widths, fed the f32 master
    (K4, K6 before) or the weight rounded to bf16 (the whole-tower kernel
    K8)."""
    a, w, _ = dgrad_operands(m, n, k, cuda, seed=2)
    wb = w.bfloat16().contiguous()
    got = hl_bwd_gemm(a, w, m, n, k, HL_DGRAD, 0)[0]
    for core_bn in WIDTHS:
        assert torch.equal(gemm(a, w, m, n, k, A_ROW, B_WEIGHT_KN, core_bn),
                           got), core_bn
        assert torch.equal(gemm(a, wb, m, n, k, A_ROW, B_ACT_KN, core_bn),
                           got), core_bn


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("m,n,k", WGRAD_SHAPES)
def test_cuda_hl_wgrad_matches_matmul(cuda, m, n, k, bn):
    """The weight gradient and, in the same launch, the column sums of its
    first operand (bf16 terms summed in f32: 1e-4 of the largest sum)."""
    a, x, ref = wgrad_operands(m, n, k, cuda)
    out, sums = hl_bwd_gemm(a, x, m, n, k, HL_WGRAD, bn, colsum=True)
    check(out, ref)
    check(sums, a.float().sum(0))
    assert torch.equal(hl_bwd_gemm(a, x, m, n, k, HL_WGRAD, bn)[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", WGRAD_SHAPES)
def test_cuda_hl_wgrad_equals_the_core_bit_for_bit(cuda, m, n, k):
    """The weight gradients are the core's sums bit for bit at every width,
    and their column sums the same bits over repeated calls."""
    a, x, _ = wgrad_operands(m, n, k, cuda, seed=4)
    first = None
    for bn in (128, 64):
        got, sums = hl_bwd_gemm(a, x, m, n, k, HL_WGRAD, bn, colsum=True)
        for core_bn in WIDTHS:
            assert torch.equal(gemm(a, x, m, n, k, A_TRANS, B_ACT_KN,
                                    core_bn), got), (bn, core_bn)
        first = sums if first is None else first
        assert torch.equal(sums, first), bn


# -- the whole-tower kernels at a ragged size: R = 72 token rows, one full
# and one partial 64-row tile in every GEMM, and N = 3 H = 384 and I = 512,
# which no tile width divides evenly
TB, TT, TH, THEADS, TI, TL = 3, 24, 128, 2, 512, 2


def _tower_inputs(dt, dev, rate):
    g = torch.Generator().manual_seed(1)

    def rn(*shape, std=1.0, mean=0.0):
        return mean + torch.randn(*shape, generator=g) * std

    h, i, n = TH, TI, TL
    m = dict(wqkv=rn(n, 3 * h, h, std=h ** -0.5), bqkv=rn(n, 1, 3 * h,
                                                          std=0.1),
             wo=rn(n, h, h, std=h ** -0.5), bo=rn(n, 1, h, std=0.1),
             g1=rn(n, 1, h, std=0.1, mean=1.0), b1=rn(n, 1, h, std=0.1),
             w1=rn(n, i, h, std=h ** -0.5), c1=rn(n, 1, i, std=0.1),
             w2=rn(n, h, i, std=i ** -0.5), c2=rn(n, 1, h, std=0.1),
             g2=rn(n, 1, h, std=0.1, mean=1.0), b2=rn(n, 1, h, std=0.1))
    lv = {k: (v.to(dev, dt).transpose(1, 2) if k.startswith("w")
              else v.to(dev, dt)) for k, v in m.items()}
    r = TB * TT
    x, dz = rn(r, h).to(dev, dt), rn(r, h).to(dev, dt)
    mask = torch.ones(TB, TT, dtype=torch.int32)
    mask[1, 17:] = 0
    mask[2, 5:] = 0
    bits = (None, None, None)
    if rate:
        bits = tuple(torch.randint(-2 ** 31, 2 ** 31 - 1, (n,) + s,
                                   generator=g, dtype=torch.int32).to(dev)
                     for s in ((THEADS * TB, TT, TT), (r, h), (r, h)))
    return lv, x, dz, mask.to(dev), bits


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4),
                                    (torch.bfloat16, 2e-2)])
def test_cuda_tower_at_a_ragged_size(cuda, dt, tol, rate):
    """K7 and K8 against their plain versions at B 3, T 24, H 128, 2 heads,
    I 512, 2 layers. Forward outputs element-wise (bf16: the residual sums
    and z to the tolerance times their largest element, as chip_smoke.py
    holds them over layers), gradients to the tolerance times their
    largest element."""
    from text_guided_face_recognition_tpu_torch.ops import block
    lv, x, dz, mask, bits = _tower_inputs(dt, cuda, rate)
    args = (x, mask, *lv.values(), TB, TT, THEADS, *bits, rate)
    got = block.tower_block_fwd(*args)
    ref = block.tower_block_fwd_ref(*args)
    for name, a, b in zip(("z", "xin", "qkv", "p", "o", "r1", "f", "r2"),
                          got, ref):
        a, b = a.float(), b.float()
        if dt == torch.bfloat16 and name in ("z", "r1", "r2"):
            err = (a - b).abs().max().item()
            assert err <= tol * max(1.0, b.abs().max().item()), (name, err)
        else:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)
    w = [lv[k] for k in ("wqkv", "wo", "g1", "b1", "w1", "w2", "g2")]
    bargs = (dz, mask, *ref[1:], *w, TB, TT, THEADS, *bits, rate)
    grads = block.tower_block_bwd(*bargs)
    want = block.tower_block_bwd_ref(*bargs)
    for name, a, b in zip(("dx",) + block.TOWER_LEAVES, grads, want):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        assert err <= tol * max(1.0, b.abs().max().item()), (name, err)
