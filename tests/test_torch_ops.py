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
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


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
    ref = jx.layernorm(jx.a(x, jdt), jx.a(p["g"]), jx.a(p["b"]), 1e-12, True)
    out = layernorm.layernorm_fused(t(x, tdt), t(p["g"]), t(p["b"]), 1e-12)
    assert out.dtype == tdt and out.shape == (B, T, H)
    close(out, ref, tol)


# I = 1024: the JAX FFN kernel streams it in two 512-wide blocks (the
# grid-accumulation path); I = 256: one block
@pytest.mark.parametrize("i_dim", [1024, 256])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_ffn_block_matches_jax(jx, jdt, tdt, tol, i_dim):
    p = _params(i_dim)
    ref = jx.ffn_block(jx.a(p["x"], jdt), *(jx.a(p[k]) for k in (
        "w1", "c1", "w2", "c2", "g", "b")), jx.bits, jx.seed, 0.0, 1e-12,
        False, True)
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
    out = block.attn_block(t(p["x"], tdt), t(mask), t(p["wqkv"]),
                           t(p["bqkv"]), t(p["wo"]), t(p["bo"]), t(p["g"]),
                           t(p["b"]), B, T, HEADS, 0.0, 1e-12)
    close(out, ref, tol)


def test_dropout_and_devices_are_refused():
    p = _params(256)
    args = (t(p["x"]), t(p["w1"]), t(p["c1"]), t(p["w2"]), t(p["c2"]),
            t(p["g"]), t(p["b"]))
    with pytest.raises(NotImplementedError, match="training slice"):
        block.ffn_block(*args, rate=0.1)
    with pytest.raises(NotImplementedError, match="training slice"):
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
