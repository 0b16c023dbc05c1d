"""Attention over the KV cache in the port against ``repro.kernels``:
``flash_attention`` (K15) and ``pq_decode_attention`` (K16).

The inputs are made with numpy from a seed and go through the reference's
Pallas kernels in interpret mode, as its own tests run them, and through
the port's plain twins, which the wrappers take for CPU tensors. Held:

* K15's twin against the interpreted ``flash_attention`` on every case of
  ``tests/test_kernels.py``'s ``FLASH_CASES`` in fp32 and bf16, the
  ``q_offset`` case, rows with no valid key (0 on both sides), one
  gemma2-2b-width case, a window without causality and head_dim 80; the
  twin's result for other tiles; the port's copy of the oracle
  ``flash_attention_ref`` against the reference's; the bf16 kernel's
  arithmetic (p split in two bf16 halves before P·V), emulated here,
  against the interpreted reference;
* K16's twin against the interpreted ``pq_decode_attention`` on every
  case of ``tests/test_pq_decode.py``'s ``CASES``, at hd 256 with 16
  sub-spaces, at ``cache_len`` 0 (zeros) and at a ``cache_len`` that is
  not a multiple of ``block_k``, with ``cache_len`` an int or a 0-d
  tensor;
* the slice: a cache the reference's ``compress_transformer_cache``
  wrote, carried across with ``convert.pq_cache``, decodes as the
  reference decodes it; and a cache the port compresses decodes close to
  dense attention over the original (the reference's quality bound);
* both ``hbm_bytes_model``s; the wrappers' typed input guards.

The tests marked ``cuda`` hold the kernels to their twins on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_batched_gated import _engines
from test_torch_jaxref import ref  # noqa: F401  (fixture)
from repro_torch import convert
from repro_torch.core import (ClusterEngine, InvalidInputError,
                              KernelFailureError)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import pq_decode as pqd
from repro_torch.serve import kvquant

# (B, Sq, Skv, H, KH, hd, causal, window, cap, block_q, block_k): the
# reference's FLASH_CASES (tests/test_kernels.py:456); then one case at
# gemma2-2b's attention width (8 heads, 4 kv heads, head_dim 256, a
# sliding window, softcap 50), a window without causality, and a head_dim
# that is no multiple of the kernel's 32 lanes
FLASH_CASES = [
    (2, 128, 128, 4, 2, 32, True, 0, 0.0, 64, 64),
    (1, 200, 200, 4, 4, 16, True, 0, 0.0, 64, 64),
    (2, 64, 256, 8, 2, 32, False, 0, 0.0, 64, 128),
    (1, 256, 256, 2, 1, 64, True, 64, 50.0, 64, 64),
    (1, 96, 96, 2, 2, 128, True, 0, 0.0, 32, 32),
]
GEMMA_FLASH = (1, 320, 320, 8, 4, 256, True, 128, 50.0, 128, 128)
MORE_FLASH = [GEMMA_FLASH,
              (1, 128, 160, 4, 2, 32, False, 48, 0.0, 64, 64),
              (1, 70, 70, 2, 1, 80, True, 0, 20.0, 32, 32)]
# the kernels' edges (card only, both dtypes), the same fields then
# q_offset: Sq and Skv no multiple of the 128- or 64-row or 64-key tiles;
# head_dim 36 (no multiple of 8: the bf16 wrapper's zero pad; the fp32
# pre-pass pads to 64); G = 1 and G = 4; a window without causality; Sq =
# Skv = 1,024, so that the K/V rings wrap many times; q_offset -40 (rows
# without keys); one query row (decode's form); no keys at all (zeros);
# then q_offset 64 and head_dim 160 (which the fp32 pre-pass pads to
# 256)
KERNEL_EDGE = [
    (2, 203, 333, 4, 2, 64, False, 0, 0.0, 64, 64, 0),
    (1, 190, 250, 4, 2, 128, True, 0, 30.0, 64, 64, 0),
    (1, 150, 150, 4, 2, 36, True, 0, 0.0, 64, 64, 0),
    (1, 256, 256, 4, 4, 64, True, 0, 0.0, 64, 64, 0),
    (2, 160, 160, 8, 2, 128, True, 0, 50.0, 64, 64, 0),
    (1, 300, 300, 2, 1, 256, False, 100, 50.0, 64, 64, 0),
    (1, 1024, 1024, 2, 1, 256, True, 0, 50.0, 128, 128, 0),
    (1, 1024, 1024, 2, 1, 256, True, 300, 50.0, 128, 128, 0),
    (1, 96, 128, 2, 2, 32, True, 0, 0.0, 32, 32, -40),
    (2, 1, 300, 8, 4, 256, False, 0, 0.0, 64, 64, 0),
    (1, 16, 0, 2, 1, 64, False, 0, 0.0, 64, 64, 0),
    (1, 32, 128, 2, 2, 32, True, 0, 0.0, 32, 32, 64),
    (1, 130, 200, 4, 2, 160, True, 0, 50.0, 64, 64, 0),
]

# (B, S, KH, G, hd, n_sub, block_k, cache_len): the reference's CASES
# (tests/test_pq_decode.py:36), then hd 256 with 16 sub-spaces at G = 2
# (gemma2-2b's), cache_len 0, a cache_len that is not a multiple of
# block_k, hd past a block's 256 threads, G past the kernel's 8 query heads
# a pass over V, and three (G, n_sub) whose tables (G, n_sub, 256) pass one
# block's shared memory: qwen2-vl-7b's 7 query heads a kv head at hd 128
# (src/repro/configs/qwen2_vl_7b.py:8) with 32 sub-spaces, 8 heads with 64
# one-wide sub-spaces, and n_sub = hd = 256, where not even one head's
# (n_sub, 256) rows fit and the kernel reads them from device memory
PQ_CASES = [
    (2, 256, 2, 2, 32, 4, 128, 256),
    (1, 300, 4, 1, 64, 8, 128, 300),
    (2, 256, 2, 4, 64, 8, 64, 100),
    (1, 128, 1, 8, 128, 16, 128, 128),
    (1, 512, 4, 2, 256, 16, 128, 512),
    (1, 256, 2, 2, 32, 4, 128, 0),
    (2, 300, 2, 2, 32, 4, 128, 201),
    (1, 64, 1, 2, 320, 20, 64, 50),
    (1, 64, 1, 12, 32, 4, 64, 64),
    (1, 64, 1, 7, 128, 32, 64, 64),
    (1, 64, 1, 8, 64, 64, 64, 64),
    (1, 64, 1, 2, 256, 256, 64, 64),
]

# fp32: the reference's own flash tolerance; twin and kernel sum in other
# orders (matmul against an online-softmax fold), each within a few ulps
# of O(1) outputs
TOL32 = 2e-5
# bf16: both sides compute in fp32 from the same bf16 inputs and round once
# at the end, so they differ by at most one bf16 ulp (2^-7 relative) where
# their fp32 values straddle a rounding boundary, plus fp32 noise
RTOL16, ATOL16 = 8e-3, 1e-5
# K16: the reference's tolerance (tests/test_pq_decode.py:63)
TOL_PQ = 2e-4


def _qkv(case, seed=0):
    B, Sq, Skv, H, KH, hd = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Skv, KH, hd), (B, Skv, KH, hd)))


def _ref_flash(ref, q, k, v, dtype, **kw):
    from repro.kernels.flash_attention import flash_attention
    jnp = ref.jnp
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                          jnp.asarray(v, jd), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL16, atol=ATOL16)


# ---------------------------------------------------------------------------
# K15: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES + MORE_FLASH)
def test_flash_twin_matches_reference(ref, case, dtype):
    """The twin (through the wrapper) against the interpreted Pallas
    kernel on the same inputs, same tiles."""
    causal, window, cap, bq, bk = case[6:]
    q, k, v = _qkv(case)
    kw = dict(causal=causal, window=window, cap=cap, block_q=bq, block_k=bk)
    want = _ref_flash(ref, q, k, v, dtype, **kw)
    got = fa.flash_attention(_port(q, dtype), _port(k, dtype),
                             _port(v, dtype), **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


def _split_p_flash(q, k, v, *, causal, window, cap, q_offset=0,
                   block_k=64):
    """The bf16 kernel's arithmetic, emulated in fp32 on the CPU: bf16 q,
    k and v; fp32 scores (products of bf16 values are exact in fp32); the
    online softmax over 64-key tiles with m and l in fp32 and l from the
    fp32 p; P·V as bf16(p)·V + bf16(p − bf16(p))·V; one rounding to bf16
    at the store."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, Sq, KH, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, KH, G, Sq), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KH, G, Sq, hd))
    for k0 in range(0, Skv, block_k):
        k1 = min(k0 + block_k, Skv)
        k_pos = torch.arange(k0, k1)[None, :]
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = (qf @ kf[..., k0:k1, :].transpose(-1, -2)) * hd ** -0.5
        if cap > 0:
            s = cap * torch.tanh(s / cap)
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        vt = vf[..., k0:k1, :]
        acc = acc * corr[..., None] + p_hi @ vt + p_lo @ vt
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).bfloat16()


@pytest.mark.parametrize("case", FLASH_CASES + [GEMMA_FLASH])
def test_split_p_arithmetic_matches_reference(ref, case):
    """The numerical design of the bf16 kernel: scores in fp32 from bf16
    inputs and p split into two bf16 halves before P·V stay within the
    bf16 tolerance of the interpreted reference, which computes P·V in
    fp32."""
    causal, window, cap, bq, bk = case[6:]
    q, k, v = (_port(x, torch.bfloat16) for x in _qkv(case))
    want = _ref_flash(ref, *(x.float().numpy() for x in (q, k, v)),
                      torch.bfloat16, causal=causal, window=window, cap=cap,
                      block_q=bq, block_k=bk)
    got = _split_p_flash(q, k, v, causal=causal, window=window, cap=cap)
    _assert_close(got, want, torch.bfloat16)


def _tf32(x):
    """fp32 → TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on the low 13
    mantissa bits, ties away from zero (finite values)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the fp32 kernel's three TF32 products: a and b split into
    hi = tf32(x) and lo = tf32(x − hi), hi·hi + hi·lo + lo·hi summed in
    fp32 (lo·lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def _tf32_flash(q, k, v, *, causal, window, cap, q_offset=0, block_k=64):
    """The fp32 kernel's arithmetic, emulated on the CPU: S = Q·Kᵀ and
    P·V each as three TF32 products (:func:`_mm3`), the online softmax
    over 64-key tiles with m and l in fp32 and p = 2^((s − m)·log2 e), the
    softcap as cap·tanh(s·(scale / cap))."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = hd ** -0.5
    pre = scale / cap if cap > 0 else scale
    log2e = 1.4426950408889634
    qf = q.float().reshape(B, Sq, KH, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, KH, G, Sq), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KH, G, Sq, hd))
    for k0 in range(0, Skv, block_k):
        k1 = min(k0 + block_k, Skv)
        k_pos = torch.arange(k0, k1)[None, :]
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = _mm3(qf, kf[..., k0:k1, :].transpose(-1, -2))
        s = cap * torch.tanh(s * pre) if cap > 0 else s * pre
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp2((s - m_new[..., None]) * log2e),
                        0.0)
        corr = torch.exp2((m - m_new) * log2e)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm3(p, vf[..., k0:k1, :])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def test_tf32_rounding_is_round_to_nearest_away():
    """``_tf32`` keeps 10 explicit mantissa bits, rounds halfway cases away
    from zero, and hi + lo holds x to about 2^-22 relative."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, one + 2.0 ** -11, 3.0])
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, 3.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi = _tf32(r)
    assert ((_tf32(r - hi) + hi - r).abs() <= 2.0 ** -21 * r.abs()).all()


@pytest.mark.parametrize("case", FLASH_CASES + [GEMMA_FLASH])
def test_3xtf32_arithmetic_matches_reference(ref, case):
    """The numerical design of the fp32 kernel: scores and P·V as three
    TF32 products each (the lo·lo term dropped) stay within ``TOL32`` of
    the interpreted reference, which computes both in fp32."""
    causal, window, cap, bq, bk = case[6:]
    q, k, v = (_port(x) for x in _qkv(case))
    want = _ref_flash(ref, *(x.numpy() for x in (q, k, v)), torch.float32,
                      causal=causal, window=window, cap=cap, block_q=bq,
                      block_k=bk)
    got = _tf32_flash(q, k, v, causal=causal, window=window, cap=cap)
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("q_offset", [64, -40])
def test_flash_twin_q_offset_matches_reference(ref, q_offset):
    """``q_offset`` masks by global position (the reference's decode-offset
    case at 64); at -40 the first 40 rows have no valid key and are 0 on
    both sides."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 32 if q_offset > 0 else 96, 2, 32))
    k, v = (rng.normal(size=(1, 128, 2, 32)) for _ in range(2))
    q, k, v = (x.astype(np.float32) for x in (q, k, v))
    kw = dict(causal=True, q_offset=q_offset, block_q=32, block_k=32)
    want = _ref_flash(ref, q, k, v, torch.float32, **kw)
    got = fa.flash_attention(_port(q), _port(k), _port(v), **kw)
    _assert_close(got, want, torch.float32)
    if q_offset < 0:
        assert not got[:, :-q_offset].any()
        assert torch.isnan(fa.flash_attention_ref(
            _port(q), _port(k), _port(v), q_offset=q_offset)[:, 0]).all()


@pytest.mark.parametrize("blocks", [(16, 16), (64, 32), (512, 512),
                                    (37, 100)])
def test_flash_twin_does_not_depend_on_its_tiles(blocks):
    """Any tiling of the twin gives the oracle's result within fp32's
    tolerance: the tile (the kernel's is its own) moves only rounding."""
    case = FLASH_CASES[3]
    q, k, v = (_port(x) for x in _qkv(case, seed=2))
    kw = dict(causal=True, window=64, cap=50.0)
    got = fa.flash_attention(q, k, v, block_q=blocks[0], block_k=blocks[1],
                             **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    _assert_close(got, want.numpy(), torch.float32)


@pytest.mark.parametrize("case", [FLASH_CASES[2], FLASH_CASES[3],
                                  (1, 64, 64, 4, 2, 16, True, 0, 0.0, 0, 0)])
def test_flash_oracle_copy_matches_reference(ref, case):
    """``flash_attention_ref`` in the port is the reference's oracle (NaN
    rows included, at a negative ``q_offset``)."""
    B, Sq, Skv, H, KH, hd, causal, window, cap = case[:9]
    q, k, v = _qkv(case, seed=3)
    kw = dict(causal=causal, window=window, cap=cap,
              q_offset=-8 if case[-1] == 0 else 0)
    jnp = ref.jnp
    want = np.asarray(ref.ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = fa.flash_attention_ref(_port(q), _port(k), _port(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# K16: decode over PQ codes
# ---------------------------------------------------------------------------


def _pq_inputs(case, seed=0):
    B, S, KH, G, hd, n_sub = case[:6]
    rng = np.random.default_rng(seed)
    dsub = hd // n_sub
    k_cb, v_cb = (rng.normal(size=(KH, n_sub, 256, dsub)).astype(np.float32)
                  for _ in range(2))
    k_codes, v_codes = (rng.integers(0, 256, size=(B, S, KH, n_sub))
                        .astype(np.uint8) for _ in range(2))
    q = rng.normal(size=(B, 1, KH * G, hd)).astype(np.float32)
    return q, k_codes, v_codes, k_cb, v_cb


def _ref_pq(ref, q, k_codes, v_codes, k_cb, v_cb, cache_len, block_k):
    from repro.kernels.pq_decode import pq_decode_attention
    jnp = ref.jnp
    out = pq_decode_attention(
        jnp.asarray(q), jnp.asarray(k_codes), jnp.asarray(v_codes),
        jnp.asarray(k_cb), jnp.asarray(v_cb),
        jnp.asarray(cache_len, jnp.int32), block_k=block_k, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("case", PQ_CASES)
def test_pq_decode_twin_matches_reference(ref, case):
    """The twin (through the wrapper) against the interpreted Pallas
    kernel; a 0-d int32 ``cache_len`` gives the int's bits (a block past
    the length, which the int skips, changes nothing)."""
    block_k, cache_len = case[6:]
    args = _pq_inputs(case)
    want = _ref_pq(ref, *args, cache_len, block_k)
    port = [_port(a, torch.uint8 if a.dtype == np.uint8 else torch.float32)
            for a in args]
    got = pqd.pq_decode_attention(*port, cache_len, block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_PQ, atol=TOL_PQ)
    as_tensor = pqd.pq_decode_attention(
        *port, torch.tensor(cache_len, dtype=torch.int32), block_k=block_k)
    assert torch.equal(as_tensor, got)
    if cache_len == 0:
        assert not got.any() and not want.any()


def test_pq_decode_twin_bf16_query_matches_reference(ref):
    """A bf16 query: both sides compute in fp32 and round once."""
    case = PQ_CASES[4]
    q, *rest = _pq_inputs(case, seed=1)
    q16 = _port(q, torch.bfloat16)
    want = _ref_pq(ref, q16.float().numpy().astype(ref.jnp.bfloat16), *rest,
                   300, 128)
    got = pqd.pq_decode_attention(
        q16, *(_port(a, torch.uint8 if a.dtype == np.uint8 else
                     torch.float32) for a in rest), 300, block_k=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL16,
                               atol=ATOL16)


def test_pq_decode_is_attention_over_the_reconstruction():
    """Inside the port: decoding the codes is dense attention (the port's
    oracle, decode form) over ``pq_decode.reconstruct``'s cache."""
    case = PQ_CASES[2]
    q, kc, vc, kcb, vcb = (_port(a, torch.uint8 if a.dtype == np.uint8
                                 else torch.float32)
                           for a in _pq_inputs(case, seed=4))
    cache_len = case[7]
    got = pqd.pq_decode_attention(q, kc, vc, kcb, vcb, cache_len, block_k=64)
    want = fa.flash_attention_ref(
        q, pqd.reconstruct(kc, kcb)[:, :cache_len],
        pqd.reconstruct(vc, vcb)[:, :cache_len], causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL_PQ,
                               atol=TOL_PQ)


# ---------------------------------------------------------------------------
# the slice: compress, carry across, decode
# ---------------------------------------------------------------------------


def test_reference_compressed_cache_decodes_as_the_reference(ref):
    """``test_torch_kvquant``'s small cache (2 layers, 2 kv heads, 1024
    tokens sampled to 512, head_dim 16, ``n_sub`` 4) compressed by the
    reference, carried across with ``convert.pq_cache``: one query (4
    heads) per layer decodes within 2e-4 of the reference's interpreted
    kernel, at the full length (``pos``, a 0-d tensor) and at 700."""
    from repro.serve import kvquant as rkv
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(1)
    shape, take = (2, 1, 1024, 2, 16), 512
    cache = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32),
             "pos": np.int32(1024)}
    reng, _ = _engines(ref, "fused", "fused", take, 4, 128, 256)
    want = rkv.compress_transformer_cache(
        jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in cache.items()},
        engine=reng, n_sub=4, lloyd_iters=3, sample=take)
    got = convert.pq_cache({k: np.asarray(v) for k, v in want.items()})
    assert got["k_codes"].dtype == torch.uint8
    assert got["k_cb"].dtype == torch.float32
    assert got["pos"].dtype == torch.int32 and got["pos"].dim() == 0
    qs = rng.normal(size=(2, 1, 1, 4, 16)).astype(np.float32)
    for li in range(2):
        layer = [want[f][li] for f in ("k_codes", "v_codes", "k_cb", "v_cb")]
        mine = [got[f][li] for f in ("k_codes", "v_codes", "k_cb", "v_cb")]
        for cache_len in (got["pos"], 700):
            r = _ref_pq(ref, qs[li], *map(np.asarray, layer),
                        int(cache_len), 256)
            p = pqd.pq_decode_attention(_port(qs[li]), *mine, cache_len,
                                        block_k=256)
            np.testing.assert_allclose(p.numpy(), r, rtol=TOL_PQ,
                                       atol=TOL_PQ)


def test_port_compressed_cache_decodes_close_to_dense_attention():
    """The port's own pipeline, as the reference's end-to-end test
    (``tests/test_pq_decode.py:66``): low-rank-plus-noise K/V through
    ``compress_transformer_cache`` (16 sub-spaces), then K16's wrapper;
    the output within 0.35 relative of dense attention over the original
    cache (the reference's bound)."""
    B, S, KH, G, hd, n_sub = 1, 512, 2, 2, 64, 16
    rng = np.random.default_rng(1)
    base = rng.normal(size=(8, hd))
    coef = rng.normal(size=(B, S, KH, 8))
    kv = (coef @ base + 0.03 * rng.normal(size=(B, S, KH, hd))).astype(
        np.float32)
    cache = {"k": kv[None], "v": np.roll(kv, 7, axis=1)[None],
             "pos": np.int32(S)}
    pq = kvquant.compress_transformer_cache(
        cache, n_sub=n_sub, engine=ClusterEngine(device="cpu"),
        generator=torch.Generator().manual_seed(100))
    q = _port(rng.normal(size=(B, 1, KH * G, hd)).astype(np.float32))
    got = pqd.pq_decode_attention(q, pq["k_codes"][0], pq["v_codes"][0],
                                  pq["k_cb"][0], pq["v_cb"][0], S,
                                  block_k=128)
    want = fa.flash_attention_ref(q, _port(cache["k"][0]),
                                  _port(cache["v"][0]), causal=False)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < 0.35, rel


# ---------------------------------------------------------------------------
# byte models and guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 32768, 32, 128, 16),
                                   (1, 8192, 4, 256, 16), (2, 300, 2, 64, 8)])
def test_pq_bytes_model_matches_reference(ref, shape):
    from repro.kernels.pq_decode import hbm_bytes_model
    assert pqd.hbm_bytes_model(*shape) == hbm_bytes_model(*shape)
    if shape[0] == 128:   # the reference's test_pq_bytes_model
        assert pqd.hbm_bytes_model(*shape)["compression"] > 10


@pytest.mark.parametrize("shape", [(1, 8192, 8192, 8, 4, 256, 4),
                                   (2, 128, 256, 4, 2, 32, 2)])
def test_flash_bytes_model_matches_reference(ref, shape):
    from repro.kernels.flash_attention import hbm_bytes_model
    assert fa.hbm_bytes_model(*shape) == hbm_bytes_model(*shape)


def _good_pq():
    q, kc, vc, kcb, vcb = _pq_inputs(PQ_CASES[0])
    return dict(q=_port(q), k_codes=_port(kc, torch.uint8),
                v_codes=_port(vc, torch.uint8), k_cb=_port(kcb),
                v_cb=_port(vcb), cache_len=200)


PQ_GUARDS = {
    "q": lambda a: a.update(q=torch.zeros(2, 2, 4, 32)),
    "heads": lambda a: a.update(q=torch.zeros(2, 1, 3, 32)),
    "n_sub": lambda a: a.update(q=torch.zeros(2, 1, 4, 30)),
    "k_codes": lambda a: a.update(k_codes=a["k_codes"].to(torch.int32)),
    "v_cb": lambda a: a.update(v_cb=a["v_cb"][:, :, :128].contiguous()),
    "cache_len": lambda a: a.update(cache_len=257),
    "negative": lambda a: a.update(cache_len=torch.tensor(-1,
                                                          dtype=torch.int32)),
    "meta": lambda a: a.update(k_cb=a["k_cb"].to("meta")),
    "contiguous": lambda a: a.update(v_codes=a["v_codes"].transpose(1, 2)
                                     .contiguous().transpose(1, 2)),
}
PQ_GUARD_NAMES = {"q": r"\bq\b", "heads": "heads", "n_sub": "n_sub",
                  "k_codes": "k_codes", "v_cb": "v_cb", "cache_len":
                  "cache_len", "negative": "cache_len", "meta": "k_cb",
                  "contiguous": "v_codes"}


@pytest.mark.parametrize("bad", sorted(PQ_GUARDS))
def test_pq_decode_guards_raise_typed(bad):
    """H not a multiple of KH, hd not a multiple of n_sub, codes not
    uint8, a codebook without 256 codes, a ``cache_len`` outside [0, S],
    a tensor on another device, a non-contiguous tensor: each raises
    ``InvalidInputError`` naming the argument."""
    args = _good_pq()
    pqd.pq_decode_attention(**args)
    PQ_GUARDS[bad](args)
    with pytest.raises(InvalidInputError, match=PQ_GUARD_NAMES[bad]):
        pqd.pq_decode_attention(**args)


FLASH_GUARDS = {
    "heads": (lambda a: a.update(q=torch.zeros(1, 8, 3, 16)), "heads"),
    "head_dim": (lambda a: a.update(q=torch.zeros(1, 8, 2, 288),
                                    k=torch.zeros(1, 8, 1, 288),
                                    v=torch.zeros(1, 8, 1, 288)), "head_dim"),
    "dtype": (lambda a: a.update(v=a["v"].to(torch.bfloat16)), r"\bv\b"),
    "shape": (lambda a: a.update(k=torch.zeros(1, 8, 2, 8)), r"\bk\b"),
    "meta": (lambda a: a.update(k=a["k"].to("meta")), r"\bk is on"),
    "contiguous": (lambda a: a.update(q=torch.zeros(1, 4, 8, 16)
                                      .transpose(1, 2)), r"\bq must be"),
}


@pytest.mark.parametrize("bad", sorted(FLASH_GUARDS))
def test_flash_guards_raise_typed(bad):
    """H not a multiple of KH, head_dim past the kernel's 256, mixed
    dtypes, mismatched k, a tensor on another device, a non-contiguous
    tensor: each raises ``InvalidInputError`` naming it."""
    args = dict(q=torch.zeros(1, 8, 4, 16), k=torch.zeros(1, 8, 2, 16),
                v=torch.zeros(1, 8, 2, 16))
    fa.flash_attention(**args)
    fix, name = FLASH_GUARDS[bad]
    fix(args)
    with pytest.raises(InvalidInputError, match=name):
        fa.flash_attention(**args)


# ---------------------------------------------------------------------------
# the kernels against their twins (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counted(name, fn):
    ops.reset_launches()
    out = fn()
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in FLASH_CASES + MORE_FLASH
    for d in (torch.float32, torch.bfloat16)] + [
    (c, torch.bfloat16) for c in KERNEL_EDGE[:11]] + [
    (c, torch.float32) for c in KERNEL_EDGE] + [
    (c, torch.bfloat16) for c in KERNEL_EDGE[11:]])
def test_flash_kernel_matches_twin_on_the_card(card, case, dtype):
    """K15 against its twin on the same card inputs, one counted launch
    each (the fp32 or the bf16 kernel), two launches the same bits; at a
    negative ``q_offset`` the rows without a key are 0."""
    causal, window, cap, bq, bk = case[6:11]
    q_offset = case[11] if len(case) > 11 else 0
    q, k, v = (_port(x, dtype).to(card) for x in _qkv(case))
    kw = dict(causal=causal, window=window, cap=cap, block_q=bq, block_k=bk,
              q_offset=q_offset)
    name = ("flash_attention" if dtype == torch.float32
            else "flash_attention_bf16")
    got = _counted(name, lambda: fa.flash_attention(q, k, v, **kw))
    again = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(got, again) and got.dtype == dtype
    assert got.shape == q.shape
    want = fa.flash_attention_torch(q, k, v, **kw)
    _assert_close(got.cpu(), want.float().cpu().numpy(), dtype)
    if q_offset < 0:
        assert not got[:, :-q_offset].any()


@pytest.mark.cuda
def test_flash_kernel_rows_without_keys_are_zero_on_the_card(card):
    """At ``q_offset`` -40 the first 40 rows have no valid key: 0, as the
    twin gives; the rest match it."""
    rng = np.random.default_rng(5)
    q, k, v = (_port(rng.normal(size=s).astype(np.float32)).to(card)
               for s in ((1, 96, 2, 32), (1, 128, 2, 32), (1, 128, 2, 32)))
    got = fa.flash_attention(q, k, v, q_offset=-40)
    assert not got[:, :40].any()
    want = fa.flash_attention_torch(q, k, v, q_offset=-40)
    _assert_close(got.cpu(), want.cpu().numpy(), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PQ_CASES)
def test_pq_decode_kernel_matches_twin_on_the_card(card, case):
    """K16 against its twin on the same card inputs (cache_len an int and a
    0-d device tensor: the same bits), one counted launch each, two
    launches the same bits, zeros at cache_len 0."""
    block_k, cache_len = case[6:]
    port = [_port(a, torch.uint8 if a.dtype == np.uint8 else
                  torch.float32).to(card) for a in _pq_inputs(case)]
    got = _counted("pq_decode_attention", lambda: pqd.pq_decode_attention(
        *port, cache_len, block_k=block_k))
    dev_len = torch.tensor(cache_len, dtype=torch.int32, device=card)
    again = pqd.pq_decode_attention(*port, dev_len, block_k=block_k)
    assert torch.equal(got, again)
    want = pqd.pq_decode_attention_torch(*port, cache_len, block_k=block_k)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL_PQ, atol=TOL_PQ)
    if cache_len == 0:
        assert not got.any()
    q16 = port[0].to(torch.bfloat16)
    got16 = pqd.pq_decode_attention(q16, *port[1:], cache_len)
    want16 = pqd.pq_decode_attention_torch(q16, *port[1:], cache_len)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().cpu().numpy(),
                               want16.float().cpu().numpy(), rtol=RTOL16,
                               atol=ATOL16)


def _template_takes(case) -> bool:
    """Whether K16's template entry stages this case's table: its split
    block holds the (G, n_sub, 256) table, (G, 256) scores, a (256,)
    buffer and 256 positions' K and V codes."""
    G, n_sub = case[3], case[5]
    return 4 * (G * n_sub * 256 + G * 256 + 256) + 2 * 256 * n_sub \
        <= ops.SMEM_LIMIT


def _arrivals_zero(card) -> bool:
    """Every arrival counter K16 keeps on the card is back at 0."""
    dev = card.index if card.index is not None else torch.cuda.current_device()
    held = [t for key, t in ops._ARRIVALS.items()
            if key[0] == "pq_decode_attention" and key[1] == dev]
    return bool(held) and all(not t.any() for t in held)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PQ_CASES)
def test_pq_decode_cache_lens_on_the_card(card, case):
    """K16 at B = 2 and cache_len 0, 1, 255, 256, 257 and S (those within
    S), fp32 and bf16 q: within 2e-4 of the twin and of the template entry
    (where its staging takes the shape; it raises past it, and the next
    K16 launch still succeeds), the same bits for an int and a device
    cache_len and on a second launch, zeros at 0, and the arrival counters
    back at 0 after every call."""
    S = case[1]
    case = (2,) + case[1:]
    port = [_port(a, torch.uint8 if a.dtype == np.uint8 else
                  torch.float32).to(card) for a in _pq_inputs(case, seed=5)]
    takes = _template_takes(case)
    for q in (port[0], port[0].to(torch.bfloat16)):
        args = [q] + port[1:]
        for cache_len in sorted({min(n, S) for n in (0, 1, 255, 256, 257,
                                                     S)}):
            got = pqd.pq_decode_attention(*args, cache_len)
            dev_len = torch.tensor(cache_len, dtype=torch.int32, device=card)
            assert torch.equal(got, pqd.pq_decode_attention(*args, dev_len))
            assert torch.equal(got, pqd.pq_decode_attention(*args,
                                                            cache_len))
            torch.cuda.synchronize()
            assert _arrivals_zero(card)
            want = pqd.pq_decode_attention_torch(*args, cache_len)
            tol = (dict(rtol=TOL_PQ, atol=TOL_PQ) if q.dtype == torch.float32
                   else dict(rtol=RTOL16, atol=ATOL16))
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
            if cache_len == 0:
                assert not got.any()
            if takes:
                old = pqd.pq_decode_attention_template(*args, cache_len)
                np.testing.assert_allclose(got.float().cpu().numpy(),
                                           old.float().cpu().numpy(), **tol)
    if not takes:
        before = pqd.pq_decode_attention(*port, S)
        with pytest.raises(KernelFailureError):
            pqd.pq_decode_attention_template(*port, S)
            torch.cuda.synchronize()
        # the refusal's error stays with it: the next launch succeeds
        assert torch.equal(before, pqd.pq_decode_attention(*port, S))


@pytest.mark.cuda
def test_pq_decode_decode_steps_leave_the_counters_at_zero(card):
    """Two decode steps in a row over four layers (gemma2-2b's heads, a
    ragged last chunk, a device cache_len): each step's outputs the first
    step's bits, and the arrival counters at 0 after each."""
    case = (1, 1000, 4, 2, 256, 16, 128, 1000)
    layers = [[_port(a, torch.uint8 if a.dtype == np.uint8 else
                     torch.float32).to(card)
               for a in _pq_inputs(case, seed=li)] for li in range(4)]
    dev_len = torch.tensor(999, dtype=torch.int32, device=card)
    steps = []
    for _ in range(2):
        steps.append([pqd.pq_decode_attention(*layer, dev_len)
                      for layer in layers])
        torch.cuda.synchronize()
        assert _arrivals_zero(card)
    for a, b in zip(*steps):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_tensors_never_reach_the_twins(card, monkeypatch):
    """On CUDA tensors the wrappers launch their kernels: a twin that
    raises is never called."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the twin")
    monkeypatch.setattr(fa, "flash_attention_torch", boom)
    monkeypatch.setattr(pqd, "pq_decode_attention_torch", boom)
    q, k, v = (_port(x).to(card) for x in _qkv(FLASH_CASES[0]))
    fa.flash_attention(q, k, v)
    port = [_port(a, torch.uint8 if a.dtype == np.uint8 else
                  torch.float32).to(card) for a in _pq_inputs(PQ_CASES[0])]
    pqd.pq_decode_attention(*port, 100)
    torch.cuda.synchronize()
