"""K16 — decode attention over a product-quantized KV cache (port of
``repro.kernels.pq_decode``), with its plain twin.

One new token's query q (B, 1, H, hd) attends over a cache kept as uint8
codes, (B, S, KH, n_sub) for K and for V, and per-kv-head codebooks
(KH, n_sub, 256, hd / n_sub): one layer of the layout
``serve.kvquant.compress_transformer_cache`` writes. Query head
h = kh·G + g reads kv head kh. Positions at or past ``cache_len`` do not
count; ``cache_len == 0`` gives zeros.

The twin repeats the TPU kernel's arithmetic: per kv head, blocks of
``block_k`` positions reconstructed (:func:`_reconstruct`; the reference's
one-hot product is a gather, exact in fp32), scored ``(q·k)·hd^-0.5``,
masked to the -1e30 sentinel and folded into the running (m, l, acc) of
an online softmax with ``p`` where-masked to 0; the result is
``acc / max(l, 1e-30)`` in q's dtype.

The kernel (``csrc/pq_decode.cu``) reconstructs nothing: the codebooks of
one kv head (512 KiB at gemma2-2b's width) do not fit a block's shared
memory, as the TPU kernel's resident codebooks do in VMEM. It scores K
through a per-query table ``lut[g, s, c] = q_g,s · k_cb[s, c]`` (the
ADC idea of K14; one launch, which lets the next start at once), and cuts
the work into blocks of (a chunk of positions, a slice of at most 64 head
dims, a kv head) (:func:`plan`): a block stages its slice's V codebook
rows (64 KiB) and reads V from them, so the codebook crosses from L2 once
a block rather than once a position. The last block of a (slice, kv
head) to finish merges the partial (m, l, acc) in chunk order, so a call
is two launches. A block stages the table rows of as many query heads as
fit its shared memory, in groups, and reads them from device memory where
not even one head's fit: any (G, n_sub) the twin takes runs. That changes
the order of additions against the twin's reconstruct-then-dot, so the
two agree to a stated tolerance (2e-4 in the tests), not bitwise; two
launches give the same bits.
:func:`pq_decode_attention_template` runs the kernel before (three
launches, the whole table staged in one block; it refuses past that) for
the card's comparisons.

The wrapper launches the kernel for tensors on the card and runs the twin
only for tensors on the CPU. A ``cache_len`` tensor on the card is read by
the kernel, never by the host, so a decode step does not wait on the
device; its range is checked only on the CPU.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.core.guards import InvalidInputError, KernelFailureError
from repro_torch.kernels import _build, ops

NEG_INF = -1e30
N_CODES = 256
MAX_DIMS = 64          # head dims a decode block takes at most (:func:`plan`)
MAX_CHUNK = 1024       # positions a decode block takes at most
TEMPLATE_CHUNK = 256   # the template's split: csrc/pq_decode.cu's kChunk
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P,) * 12 + (_I,) * 8 + (ctypes.c_float,) + (_I,) * 3 + (_P,)
_TEMPLATE_ARGTYPES = (_P,) * 11 + (_I,) * 8 + (ctypes.c_float, _P)


def plan(B: int, S: int, KH: int, hd: int, n_sub: int,
         sms: int) -> tuple[int, int]:
    """(chunk, dims) of the decode kernel's blocks: ``dims`` the largest
    divisor of hd up to :data:`MAX_DIMS` (a block stages those dims'
    codebook rows, dims KiB, and reads V from them), ``chunk`` the
    positions a block takes, a multiple of 32 that leaves about one block
    on each of the card's ``sms`` SMs over a full cache of S positions, at
    most :data:`MAX_CHUNK`, and its codes (chunk·(n_sub + the slice's
    sub-spaces) bytes, staged) within 48 KiB. The plan reads no
    ``cache_len``, so an int and a device length give the same bits; the
    blocks past ``cache_len`` return at once, so a short cache leaves most
    SMs idle (16 of 128 blocks work at gemma2-2b's width, S 8,192 and
    ``cache_len`` 1,024)."""
    dims = max(d for d in range(1, min(hd, MAX_DIMS) + 1) if hd % d == 0)
    dsub = hd // n_sub
    ns = min(n_sub, (dims - 1) // dsub + 2)
    cap = max(32, min(MAX_CHUNK, 49152 // (n_sub + ns)) // 32 * 32)
    want = -(-S * (hd // dims) * KH * B // sms)
    return min(cap, max(32, -(-want // 32) * 32)), dims


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def _reconstruct(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """codes (..., n_sub) uint8 + cb (n_sub, 256, dsub) -> (..., n_sub·dsub):
    each sub-vector its code's centroid (the reference's one-hot product,
    exact in fp32, as a gather)."""
    n_sub = cb.shape[0]
    sub = torch.arange(n_sub, device=cb.device)
    return cb[sub, codes.long()].flatten(-2)


def reconstruct(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """The dense cache a layer's codes stand for: codes (B, S, KH, n_sub)
    and per-kv-head codebooks (KH, n_sub, 256, dsub) -> (B, S, KH, hd)
    fp32."""
    return torch.stack([_reconstruct(codes[:, :, h], cb[h].float())
                        for h in range(cb.shape[0])], dim=2)


def pq_decode_attention_torch(q, k_codes, v_codes, k_cb, v_cb, cache_len, *,
                              block_k: int = 512) -> torch.Tensor:
    """Plain twin of K16: same arguments and result as
    :func:`pq_decode_attention`."""
    B, _, H, hd = q.shape
    S, KH = k_codes.shape[1], k_codes.shape[2]
    G = H // KH
    scale = hd ** -0.5
    dev = q.device
    qh = q.float().reshape(B, KH, G, hd)
    k = reconstruct(k_codes, k_cb).transpose(1, 2)        # (B, KH, S, hd)
    v = reconstruct(v_codes, v_cb).transpose(1, 2)
    m = torch.full((B, KH, G), NEG_INF, device=dev)
    l = torch.zeros((B, KH, G), device=dev)
    acc = torch.zeros((B, KH, G, hd), device=dev)
    # an int length skips the blocks past it (the TPU kernel's pl.when); a
    # tensor's blocks are all computed: a block with no valid position
    # leaves (m, l, acc) as they were
    stop = S if torch.is_tensor(cache_len) else min(S, max(cache_len, 0))
    for start in range(0, stop, block_k):
        end = min(start + block_k, S)
        mask = torch.arange(start, end, device=dev) < cache_len
        s = torch.matmul(qh, k[:, :, start:end].transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, v[:, :, start:end])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(q, k_codes, v_codes, k_cb, v_cb, cache_len, block_k):
    """The wrapper's input guards, the same on both devices; each raises
    ``InvalidInputError`` naming the argument."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise InvalidInputError(f"q must be (B, 1, H, hd), got "
                                f"{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise InvalidInputError(f"q must be float32 or bfloat16, got "
                                f"{q.dtype}")
    B, _, H, hd = q.shape
    for name, c in (("k_codes", k_codes), ("v_codes", v_codes)):
        if c.dim() != 4 or c.shape[0] != B:
            raise InvalidInputError(f"{name} must be (B={B}, S, KH, n_sub), "
                                    f"got {tuple(c.shape)}")
        if c.dtype != torch.uint8:
            raise InvalidInputError(f"{name} must be uint8, got {c.dtype}")
    if v_codes.shape != k_codes.shape:
        raise InvalidInputError(f"v_codes {tuple(v_codes.shape)} must match "
                                f"k_codes {tuple(k_codes.shape)}")
    S, KH, n_sub = k_codes.shape[1:]
    if KH == 0 or H % KH:
        raise InvalidInputError(f"q's {H} heads must be a multiple of "
                                f"k_codes' {KH} kv heads")
    if n_sub == 0 or hd % n_sub:
        raise InvalidInputError(f"q's head_dim {hd} must be a multiple of "
                                f"k_codes' n_sub {n_sub}")
    for name, cb in (("k_cb", k_cb), ("v_cb", v_cb)):
        if cb.dim() != 4 or cb.shape[2] != N_CODES:
            raise InvalidInputError(f"{name} must hold {N_CODES} codes per "
                                    f"sub-space (KH, n_sub, {N_CODES}, "
                                    f"dsub), got {tuple(cb.shape)}")
        if cb.shape != (KH, n_sub, N_CODES, hd // n_sub):
            raise InvalidInputError(f"{name} {tuple(cb.shape)} must be "
                                    f"({KH}, {n_sub}, {N_CODES}, "
                                    f"{hd // n_sub})")
        if cb.dtype != torch.float32:
            raise InvalidInputError(f"{name} must be float32, got {cb.dtype}")
    if isinstance(cache_len, numbers.Integral) and not isinstance(cache_len,
                                                                  bool):
        length = int(cache_len)
    elif torch.is_tensor(cache_len) and cache_len.dim() == 0 \
            and cache_len.dtype == torch.int32:
        length = None if cache_len.device.type != "cpu" else int(cache_len)
    else:
        raise InvalidInputError(f"cache_len must be an int or a 0-d int32 "
                                f"tensor, got {cache_len!r}")
    if length is not None and not 0 <= length <= S:
        raise InvalidInputError(f"cache_len {length} outside [0, S={S}]")
    if block_k < 1:
        raise InvalidInputError(f"block_k must be >= 1, got {block_k}")
    tensors = dict(q=q, k_codes=k_codes, v_codes=v_codes, k_cb=k_cb,
                   v_cb=v_cb)
    if torch.is_tensor(cache_len):
        tensors["cache_len"] = cache_len
    ops.check_inputs(q.device, **tensors)


def pq_decode_attention(q: torch.Tensor, k_codes: torch.Tensor,
                        v_codes: torch.Tensor, k_cb: torch.Tensor,
                        v_cb: torch.Tensor, cache_len, *,
                        block_k: int = 512) -> torch.Tensor:
    """Single-token decode attention over PQ codes.

    q (B, 1, H, hd) fp32 or bf16; k_codes / v_codes (B, S, KH, n_sub)
    uint8; k_cb / v_cb (KH, n_sub, 256, hd / n_sub) fp32; ``cache_len``
    the valid positions, an int or a 0-d int32 tensor on q's device.
    Returns (B, 1, H, hd) in q's dtype. ``block_k`` is the twin's block
    of positions; the kernel's split is its own (:func:`plan`). On
    the card this launches K16 (counted once); CPU tensors take the plain
    twin."""
    _check(q, k_codes, v_codes, k_cb, v_cb, cache_len, block_k)
    if q.device.type == "cpu":
        return pq_decode_attention_torch(q, k_codes, v_codes, k_cb, v_cb,
                                         cache_len, block_k=block_k)
    out = _launch(q, k_codes, v_codes, k_cb, v_cb, cache_len,
                  template=False)
    if out.numel():
        ops.LAUNCHES["pq_decode_attention"] += 1
    return out


def pq_decode_attention_template(q, k_codes, v_codes, k_cb, v_cb, cache_len,
                                 *, block_k: int = 512) -> torch.Tensor:
    """K16 before its redesign (the table, a split over 256-position
    chunks staging the whole (G, n_sub, 256) table, an ordered combine):
    :func:`pq_decode_attention`'s arguments and result, for the card's
    comparisons. Counts no launch; raises ``KernelFailureError`` where
    the table does not fit one block's shared memory. CPU tensors take
    the twin."""
    _check(q, k_codes, v_codes, k_cb, v_cb, cache_len, block_k)
    if q.device.type == "cpu":
        return pq_decode_attention_torch(q, k_codes, v_codes, k_cb, v_cb,
                                         cache_len, block_k=block_k)
    return _launch(q, k_codes, v_codes, k_cb, v_cb, cache_len,
                   template=True)


def _vec(dsub: int, dims: int, v_cb: torch.Tensor) -> int:
    """Floats a decode thread copies and reads at once: 4, 2 or 1, the
    most that divides dsub, a block's dims and the codebook's alignment."""
    for v in (4, 2):
        if dsub % v == 0 and dims % v == 0 and v_cb.data_ptr() % (4 * v) == 0:
            return v
    return 1


def _launch(q, k_codes, v_codes, k_cb, v_cb, cache_len, *, template):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, _, H, hd = q.shape
    S, KH, n_sub = k_codes.shape[1:]
    G = H // KH
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    if template:
        chunk, n_slices = TEMPLATE_CHUNK, 1
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunk, dims = plan(B, S, KH, hd, n_sub, sms)
        n_slices = hd // dims
    nc = max(1, -(-S // chunk))
    n_lut, n_acc = B * KH * G * n_sub * N_CODES, B * KH * nc * G * hd
    n_ml = B * KH * n_slices * nc * G
    scratch = torch.empty(n_lut + 2 * n_ml + n_acc, device=dev)
    lut = scratch.data_ptr()
    part_m, part_l = lut + 4 * n_lut, lut + 4 * (n_lut + n_ml)
    part_acc = lut + 4 * (n_lut + 2 * n_ml)
    on_device = torch.is_tensor(cache_len)
    args = (q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
            k_cb.data_ptr(), v_cb.data_ptr(),
            cache_len.data_ptr() if on_device else None,
            lut, part_m, part_l, part_acc)
    dims_ = (B, S, KH, G, hd, n_sub, 0 if on_device else int(cache_len),
             int(q.dtype == torch.bfloat16), hd ** -0.5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if template:
            fn = _build.function("pq_decode", "pq_decode_template_launch",
                                 _TEMPLATE_ARGTYPES)
            err = fn(*args, out.data_ptr(), *dims_, stream)
        else:
            fn = _build.function("pq_decode", "pq_decode_launch", _ARGTYPES)
            key = ("pq_decode_attention", torch.cuda.current_device(),
                   stream)
            arrivals = ops.arrivals(key, B * KH * n_slices)
            err = fn(*args, arrivals.data_ptr(), out.data_ptr(), *dims_,
                     chunk, dims, _vec(hd // n_sub, dims, v_cb), stream)
            if err != 0:
                ops.drop_arrivals(key)
    if err != 0:
        what = "pq_decode_attention_template" if template else \
            "pq_decode_attention"
        raise KernelFailureError(f"{what} launch failed: cudaError {err}")
    return out


def hbm_bytes_model(B: int, S: int, KH: int, hd: int, n_sub: int) -> dict:
    """Per-step cache traffic: PQ codes (and both codebooks) against a bf16
    K/V cache (the reference's model, unchanged)."""
    bf16 = 2 * B * S * KH * hd * 2
    pq = 2 * B * S * KH * n_sub + 2 * KH * n_sub * 256 * (hd // n_sub) * 4
    return {"bf16_cache_bytes": bf16, "pq_bytes": pq,
            "compression": bf16 / pq}
