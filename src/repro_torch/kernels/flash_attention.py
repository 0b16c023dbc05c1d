"""K15 — online-softmax attention with the score matrix kept out of device
memory (port of ``repro.kernels.flash_attention``), with its plain twin and
the exact-softmax oracle (``repro.kernels.ref.flash_attention_ref``).

q (B, Sq, H, hd) attends over k/v (B, Skv, KH, hd); query head h reads kv
head h // G (H = KH·G). Query row i sits at global position
``q_offset + i``; key j at j. A pair counts when ``j <= q_pos`` (causal)
and ``j > q_pos - window`` (window > 0). Scores are ``(q·k)·hd^-0.5``,
softcapped to ``cap·tanh(s / cap)`` (cap > 0) before masking, masked to
the -1e30 sentinel; ``p`` is where-masked to 0, and the result is
``acc / max(l, 1e-30)``: a query row with no valid key gives 0 (the
oracle gives NaN there). bf16 inputs are computed in fp32 and rounded
once, at the store.

The twin repeats the TPU kernel's blocking: ``block_q`` × ``block_k``
tiles, the kv axis innermost, tiles with no valid pair skipped. The
kernels (``csrc/flash_attention.cu``) tile by their own constants (the TPU
default of 512 rows at hd 256 is a 512 KiB fp32 accumulator, far past
Hopper's 227 KB of shared memory and 255 registers a thread) and visit
only the key tiles that meet their query tile's band, the work the TPU
kernel's skip leaves. Both run on the tensor cores (``wgmma`` fed by a
TMA ring). bf16 takes 128 query rows × 64 keys, with P·V as bf16(p)·V +
bf16(p − bf16(p))·V so that p keeps about 16 bits, as the fp32
reference's tolerance needs. fp32 takes 64 query rows × 64 keys in split
TF32 (3xTF32): each operand x as tf32(x) + tf32(x − tf32(x)), each
product as three TF32 products (hi·hi + hi·lo + lo·hi) into an fp32
accumulator, which keeps about 22 of fp32's 24 bits. The sums run in
another order than the twin's matmuls, so kernel and twin agree to a
stated tolerance; two launches give the same bits.

The wrapper launches a kernel for tensors on the card and runs the twin
only for tensors on the CPU; both take head_dim up to
:data:`MAX_HEAD_DIM`. TMA needs 16-byte strides and addresses: for a bf16
head_dim that is no multiple of 8 (or a misaligned tensor) the wrapper
zero-pads the head dim into a copy, which changes nothing (zero columns
add nothing to q·k, and the output columns they make are dropped). The
fp32 kernel's pre-pass writes such a copy itself: the hi and lo planes of
q, k and of V transposed (TF32 ``wgmma`` takes both operands K-major, so
V's keys must be contiguous), the head dim zero-padded to 64, 128 or
256, into scratch the wrapper allocates (:func:`tf32_scratch_floats`).
Launches count under ``flash_attention`` (fp32) and
``flash_attention_bf16``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.guards import InvalidInputError, KernelFailureError
from repro_torch.kernels import _build, ops

NEG_INF = -1e30
MAX_HEAD_DIM = 256   # wgmma's widest N (bf16); four 64-column chunks (fp32)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ((_P,) * 4 + (_I,) * 7 + (ctypes.c_float,) * 2 + (_I,) * 3
             + (_P, ctypes.c_size_t, _P))


# ---------------------------------------------------------------------------
# the plain twin and the oracle
# ---------------------------------------------------------------------------


def _tile_live(q_lo: int, q_hi: int, k_lo: int, k_hi: int, causal: bool,
               window: int) -> bool:
    """Whether query positions [q_lo, q_hi] and keys [k_lo, k_hi] hold a
    valid pair: the union of the rows' bands is (q_lo − window, q_hi]."""
    return ((not causal or k_lo <= q_hi)
            and (window <= 0 or k_hi > q_lo - window))


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          cap: float = 0.0, block_q: int = 512,
                          block_k: int = 512,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain twin of K15: same arguments and result as
    :func:`flash_attention`, blocked by ``block_q`` × ``block_k``."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = max(H // KH, 1)
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Sq, KH, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]        # (B, KH, 1, S, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.zeros((B, KH, G, Sq, hd), device=dev)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        q_pos = q_offset + torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((B, KH, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, G, q1 - q0, hd), device=dev)
        for k0 in range(0, Skv, block_k):
            k1 = min(k0 + block_k, Skv)
            if not _tile_live(q_offset + q0, q_offset + q1 - 1, k0, k1 - 1,
                              causal, window):
                continue
            k_pos = torch.arange(k0, k1, device=dev)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window > 0:
                mask &= k_pos > q_pos - window
            s = torch.matmul(qf[:, :, :, q0:q1],
                             kf[:, :, :, k0:k1].transpose(-1, -2)) * scale
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p,
                                                       vf[:, :, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """The oracle: exact softmax attention in fp32 (a copy of
    ``repro.kernels.ref.flash_attention_ref``). A query row with no valid
    key gives NaN."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, Sq, KH, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * (hd ** -0.5)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(q, k, v, block_q, block_k):
    """The wrapper's input guards, the same on both devices; each raises
    ``InvalidInputError`` naming the argument."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise InvalidInputError(f"{name} must be 4-D, got "
                                    f"{tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise InvalidInputError(f"{name} must be float32 or bfloat16, "
                                    f"got {t.dtype}")
    B, _, H, hd = q.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise InvalidInputError(f"k ({k.dtype}) and v ({v.dtype}) must have "
                                f"q's dtype {q.dtype}")
    if k.shape[0] != B or k.shape[3] != hd:
        raise InvalidInputError(f"k {tuple(k.shape)} must be (B={B}, Skv, "
                                f"KH, hd={hd})")
    if v.shape != k.shape:
        raise InvalidInputError(f"v {tuple(v.shape)} must match k "
                                f"{tuple(k.shape)}")
    KH = k.shape[2]
    if KH == 0 or H % KH:
        raise InvalidInputError(f"q's {H} heads must be a multiple of k's "
                                f"{KH} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise InvalidInputError(f"q's head_dim {hd} must be in [1, "
                                f"{MAX_HEAD_DIM}] (the kernel's register "
                                f"budget)")
    if block_q < 1 or block_k < 1:
        raise InvalidInputError(f"block_q {block_q} and block_k {block_k} "
                                f"must be >= 1")
    ops.check_inputs(q.device, q=q, k=k, v=v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, cap: float = 0.0,
                    block_q: int = 512, block_k: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Skv, KH, hd), H = KH·G, all fp32 or all
    bf16. Returns (B, Sq, H, hd) in q's dtype. ``block_q``/``block_k``
    tile the twin; the kernels' tiles are their own. On the card this
    launches K15 (the fp32 or the bf16 kernel); CPU tensors take the plain
    twin."""
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     cap=cap, block_q=block_q,
                                     block_k=block_k, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if B * Sq * H * hd == 0:
        return torch.empty_like(q)
    width = hd
    if bf16 and (hd % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        width = -(-hd // 8) * 8
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd))
                   for t in (q, k, v))
    out = torch.empty((B, Sq, H, width), dtype=q.dtype, device=q.device)
    scratch = (None if bf16 else torch.empty(
        tf32_scratch_floats(B, Sq, Skv, H, KH, hd), device=q.device))
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 Sq, Skv, H, KH, width, int(causal), float(cap), hd ** -0.5,
                 int(window), int(q_offset), int(bf16),
                 None if bf16 else scratch.data_ptr(),
                 0 if bf16 else 4 * scratch.numel(), stream)
    if err != 0:
        raise KernelFailureError(
            f"flash_attention launch failed: cudaError {err}")
    ops.LAUNCHES["flash_attention_bf16" if bf16 else "flash_attention"] += 1
    return out if width == hd else out[..., :hd].contiguous()


def tf32_scratch_floats(B: int, Sq: int, Skv: int, H: int, KH: int,
                        hd: int) -> int:
    """fp32 scratch of the fp32 kernel's pre-pass: hi and lo planes of q
    (B, Sq, H, hdp), k (B, Skv, KH, hdp) and V transposed (B, KH, hdp, Sp),
    hdp the head dim rounded up to 64, 128 or 256 and Sp the keys rounded
    up to 64 (``tf32k::dispatch``)."""
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    sp = -(-Skv // 64) * 64
    return 2 * hdp * (B * Sq * H + B * Skv * KH + B * KH * sp)


def tf32_smem_bytes(chunks: int) -> int:
    """Dynamic shared memory of one block of the fp32 kernel at ``chunks``
    = hdp / 64 (``tf32k::Smem``): the hi and lo planes of the 64-row Q
    tile, two rings (one per consumer warpgroup) of as many 16 KB stages
    as fit Hopper's 232,448 bytes, the mbarriers, and 1 KB of slack for
    the 1024-byte alignment."""
    q_bytes = 2 * 2 * chunks * 8192
    ring = (232_448 - 1280 - q_bytes) // 32_768
    return q_bytes + 2 * ring * 16_384 + 8 * (1 + 4 * ring) + 1024


def hbm_bytes_model(B: int, Sq: int, Skv: int, H: int, KH: int, hd: int,
                    dtype_bytes: int = 2) -> dict:
    """Device-memory traffic of the kernel (q, k, v read once, out written
    once) against the score and probability blocks an unfused blocked
    softmax writes (the reference's model, unchanged)."""
    kernel = dtype_bytes * (B * Sq * H * hd + 2 * B * Skv * KH * hd
                            + B * Sq * H * hd)
    hlo_scores = 4 * B * H * Sq * Skv
    return {"kernel_bytes": kernel, "hlo_score_bytes_lower_bound": hlo_scores}
