"""Blocked online-softmax attention: the CUDA forward and backward kernels,
their plain versions, and the autograd Function that joins them.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py`` (route:
CUDA C++ for sm_90a, ``csrc/flash_attention.cu``, bound with ctypes).  At
the prefill shape the kernel is bound by operations: the source's head
note says so and what its design does about it.  The kernel a call
launches is a fixed function of its dtype (``KERNELS``): bf16 at every
head dim goes to ``flash_fwd_tma`` (TMA ring, wgmma), float32 to
``flash_fwd_f32`` (scalar FMAs).

q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0 (GQA:
query head h reads kv head h // (H // Hkv)).  Masks: causal (row >= col)
and, for ``window > 0``, row - col < window; none for ``causal=False``
(whisper's encoder and cross-attention), at any Sk.  The output is
(B, Sq, H, D) in q's dtype.  A query row that sees no key at all
(possible only when Sq > Sk + window) gets zeros from the bf16 kernel,
where the plain version averages every value row; the model never makes
such a call (Sq == Sk, or non-causal).

:func:`flash_attention` launches the kernel on CUDA tensors and raises on
anything else; :func:`flash_attention_ref` is the same function as dense
masked softmax in float32 (``repro/kernels/ref.py::attention_ref``), the
CPU path and the card's yardstick.

The gradient (``csrc/flash_attention_bwd.cu``, new in the port: the TPU
kernel has none, the reference lets XLA differentiate
``blocked_attention``) is two wrappers after FlashAttention-2's split:
:func:`flash_bwd_dq` (delta = rowsum(dO o) and dq) and
:func:`flash_bwd_dkdv` (dk and dv, summed over each GQA group with no
atomics).  Both recompute the probabilities from the row log-sum-exp that
the forward writes when asked (:func:`flash_attention_with_lse`).  The
kernels each launches are a fixed function of the dtype
(``BWD_KERNELS``).  bf16 runs the Hopper kernels: every product on the
tensor cores with wgmma (dq does 3 products over the visible pairs: S,
dP, dq; dkdv 4: S, dP, dv, dk, so both are bound by operations), tiles by
TMA into mbarrier rings, P and dS rounded to bf16 in registers.  dkdv's
block owns one kv tile of one kv head and walks ``dkdv_splits`` parts of
its GQA group; with more than one part each block writes float32
partials that ``flash_bwd_dkdv_sum`` adds in part order
(:func:`flash_bwd_dkdv_split_ref` is that scheme in plain torch), so the
grid fills the card at the training call and two runs are bitwise equal.
float32 runs scalar FMA kernels (tensor cores would be TF32).
:class:`FlashAttentionFn` is the ``torch.autograd.Function`` whose
forward is the forward kernel and whose backward is those two; its plain
counterpart is autograd through :func:`flash_attention_ref`, and
:func:`flash_attention_bwd_ref` writes out the formulas the kernels
compute, for the CPU tests.  A row that sees no key gets a zero gradient
from the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches, at every head dim (csrc/flash_attention.cu)
KERNELS = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_tma"}
# the kernels each backward wrapper launches, per dtype, at every head dim
# (csrc/flash_attention_bwd.cu); flash_bwd_dkdv_sum only when
# dkdv_splits(...) > 1
BWD_KERNELS = {
    torch.float32: {"flash_bwd_dq": ("flash_bwd_dq",),
                    "flash_bwd_dkdv": ("flash_bwd_dkdv",)},
    torch.bfloat16: {"flash_bwd_dq": ("flash_bwd_dq_wgmma",),
                     "flash_bwd_dkdv": ("flash_bwd_dkdv_wgmma",
                                        "flash_bwd_dkdv_sum")},
}
BWD_ROWS = 64        # rows of every backward tile
# blocks of flash_bwd_dkdv_wgmma per SM that dkdv_splits aims for, and the
# SM count it assumes when not given the card's (an H100 SXM's)
DKDV_BLOCKS_PER_SM = 2
H100_SMS = 132


def check_args(q, k, v, *, window: int) -> None:
    """Shape contract shared by both versions: 4-D (B, S, H, D) tensors of
    one dtype, H % Hkv == 0, window >= 0.  The TPU kernel also refuses a
    non-causal call whose Sk its 128-row kv block would pad; the port
    masks the columns >= Sk in both versions and takes any Sk."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_start: int = 0, k_start: int = 0):
    """Plain torch version: dense masked softmax in float32, output in
    q.dtype.  Row i of q is position ``q_start + i`` and row j of k and v
    position ``k_start + j`` of the masks (both 0 for a whole call, as
    the kernel numbers them: with Sq != Sk its rows and columns both
    start at 0).  So a band of rows ``q[:, r0:r1]`` of a call too long
    for the dense (B, H, Sq, Sk) scores is
    ``flash_attention_ref(q[:, r0:r1], k[:, c0:r1], v[:, c0:r1],
    q_start=r0, k_start=c0)`` for any c0 below the band's first visible
    column (0, or r0 - window + 1 with a window)."""
    check_args(q, k, v, window=window)
    return _out_ref(_scores_ref(q, k, causal, window, q_start, k_start),
                    v).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """Plain version of the forward with its row log-sum-exp: (out in
    q.dtype, lse (B, H, Sq) float32 of the scaled scores over the visible
    columns; -1e30 plus the log of Sk for a row that sees no key, whose
    masked columns all weigh the same)."""
    check_args(q, k, v, window=window)
    s = _scores_ref(q, k, causal, window)
    return _out_ref(s, v).to(q.dtype), torch.logsumexp(s, dim=-1)


def _out_ref(s, v):
    """softmax(s) v in float32, the kv heads repeated over their group."""
    rep = s.shape[1] // v.shape[2]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.float().repeat_interleave(rep, dim=2))


def _scores_ref(q, k, causal, window, q_start=0, k_start=0):
    """(B, H, Sq, Sk) float32 scaled scores, NEG_INF where masked."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk, rep = k.shape[1], h // k.shape[2]
    kk = k.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(d)
    return torch.where(_mask(sq, sk, causal, window, q.device, q_start,
                             k_start), s, NEG_INF)


def _mask(sq, sk, causal, window, device, q_start=0, k_start=0):
    q_pos = q_start + torch.arange(sq, device=device)[:, None]
    k_pos = k_start + torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    return mask


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0):
    """The backward kernels' formulas as dense float32 torch: returns
    (dq, dk, dv) in the inputs' dtype.  P = exp(s - lse) on the visible
    pairs and 0 elsewhere, delta = rowsum(dO o), dS = P (dO v - delta),
    dq = dS k scale, dk = dS^T q scale and dv = P^T dO, each summed over
    the query heads of a GQA group.  Equal to autograd through
    :func:`flash_attention_ref` wherever every row sees a key."""
    check_args(q, k, v, window=window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep, scale = h // hkv, 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(rep, dim=2)
    vv = v.float().repeat_interleave(rep, dim=2)
    p = torch.where(_mask(sq, sk, causal, window, q.device),
                    torch.exp(_scores_ref(q, k, causal, window)
                              - lse[..., None]), 0.0)
    dof = do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, hkv, rep, d).sum(3)
    dv = dv.reshape(b, sk, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dkdv_splits(b: int, hkv: int, group: int, sk: int,
                sms: int = H100_SMS) -> int:
    """Parts of each GQA group that flash_bwd_dkdv's bf16 kernel splits
    its walk over: the smallest divisor s of ``group`` for which
    b hkv ceil(sk / 64) s blocks reach DKDV_BLOCKS_PER_SM per SM of a card
    with ``sms`` SMs, else the group itself.  On an H100 (132 SMs): 3 at
    qwen2-1.5b's training call (2, 2048, group 6, Hkv 2), 2 at its prefill
    call (2, 4096)."""
    base = b * hkv * -(-sk // BWD_ROWS)
    for s in range(1, group + 1):
        if group % s == 0 and base * s >= DKDV_BLOCKS_PER_SM * sms:
            return s
    return group


def flash_bwd_dkdv_split_ref(q, k, v, do, lse, delta, *, splits: int,
                             causal: bool = True, window: int = 0):
    """flash_bwd_dkdv's split scheme as dense float32 torch: split s of
    ``splits`` sums dk and dv over query heads s (group / splits) ..
    (s + 1) (group / splits) - 1 of each GQA group into float32 partials
    (splits, B, Sk, Hkv, D), which are added in split order, as
    ``flash_bwd_dkdv_sum`` adds them.  delta is rowsum(dO o) (B, H, Sq).
    Returns (dk, dv) in k's dtype."""
    check_args(q, k, v, window=window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group, scale = h // hkv, 1.0 / math.sqrt(d)
    if splits < 1 or group % splits:
        raise ValueError(f"splits {splits} does not divide the group "
                         f"{group}")
    per = group // splits
    vv = v.float().repeat_interleave(group, dim=2)
    p = torch.where(_mask(sq, sk, causal, window, q.device),
                    torch.exp(_scores_ref(q, k, causal, window)
                              - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv)
    ds = p * (dp - delta[..., None])
    # (B, Sk, H, D) per query head, then (B, Sk, Hkv, splits, per, D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    parts_k = dk.reshape(b, sk, hkv, splits, per, d).sum(4)
    parts_v = dv.reshape(b, sk, hkv, splits, per, d).sum(4)
    out_k, out_v = parts_k[:, :, :, 0], parts_v[:, :, :, 0]
    for s in range(1, splits):
        out_k = out_k + parts_k[:, :, :, s]
        out_v = out_v + parts_v[:, :, :, s]
    return out_k.to(k.dtype), out_v.to(v.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p])
# q, k, v, o|dout, ... pointers, then dtype, B, Sq, Sk, H, Hkv, D, causal,
# window, scale, stream (csrc/flash_attention_bwd.cu); dkdv takes splits
# and the partials' scratch before the stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p])
_DKDV_ARGTYPES = _BWD_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]


def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_info(dtype, d: int) -> dict:
    """Registers per thread, shared memory per block and local memory per
    thread (spills and stack) of the kernel a (dtype, head dim) call
    launches, as the CUDA runtime reports them (builds the library)."""
    fn = _build.load("flash_attention").flash_attention_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    rc = fn(DTYPES[dtype], d, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_kernel_info: cudaError {rc}")
    return {"kernel": KERNELS[dtype], "registers": out[0],
            "smem_bytes": out[1], "local_bytes": out[2]}


def _check_cuda_layout(x, name: str, dev) -> None:
    align = 16 // x.element_size()
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention reads {name} through its strides (16-byte "
            f"loads, TMA tensor maps): the head dim must be contiguous and "
            f"the other strides multiples of {align} elements, got strides "
            f"{x.stride()}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel: q (B, Sq, H, D), k and v (B, Sk, Hkv, D),
    float32 or bfloat16 on one CUDA device, D in 16/32/64/80/96/128, the
    head dim contiguous.  Returns (B, Sq, H, D) in q's dtype.

    Adds one to ``flash_attention.launches`` for each launch.  Raises on
    a CPU tensor, another dtype, head dim or layout, or a launch the
    runtime refuses.
    """
    return _forward(q, k, v, causal, window, want_lse=False)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0):
    """The same launch (and count) as :func:`flash_attention`, which also
    writes each row's log-sum-exp: returns (out, lse (B, H, Sq) float32;
    +inf in bfloat16 for a row that sees no key)."""
    return _forward(q, k, v, causal, window, want_lse=True)


def _check_cuda(q, k, v, window, name):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {dev}")
    check_args(q, k, v, window=window)
    if q.dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} is not one of {HEAD_DIMS}")
    if k.shape[1] == 0:
        raise ValueError(f"{name} needs at least one key")


def _forward(q, k, v, causal, window, want_lse):
    _check_cuda(q, k, v, window, "flash_attention")
    dev = q.device
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda_layout(x, name, dev)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, sq, device=dev, dtype=torch.float32) \
        if want_lse else None
    if b == 0 or sq == 0 or h == 0:
        return out, lse
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, sq, sk, h, hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window),
                1.0 / math.sqrt(d), lse.data_ptr() if want_lse else None,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------


def _bwd_launcher(name, argtypes=_BWD_ARGTYPES):
    fn = getattr(_build.load("flash_attention_bwd"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def bwd_kernel_info(dtype, d: int) -> dict:
    """Registers, shared memory and local memory (spills and stack) of
    each kernel of ``BWD_KERNELS[dtype]`` at head dim ``d``, as the CUDA
    runtime reports them (builds the library): {name: {"registers",
    "smem_bytes", "local_bytes"}}."""
    fn = _build.load("flash_attention_bwd").flash_bwd_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    names = [n for group in BWD_KERNELS[dtype].values() for n in group]
    out = {}
    for which, name in enumerate(names):
        info = (ctypes.c_int * 3)()
        rc = fn(DTYPES[dtype], d, which, info)
        if rc != 0:
            raise RuntimeError(f"flash_bwd_kernel_info({name}): cudaError "
                               f"{rc}")
        out[name] = {"registers": info[0], "smem_bytes": info[1],
                     "local_bytes": info[2]}
    return out


def _bwd_args(q, k, causal, window):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return (DTYPES[q.dtype], b, sq, sk, h, hkv, d, int(causal), int(window),
            1.0 / math.sqrt(d))


def _check_bwd(tensors, q, lse, name):
    """The backward kernels read packed tensors: q's dtype and device for
    every input, float32 (B, H, Sq) for the LSE and delta."""
    b, sq, h, _ = q.shape
    for x in tensors:
        if x.device != q.device or x.dtype != q.dtype or \
                not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous {q.dtype} tensors on "
                             f"{q.device}, got {x.dtype} on {x.device} with "
                             f"strides {x.stride()}")
    for x in lse:
        if x.shape != (b, h, sq) or x.dtype != torch.float32 or \
                x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name}: the LSE and delta are contiguous "
                             f"float32 {(b, h, sq)} on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def flash_bwd_dq(q, k, v, o, do, lse, *, causal: bool = True,
                 window: int = 0):
    """Launch ``flash_bwd_dq``: every input contiguous on one CUDA device,
    q, k, v, o and dO of one dtype, lse from the forward.  Returns (dq in
    q's dtype, delta = rowsum(dO o) as (B, H, Sq) float32), and adds one
    to ``flash_bwd_dq.launches``."""
    _check_cuda(q, k, v, window, "flash_bwd_dq")
    _check_bwd((q, k, v, o, do), q, (lse,), "flash_bwd_dq")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    fn = _bwd_launcher("flash_bwd_dq_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), *_bwd_args(q, k, causal, window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError {rc}")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                   window: int = 0):
    """Launch ``flash_bwd_dkdv`` after :func:`flash_bwd_dq` (it reads that
    kernel's delta).  Returns (dk, dv) in k's dtype, each summed over the
    query heads of its GQA group, and adds one to
    ``flash_bwd_dkdv.launches``.  In bf16 with ``dkdv_splits`` > 1 it
    allocates the float32 partials (2, splits, B, Sk, Hkv, D) and the
    call also launches ``flash_bwd_dkdv_sum``."""
    _check_cuda(q, k, v, window, "flash_bwd_dkdv")
    _check_bwd((q, k, v, do), q, (lse, delta), "flash_bwd_dkdv")
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = dkdv_splits(b, hkv, h // hkv, sk, sms) \
        if q.dtype == torch.bfloat16 else 1
    part = torch.empty(2, splits, b, sk, hkv, d, device=q.device,
                       dtype=torch.float32) if splits > 1 else None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _bwd_launcher("flash_bwd_dkdv_launch", _DKDV_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *_bwd_args(q, k, causal, window), splits,
                part.data_ptr() if part is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkdv launch failed: cudaError {rc}")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkdv.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of the forward's output o for its gradient dO: the two
    backward kernels in turn, on packed copies of any strided input."""
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, causal=causal,
                             window=window)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal,
                            window=window)
    return dq, dk, dv


# the two halves of the Function; tests swap in the plain versions
_fwd = flash_attention_with_lse
_bwd = flash_attention_bwd


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward kernel (writing
    each row's LSE when ``need_grad``), and the two backward kernels.
    ``ops.flash_attention`` routes every CUDA call through it; with
    ``need_grad`` false (serving, ``no_grad``) it is the plain forward
    launch, with no LSE written and nothing saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, need_grad: bool):
        if not need_grad:
            return flash_attention(q, k, v, causal=causal, window=window)
        out, lse = _fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, do, lse, causal=ctx.causal,
                          window=ctx.window)
        return dq, dk, dv, None, None, None
