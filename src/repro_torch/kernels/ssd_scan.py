"""Chunked Mamba-2 SSD scan: the CUDA kernel, its plain version and the
sequential oracle.

Port of the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (route: CUDA
C++ for sm_90a, ``csrc/ssd_scan.cu``, bound with ctypes).  The source's
head note says what bounds it on the card and what its design does about
that.

x is (b, s, nh, hd), dt (b, s, nh), A (nh,), B and C (b, s, ds): one
group (``ngroups=1``), so B and C are shared by every head.  Within a
chunk the recurrence is the masked dense product
``exp(segsum(dt A)) * (C B^T)`` applied to ``dt x``; across chunks a state
(nh, hd, ds) is carried and read back as ``C . state``, decayed by
``exp(cumsum(dt A))``.  ``s % chunk`` must be 0.

:func:`ssd_scan` launches the kernel on CUDA tensors and raises on
anything else.  :func:`ssd_scan_ref` is the chunked dual form in torch
(``repro/models/ssd.py::ssd_chunked``, which ``models/ssd.py`` re-exports
under that name): the model's CPU path and the card's yardstick.
:func:`ssd_ref` is the sequential recurrence
(``repro/kernels/ref.py::ssd_ref``), the oracle of the tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CHUNKS = (8, 16, 32, 64, 128, 256)
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(x, dt, A, B, C, chunk: int) -> None:
    """Shape contract shared by every version: x (b, s, nh, hd), dt
    (b, s, nh), A (nh,), B and C (b, s, ds), and ``s % chunk == 0``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, nh, hd), got {tuple(x.shape)}")
    b, s, nh, _ = x.shape
    if tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,):
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if B.dim() != 3 or tuple(B.shape[:2]) != (b, s) or B.shape != C.shape:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"both be (b, s, ds) with (b, s) = {(b, s)}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")


def segsum(dA):
    """Segment sum over the last axis: out[..., i, j] = sum_{j<k<=i}
    dA[..., k], and -inf above the diagonal.

    Each segment is summed on its own (a running sum down the masked
    columns), not taken as the difference cs_i - cs_j of two running sums
    as the reference does: over a chunk of 256 the running sums reach
    several hundred, and their difference keeps only about 1e-4 of the
    small segments' exponent.  dA has one sign, so these sums do not
    cancel.
    """
    q = dA.shape[-1]
    ones = torch.ones(q, q, dtype=torch.bool, device=dA.device)
    z = dA[..., :, None].expand(*dA.shape, q)         # z[..., k, j] = dA_k
    seg = torch.cumsum(z.masked_fill(~ones.tril(-1), 0.0), dim=-2)
    return seg.masked_fill(~ones.tril(), float("-inf"))


def ssd_scan_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """Plain torch version, the chunked dual form in float32.

    Returns y (b, s, nh, hd) in x's dtype and the final state
    (b, nh, hd, ds) in float32; ``initial_state`` (b, nh, hd, ds) is the
    state entering the first chunk (zeros if None).
    """
    check_args(x, dt, A, B, C, chunk)
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, nh, hd).to(f32)
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, ds).to(f32)
    Cc = C.reshape(b, nc, chunk, ds).to(f32)
    dA = dtc * A.to(f32)                                   # (b,nc,q,nh)
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk: y_diag[i] = sum_{j<=i} exp(segsum)_ij (C_i.B_j) dt_j x_j
    seg = segsum(dA.transpose(2, 3))                       # (b,nc,nh,q,q)
    L = torch.exp(seg)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # (b,nc,q,q)
    w = L * scores[:, :, None] * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w, xc)

    # chunk-final states: sum_j exp(cs_end - cs_j) dt_j B_j x_j
    decay_to_end = torch.exp(seg[..., -1, :]).transpose(2, 3)
    wx = (decay_to_end * dtc)[..., None] * xc              # (b,nc,q,nh,hd)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, wx)     # (b,nc,nh,hd,ds)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (b,nc,nh)
    carry = (torch.zeros(b, nh, hd, ds, dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1) if prev else states

    # inter-chunk output: y_off[i] = exp(cs_i) C_i . state entering
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) \
        * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, nh, hd)
    return y.to(x.dtype), carry


def ssd_ref(x, dt, A, B, C):
    """Sequential (non-chunked) recurrence in float32, the exact oracle:
    h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t, y_t = C_t . h_t.  Returns y
    in x's dtype."""
    b, s, nh, hd = x.shape
    f32 = torch.float32
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    h = torch.zeros(b, nh, hd, B.shape[-1], dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)                  # (b, nh)
        dBx = torch.einsum("bn,bh,bhp->bhpn", Bf[:, t], dtf[:, t], xf[:, t])
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, 1).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])


def _launcher():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256):
    """Launch the CUDA kernel; returns y (b, s, nh, hd) in x's dtype.

    x float32 or bfloat16 with hd in 16/32/64; B and C of one dtype,
    float32 or bfloat16, with ds in 16/32/64/128; dt and A float32; all
    on one CUDA device, the last dim of x, B and C contiguous (the rest
    is read through strides).  ``chunk`` in 8/16/32/64/128/256 and
    ``s % chunk == 0``.  The TPU kernel's ``block_heads`` (its head
    tiling) and ``interpret`` (its emulator) have no counterpart here.

    Adds one to ``ssd_scan.launches`` for each launch.  Raises on a CPU
    tensor, another dtype, size or layout, or a launch the runtime
    refuses.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan launches on CUDA tensors, got {dev}")
    check_args(x, dt, A, B, C, chunk)
    for t, name in ((dt, "dt"), (A, "A"), (B, "B"), (C, "C")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in DTYPES or B.dtype not in DTYPES or B.dtype != C.dtype:
        raise ValueError("ssd_scan takes x and B/C in float32 or bfloat16 "
                         f"(B and C alike), got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    if chunk not in CHUNKS or hd not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"chunk {chunk}, hd {hd}, ds {ds}: the kernel "
                         f"takes chunk in {CHUNKS}, hd in {HEAD_DIMS}, ds "
                         f"in {STATE_DIMS}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan reads the last dim of x, B and C "
                         "contiguously")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if b == 0 or s == 0 or nh == 0:
        return y
    A = A.contiguous()
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), DTYPES[x.dtype], DTYPES[B.dtype],
                b, s, nh, hd, ds, chunk, *x.stride()[:3], *dt.stride(),
                *B.stride()[:2], *C.stride()[:2], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
