"""Chunked Mamba-2 SSD scan: the CUDA kernel, its plain version and the
sequential oracle.

Port of the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (route: CUDA
C++ for sm_90a, ``csrc/ssd_scan.cu``, bound with ctypes).  The inputs'
types pick the path: x, B and C all bfloat16 (the model's prefill) run
three chunk-parallel kernels on the tensor cores (the chunk states, the
pass over chunks, the outputs); any float32 among them runs one kernel of
f32 FMAs.  The source's head note says what bounds each on the card and
what its design does about that.

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


def ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk: int, initial_state=None):
    """The scan's gradient, written out in float32 with the decomposition
    the CUDA kernels use (not autograd through :func:`ssd_scan_ref`).

    Given dy = dL/dy (b, s, nh, hd), returns (dx in x's dtype, ddt and dA
    in float32, dB and dC in B's dtype, d_initial_state in float32 or
    None when ``initial_state`` is None).  With P_c the state entering
    chunk c and seg(j, i] the same-sign segment sums of :func:`segsum`:

    1. recompute the forward's chunk states and P_c in float32;
    2. G_c = sum_i exp(seg(-1, i]) dy_i C_i^T, the chunk's dy-side state
       gradient, and the reverse pass over chunks D_c = G_c
       + exp(seg(-1, Q-1]) D_{c+1} (D of the state entering chunk c; the
       chunk's end state gets D_{c+1});
    3. per chunk and head: dx, ddt and dA through the diagonal block
       (weights exp(seg) (C_i . B_j) dt_j), the off-diagonal read
       exp(seg(-1, i]) C_i . P_c and the end state's share
       exp(seg(j, Q-1]) dt_j x_j B_j^T; per-head dB and dC;
    4. dB, dC summed over heads (``ngroups = 1``), dA over b and s.

    A step k's exponent gradient collects dL_ij L_ij over every segment
    (j, i] that holds it -- j < k <= i -- as a sum over i >= k of the
    prefix sums over j < k of each row, never as a difference of running
    sums; masked entries (above the diagonal) carry no gradient.
    """
    check_args(x, dt, A, B, C, chunk)
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    q = chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, q, nh, hd).to(f32)
    dyc = dy.reshape(b, nc, q, nh, hd).to(f32)
    dtc = dt.reshape(b, nc, q, nh).to(f32)
    Bc = B.reshape(b, nc, q, ds).to(f32)
    Cc = C.reshape(b, nc, q, ds).to(f32)
    Af = A.to(f32)
    dA = dtc * Af                                          # (b,nc,q,nh)
    seg = segsum(dA.transpose(2, 3))                       # (b,nc,nh,q,q)
    L = torch.exp(seg)
    e_in = torch.exp(torch.cumsum(dA, dim=2))              # exp seg(-1, i]
    u_end = torch.exp(seg[..., -1, :]).transpose(2, 3)     # exp seg(j, Q-1]
    dec = e_in[:, :, -1, :]                                # (b,nc,nh)

    # 1. the forward's chunk states and the state entering each chunk
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                          (u_end * dtc)[..., None] * xc)
    carry = (torch.zeros(b, nh, hd, ds, dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * dec[:, c, :, None, None] + states[:, c]
    P = torch.stack(prev, 1)                               # (b,nc,nh,hd,ds)

    # 2. the dy-side state gradient and the reverse pass over chunks
    G = torch.einsum("bcihp,bcin->bchpn", e_in[..., None] * dyc, Cc)
    D = torch.zeros(b, nh, hd, ds, dtype=f32, device=x.device)
    dS = [None] * nc                     # gradient of each chunk's end state
    for c in reversed(range(nc)):
        dS[c] = D
        D = G[:, c] + dec[:, c, :, None, None] * D
    dS = torch.stack(dS, 1)

    # 3. per chunk and head
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # (b,nc,q,q)
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)      # (b,nc,nh,q,q)
    dt_j = dtc.transpose(2, 3)[..., None, :]               # (b,nc,nh,1,q)
    Lds = L * dyx                                          # dL/ds / dt_j
    N = Lds * scores[:, :, None]                           # dL/d(dt_j) part
    W = L * scores[:, :, None] * dt_j                      # forward weights
    dsc = Lds * dt_j                                       # dL/d(scores)
    dx = torch.einsum("bchij,bcihp->bcjhp", W, dyc)
    ddt = N.sum(-2).transpose(2, 3)                        # (b,nc,q,nh)
    dC = torch.einsum("bchij,bcjn->bcin", dsc, Bc)
    dB = torch.einsum("bchij,bcin->bcjn", dsc, Cc)
    # off-diagonal read: y_i += e_i C_i . P_c
    dyP = torch.einsum("bcihp,bchpn->bcihn", dyc, P)
    dC = dC + torch.einsum("bcih,bcihn->bcin", e_in, dyP)
    de = torch.einsum("bcihn,bcin->bcih", dyP, Cc)
    # the end state's share: u_j dt_j x_j B_j^T, and its decay of P_c
    BdS = torch.einsum("bcjn,bchpn->bcjhp", Bc, dS)
    xBdS = (xc * BdS).sum(-1)                              # (b,nc,q,nh)
    dx = dx + (u_end * dtc)[..., None] * BdS
    ddt = ddt + u_end * xBdS
    dB = dB + torch.einsum("bcjhp,bchpn->bcjn",
                           (u_end * dtc)[..., None] * xc, dS)
    dE = (dS * P).sum((-1, -2))                            # (b,nc,nh)

    # exponent gradients: step k lies in (j, i] for j < k <= i
    M = N * dt_j                                           # dL_ij L_ij
    pre = torch.cumsum(M, dim=-1)                          # sum_{j'<=j}
    T = torch.zeros_like(M)
    T[..., 1:] = pre[..., :-1]                             # sum_{j<k}
    ones = torch.ones(q, q, dtype=torch.bool, device=x.device)
    da = T.masked_fill(~ones.tril(), 0.0).sum(-2).transpose(2, 3)
    da = da + torch.flip(torch.cumsum(torch.flip(de * e_in, [2]), 2), [2])
    da = da + (dE * dec)[:, :, None, :]
    du = dtc * xBdS * u_end
    da = da + torch.cumsum(du, 2) - du                     # sum_{j<k}
    ddt = ddt + da * Af
    dA_out = (da * dtc).sum((0, 1, 2))

    d_init = D if initial_state is not None else None
    return (dx.reshape(b, s, nh, hd).to(x.dtype), ddt.reshape(b, s, nh),
            dA_out, dB.reshape(b, s, ds).to(B.dtype),
            dC.reshape(b, s, ds).to(C.dtype), d_init)


def ssd_ref(x, dt, A, B, C):
    """Sequential (non-chunked) recurrence, the exact oracle:
    h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t, y_t = C_t . h_t, in float32
    (float64 when x is float64).  Returns y in x's dtype."""
    b, s, nh, hd = x.shape
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
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


_F32_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong] * 10 + [ctypes.c_void_p] * 2)
# the tensor-core path's device kernels, in launch order
KERNELS = ("ssd_scan_chunk_state", "ssd_scan_state_pass",
           "ssd_scan_chunk_out")


def _launchers():
    lib = _build.load("ssd_scan")
    f32, bf16 = lib.ssd_scan_launch, lib.ssd_scan_bf16_launch
    f32.argtypes, bf16.argtypes = _F32_ARGTYPES, _BF16_ARGTYPES
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def check_bf16_layout(x, B, C) -> None:
    """The tensor-core path reads x, B and C in 16-byte pieces: each must
    start on 16 bytes, with strides over (b, s[, h]) that are multiples of
    8 elements.  Raises ``ValueError`` otherwise (no copy, no fallback)."""
    for t, name in ((x, "x"), (B, "B"), (C, "C")):
        if not fits_bf16_layout(t):
            raise ValueError(
                f"ssd_scan in bf16 reads {name} in 16-byte pieces: it must "
                f"start on 16 bytes with strides over its leading dims that "
                f"are multiples of 8 elements, got address "
                f"{t.data_ptr()} and strides {t.stride()}")


def check_cuda_args(x, dt, A, B, C, chunk: int) -> None:
    """What every CUDA kernel of the scan takes: the shapes of
    :func:`check_args`, one CUDA device, x and B/C float32 or bfloat16 (B
    and C alike), dt and A float32, the last dim of x, B and C contiguous,
    chunk, hd and ds from CHUNKS, HEAD_DIMS and STATE_DIMS.  Raises
    ``ValueError`` otherwise."""
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
    _, _, _, hd = x.shape
    ds = B.shape[-1]
    if chunk not in CHUNKS or hd not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"chunk {chunk}, hd {hd}, ds {ds}: the kernel "
                         f"takes chunk in {CHUNKS}, hd in {HEAD_DIMS}, ds "
                         f"in {STATE_DIMS}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan reads the last dim of x, B and C "
                         "contiguously")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256):
    """Launch the CUDA kernels; returns y (b, s, nh, hd) in x's dtype.

    x float32 or bfloat16 with hd in 16/32/64; B and C of one dtype,
    float32 or bfloat16, with ds in 16/32/64/128; dt and A float32; all
    on one CUDA device, the last dim of x, B and C contiguous (the rest
    is read through strides; with x, B and C all bfloat16 see
    :func:`check_bf16_layout`).  ``chunk`` in 8/16/32/64/128/256 and
    ``s % chunk == 0``.  The TPU kernel's ``block_heads`` (its head
    tiling) and ``interpret`` (its emulator) have no counterpart here.

    Adds one to ``ssd_scan.launches`` for each call (the tensor-core
    path's three device kernels count as one call).  Raises on a CPU
    tensor, another dtype, size or layout, or a launch the runtime
    refuses.
    """
    check_cuda_args(x, dt, A, B, C, chunk)
    dev = x.device
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    bf16 = x.dtype == B.dtype == torch.bfloat16
    if bf16:
        check_bf16_layout(x, B, C)
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if b == 0 or s == 0 or nh == 0:
        return y
    A = A.contiguous()
    f32_fn, bf16_fn = _launchers()
    strides = (*x.stride()[:3], *dt.stride(), *B.stride()[:2],
               *C.stride()[:2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            # scratch; once freed, the caching allocator hands it only to
            # work queued after these kernels on this stream
            nc = s // chunk
            st = torch.empty(b, nc, nh, hd, ds, dtype=torch.float32,
                             device=dev)
            dec = torch.empty(b, nc, nh, dtype=torch.float32, device=dev)
            prev = torch.empty(2, b, nc, nh, hd, ds, dtype=torch.bfloat16,
                               device=dev)  # hi and lo planes
            fac = torch.empty(b, nc, nh, 8, chunk, dtype=torch.float32,
                              device=dev)  # 8 decay-factor rows a chunk
            errs = (ctypes.c_int * 3)()
            bf16_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), st.data_ptr(),
                    dec.data_ptr(), prev.data_ptr(), fac.data_ptr(), b, s,
                    nh, hd, ds, chunk, *strides, stream, errs)
            failed = {k: e for k, e in zip(KERNELS, errs) if e}
            if failed:
                raise RuntimeError(f"ssd_scan launch failed: cudaError "
                                   f"by kernel {failed}")
        else:
            rc = f32_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), y.data_ptr(),
                        DTYPES[x.dtype], DTYPES[B.dtype], b, s, nh, hd, ds,
                        chunk, *strides, stream)
            if rc != 0:
                raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0


_BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
                 + [ctypes.c_longlong] * 13 + [ctypes.c_void_p] * 2)
_BWD_TC_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 13
                    + [ctypes.c_void_p] * 2)
# the backward's device kernels by path, in launch order
# (csrc/ssd_scan_bwd.cu): x, B and C bfloat16 take the tensor-core kernels
BWD_KERNELS = {
    torch.bfloat16: ("ssd_bwd_tc_states", "ssd_bwd_tc_pass",
                     "ssd_bwd_tc_chunk", "ssd_bwd_tc_bc", "ssd_bwd_tc_sum"),
    torch.float32: ("ssd_bwd_chunk_state", "ssd_bwd_state_pass",
                    "ssd_bwd_chunk", "ssd_bwd_sum"),
}
_TILE = 64


def bwd_plan(b: int, s: int, nh: int, hd: int, ds: int, chunk: int,
             sms: int) -> dict:
    """The tensor-core backward's grid for one call on a card of ``sms``
    SMs.

    ``heads_per_group``: the chunk kernel's block takes one 64-row column
    tile of one chunk for a group of heads, adding the group's W in head
    order; the largest power of two up to 8 whose grid (``chunk_blocks``)
    still gives three blocks per SM (fewer groups, less W written).
    ``ksplits``: the dB/dC kernel splits the heads into this many parts
    (each a float32 partial of dB and dC), the least power of two up to 8
    and nh giving two blocks per SM (``bc_blocks``, beside the b x nc x nh
    blocks of the exponent gradient).  ``partial_bytes``: the float32
    partials of W and of dB and dC written once.  The scratch that holds
    them is sized by the library (:func:`bwd_scratch`)."""
    nc = s // chunk
    t = min(chunk, _TILE)
    nt = chunk // t
    g = 8
    while g > 1 and b * nc * -(-nh // g) * nt < 3 * sms:
        g //= 2
    groups = -(-nh // g)
    ks = 1
    while 2 * ks <= min(8, nh) and b * nc * nt * 2 * ks < 2 * sms:
        ks *= 2
    pairs = nt * (nt + 1) // 2
    return {"tile": t, "tiles": nt, "heads_per_group": g, "groups": groups,
            "ksplits": ks, "chunk_blocks": b * nc * groups * nt,
            "bc_blocks": b * nc * nt * 2 * ks,
            "partial_bytes": 4 * (groups * b * nc * pairs * t * t
                                  + ks * 2 * b * s * ds)}


def bwd_scratch(b: int, s: int, nh: int, hd: int, ds: int, chunk: int,
                heads_per_group: int, ksplits: int,
                dy_f32: bool = False) -> tuple[int, int]:
    """The float32 floats and bfloat16 elements of the tensor-core
    backward's scratch for one call, as its launcher carves them (builds
    the library).  Raises ``ValueError`` for arguments it does not take."""
    fn = _build.load("ssd_scan_bwd").ssd_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    sizes = (ctypes.c_longlong * 2)()
    args = (b, s, nh, hd, ds, chunk, heads_per_group, ksplits)
    if fn(*args, 0 if dy_f32 else 1, sizes):
        raise ValueError(f"ssd_bwd_scratch does not take {args}, dy_f32 "
                         f"{dy_f32}")
    return sizes[0], sizes[1]


def fits_bf16_layout(t) -> bool:
    """Whether ``t`` starts on 16 bytes with strides over its leading dims
    that are multiples of 8 elements and its last dim contiguous: what the
    tensor-core kernels read in 16-byte pieces."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and not any(st % 8 for st in t.stride()[:-1]))


def sm_count(device) -> int:
    """The card's SM count, which :func:`bwd_plan` sizes the grid by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_launchers():
    lib = _build.load("ssd_scan_bwd")
    f32, tc = lib.ssd_scan_bwd_launch, lib.ssd_scan_bwd_bf16_launch
    f32.argtypes, tc.argtypes = _BWD_ARGTYPES, _BWD_TC_ARGTYPES
    f32.restype = tc.restype = ctypes.c_int
    return f32, tc


def bwd_kernel_info(hd: int, ds: int) -> dict:
    """Registers, shared memory, local memory (spills and stack) and
    resident blocks per SM of each tensor-core backward kernel at (hd, ds)
    with a bfloat16 dy, as the CUDA runtime reports them (builds the
    library): {name: {"registers", "smem_bytes", "local_bytes",
    "blocks_per_sm"}}."""
    fn = _build.load("ssd_scan_bwd").ssd_bwd_kernel_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for which, name in enumerate(BWD_KERNELS[torch.bfloat16]):
        info = (ctypes.c_int * 4)()
        rc = fn(hd, ds, which, info)
        if rc != 0:
            raise RuntimeError(f"ssd_bwd_kernel_info({name}): cudaError {rc}")
        out[name] = {"registers": info[0], "smem_bytes": info[1],
                     "local_bytes": info[2], "blocks_per_sm": info[3]}
    return out


def bwd_fma(fn, x, dt, A, B, C, dy, chunk, out, stream):
    """The four f32-FMA kernels (the f32 path, which reads x, B, C and dy
    as float32 or bfloat16 through strides) through launcher ``fn``
    (``ssd_scan_bwd_launch``) into ``out`` = (dx, ddt, dA, dB, dC) on
    ``stream``; returns the launches' cudaError_t array."""
    b, s, nh, hd = x.shape
    ds, nc, f32 = B.shape[-1], s // chunk, torch.float32
    dev = x.device
    dx, ddt, dA, dB, dC = out
    # scratch: the chunk states then the states entering each chunk, their
    # dy-side gradients then the end states' gradients, the chunk decays,
    # each head's dB and dC and each block's share of dA
    st = torch.empty(b, nc, nh, hd, ds, dtype=f32, device=dev)
    gs = torch.empty_like(st)
    dec = torch.empty(b, nc, nh, dtype=f32, device=dev)
    dbp = torch.empty(nh, b, s, ds, dtype=f32, device=dev)
    dcp = torch.empty_like(dbp)
    dap = torch.empty(b, nc, nh, dtype=f32, device=dev)
    strides = (*x.stride()[:3], *dy.stride()[:3], *dt.stride(),
               *B.stride()[:2], *C.stride()[:2])
    errs = (ctypes.c_int * 4)()
    fn(x.data_ptr(), dt.data_ptr(), A.contiguous().data_ptr(), B.data_ptr(),
       C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
       dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), st.data_ptr(),
       gs.data_ptr(), dec.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
       dap.data_ptr(), DTYPES[x.dtype], DTYPES[dy.dtype], DTYPES[B.dtype], b,
       s, nh, hd, ds, chunk, *strides, stream, errs)
    return errs


def ssd_scan_bwd(x, dt, A, B, C, dy, *, chunk: int = 256):
    """Launch the backward's CUDA kernels (``csrc/ssd_scan_bwd.cu``);
    returns (dx in x's dtype, ddt and dA in float32, dB and dC in B's
    dtype) for dy = dL/dy of :func:`ssd_scan` on the same inputs.

    Takes what :func:`ssd_scan` takes and dy of x's shape, float32 or
    bfloat16, on the same device.  The inputs' types pick the path as the
    forward's do: x, B and C all bfloat16 run the five tensor-core kernels
    (``BWD_KERNELS``; x, B and C must meet :func:`check_bf16_layout`, and
    a dy that does not is copied), any float32 among them the four f32
    kernels (any strides with the last dim contiguous; dy copied when its
    last dim is not).  The state entering each chunk is recomputed in
    float32.  Adds one to ``ssd_scan_bwd.launches`` for each call (its
    device kernels count as one).  Raises on a CPU tensor, another dtype,
    size or layout, or a launch the runtime refuses.
    """
    check_cuda_args(x, dt, A, B, C, chunk)
    dev = x.device
    if dy.shape != x.shape or dy.device != dev or dy.dtype not in DTYPES:
        raise ValueError(f"dy must be float32 or bfloat16 of x's shape "
                         f"{tuple(x.shape)} on {dev}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    tc = x.dtype == B.dtype == torch.bfloat16
    if tc:
        check_bf16_layout(x, B, C)
        if not fits_bf16_layout(dy):
            dy = dy.clone(memory_format=torch.contiguous_format)
    elif dy.stride(3) != 1:
        dy = dy.contiguous()
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    f32 = torch.float32
    # every element of every output is written by the kernels
    out = (torch.empty(x.shape, dtype=x.dtype, device=dev),
           torch.empty(b, s, nh, dtype=f32, device=dev),
           torch.empty(nh, dtype=f32, device=dev),
           torch.empty(b, s, ds, dtype=B.dtype, device=dev),
           torch.empty(b, s, ds, dtype=C.dtype, device=dev))
    if b == 0 or s == 0 or nh == 0:
        return tuple(t.zero_() for t in out)
    dx, ddt, dA, dB, dC = out
    f32_fn, tc_fn = _bwd_launchers()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tc:
            plan = bwd_plan(b, s, nh, hd, ds, chunk, sm_count(dev))
            g, ks = plan["heads_per_group"], plan["ksplits"]
            # scratch: the chunk states, the states' hi + lo planes, the
            # scores, W's group partials, the vectors of the exponent
            # gradient, the splits' dB and dC (csrc: tc::Scratch)
            nf, nb = bwd_scratch(b, s, nh, hd, ds, chunk, g, ks,
                                 dy.dtype == f32)
            fs = torch.empty(nf, dtype=f32, device=dev)
            hs = torch.empty(nb, dtype=torch.bfloat16, device=dev)
            strides = (*x.stride()[:3], *dy.stride()[:3], *dt.stride(),
                       *B.stride()[:2], *C.stride()[:2])
            errs = (ctypes.c_int * 5)()
            tc_fn(x.data_ptr(), dt.data_ptr(), A.contiguous().data_ptr(),
                  B.data_ptr(), C.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                  dC.data_ptr(), fs.data_ptr(), hs.data_ptr(), fs.numel(),
                  hs.numel(), DTYPES[dy.dtype], b, s, nh, hd, ds, chunk, g,
                  ks, *strides, stream, errs)
        else:
            errs = bwd_fma(f32_fn, x, dt, A, B, C, dy, chunk, out, stream)
    names = BWD_KERNELS[torch.bfloat16 if tc else f32]
    failed = {k: e for k, e in zip(names, errs) if e}
    if failed:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError by "
                           f"kernel {failed}")
    ssd_scan_bwd.launches += 1
    return out


ssd_scan_bwd.launches = 0


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan`` as an autograd node: its forward is the kernel, its
    backward the backward kernels (:func:`ssd_scan_bwd`), which
    recompute what they need from the saved inputs.  ``ops.ssd_scan``
    routes every CUDA call that records a gradient through it; on the CPU
    the plain version is differentiated as it is."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C = ctx.saved_tensors
        return (*ssd_scan_bwd(x, dt, A, B, C, dy, chunk=ctx.chunk), None)
