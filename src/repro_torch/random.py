"""Counter-based random numbers in int64 tensor ops.

Every draw of the port is a pure function of ``(seed, stream, block,
counter)``: the scenario's own seed, a fixed stream id per kind of draw,
a block index (the hour of a demand block, the second of a plant-noise
row) and the lane inside it.  So a scenario draws the same numbers in
any batch and any chunking, on any device -- the property that makes
``engine_sweep`` independent of ``chunk_size``.

The mixer is Chris Wellons' ``lowbias32`` integer hash, chained over the
key words and applied twice to the counter.  It works on 32-bit values
held in int64 tensors; a 32x32-bit product is split into 16-bit halves
so no intermediate leaves the int64 range.  The bits are not those of
JAX's threefry: parity tests inject the reference's draws instead.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

# stream ids: one per kind of draw (values are arbitrary, distinct)
PLANT_NOISE = 1
LOAD_NOISE = 2
LOAD_PHASE = 3
LOAD_JITTER = 4
FREQ_WANDER = 5
EVENT_COUNT = 6
EVENT_TIME = 7
EVENT_NADIR = 8
EVENT_RECOVERY = 9
BID_ENSEMBLE = 10      # the bidder's forecast ensemble: (seed, hour, member)
BID_PROPOSAL = 11      # the bidder's CEM proposals: (seed, hour, iteration)
SERVICE_LOAD = 12      # the service's live demand noise: (seed, second, host)
TOKEN_ZIPF = 13        # the synthetic LM batch's tokens: (seed, step, lane)
TOKEN_REPEAT = 14      # its repeat-the-previous-token flags
TOKEN_FRONTEND = 15    # its VLM embeds or enc-dec frames: (seed, step, lane)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * (c & 0xFFFF)) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a bijection on 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _as_key(v, device):
    """A key word: a tensor moved to ``device``, or a Python int (which
    enters the hash as a kernel argument, with no copy to the device)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64) & MASK32
    return int(v) & MASK32


def bits(seed, stream: int, block, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits per element of ``counter`` (int64 in [0, 2**32)).

    ``seed`` and ``block`` broadcast against ``counter``; ``stream`` is a
    Python int naming the kind of draw.
    """
    dev = counter.device
    k = hash32(_as_key(seed, dev) ^ _GOLDEN)
    k = hash32(k ^ stream)
    k = hash32(k ^ _as_key(block, dev))
    h = hash32((counter.to(torch.int64) & MASK32) ^ k)
    return hash32(h ^ hash32(k ^ _GOLDEN))


def uniform(seed, stream: int, block, counter: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """Uniform in the open interval (0, 1), 24 bits of resolution."""
    b = bits(seed, stream, block, counter) >> 8
    return ((b.to(torch.float64) + 0.5) * 2.0 ** -24).to(dtype)


def normal(seed, stream: int, block, counter: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normals by Box-Muller on two uniforms per element."""
    c = counter.to(torch.int64) * 2
    u1 = uniform(seed, stream, block, c, torch.float64)
    u2 = uniform(seed, stream, block, c + 1, torch.float64)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.to(dtype)


def lanes(shape, device) -> torch.Tensor:
    """Row-major lane counters 0..prod(shape)-1 shaped ``shape``."""
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
