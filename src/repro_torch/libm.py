"""glibc's single-precision ``powf`` as torch tensor ops.

The JAX package's f32 ``pow`` runs, on its CPU backend, as a call to
glibc's ``powf`` (sysdeps/ieee754/flt-32, from ARM's optimized-routines).
torch's f32 ``pow``, on the CPU and on the card, is another approximation
that differs from it by an ulp on a few percent of inputs, which moves a
synthetic token (``data.pipeline``) or a bias correction
(``training.optimizer``).  This is glibc's algorithm: table lookups and
polynomials in float64, rounded once to float.  Each product and sum is
its own float64 op (no fused multiply-add); the tests hold the results to
the JAX package's on every input of the domain the port calls it on.
"""
from __future__ import annotations

import functools

import torch

F32, F64 = torch.float32, torch.float64
_M32 = 0xFFFFFFFF

_h = float.fromhex

# powf: log2(x) = log2(c) + k + log1p(z/c - 1)/ln2 over 16 subintervals
# (__powf_log2_data), then exp2 through 2^(j/32) (__exp2f_data)
_LOG2_INVC = tuple(map(_h, (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1")))
_LOG2_LOGC = tuple(map(_h, (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2")))
_LOG2_POLY = tuple(map(_h, (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")))
_EXP2_POLY = tuple(map(_h, (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")))
_EXP2_TAB = tuple(2.0 ** (j / 32) for j in range(32))   # exact doubles
_EXP2_SHIFT = _h("0x1.8p+47")         # x + SHIFT - SHIFT rounds x to k/32
_POW_OFF = 0x3f330000
_POW_OVERFLOW = _h("0x1.fffffffd1d571p+6")

@functools.lru_cache(maxsize=None)
def _tables(dev: torch.device):
    """The lookup tables on ``dev``, copied there once (a copy from the
    host waits for the device, so none is made per call)."""
    return tuple(torch.tensor(t, dtype=F64, device=dev)
                 for t in (_LOG2_INVC, _LOG2_LOGC, _EXP2_TAB))


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) read as int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def powf(x: torch.Tensor, y) -> torch.Tensor:
    """glibc's ``powf(x, y)`` for f32 ``x`` positive and normal (no zero,
    subnormal, inf or NaN) and ``y`` an f32 tensor that broadcasts with
    it, or a Python float (rounded to f32 first)."""
    invc_t, logc_t, exp2_t = _tables(x.device)
    ix = x.view(torch.int32).to(torch.int64)
    tmp = (ix - _POW_OFF) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = _signed32(top) >> 23
    z = _signed32((ix - top) & _M32).to(torch.int32).view(F32).to(F64)
    A = _LOG2_POLY
    # torch.take: an index tensor of any shape (a 0-dim one included,
    # which plain indexing would read on the host)
    r = z * torch.take(invc_t, i) - 1.0
    y0 = torch.take(logc_t, i) + k.to(F64)
    r2 = r * r
    p1 = A[0] * r + A[1]
    p = A[2] * r + A[3]
    r4 = r2 * r2
    q = A[4] * r + y0
    q = p * r2 + q
    logx = p1 * r4 + q
    if isinstance(y, torch.Tensor):
        xd = y.to(F32).to(F64) * logx
    else:
        xd = float(torch.tensor(y, dtype=F32)) * logx
    # exp2(xd) = 2^(n/32) * 2^r, |r| <= 1/64
    kd = (xd + _EXP2_SHIFT) - _EXP2_SHIFT
    n = (kd * 32.0).to(torch.int64)
    r = xd - kd
    s = torch.take(exp2_t, n & 31) * (((n >> 5) + 1023) << 52).view(F64)
    C = _EXP2_POLY
    zc = C[0] * r + C[1]
    r2 = r * r
    out = C[2] * r + 1.0
    out = zc * r2 + out
    out = (out * s).to(F32)
    out = torch.where(xd > _POW_OVERFLOW, float("inf"), out)
    return torch.where(xd <= -150.0, 0.0, out)
