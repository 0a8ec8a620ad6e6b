"""Shared op helpers: edge-clamped shifts and padding, coordinate grids,
popcount, the argument checks of the kernel wrappers, and the float32
arithmetic of XLA's CPU backend that the plain versions and the kernels
reproduce (``ftz``, ``inv32``, ``fma32``, ``exp_cephes``) — counterpart of
``eppm_tpu/ops/_util.py``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "shift2d", "pad_edge", "grid", "popcount8", "round_up", "require_cuda",
    "check_tensor", "trunc_i32",
    "ftz", "fma32", "exp_cephes", "inv32", "f32", "FLT_MIN",
]

FLT_MIN = 1.1754943508222875e-38  # smallest normal float32


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal values of a non-negative float32 tensor to zero.

    The JAX package's arithmetic flushes subnormals (XLA on the CPU and
    the TPU alike).  The bilateral weights exp(-d^2/sigma_r^2) land in
    the subnormal band often (sigma_r = 0.02), and there a flushed zero
    against a tiny nonzero weight decides exact ties differently — so
    every bilateral weight of the port, in the plain versions and in the
    CUDA kernels, is flushed explicitly."""
    return torch.where(x < FLT_MIN, 0.0, x)


def inv32(c: float) -> float:
    """1/c rounded in float32, as XLA folds it: inside ``jit`` the JAX
    package's ``x / c`` by a constant c becomes ``x * inv32(c)``, so the
    port multiplies by this reciprocal wherever the reference divides by
    a constant.  A multiplication is also rounded alike on every device
    (torch's CUDA division by a Python scalar is not)."""
    return float(np.float32(1.0) / np.float32(c))


def f32(v: float) -> float:
    """A Python float rounded to float32, as XLA applies a weakly typed
    constant: multiplying a float32 tensor by it rounds the same on every
    device."""
    return float(np.float32(v))


# Cephes expf constants, rounded to float32 as the CUDA kernels hold them.
_LOG2E = f32(1.44269504088896341)
_NEG_C1 = f32(-0.693359375)
_NEG_C2 = f32(2.12194440e-4)
_EXP_P = tuple(f32(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1,
))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add a*b + c: the product of two float32
    values is exact in float64, so only the rounding to float32 remains.
    XLA's CPU backend fuses the multiply-adds of the JAX package's loops,
    so the plain versions use this where it does, and the CUDA kernels its
    copy in ``csrc/common.cuh``; the same float64 operations give the same
    bits on every device."""
    if isinstance(c, torch.Tensor):
        c = c.to(torch.float64)
    return (a.to(torch.float64) * b + c).to(torch.float32)


def exp_cephes(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA computes it on the CPU: the Cephes polynomial,
    every multiply-add fused, subnormal results flushed to zero.

    The port's costs and bilateral weights all use this one function, in
    the plain versions and (as ``exp_cephes`` in ``csrc/common.cuh``) in
    the CUDA kernels: it is built from IEEE operations only, so a plain
    version on the CPU, the same on the GPU and its kernel compute the
    same bits, and they match the JAX package's CPU reference.  The
    flow's next level truncates smoothed values such as 2.9999998 or
    3.0000002, so a last-bit difference in exp moves whole pixels."""
    x = x.to(torch.float32).clamp(-87.8, 88.8)
    n = torch.floor(fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = fma32(n, _NEG_C1, x)  # x - n ln2, in two parts
    a = fma32(n, _NEG_C2, a)
    z = fma32(a, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = fma32(z, a, p)
    z = fma32(z, a * a, a)
    z = 1.0 + z
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(z * pow2)


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero, as XLA converts: values
    beyond the int32 range saturate to its ends and NaN becomes 0.

    A plain ``.to(torch.int32)`` of such a value is undefined in C and
    gives -2^31 on torch's CPU backend, while the card's ``cvt.rzi``
    saturates.  The flows a caller hands in (a temporal ``init_flow``)
    and their resizes can hold ``UNKNOWN_FLOW`` = 1e10 or mixes of it, so
    every truncation of such a flow goes through this: the clamp makes
    the conversion the same on every device.  2147483520 is the largest
    float32 below 2^31."""
    x = x.to(torch.float32)
    out = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(x >= 2147483648.0, 2147483647, out.to(torch.int32))


def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices clamp(lo..hi-1, 0, n-1) (CUDA texture clamp addressing)."""
    return torch.arange(lo, hi, device=device).clamp_(0, n - 1)


def pad_edge(a: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Edge-replicate pad of the two leading (spatial) dims; trailing dims
    pass through (numpy/jnp ``mode="edge"``)."""
    h, w = a.shape[0], a.shape[1]
    iy = _clamped(h, -py, h + py, a.device)
    ix = _clamped(w, -px, w + px, a.device)
    return a.index_select(0, iy).index_select(1, ix)


def shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped static shift: out[y, x] = a[clamp(y+dy), clamp(x+dx)]
    (CUDA texture clamp semantics); trailing dims pass through."""
    h, w = a.shape[0], a.shape[1]
    iy = _clamped(h, dy, h + dy, a.device)
    ix = _clamped(w, dx, w + dx, a.device)
    return a.index_select(0, iy).index_select(1, ix)


def grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) int32 coordinate fields."""
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return ys, xs


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Branch-free popcount for 8-bit values stored in int32."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device — the kernel
    wrappers never fall back to a plain version."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"a CUDA kernel needs CUDA tensors, got one on {t.device}"
            )
        if t.device != tensors[0].device:
            raise ValueError(
                f"tensors on {tensors[0].device} and {t.device}: a kernel "
                "takes one device"
            )


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...], align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    whose data starts on an ``align``-byte boundary — what a kernel that
    reads it as raw memory (e.g. one float4 per pixel) takes."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")
