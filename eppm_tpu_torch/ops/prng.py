"""JAX's threefry key arithmetic in torch: ``prng_key``, ``split``,
``fold_in`` and ``randint`` make the bits of ``jax.random.PRNGKey``,
``split``, ``fold_in`` and ``randint(..., dtype=int32)`` (jax 0.9, the
default threefry2x32 implementation with ``jax_threefry_partitionable``
on), so the PatchMatch engine draws what ``eppm_tpu`` draws for the same
seed (``ops/patchmatch.py::ThreefrySampler``).

A key is an int64 tensor (..., 2) holding the two uint32 words of JAX's
raw key; functions take stacks of keys along the leading dims and return
the results stacked alike.  All arithmetic is int64 with 32-bit masks:
integer operations, so the card and the CPU give the same bits.  Nothing
is copied from the host (on the card such a copy would wait for the
device): constants enter as scalars or fills.

- threefry2x32: 20 rounds, rotations 13/15/26/6 and 17/29/16/24, a key
  injection after every 4 rounds (``jax._src.prng._threefry2x32_lowering``);
- ``split(key, n)``: key i is the hash of the counter (0, i)
  (``_threefry_split_foldlike``);
- ``fold_in(key, d)``: the hash of (0, d) (``threefry_2x32(key,
  threefry_seed(d))``);
- random bits: element j of a field hashes the counter (j >> 32, j mod
  2^32), and its 32 bits are the xor of the two output words
  (``_threefry_random_bits_partitionable``);
- ``randint``: two fields of bits from ``split(key)``, combined as
  ((hi mod span) * (2^16 mod span)^2 + lo mod span) mod span in uint32
  arithmetic (``jax._src.random._randint``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

__all__ = ["prng_key", "split", "fold_in", "random_bits", "randint",
           "threefry2x32"]

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1

Bound = Union[int, torch.Tensor]


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry2x32 hash of the counter words (x0, x1) under the key
    words (k1, k2): int64 tensors of uint32 values, broadcast together ->
    the two output words.  x0 is left unmasked between additions (it
    stays far below 2^63 and only its low 32 bits reach x1 or the
    output)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0
            x1 = x1 & MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0 & MASK, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> (2,) int64: (seed >> 32, seed mod
    2^32), a seed in the int32 range giving (0, seed mod 2^32) as JAX's
    32-bit default does."""
    seed = int(seed)
    hi = 0 if _INT32_MIN <= seed <= _INT32_MAX else (seed >> 32) & MASK
    key = torch.full((2,), seed & MASK, dtype=torch.int64, device=device)
    key[:1].fill_(hi)  # a fill: ``key[0] = hi`` copies from the host
    return key


def _words(key: torch.Tensor):
    if key.shape[-1] != 2 or key.dtype != torch.int64:
        raise ValueError(f"a key is an int64 tensor (..., 2), got "
                         f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0:1], key[..., 1:2]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys (..., 2) -> (..., num, 2)."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for uint32 ``data``: keys (...,
    2) and an int -> (..., 2); a 1-D tensor of data (the vmap of the
    reference's per-pair keys) -> (..., len(data), 2)."""
    k1, k2 = _words(key)
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        d = torch.full((1,), int(data) & MASK, dtype=torch.int64,
                       device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    out = torch.stack([b1, b2], dim=-1)
    return out if torch.is_tensor(data) else out[..., 0, :]


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits a position (``jax.random.bits(key, shape,
    uint32)``): keys (..., 2) -> int64 (..., *shape) in [0, 2^32)."""
    k1, k2 = _words(key)
    n = math.prod(shape)
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, j >> 32, j & MASK)
    return (b1 ^ b2).reshape(key.shape[:-1] + tuple(shape))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for a, b in [0, 2^32), without leaving int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _bound(b: Bound, device) -> torch.Tensor:
    """A bound as an int64 tensor on ``device``; an int is checked against
    the int32 range here, a tensor's values are the caller's to keep in
    it (reading them would wait for the device)."""
    if torch.is_tensor(b):
        return b.to(device=device, dtype=torch.int64)
    if not _INT32_MIN <= int(b) <= _INT32_MAX:
        raise ValueError("randint takes bounds in the int32 range")
    return torch.full((), int(b), dtype=torch.int64, device=device)


def randint(key: torch.Tensor, shape: Sequence[int], low: Bound,
            high: Bound) -> torch.Tensor:
    """``jax.random.randint(key, shape, low, high, dtype=int32)``: keys
    (..., 2) -> int32 (..., *shape), uniform in [low, high) (``low`` where
    high <= low).  ``low`` and ``high`` are ints or int tensors that
    broadcast against the result, within the int32 range."""
    keys = split(key)                                  # (..., 2, 2)
    bits = random_bits(keys, shape)                    # (..., 2, *shape)
    lead = key.dim() - 1
    higher, lower = bits.unbind(lead)
    lo, hi = _bound(low, key.device), _bound(high, key.device)
    span = torch.where(hi <= lo, 1, (hi - lo) & MASK)
    mult = torch.remainder(65536, span)
    mult = torch.remainder(_mul32(mult, mult), span)
    off = _mul32(torch.remainder(higher, span), mult)
    off = ((off + torch.remainder(lower, span)) & MASK) % span
    return (lo + off).to(torch.int32)
