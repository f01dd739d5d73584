"""The reference's `jax.random` draws, bit for bit, in plain tensor ops.

RANSAC in the reference draws every number from `jax.random`'s threefry
generator: `PRNGKey(seed)`, one `split` key a pair, and `uniform` under
that key (`fold_in(key, 1)` for the homography's scoring subsample).  This
module is the port's copy of those functions, so a stitch with the same
seed samples the same hypotheses as the reference's, on the CPU and on the
card alike (the arithmetic is exact integer arithmetic on both).

The counters follow `jax_threefry_partitionable=True`, the default of jax
0.5 and later: `split` and `uniform` hash the 64-bit flat index of each
output element as its (high, low) 32-bit pair, a 32-bit draw is the XOR of
the two hash words, and so `split(key, n)[i] == fold_in(key, i)`.

A key is an int64 tensor of shape (..., 2) holding two uint32 values (the
reference's uint32 (2,) key data).  Every function is batched over the
leading `...`: one call draws for every key of a block of pairs.  Each
threefry call is ~180 elementwise ops on int64 tensors (179 kernel
launches for `uniform`), every value masked back to 32 bits after each
add and shift.
"""

from __future__ import annotations

import math
import operator
from typing import Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "split", "fold_in", "uniform", "threefry_2x32",
           "check_key"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def check_key(key, batch: Tuple[int, ...] = None) -> torch.Tensor:
    """`key` itself if it is an int64 tensor of shape (..., 2) (with
    leading shape `batch` when given); raises otherwise."""
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64:
        raise TypeError("a PRNG key is an int64 tensor of shape (..., 2) "
                        f"(core/prng.py::PRNGKey), got {type(key).__name__}"
                        + (f" of {key.dtype}" if isinstance(key, torch.Tensor)
                           else ""))
    if key.ndim == 0 or key.shape[-1] != 2:
        raise ValueError(f"a PRNG key has shape (..., 2), got "
                         f"{tuple(key.shape)}")
    if batch is not None and tuple(key.shape[:-1]) != tuple(batch):
        raise ValueError(f"keys of shape {tuple(key.shape)}, expected "
                         f"{tuple(batch) + (2,)}")
    return key


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs (x1, x2) under the
    key words (k1, k2): int64 tensors of uint32 values, broadcast together.
    Returns the two hash words (jax `_threefry2x32_lowering`)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int,
            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """The key (2,) of an integer seed: [0, seed mod 2^32], as
    `jax.random.PRNGKey` makes it from a 32-bit seed (-1 gives [0,
    0xFFFFFFFF]).  Seeds outside [-2^31, 2^32) raise, as do non-integers."""
    seed = operator.index(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _counts(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (high, low) words of the flat indices 0 .. n - 1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2) -> (..., n, 2): key i of each is threefry(key, (0, i))."""
    check_key(key)
    hi, lo = _counts(n, key.device)
    b1, b2 = threefry_2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """(..., 2) -> (..., 2): threefry(key, (0, data)) for a uint32 data."""
    check_key(key)
    if not 0 <= int(data) <= _M32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    zero = torch.zeros_like(key[..., 0])
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], zero, zero + int(data))
    return torch.stack([b1, b2], dim=-1)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(..., 2) -> (...,) + shape float32 in [0, 1): `jax.random.uniform`
    of each key.  Element i's 32 random bits are the XOR of the two hash
    words of its flat index; their top 23 become the mantissa under the
    exponent of 1.0, less 1.0."""
    check_key(key)
    shape = tuple(int(d) for d in shape)
    hi, lo = _counts(math.prod(shape), key.device)
    b1, b2 = threefry_2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    one_bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return one_bits.view(torch.float32).reshape(key.shape[:-1] + shape) - 1.0
