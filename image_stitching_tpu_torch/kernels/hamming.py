"""K4: Hamming 2-NN over 256-bit descriptors, batched over pairs.

Hopper replacement for `image_stitching_tpu/kernels/hamming_pallas.py`
(`hamming_two_nn_pallas`, `:178`, and `hamming_two_nn_pallas_batched`,
`:104`).  The CUDA kernel is `csrc/hamming.cu`; the plain version is the
reference pipeline's live path, `_two_nn(hamming_matrix(...))`
(`ops/matching.py:79-146`): a float32 bit-plane product for the distance
matrix, then two masked argmins.  Unlike the TPU kernel, an invalid column
is set to exactly 2^30 rather than poisoned through its popcount.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

__all__ = ["hamming_two_nn", "hamming_two_nn_plain", "hamming_matrix",
           "two_nn"]


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., K, 8) int32 words -> (..., K, 256) float32 bit planes."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """(..., Ka, 8) x (..., Kb, 8) int32 -> (..., Ka, Kb) int32 distances."""
    ba = _unpack_bits(desc_a)
    bb = _unpack_bits(desc_b)
    pa = ba.sum(-1)
    pb = bb.sum(-1)
    common = ba @ bb.transpose(-1, -2)
    return (pa[..., :, None] + pb[..., None, :] - 2.0 * common).to(
        torch.int32)


def two_nn(dist: torch.Tensor, valid_b: torch.Tensor):
    """Per row: (i1, d1, i2, d2) of the two nearest valid columns; ties
    go to the lower column, as argmin."""
    big = float(2 ** 30)
    masked = torch.where(valid_b[..., None, :], dist, big)
    d1, i1 = torch.min(masked, dim=-1)
    cols = torch.arange(masked.shape[-1], device=dist.device)
    masked2 = torch.where(cols == i1[..., None], big, masked)
    d2, i2 = torch.min(masked2, dim=-1)
    return i1, d1, i2, d2


def hamming_two_nn_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                         valid_b: torch.Tensor):
    """The 2-NN from the whole (P, Ka, Kb) distance matrix."""
    return two_nn(hamming_matrix(desc_a, desc_b).to(torch.float32), valid_b)


def _check(desc_a, desc_b, valid_b):
    dev = desc_a.device
    for name, x, dtype in (("desc_a", desc_a, torch.int32),
                           ("desc_b", desc_b, torch.int32),
                           ("valid_b", valid_b, torch.bool)):
        if x.dtype != dtype:
            raise TypeError(f"hamming_two_nn: {name} must be {dtype}, "
                            f"got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"hamming_two_nn: {name} on {x.device}, "
                             f"desc_a on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"hamming_two_nn: {name} must be contiguous")
    if desc_a.ndim != 3 or desc_a.shape[2] != 8:
        raise ValueError(f"hamming_two_nn: desc_a must be (P, Ka, 8), got "
                         f"{tuple(desc_a.shape)}")
    if desc_b.ndim != 3 or desc_b.shape[2] != 8 or \
            desc_b.shape[0] != desc_a.shape[0]:
        raise ValueError(f"hamming_two_nn: desc_b must be (P, Kb, 8), got "
                         f"{tuple(desc_b.shape)}")
    if tuple(valid_b.shape) != tuple(desc_b.shape[:2]):
        raise ValueError(f"hamming_two_nn: valid_b must be (P, Kb), got "
                         f"{tuple(valid_b.shape)}")


def hamming_two_nn(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   valid_b: torch.Tensor):
    """(i1 int64, d1 float32, i2 int64, d2 float32), each (P, Ka): per row
    of A the nearest and second-nearest valid column of B.  desc_* (P, K,
    8) int32 words, valid_b (P, Kb) bool.  The d values are exact integers;
    an invalid column counts as 2^30."""
    _check(desc_a, desc_b, valid_b)
    dev = desc_a.device
    if dev.type == "cpu":
        return hamming_two_nn_plain(desc_a, desc_b, valid_b)
    if dev.type != "cuda":
        raise ValueError(f"hamming_two_nn: no kernel for device {dev}")
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("hamming_two_nn: descriptors must be 16-byte "
                         "aligned (the kernel reads them as uint4)")
    lib = load_library()
    p, ka, kb = desc_a.shape[0], desc_a.shape[1], desc_b.shape[1]
    i1 = torch.empty((p, ka), dtype=torch.int64, device=dev)
    i2 = torch.empty((p, ka), dtype=torch.int64, device=dev)
    d1 = torch.empty((p, ka), dtype=torch.float32, device=dev)
    d2 = torch.empty((p, ka), dtype=torch.float32, device=dev)
    code = lib.hamming_two_nn_launch(
        desc_a.data_ptr(), desc_b.data_ptr(), valid_b.data_ptr(), p, ka, kb,
        i1.data_ptr(), d1.data_ptr(), i2.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "hamming_two_nn")
    hamming_two_nn.launches += 1
    return i1, d1, i2, d2


hamming_two_nn.launches = 0
