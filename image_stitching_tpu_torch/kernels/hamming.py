"""K4: Hamming 2-NN over binary descriptors, all pairs, both directions.

Hopper replacement for `image_stitching_tpu/kernels/hamming_pallas.py`
(`hamming_two_nn_pallas`, `:178`, and `hamming_two_nn_pallas_batched`,
`:104`), which take descriptors of any word count W: ORB's are W = 8
(256 bits), AKAZE's W = 12 (360 bits, zero-padded to 384), BRIEF-128's
W = 4, BRIEF-512's, BRISK's, FREAK's and the full 486-bit MLDB's W = 16.
The CUDA kernels are `csrc/hamming.cu` and `csrc/hamming_chunked.cu`, on
one of two routes (`kernel_route`); on both, one launch unpacks every
descriptor of the stack once into 32 W int8 of +-1 (`pm1_rows` is its
plain twin) and the other takes every pair and both directions, with the
dot products on the tensor cores (hamming = (32 W - dot) / 2):
  * "tensor", W in `KERNEL_WORDS`: a template on W that holds each A row
    in its `mma.sync` fragments;
  * "chunked", every other W from 1 to `MAX_WORDS`: W at run time, the
    rows brought into shared memory by TMA in 128-byte stages of depth
    and multiplied by `wgmma` (`hamming_wgmma_kernel`).
The plain version is the reference pipeline's live path, `match_pair`'s
`_two_nn(hamming_matrix(...))` and `_two_nn` of the transposed matrix
(`ops/matching.py:79-167`): a float32 bit-plane product for the distance
matrix, then two masked argmins per direction.  Unlike the TPU kernel, an
invalid column is set to exactly 2^30 rather than poisoned through its
popcount.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

__all__ = ["hamming_two_nn_pairs", "hamming_two_nn_pairs_plain",
           "hamming_two_nn_plain", "hamming_matrix", "two_nn", "pm1_rows",
           "pair_chunk", "unpack_pm1", "kernel_route", "KERNEL_WORDS",
           "MAX_WORDS", "MAX_K"]

# The kernels pack (distance, column) into one 32-bit key: a column in 16
# bits, a distance (at most 32 W) in the other 16.
MAX_K = 1 << 16
MAX_WORDS = 2047
# The descriptor word counts the tensor-core kernel is instantiated for.
KERNEL_WORDS = (8, 12)


def kernel_route(words: int) -> str:
    """The CUDA route of a call with W-word descriptors: "tensor" (the
    int8 tensor-core template, W in `KERNEL_WORDS`) or "chunked" (the
    run-time-width tensor-core kernel, any other W up to `MAX_WORDS`).
    Raises ValueError for W < 1 or W > MAX_WORDS."""
    if words < 1 or words > MAX_WORDS:
        raise ValueError(f"hamming_two_nn_pairs: descriptors of {words} "
                         f"words; the kernels take 1 to {MAX_WORDS} words "
                         f"(32 W bits must fit a 16-bit distance)")
    return "tensor" if words in KERNEL_WORDS else "chunked"


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., K, W) int32 words -> (..., K, 32 W) int32 bits, bit b of word
    w at 32 w + b."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)


def pm1_rows(desc: torch.Tensor) -> torch.Tensor:
    """(..., K, W) int32 words -> (..., K, 32 W) int8 rows of +1 (bit 0)
    and -1 (bit 1): the layout the CUDA kernel's unpack writes, so that
    hamming(a, b) = (32 W - <pm1(a), pm1(b)>) / 2."""
    return (1 - 2 * _unpack_bits(desc)).to(torch.int8)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor):
    """(..., Ka, W) x (..., Kb, W) int32 -> (..., Ka, Kb) int32 distances."""
    ba = _unpack_bits(desc_a).to(torch.float32)
    bb = _unpack_bits(desc_b).to(torch.float32)
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
    """One direction's 2-NN from the whole (..., Ka, Kb) distance matrix."""
    return two_nn(hamming_matrix(desc_a, desc_b).to(torch.float32), valid_b)


def pair_chunk(k: int) -> int:
    """Pairs per batch of the plain version: bound its (K, K) float32
    matrices (~12 B per entry with temporaries) to ~600 MB."""
    c = max(1, min(64, int(6e8) // max(k * k * 12, 1)))
    return 1 << (c.bit_length() - 1)


def hamming_two_nn_pairs_plain(desc: torch.Tensor, valid: torch.Tensor,
                               ii: torch.Tensor, jj: torch.Tensor,
                               chunk: int = 0):
    """`hamming_two_nn_pairs` in PyTorch ops, `chunk` pairs at a time
    (default `pair_chunk(K)`): one distance matrix per pair, read as it is
    for the forward 2-NN and transposed for the reverse one."""
    chunk = chunk or pair_chunk(desc.shape[1])
    fwd, rev = [], []
    for s in range(0, ii.shape[0], chunk):
        a, b = ii[s:s + chunk], jj[s:s + chunk]
        dist = hamming_matrix(desc[a], desc[b]).to(torch.float32)
        fwd.append(two_nn(dist, valid[b]))
        rev.append(two_nn(dist.transpose(-1, -2), valid[a]))
    if not fwd:
        z_i = torch.zeros((0, desc.shape[1]), dtype=torch.int64,
                          device=desc.device)
        z_d = torch.zeros((0, desc.shape[1]), device=desc.device)
        return (z_i, z_d, z_i, z_d), (z_i, z_d, z_i, z_d)
    return (tuple(torch.cat(x) for x in zip(*fwd)),
            tuple(torch.cat(x) for x in zip(*rev)))


def _check(desc, valid, ii, jj):
    dev = desc.device
    for name, x, dtype in (("desc", desc, torch.int32),
                           ("valid", valid, torch.bool),
                           ("ii", ii, torch.int32), ("jj", jj, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"hamming_two_nn_pairs: {name} must be {dtype}, "
                            f"got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"hamming_two_nn_pairs: {name} on {x.device}, "
                             f"desc on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"hamming_two_nn_pairs: {name} must be "
                             f"contiguous")
    if desc.ndim != 3:
        raise ValueError(f"hamming_two_nn_pairs: desc must be (N, K, W), "
                         f"got {tuple(desc.shape)}")
    if tuple(valid.shape) != tuple(desc.shape[:2]):
        raise ValueError(f"hamming_two_nn_pairs: valid must be (N, K), got "
                         f"{tuple(valid.shape)}")
    if ii.ndim != 1 or ii.shape != jj.shape:
        raise ValueError(f"hamming_two_nn_pairs: ii, jj must be (P,), got "
                         f"{tuple(ii.shape)} and {tuple(jj.shape)}")
    if desc.shape[1] > MAX_K:
        raise ValueError(f"hamming_two_nn_pairs: K = {desc.shape[1]} > "
                         f"{MAX_K} (a column must fit 16 bits)")


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """`pm1_rows` of a contiguous CUDA (..., K, W) int32 tensor by the
    kernel's unpack step (the first of the two launches of
    `hamming_two_nn_pairs`)."""
    if desc.device.type != "cuda":
        raise ValueError(f"unpack_pm1: no kernel for device {desc.device}")
    w = desc.shape[-1]
    out = torch.empty(desc.shape[:-1] + (32 * w,), dtype=torch.int8,
                      device=desc.device)
    check_launch(load_library().hamming_unpack_launch(
        desc.data_ptr(), desc.numel() // max(w, 1), w, out.data_ptr(),
        torch.cuda.current_stream(desc.device).cuda_stream),
        "hamming_two_nn_pairs (unpack)")
    return out


def _launch(route: str, desc, valid, ii, jj):
    """Launch `route`'s kernels on checked CUDA inputs; (fwd, rev)."""
    lib = load_library()
    dev = desc.device
    n_img, k, words = desc.shape
    p = ii.shape[0]
    pm1 = unpack_pm1(desc)
    i1 = torch.empty((2, p, k), dtype=torch.int64, device=dev)
    i2 = torch.empty((2, p, k), dtype=torch.int64, device=dev)
    d1 = torch.empty((2, p, k), dtype=torch.float32, device=dev)
    d2 = torch.empty((2, p, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (i1.data_ptr(), d1.data_ptr(), i2.data_ptr(), d2.data_ptr())
    if route == "tensor":
        code = lib.hamming_pairs_launch(
            pm1.data_ptr(), valid.data_ptr(), ii.data_ptr(), jj.data_ptr(),
            p, k, words, *ptrs, stream)
    else:
        code = lib.hamming_chunked_launch(
            pm1.data_ptr(), valid.data_ptr(), ii.data_ptr(), jj.data_ptr(),
            n_img, p, k, words, *ptrs, stream)
    check_launch(code, f"hamming_two_nn_pairs ({route} route)")
    return (i1[0], d1[0], i2[0], d2[0]), (i1[1], d1[1], i2[1], d2[1])


def hamming_two_nn_pairs(desc: torch.Tensor, valid: torch.Tensor,
                         ii: torch.Tensor, jj: torch.Tensor):
    """The 2-NN of every pair (ii[p], jj[p]) of an image stack, both ways.

    desc (N, K, W) int32 words (on CUDA, 1 <= W <= `MAX_WORDS` by the
    route `kernel_route(W)` picks; any W on the CPU), valid (N, K) bool,
    ii/jj (P,) int32 image indices.  Returns (fwd, rev), each (i1 int64,
    d1 float32, i2 int64, d2 float32) of shape (P, K): fwd per row of
    image ii[p] its nearest and second-nearest valid column of image
    jj[p], rev the same with the images swapped.  The d values are exact
    integers; an invalid column counts as 2^30.  A CUDA call counts one
    launch in `launches` and one in `route_launches[route]`."""
    _check(desc, valid, ii, jj)
    dev = desc.device
    if dev.type == "cpu":
        return hamming_two_nn_pairs_plain(desc, valid, ii, jj)
    if dev.type != "cuda":
        raise ValueError(f"hamming_two_nn_pairs: no kernel for device {dev}")
    route = kernel_route(desc.shape[2])
    out = _launch(route, desc, valid, ii, jj)
    hamming_two_nn_pairs.launches += 1
    hamming_two_nn_pairs.route_launches[route] += 1
    return out


hamming_two_nn_pairs.launches = 0
hamming_two_nn_pairs.route_launches = {"tensor": 0, "chunked": 0}


def _chunked_pairs(desc: torch.Tensor, valid: torch.Tensor,
                   ii: torch.Tensor, jj: torch.Tensor):
    """The chunked route's kernel at any W, 8 and 12 included, outside the
    counts: a measuring aid beside the template, not a route."""
    _check(desc, valid, ii, jj)
    if desc.device.type != "cuda":
        raise ValueError(f"_chunked_pairs: no kernel for device "
                         f"{desc.device}")
    kernel_route(desc.shape[2])
    return _launch("chunked", desc, valid, ii, jj)
