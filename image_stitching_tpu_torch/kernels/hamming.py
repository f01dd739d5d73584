"""K4: Hamming 2-NN over binary descriptors, all pairs, both directions.

Hopper replacement for `image_stitching_tpu/kernels/hamming_pallas.py`
(`hamming_two_nn_pallas`, `:178`, and `hamming_two_nn_pallas_batched`,
`:104`), which take descriptors of any word count W: ORB's are W = 8
(256 bits), AKAZE's W = 12 (360 bits, zero-padded to 384), BRIEF-128's
W = 4, BRIEF-512's, BRISK's, FREAK's and the full 486-bit MLDB's W = 16.
A CUDA call is two launches of `csrc/hamming_chunked.cu`: the first
unpacks every descriptor of the stack once into 32 W int8 of +-1
(`pm1_rows` is its plain twin), the second takes every pair and both
directions, the
dot products by `wgmma` on the tensor cores (hamming = (32 W - dot) / 2),
at any W, K and pair count; its (distance, column) keys are 32 or 64 bits
(`key_bits`).  The plain version is the reference pipeline's live path,
`match_pair`'s `_two_nn(hamming_matrix(...))` and `_two_nn` of the
transposed matrix (`ops/matching.py:79-167`): a float32 bit-plane product
for the distance matrix, then two masked argmins per direction.  Unlike
the TPU kernel, an invalid column is set to exactly 2^30 rather than
poisoned through its popcount.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

__all__ = ["hamming_two_nn_pairs", "hamming_two_nn_pairs_plain",
           "hamming_two_nn_plain", "hamming_matrix", "two_nn", "pm1_rows",
           "pair_chunk", "unpack_pm1", "key_bits", "max_k", "MAX_TMA"]

# TMA's coordinates (32 W bytes of a row, the image) are signed 32-bit.
MAX_TMA = 2 ** 31 - 1


def key_bits(k: int, words: int) -> int:
    """The width of the (distance, column) keys the CUDA kernel is
    launched on for K descriptors of W words: 32 (d << 16 | column) while
    K <= 65536 and 32 W <= 65535, else 64 (d << 32 | column).  Raises
    ValueError for W < 1."""
    if words < 1:
        raise ValueError(f"hamming_two_nn_pairs: descriptors of {words} "
                         f"words; the kernel takes 1 or more")
    return 32 if k <= 1 << 16 and 32 * words <= 65535 else 64


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


def max_k(words: int, device: torch.device) -> int:
    """The most descriptors an image the CUDA kernel takes at W = `words`
    on `device`: its block keeps B's validity in shared memory, 36 bytes a
    128-column tile beside its stages, within the device's limit a block
    (`hamming_chunked_max_k`; 472960 on the H100)."""
    dev = torch.device(device)
    got = load_library().hamming_chunked_max_k(
        words, torch.cuda.current_device() if dev.index is None else
        dev.index)
    if got < 0:
        check_launch(-got, "hamming_two_nn_pairs (shared-memory limit)")
    return got


def _check_kernel(desc):
    """Raise ValueError past what the CUDA kernel's shared memory and TMA
    coordinates hold; the key width."""
    n_img, k, words = desc.shape
    bits = key_bits(k, words)
    if 32 * words > MAX_TMA or n_img > MAX_TMA:
        raise ValueError(f"hamming_two_nn_pairs: {n_img} images of "
                         f"{32 * words}-byte +-1 rows; TMA's signed 32-bit "
                         f"coordinates take at most {MAX_TMA} of each")
    limit = max_k(words, desc.device)
    if k > limit:
        raise ValueError(f"hamming_two_nn_pairs: K = {k} > {limit}: the "
                         f"kernel keeps B's validity in shared memory, 36 "
                         f"bytes a 128-column tile beside its stages")
    return bits


def _launch(desc, valid, ii, jj, bits):
    """Launch the unpack and the 2-NN kernel on checked CUDA inputs, on
    `bits`-bit keys; (fwd, rev)."""
    n_img, k, words = desc.shape
    p = ii.shape[0]
    dev = desc.device
    try:
        pm1 = unpack_pm1(desc)
        i1, i2 = (torch.empty((2, p, k), dtype=torch.int64, device=dev)
                  for _ in range(2))
        d1, d2 = (torch.empty((2, p, k), dtype=torch.float32, device=dev)
                  for _ in range(2))
    except torch.OutOfMemoryError as err:
        raise torch.OutOfMemoryError(
            f"hamming_two_nn_pairs: the {n_img} x {k} x {32 * words} bytes "
            f"of +-1 rows and the 48 x {p} x {k} bytes of outputs do not fit "
            f"the device's memory") from err
    code = load_library().hamming_chunked_launch(
        pm1.data_ptr(), valid.data_ptr(), ii.data_ptr(), jj.data_ptr(),
        n_img, p, k, words, bits, i1.data_ptr(), d1.data_ptr(),
        i2.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "hamming_two_nn_pairs")
    return (i1[0], d1[0], i2[0], d2[0]), (i1[1], d1[1], i2[1], d2[1])


def hamming_two_nn_pairs(desc: torch.Tensor, valid: torch.Tensor,
                         ii: torch.Tensor, jj: torch.Tensor):
    """The 2-NN of every pair (ii[p], jj[p]) of an image stack, both ways.

    desc (N, K, W) int32 words (W >= 1 on CUDA, K up to `max_k`; any shape
    on the CPU), valid (N, K) bool, ii/jj (P,) int32 image indices.
    Returns (fwd, rev), each (i1 int64, d1 float32, i2 int64, d2 float32)
    of shape (P, K): fwd per row of image ii[p] its nearest and
    second-nearest valid column of image jj[p], rev the same with the
    images swapped.  The d values are exact integers; an invalid column
    counts as 2^30.  A CUDA call counts one in `launches`."""
    _check(desc, valid, ii, jj)
    dev = desc.device
    if dev.type == "cpu":
        return hamming_two_nn_pairs_plain(desc, valid, ii, jj)
    if dev.type != "cuda":
        raise ValueError(f"hamming_two_nn_pairs: no kernel for device {dev}")
    out = _launch(desc, valid, ii, jj, _check_kernel(desc))
    hamming_two_nn_pairs.launches += 1
    return out


hamming_two_nn_pairs.launches = 0
