"""K6 (`kernels/orb_detect.py::orb_detect_maps`): one ORB level's plane,
blur, Harris response and rank plane.

On the CPU the wrapper is its plain version, held here to the chain it
replaced (`resize`, `gaussian_blur`, `harris_response_map`,
`fast_corner_mask` and the NMS over candidates) bit for bit.  `emulate` runs
the CUDA kernel's arithmetic and indexing in numpy, block by block: the
shared-memory regions start as NaN, so a read outside what a block wrote
shows as a difference.  The tests marked `cuda` hold the kernel to the
plain version on the card, map by map and through the whole detector.
This file imports no JAX, so it runs on the card's machine as it is."""

import numpy as np
import pytest
import torch

from _torch_port import check_k6, cuda_device, kernel_launches, n
from image_stitching_tpu_torch.core import logging as log
from image_stitching_tpu_torch.kernels import orb_detect as k6
from image_stitching_tpu_torch.ops import imgproc
from image_stitching_tpu_torch.ops.features import orb

TILE = 32
RING = [(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3)]


def textured(h, w, seed=0, dtype=np.uint8):
    """Blocks of random grey upsampled with noise: corners of all
    strengths.  float32 images keep fractional values."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1))
    img = np.kron(base, np.ones((8, 8)))[:h, :w] + rng.normal(0, 6, (h, w))
    img = np.clip(img, 0, 255)
    if dtype == np.uint8:
        return np.round(img).astype(np.uint8)
    return img.astype(np.float32)


def tiled(h, w, seed=0, period=16):
    """One random patch repeated: equal Harris responses at every copy,
    so the top-k's tie order decides which are kept."""
    rng = np.random.default_rng(seed)
    patch = rng.integers(0, 256, (period, period))
    reps = (h // period + 1, w // period + 1)
    return np.tile(patch, reps)[:h, :w].astype(np.uint8)


def level_shapes(h, w, n_levels=8, patch=40):
    """(level, lh, lw) of the levels `detect_levels` keeps."""
    out = []
    for level in range(n_levels):
        lh, lw = imgproc.scale_size(h, w, 1.0 / 1.2 ** level)
        if min(lh, lw) >= patch + 8:
            out.append((level, lh, lw))
    return out


def chain(gray, level, lh, lw, patch=40, thr=20.0):
    """The chain `detect_levels` ran before K6, op by op."""
    img_l = (imgproc.resize(gray, (lh, lw)) if level
             else gray.to(torch.float32))
    corner = orb.fast_corner_mask(gray if level == 0 else img_l, thr)
    harris = orb.harris_response_map(img_l)
    masked = torch.where(corner, harris, -torch.inf)
    pooled = torch.nn.functional.max_pool2d(masked[None, None], 3, stride=1,
                                            padding=1)[0, 0]
    border = patch // 2 + 2
    yy = torch.arange(lh)[:, None]
    xx = torch.arange(lw)[None, :]
    inb = ((yy >= border) & (yy < lh - border) & (xx >= border) &
           (xx < lw - border))
    rank = torch.where(corner & (masked >= pooled) & inb, harris, -torch.inf)
    return img_l, imgproc.gaussian_blur(img_l, 2.0, 3), harris, rank


def same_bits(a, b):
    """Equal float32 planes bit for bit (NaNs and signed zeros included)."""
    a, b = n(a), n(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


# ---- numpy emulation of csrc/orb_detect.cu ------------------------------

def fma64(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) +
            np.asarray(c, np.float64)).astype(np.float32)


def reflect101(i, size):
    i = np.abs(i)
    return np.where(i > size - 1, 2 * (size - 1) - i, i)


def resize_axis(i, s, size):
    src = fma64(np.float32(i) + np.float32(0.5), s, -0.5)
    f = np.minimum(np.maximum(np.floor(src), np.float32(0)),
                   np.float32(size - 1))
    wt = np.minimum(np.maximum(src - f, np.float32(0)), np.float32(1))
    i0 = f.astype(np.int64)
    return i0, np.minimum(i0 + 1, size - 1), wt


def emulate_level_pixel(gray, y, x, resize, sy, sx):
    if not resize:
        return gray[y, x].astype(np.float32)
    h, w = gray.shape
    y0, y1, wy = resize_axis(y, sy, h)
    x0, x1, wx = resize_axis(x, sx, w)
    g = gray.astype(np.float32)
    a0, b0, a1, b1 = g[y0, x0], g[y1, x0], g[y0, x1], g[y1, x1]
    c0 = fma64(b0 - a0, wy, a0)
    c1 = fma64(b1 - a1, wy, a1)
    return fma64(c1 - c0, wx, c0)


def blur_taps(consts, v):
    acc = fma64(v[0], consts[0], np.float32(consts[1]) * v[1])
    for i in range(2, 7):
        acc = fma64(v[i], consts[i], acc)
    return acc


def run9(r):
    for _ in range(8):
        r = r & (((r << 1) | (r >> 15)) & 0xFFFF)
    return r != 0


def emulate_block(gray, lh, lw, resize, consts, thr, border, gy0, gx0,
                  outs):
    """One block of the kernel, phase by phase, on NaN-initialised
    regions; writes its tile of the four planes into `outs`."""
    h, w = gray.shape
    sy = np.float32(h / lh)
    sx = np.float32(w / lw)
    f32 = np.float32
    nan = np.float32(np.nan)
    clamp = np.clip
    # 1. level plane, tile + 5
    s_img = np.full((TILE + 10, TILE + 10), nan, f32)
    r, c = np.mgrid[0:TILE + 10, 0:TILE + 10]
    y, x = gy0 - 5 + r, gx0 - 5 + c
    ok = (y >= 0) & (y < lh) & (x >= 0) & (x < lw)
    s_img[ok] = emulate_level_pixel(gray, y[ok], x[ok], resize, sy, sx)

    def img_at(yy, xx):
        return s_img[clamp(yy, 0, lh - 1) - (gy0 - 5),
                     clamp(xx, 0, lw - 1) - (gx0 - 5)]
    # 2a. products, tile + 4
    s_xx, s_yy, s_xy = (np.full((TILE + 8, TILE + 8), nan, f32)
                        for _ in range(3))
    r, c = np.mgrid[0:TILE + 8, 0:TILE + 8]
    y, x = gy0 - 4 + r, gx0 - 4 + c
    ok = (y >= 0) & (y < lh) & (x >= 0) & (x < lw)
    y, x = y[ok], x[ok]
    gx = ((img_at(y - 1, x + 1) + f32(2) * img_at(y, x + 1)) +
          img_at(y + 1, x + 1)) - ((img_at(y - 1, x - 1) +
                                    f32(2) * img_at(y, x - 1)) +
                                   img_at(y + 1, x - 1))
    gy = ((img_at(y + 1, x - 1) + f32(2) * img_at(y + 1, x)) +
          img_at(y + 1, x + 1)) - ((img_at(y - 1, x - 1) +
                                    f32(2) * img_at(y - 1, x)) +
                                   img_at(y - 1, x + 1))
    s_xx[ok], s_yy[ok], s_xy[ok] = gx * gx, gy * gy, gx * gy
    # 2b. corner flags, tile + 1
    s_c = np.zeros((TILE + 2, TILE + 2), bool)
    r, c = np.mgrid[0:TILE + 2, 0:TILE + 2]
    y, x = gy0 - 1 + r, gx0 - 1 + c
    ok = (y >= 3) & (y < lh - 3) & (x >= 3) & (x < lw - 3)
    y, x = y[ok], x[ok]
    center = np.rint(img_at(y, x)).astype(np.int64)
    bright = np.zeros_like(center)
    dark = np.zeros_like(center)
    for k, (dx, dy) in enumerate(RING):
        nb = np.rint(img_at(y + dy, x + dx)).astype(np.int64)
        bright |= (nb > center + thr).astype(np.int64) << k
        dark |= (nb < center - thr).astype(np.int64) << k
    s_c[ok] = run9(bright) | run9(dark)
    # 2c. vertical blur, the tile's rows, columns + 3
    s_vb = np.full((TILE, TILE + 6), nan, f32)
    r, c = np.mgrid[0:TILE, 0:TILE + 6]
    y, x = gy0 + r, gx0 - 3 + c
    ok = (y < lh) & (x >= 0) & (x < lw)
    y, x = y[ok], x[ok]
    s_vb[ok] = blur_taps(consts, [
        s_img[reflect101(y + k - 3, lh) - (gy0 - 5), x - (gx0 - 5)]
        for k in range(7)])
    # 3a. Harris, tile + 1, by bands of 5 rows sliding down a column
    s_h = np.full((TILE + 2, TILE + 2), nan, f32)
    n_bands = (TILE + 2 + 4) // 5
    for b in range(n_bands):
        r0 = b * 5
        cc = np.arange(TILE + 2)
        x = gx0 - 1 + cc
        keep = (x >= 0) & (x < lw)
        cc, x = cc[keep], x[keep]
        cols = [clamp(x + k - 3, 0, lw - 1) - (gx0 - 4) for k in range(7)]
        acc = np.zeros((3, 5, len(cc)), f32)
        for j in range(5 + 6):
            pr = min(int(clamp(gy0 - 1 + r0 + j - 3, 0, lh - 1)) - (gy0 - 4),
                     TILE + 7)
            vals = [[s[pr, cols[k]] for k in range(7)]
                    for s in (s_xx, s_yy, s_xy)]
            for o in range(5):
                if 0 <= j - o < 7:
                    for k in range(7):
                        for p in range(3):
                            acc[p, o] = acc[p, o] + vals[p][k]
        for o in range(5):
            rr = r0 + o
            yy = gy0 - 1 + rr
            if rr < TILE + 2 and 0 <= yy < lh:
                axx, ayy, axy = acc[:, o]
                det = axx * ayy - axy * axy
                tr = axx + ayy
                s_h[rr, cc] = (det - (f32(consts[7]) * tr) * tr) * \
                    f32(consts[8])
    # 3b. level plane and horizontal blur out
    r, c = np.mgrid[0:TILE, 0:TILE]
    y, x = gy0 + r, gx0 + c
    ok = (y < lh) & (x < lw)
    y, x, r, c = y[ok], x[ok], r[ok], c[ok]
    outs[0][y, x] = s_img[r + 5, c + 5]
    outs[1][y, x] = blur_taps(consts, [
        s_vb[r, reflect101(x + k - 3, lw) - (gx0 - 3)] for k in range(7)])
    # 4. response and rank out
    hc = s_h[r + 1, c + 1]
    cand = s_c[r + 1, c + 1] & (y >= border) & (y < lh - border) & \
        (x >= border) & (x < lw - border)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy, xx = y + dy, x + dx
            inside = (yy >= 0) & (yy < lh) & (xx >= 0) & (xx < lw)
            nb_c = s_c[r + 1 + dy, c + 1 + dx]
            nb_h = s_h[r + 1 + dy, c + 1 + dx]
            with np.errstate(invalid="ignore"):
                cand &= ~(inside & nb_c & ~(nb_h <= hc))
    outs[2][y, x] = hc
    outs[3][y, x] = np.where(cand, hc, f32(-np.inf))


def emulate(gray, level, lh, lw, patch=40, thr=20):
    """The kernel's four planes, every block of its grid in turn."""
    gray = np.asarray(gray)
    outs = [np.full((lh, lw), np.nan, np.float32) for _ in range(4)]
    for gy0 in range(0, lh, TILE):
        for gx0 in range(0, lw, TILE):
            emulate_block(gray, lh, lw, level > 0, k6.KERNEL_CONSTS, thr,
                          patch // 2 + 2, gy0, gx0, outs)
    return outs


# ---- CPU tests -----------------------------------------------------------

VGA_LEVELS = level_shapes(480, 640)


@pytest.mark.parametrize("level,lh,lw", VGA_LEVELS)
def test_plain_maps_are_the_chain(level, lh, lw):
    """On CPU tensors the wrapper is the chain it replaced, map by map."""
    gray = torch.from_numpy(textured(480, 640, seed=level))
    got = k6.orb_detect_maps(gray, level, lh, lw)
    want = chain(gray, level, lh, lw)
    for g, w in zip(got, want):
        assert same_bits(g, w)


def test_plain_maps_at_the_smallest_level():
    """A 48-px level, the smallest `detect_levels` keeps (patch 40 + 8)."""
    gray = torch.from_numpy(textured(58, 58, seed=3))
    assert imgproc.scale_size(58, 58, 1 / 1.2) == (48, 48)
    for g, w in zip(k6.orb_detect_maps(gray, 1, 48, 48),
                    chain(gray, 1, 48, 48)):
        assert same_bits(g, w)


EMULATED = [("u8", 480, 640, lv) for lv in range(8)] + [
    ("f32", 480, 640, 0), ("f32", 480, 640, 3), ("u8", 58, 58, 1),
    ("tied", 200, 300, 0), ("tied", 200, 300, 2), ("u8", 97, 131, 0)]


@pytest.mark.parametrize("kind,h,w,level", EMULATED)
def test_kernel_emulation_equals_plain(kind, h, w, level):
    """The kernel's arithmetic and halo indexing, emulated block by block,
    give the plain version's four planes bit for bit: u8 and float32
    images, every level of a VGA image, the 48-px level, planes of tied
    responses and a plane that no tile size divides."""
    if kind == "tied":
        img = tiled(h, w, seed=level)
    else:
        img = textured(h, w, seed=10 + level,
                       dtype=np.uint8 if kind == "u8" else np.float32)
    _, lh, lw = dict((lv, (lv, a, b)) for lv, a, b in
                     level_shapes(h, w))[level]
    want = k6.orb_detect_maps_plain(torch.from_numpy(img), level, lh, lw)
    got = emulate(img, level, lh, lw)
    for name, g, wnt in zip(("img", "blur", "harris", "rank"), got, want):
        assert same_bits(g, wnt), name
    assert np.isfinite(got[3]).sum() > 0


def test_tied_plane_has_ties():
    """The tied image's rank plane holds equal responses, so the stable
    top-k's lower-index-first order decides which are kept."""
    rank = n(k6.orb_detect_maps(torch.from_numpy(tiled(200, 300)), 0, 200,
                                300)[3])
    vals = rank[np.isfinite(rank)]
    assert vals.size > np.unique(vals).size + 20


def test_wrapper_checks_inputs():
    gray = torch.from_numpy(textured(64, 80))
    with pytest.raises(TypeError):
        k6.orb_detect_maps(gray.double(), 0, 64, 80)
    with pytest.raises(TypeError):
        k6.orb_detect_maps(gray.to(torch.int32), 0, 64, 80)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray[None], 0, 64, 80)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray.t(), 0, 80, 64)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray, 0, 53, 67)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray, 1, 3, 67)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray, -1, 64, 80)
    with pytest.raises(ValueError):
        k6.orb_detect_maps(gray.to("meta"), 0, 64, 80)


FEATURE_FIELDS = ("xy", "response", "angle", "octave", "size", "desc",
                  "valid")


@pytest.mark.parametrize("view", ["crop", "channel"])
def test_orb_takes_strided_views(view):
    """`orb_detect_and_describe` takes a view that is not contiguous (a
    crop, one channel of an image) and finds what it finds in the view's
    contiguous copy."""
    if view == "crop":
        gray = torch.from_numpy(textured(140, 180, seed=4))[10:-10, 10:-10]
    else:
        rgb = np.stack([textured(120, 160, seed=s) for s in (5, 6, 7)], -1)
        gray = torch.from_numpy(rgb)[..., 1]
    assert not gray.is_contiguous() and tuple(gray.shape) == (120, 160)
    got = orb.orb_detect_and_describe(gray, n_features=500)
    want = orb.orb_detect_and_describe(gray.contiguous(), n_features=500)
    for name in FEATURE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.valid.sum()) > 100


def test_k6_span_under_each_orb_level():
    """`detect_levels` opens one `K6` span a level, inside its `orb level`
    span, carrying the level, its shape and its keypoint budget."""
    gray = torch.from_numpy(textured(120, 160))
    with log.trace_stitch() as trace:
        orb.orb_detect_and_describe(gray, n_features=500)
    levels = [(i, s) for i, s in enumerate(trace.spans)
              if s.name == "orb level"]
    shapes = level_shapes(120, 160)
    counts = orb.per_level_counts(500, 8, 1.2)
    assert len(levels) == len(shapes)
    for (i, _), (level, lh, lw) in zip(levels, shapes):
        kids = trace.children(i)
        assert [s.name for s in kids] == ["K6"]
        assert kids[0].attrs == dict(level=level, lh=lh, lw=lw,
                                     k=counts[level])


# ---- on the card ---------------------------------------------------------

CUDA_CASES = [("u8", 480, 640), ("f32", 480, 640), ("u8", 58, 58),
              ("tied", 200, 300), ("u8", 2448, 3264), ("f32", 2448, 3264)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", CUDA_CASES)
def test_kernel_matches_plain_on_cuda(kind, h, w):
    """K6 on the card equals its plain version on the card bit for bit on
    all four maps at every kept level, one launch a call, one kernel in a
    CUDA graph of it; at 2448x3264 on the u8 grays of fast ingest and on
    the float32 ones (with fractions) of the legacy decode."""
    dev = cuda_device()
    img = tiled(h, w) if kind == "tied" else textured(
        h, w, seed=5, dtype=np.float32 if kind == "f32" else np.uint8)
    gray = torch.from_numpy(img).to(dev)
    for level, lh, lw in level_shapes(h, w):
        check_k6(gray, level, lh, lw)
        assert kernel_launches(
            lambda: k6.orb_detect_maps(gray, level, lh, lw)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,w", [("u8", 2448, 3264), ("u8", 480, 640),
                                      ("tied", 480, 640)])
def test_orb_through_k6_equals_plain_route_on_cuda(kind, h, w,
                                                   monkeypatch):
    """The whole detector through K6 equals it through the plain maps on
    the card: keypoints, responses, angles, descriptors and validity."""
    dev = cuda_device()
    img = tiled(h, w) if kind == "tied" else textured(h, w, seed=7)
    gray = torch.from_numpy(img).to(dev)
    got = orb.orb_detect_and_describe(gray, n_features=4000)
    monkeypatch.setattr(orb, "orb_detect_maps", k6.orb_detect_maps_plain)
    want = orb.orb_detect_and_describe(gray, n_features=4000)
    torch.cuda.synchronize()
    for name in FEATURE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.valid.sum()) > 1000
