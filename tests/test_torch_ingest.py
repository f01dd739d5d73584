"""Port parity: fast ingest (`pipeline/ingest.py`) and the native runtime's
decode bindings (`core/native.py`).

Inputs are JPEGs written with PIL from seeded numpy images.  Both packages
decode them through the native runtime, so the planes are compared byte
for byte (the valid regions: iMCU padding beyond the image is left
uninitialised by libjpeg), and the device steps bit for bit; the seam
stack, a float resize rounded to u8, within 1."""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import n, t
from image_stitching_tpu.core import native as jnative
from image_stitching_tpu.ops.imgproc import scale_size
from image_stitching_tpu.pipeline import ingest as jingest
from image_stitching_tpu_torch.core import native
from image_stitching_tpu_torch.pipeline import ingest


def _image(rng, hw):
    """Smooth colour structure plus noise (JPEG-realistic chroma)."""
    base = rng.integers(0, 255, (6, 8, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize((hw[1], hw[0]),
                                                  Image.BILINEAR), np.float32)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _write_set(directory, hws, subsampling=None, ext=".jpg", seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i, hw in enumerate(hws):
        p = os.path.join(str(directory), f"{i}{ext}")
        kw = {} if ext == ".png" else dict(quality=92)
        if subsampling is not None:
            kw["subsampling"] = subsampling
        Image.fromarray(_image(rng, hw)).save(p, **kw)
        paths.append(p)
    return paths


def _planes(buf, w0, h0, num8, w, h):
    """The valid Y, Cb, Cr crops of a packed raw buffer."""
    ya_w, ya_h, ca_w, ca_h = native.yuv420_layout(w0, h0, num8)
    y_sz, c_sz = ya_w * ya_h, ca_w * ca_h
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return (buf[:y_sz].reshape(ya_h, ya_w)[:h, :w],
            buf[y_sz:y_sz + c_sz].reshape(ca_h, ca_w)[:ch, :cw],
            buf[y_sz + c_sz:].reshape(ca_h, ca_w)[:ch, :cw])


@pytest.mark.parametrize("hw", [(37, 53), (160, 224), (2, 3)])
def test_fancy_upsample_and_colour_convert_equal(hw):
    """`_fancy_upsample2x` and `yuv420_to_rgb_exact` equal the JAX
    functions on random planes, odd sizes included; the port's batched
    call equals the reference per image."""
    rng = np.random.default_rng(sum(hw))
    h, w = hw
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
    got_up = n(ingest._fancy_upsample2x(t(cb).to(torch.int32)))
    got = n(ingest.yuv420_to_rgb_exact(t(y), t(cb), t(cr)))
    for i in range(2):
        want_up = np.asarray(jingest._fancy_upsample2x(
            jnp.asarray(cb[i], jnp.int32)))
        np.testing.assert_array_equal(got_up[i], want_up)
        want = np.asarray(jingest.yuv420_to_rgb_exact(
            jnp.asarray(y[i]), jnp.asarray(cb[i]), jnp.asarray(cr[i])))
        np.testing.assert_array_equal(got[i], want)
    assert got.shape == (2, h, w, 3) and got.dtype == np.uint8


def test_pick_num8_and_layout_equal():
    for s in (1.0, 0.9, 0.625, 0.61, 0.5, 0.2237, 0.1, 0.01):
        assert ingest.pick_num8(s) == jingest.pick_num8(s)
    for w, h in ((77, 61), (3264, 2448), (16, 16)):
        for num8 in range(1, 9):
            assert native.yuv420_layout(w, h, num8) == \
                jnative.yuv420_layout(w, h, num8)
            assert native.scaled_dims(w, h, num8) == \
                jnative.scaled_dims(w, h, num8)


@pytest.mark.parametrize("num8", [2, 4, 6, 8])
def test_raw_planes_and_session_equal(tmp_path, num8):
    """read_jpeg_yuv420 and DecodeSession give the packed planes (valid
    regions) and dims of the JAX bindings, byte for byte; the session's
    luma-only and RGB items equal read_image_opts; caller-owned torch
    buffers receive the same bytes as the session's own arrays."""
    paths = _write_set(tmp_path, [(61, 77), (61, 77)], seed=num8)
    p = paths[0]
    assert native.probe_jpeg_sampling(p) == jnative.probe_jpeg_sampling(p)
    got = native.read_jpeg_yuv420(p, num8)
    want = jnative.read_jpeg_yuv420(p, num8)
    assert got[1:] == want[1:] == native.scaled_dims(77, 61, num8)
    for a, b in zip(_planes(got[0], 77, 61, num8, *got[1:]),
                    _planes(want[0], 77, 61, num8, *want[1:])):
        np.testing.assert_array_equal(a, b)
    items = [(q, False, num8, True) for q in paths] + [
        (p, True, num8), (p, False, num8)]
    ref = jnative.DecodeSession(items, nthreads=2)
    own = native.DecodeSession(items, nthreads=2)
    bufs = [torch.zeros(native.item_shape(*it), dtype=torch.uint8)
            for it in items]
    owned = native.DecodeSession(items, nthreads=1, buffers=bufs)
    for i, item in enumerate(items):
        a, b, c = own.wait(i), ref.wait(i), owned.wait(i)
        assert c is bufs[i] and a.shape == b.shape == tuple(c.shape)
        if len(item) > 3:
            w, h = native.scaled_dims(77, 61, num8)
            for x, y, z in zip(_planes(a, 77, 61, num8, w, h),
                               _planes(b, 77, 61, num8, w, h),
                               _planes(n(c), 77, 61, num8, w, h)):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, n(c))
            np.testing.assert_array_equal(
                a, jnative.read_image_opts(p, gray=item[1], num8=num8))
    for s in (own, ref, owned):
        s.finish()
    with pytest.raises(ValueError, match="buffer 0"):
        native.DecodeSession(items[:1], buffers=[np.zeros(3, np.uint8)])


@pytest.mark.parametrize("libs", ["system", "pillow"])
def test_runtime_built_from_vendored_headers(tmp_path, monkeypatch, libs):
    """The port's own build of native/stitch_runtime.cpp (vendored headers;
    the system's libjpeg/libpng16, or Pillow's bundled copies, as on a
    machine without system codecs) decodes as libjpeg does through PIL:
    the raw Y plane equals PIL's luma decode at num8 8 and 4, and the
    colour conversion of the num8-8 planes equals PIL's RGB decode."""
    if libs == "pillow":
        monkeypatch.setattr(native, "_ldconfig_libs", lambda: [])
    jpeg, png = native.codec_libs()
    if libs == "pillow":
        assert "pillow.libs" in jpeg.lower() and "pillow.libs" in png.lower()
    path = native.build_runtime()
    assert os.path.dirname(path).endswith(os.path.join(
        "image_stitching_tpu_torch", "build"))
    lib = ctypes.CDLL(path)
    native._declare(lib)
    monkeypatch.setitem(native._state, "lib", lib)
    for p in _write_set(tmp_path, [(61, 77), (64, 96)], seed=3):
        with Image.open(p) as im:
            w0, h0 = im.size
            rgb = np.asarray(im.convert("RGB"))
        for num8 in (8, 4):
            buf, w, h = native.read_jpeg_yuv420(p, num8)
            y, cb, cr = _planes(buf, w0, h0, num8, w, h)
            with Image.open(p) as im:
                im.draft("L", (w0 * num8 // 8, h0 * num8 // 8))
                np.testing.assert_array_equal(y, np.asarray(im))
            if num8 == 8:
                np.testing.assert_array_equal(
                    n(ingest.yuv420_to_rgb_exact(t(y), t(cb), t(cr))), rgb)


def test_fast_path_needs_the_runtime(tmp_path, monkeypatch):
    """A missing runtime raises; it never sends the fast path to PIL."""
    paths = _write_set(tmp_path, [(32, 48), (32, 48)])
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "no runtime (test)")
    with pytest.raises(RuntimeError, match="no runtime"):
        ingest.start_fast_ingest(paths, False, True, 1.0, 1.0, device="cpu")
    assert not native.available()


# (label, subsampling, gray_scale, rgb_scale, expected route)
ROUTES = {
    "yuv num8 8": (None, 1.0, 1.0, "yuv"),
    "yuv num8 4": (None, 0.5, 0.3, "yuv"),
    "luma": (0, 0.5, 0.25, "luma"),
    "from_rgb": (0, 0.5, 1.0, "from_rgb"),
}


def _fields(fi):
    return (fi.n, fi.want_gray, fi.gray_from_rgb, fi.gray_num8, fi.rgb_num8,
            list(fi.full_sizes), fi.raw_yuv, tuple(fi.decode_hw),
            fi.raw_num8, tuple(fi.raw_layout))


@pytest.mark.parametrize("portrait", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fast_prep_matches_reference(tmp_path, route, portrait):
    """start_fast_ingest -> upload -> fast_prep in both packages on the
    same files: the same route and FastIngest fields; gray_work and the
    oriented RGB equal; the seam stack within 1."""
    sub, gray_scale, rgb_scale, mode = ROUTES[route]
    paths = _write_set(tmp_path, [(90, 122)] * 3, subsampling=sub)
    fj = jingest.start_fast_ingest(paths, portrait, True, gray_scale,
                                   rgb_scale)
    ft = ingest.start_fast_ingest(paths, portrait, True, gray_scale,
                                  rgb_scale, device="cpu")
    assert _fields(ft) == _fields(fj)
    assert ft.raw_yuv == (mode == "yuv")
    assert ft.want_gray == (mode == "luma")
    w0, h0 = ft.full_sizes[0]
    work_hw = (scale_size(h0, w0, gray_scale) if gray_scale != 1.0
               else (h0, w0))
    seam_hw = scale_size(h0, w0, 0.3)
    want = jingest.fast_prep(fj, *fj.upload(), portrait, work_hw, seam_hw)
    got = ingest.fast_prep(ft, *ft.upload(), portrait, work_hw, seam_hw)
    assert got[0].shape == (3,) + work_hw and got[0].dtype == torch.uint8
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert got[2].shape == (3,) + seam_hw + (3,)
    seam_diff = np.abs(n(got[2]).astype(int) - np.asarray(want[2]))
    assert seam_diff.max() <= 1


@pytest.mark.parametrize("capture_set", ["png", "mixed sizes", "4:4:4",
                                         "4:2:0"])
def test_start_fast_ingest_route_equal(tmp_path, capture_set):
    """Both packages take the same route on a capture set: None (the
    legacy decode) for PNG files and mixed sizes, the two-stream decode for
    4:4:4 JPEGs, the raw 4:2:0 planes for 4:2:0 JPEGs; equal fields."""
    hws, sub, ext = {
        "png": ([(40, 56)] * 2, None, ".png"),
        "mixed sizes": ([(40, 56), (48, 56)], None, ".jpg"),
        "4:4:4": ([(40, 56)] * 2, 0, ".jpg"),
        "4:2:0": ([(40, 56)] * 2, None, ".jpg"),
    }[capture_set]
    paths = _write_set(tmp_path, hws, subsampling=sub, ext=ext)
    fj = jingest.start_fast_ingest(paths, False, True, 0.5, 0.25)
    ft = ingest.start_fast_ingest(paths, False, True, 0.5, 0.25, device="cpu")
    if capture_set in ("png", "mixed sizes"):
        assert fj is None and ft is None
        return
    assert _fields(ft) == _fields(fj)
    assert ft.raw_yuv == (capture_set == "4:2:0")
    got, want = ft.upload(), fj.upload()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == b.shape and a.dtype == torch.uint8


@pytest.mark.cuda
def test_fast_ingest_planes_equal_pil_on_cuda(tmp_path):
    """Fast ingest on the card, three 4:2:0 JPEGs at 2448x3264: the raw
    route at num8 8 into one pinned host buffer a file; the device RGB of
    the planes equals PIL's RGB decode and the Y plane PIL's luma decode;
    at num8 4 the Y plane equals PIL's half-size luma decode; the card's
    fast_prep equals the CPU's on the same planes (the seam stack within
    1)."""
    from _torch_port import cuda_device
    dev = cuda_device()
    paths = _write_set(tmp_path, [(2448, 3264)] * 3)

    def luma(path, num8):
        with Image.open(path) as im:
            im.draft("L", (im.size[0] * num8 // 8, im.size[1] * num8 // 8))
            return np.asarray(im.convert("L"))
    fi = ingest.start_fast_ingest(paths, False, True, 1.0, 1.0, device=dev)
    assert fi is not None and fi.raw_yuv and fi.raw_num8 == 8
    assert sum(isinstance(b, torch.Tensor) and b.is_pinned()
               for b in fi.session._buffers) == len(paths)
    raw = fi.upload()[1]
    y, cb, cr = ingest._unpack_planes(raw, fi.raw_layout)
    rgb = n(ingest.yuv420_to_rgb_exact(y, cb, cr))
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            np.testing.assert_array_equal(rgb[i], np.asarray(im.convert(
                "RGB")))
        np.testing.assert_array_equal(n(y[i]), luma(p, 8))
    half = ingest.start_fast_ingest(paths, False, True, 0.5, 0.3, device=dev)
    assert half is not None and half.raw_yuv and half.raw_num8 == 4
    y4 = ingest._unpack_planes(half.upload()[1], half.raw_layout)[0]
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(n(y4[i]), luma(p, 4))
    from image_stitching_tpu_torch.ops.imgproc import scale_size as size
    seam_hw = size(2448, 3264, (0.1e6 / (2448 * 3264)) ** 0.5)
    got, want = (ingest.fast_prep(fi, None, stack, False, (2448, 3264),
                                  seam_hw) for stack in (raw, raw.cpu()))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert int((got[2].cpu().int() - want[2].int()).abs().max()) <= 1
