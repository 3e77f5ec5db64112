"""The port's PNG reader and writer (``data/png.py``) against PIL.

Files written by the port with each of the five row filters are read back
by PIL and by the port bitwise; files written by PIL (RGB, RGBA, L, LA and
P, with PIL's own per-row filter choice) are read by the port bitwise equal
to PIL's ``.convert("RGB")``.  16-bit and interlaced files, damaged files
and other formats raise errors that name the file.  PIL is needed only
where it is the comparison.
"""

import builtins
import struct
import zlib

import numpy as np
import pytest

from surfacenet_tpu_torch.data import dtu, png


@pytest.fixture
def no_pil(monkeypatch):
    """Calling it makes ``import PIL`` fail for the rest of the test."""
    real_import = builtins.__import__

    def guarded(name, *args, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("no PIL")
        return real_import(name, *args, **kw)

    return lambda: monkeypatch.setattr(builtins, "__import__", guarded)


def _image(H=37, W=53, seed=0):
    """Smooth gradients over noise rows: an encoder's filter choice varies."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    smooth = (np.sin(xx / 5.0) + np.cos(yy / 7.0)) * 60 + 128
    img = np.stack([smooth, smooth[::-1], rng.integers(0, 256, (H, W))],
                   axis=-1).astype(np.uint8)
    img[: H // 4] = rng.integers(0, 256, (H // 4, W, 3))
    return img


def _row_filters(path):
    """The filter type byte of every row of an 8-bit PNG."""
    data = open(path, "rb").read()
    chunks = list(png._chunks(data, path))
    W, H, _, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    flat = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    return np.frombuffer(flat, np.uint8).reshape(H, -1)[:, 0]


@pytest.mark.parametrize("ftype", range(5), ids=png.FILTERS)
def test_port_writer_each_filter_read_by_port(tmp_path, ftype):
    img = _image()
    path = str(tmp_path / "a.png")
    png.write_png(path, img, filter_type=ftype)
    assert (_row_filters(path) == ftype).all()
    got = png.read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)


@pytest.mark.parametrize("ftype", range(5), ids=png.FILTERS)
def test_port_writer_each_filter_read_by_pil(tmp_path, ftype):
    Image = pytest.importorskip("PIL.Image")
    img = _image(seed=ftype)
    path = str(tmp_path / "a.png")
    png.write_png(path, img, filter_type=ftype)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        assert np.array_equal(np.asarray(im), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_pil_written_files_read_bitwise(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    img = _image()
    im = Image.fromarray(img)
    if mode == "P":  # a 256-colour palette keeps PIL at 8 bits
        im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=256)
    else:
        im = im.convert(mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    with Image.open(path) as f:
        ref = np.asarray(f.convert("RGB"))
    got = png.read_png(path)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    if mode in ("RGB", "L"):  # PIL picks several filters per file here
        assert len(set(_row_filters(path).tolist())) >= 3


def _raw_png(path, W, H, depth, ctype, interlace, body=b""):
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                 + png._chunk(b"IDAT", zlib.compress(body))
                 + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,interlace", [(16, 0), (8, 1), (4, 0)])
def test_unsupported_variants_raise_clear_errors(tmp_path, depth,
                                                 interlace, no_pil):
    path = str(tmp_path / "v.png")
    _raw_png(path, 4, 3, depth, 2 if depth != 4 else 0, interlace)
    with pytest.raises(png.PNGUnsupported, match="supported: 8-bit"):
        png.read_png(path)
    # without PIL the scan loader names the file and what it reads
    no_pil()
    with pytest.raises(ValueError, match="v.png.*without PIL only"):
        dtu._load_image(path)
    other = tmp_path / "x.jpg"
    other.write_bytes(b"\xff\xd8\xff\xe0not a png")
    with pytest.raises(ValueError, match="x.jpg: not a PNG"):
        dtu._load_image(str(other))


def test_damaged_files_raise(tmp_path):
    path = str(tmp_path / "a.png")
    png.write_png(path, _image(8, 8))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0x01  # inside the IDAT payload: its CRC no longer holds
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC mismatch"):
        png.read_png(str(bad))
    bad.write_bytes(bytes(data[:30]))
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(str(bad))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, _image(8, 8).astype(np.float32))


def test_scan_round_trip_without_pil(tmp_path, no_pil):
    """write_scan then load_scan with PIL unimportable: the images come
    back as their uint8 values / 255, bitwise."""
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene

    no_pil()
    sc = make_sphere_scene(n_views=2, hw=(30, 40))
    d = str(tmp_path / "scan")
    dtu.write_scan(d, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
    scan = dtu.load_scan(d)
    u8 = np.clip(sc.images * 255.0, 0, 255).astype(np.uint8)
    assert scan.images.dtype == np.float32
    assert np.array_equal(scan.images, u8.astype(np.float32) / 255.0)
    np.testing.assert_allclose(scan.Ps, sc.Ps, rtol=1e-9)
