"""The file route finds a page's format in PIL's plugin order
(``tdnet_torch/data/plugins.py``, ``image.py``): held against
``Image.open`` on a byte fuzz of TGA, PCX and IM headers (TGA and IM have
no magic number, so PIL offers them every file its other plugins pass on),
on files that a plugin the port does not have takes first, and on a PCX
prefix that PCX passes on to TGA. Also the routes' messages for a body or
a file neither reads."""

import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from tdnet_torch.data import image as port_image
from tests.test_torch_tga import assert_as_pil, pil_bytes, pil_rgb, tga_file

FUZZ_CASES = 300


def _fuzzed(case: int) -> bytes:
    """A TGA, PCX or IM file of PIL's writer with 1 to 3 of its header
    bytes replaced (a byte of the format's values or any byte), 1 case in
    10 also cut short."""
    rng = np.random.default_rng(1000 + case)
    kind = ("tga", "pcx", "im")[case % 3]
    w, h = int(rng.integers(1, 13)), int(rng.integers(1, 9))
    im = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    modes = {"tga": ["RGB", "RGBA", "L", "P", "LA", "1"], "pcx": ["RGB", "L", "P", "1"],
             "im": ["RGB", "L", "P", "1", "LA", "RGBA", "CMYK", "F", "I"]}[kind]
    mode = str(rng.choice(modes))
    im = im.quantize(int(rng.integers(2, 40))) if mode == "P" else im.convert(mode)
    kw = {"compression": "tga_rle" if rng.random() < 0.5 else None} if kind == "tga" else {}
    data = bytearray(pil_bytes(im, kind.upper(), **kw))
    head = {"tga": 18, "pcx": 128, "im": 100}[kind]
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(0, head))
        data[at] = int(rng.integers(0, 256)) if rng.random() < 0.6 else int(rng.choice(
            [0, 1, 2, 3, 9, 10, 11, 12, 0x1C, 0x20, 26, 13, 0xFF, 0x80, 5]))
    if rng.random() < 0.1:
        data = data[:int(rng.integers(0, len(data)))]
    return bytes(data)


@pytest.mark.parametrize("case", range(FUZZ_CASES))
def test_plugin_order_fuzz_reads_or_refuses_as_pil(case, tmp_path):
    """The port reads exactly the files PIL opens and converts, with equal
    pixels and size, and refuses the rest."""
    data = _fuzzed(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = pil_rgb(data)
    if want is None:
        with pytest.raises(ValueError):
            port_image.decode_image(data, route="pil")
        return
    got = port_image.decode_image(data, route="pil")
    assert got.shape == want[0].shape and np.array_equal(got, want[0])
    path = tmp_path / "page"
    path.write_bytes(data)
    assert tuple(port_image.image_size(path)) == tuple(want[1])


def test_a_pcx_prefix_pcx_passes_on_reads_as_tga():
    """Byte 0 of 10 and version 0 with an empty window: PCX passes the
    file on and PIL reads it as a gray TGA with a 10-byte ID field."""
    header = bytes([10, 0, 3, 0]) + struct.pack("<4H", 9, 0, 2, 3) + struct.pack("<HH", 4, 3)
    header += bytes([8, 0x20])
    data = header + bytes(range(10)) + bytes(range(100, 112))
    assert Image.open(io.BytesIO(data)).format == "TGA"
    assert np.array_equal(port_image.decode_image(data, route="pil"), pil_rgb(data)[0])


@pytest.mark.parametrize("case,plugin", [
    ("mpeg", "MPEG"), ("avif", "AVIF"), ("bufr", "BUFR"), ("grib", "GRIB"), ("hdf5", "HDF5"),
    ("eps", "EPS"), ("wmf", "WMF")])
def test_files_a_plugin_the_port_lacks_takes_first(case, plugin, tmp_path):
    """PIL hands these to a plugin that opens the file and then cannot load
    it (BUFR, GRIB, HDF5: no loader; EPS: no Ghostscript; MPEG; WMF), or
    to its AVIF plugin, which fails in its ``_open`` on this stub, before
    the TGA (or any) reader: the port refuses them, naming the plugin and
    PIL's own failure, or (AVIF) in its own AVIF reader as PIL does."""
    tga_body = bytes(12)
    data = {
        "mpeg": b"\0\0\1\xb3\x10\x00\x80" + tga_file(tga_body, 2, 2, 2, 24)[7:],
        "avif": b"\0\0\0\x1cftypavif" + bytes(40),
        "bufr": b"BUFR" + bytes(100),
        "grib": b"GRIB\0\0\0\1" + bytes(100),
        "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(100),
        "eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 10\n" + bytes(100),
        "wmf": b"\xd7\xcd\xc6\x9a\0\0" + struct.pack("<4hH", 0, 0, 100, 50, 72) + bytes(6)
        + b"\x01\x00\t\x00" + bytes(40),
    }[case]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(io.BytesIO(data))
        assert im.format == plugin
        with pytest.raises(OSError) as pil_failure:
            im.convert("RGB")
        failure = str(pil_failure.value)
    except Exception:  # noqa: BLE001 (the plugin fails in its _open: Image.open ends)
        failure = None
    match = "AVIF .*PIL refuses it" if plugin == "AVIF" else f"by its {plugin} plugin"
    with pytest.raises(ValueError, match=match) as got:
        port_image.decode_image(data, route="pil")
    if plugin in ("BUFR", "GRIB", "HDF5", "EPS", "MPEG", "WMF"):
        assert "cannot load it" in str(got.value) and failure in str(got.value)
    else:
        assert failure is None and port_image.pil_plugin(data)[0] == "AVIF"
    path = tmp_path / "page"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        port_image.image_size(path)


def test_an_mpeg_header_of_no_size_passes_on_to_tga():
    """MPEG's plugin passes on a sequence header whose size is 0, and PIL
    takes the file for the TGA it also is (here one that it cannot load)."""
    data = b"\0\0\1\xb3" + tga_file(bytes(12), 2, 2, 2, 24)[4:]
    assert Image.open(io.BytesIO(data)).format == "TGA"
    assert port_image.pil_plugin(data)[0] == "TGA"
    assert not assert_as_pil(data)


# --- the headers of the plugins that see many files, fuzzed: the port hands
# each file to the plugin PIL does, and reads it as PIL does

NEW_KINDS = ("imt", "spider", "gbr", "iptc", "cur", "dib")
NEW_FUZZ_CASES = 240
_PREINIT = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG"]


def _pil_plugin(data: bytes):
    """The plugin that Image.open hands data to (it opens the file or fails
    in it), by offering it to one plugin at a time in Image.open's order."""
    Image.init()
    for name in _PREINIT + [n for n in Image.ID if n not in _PREINIT]:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                Image.open(io.BytesIO(data), formats=[name])
        except UnidentifiedImageError:
            continue
        except Exception:  # noqa: BLE001 (the plugin fails in its _open)
            return name.upper()
        return name.upper()
    return None


def _iptc_file(w, h, pixels):
    def field(record, dataset, value):
        return bytes([0x1C, record, dataset]) + struct.pack(">H", len(value)) + value
    return (field(2, 0, b"\0\2") + field(3, 60, bytes([1, 0])) + field(3, 20, struct.pack(">H", w))
            + field(3, 30, struct.pack(">H", h)) + field(3, 120, b"\1")
            + field(8, 10, pixels))


def _new_fuzzed(case: int) -> bytes:
    """A file of one of NEW_KINDS with 1 to 3 of its header bytes replaced,
    1 case in 10 also cut short."""
    rng = np.random.default_rng(5000 + case)
    kind = NEW_KINDS[case % len(NEW_KINDS)]
    w, h = int(rng.integers(1, 13)), int(rng.integers(1, 9))
    px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "imt":
        data, head = b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + px[:, :, 0].tobytes(), 28
    elif kind == "spider":
        f = (px[:, :, 0].astype(np.float32) - 20) * 1.5
        data, head = pil_bytes(Image.fromarray(f, "F"), "SPIDER"), 108
    elif kind == "gbr":
        depth = int(rng.choice([1, 4]))
        body = px[:, :, 0].tobytes() if depth == 1 else np.dstack([px, px[:, :, :1]]).tobytes()
        data = struct.pack(">5I", 28, 2, w, h, depth) + b"GIMP" + struct.pack(">I", 1) + body
        head = 28
    elif kind == "iptc":
        data, head = _iptc_file(w, h, px[:, :, 0].tobytes()), 40
    elif kind == "cur":
        from tests.test_torch_ico import cur_file, dib_frame

        im = Image.fromarray(px).quantize(int(rng.integers(2, 30)))
        data, head = cur_file([(w, h, dib_frame(im))]), 62
    else:
        im = Image.fromarray(px)
        im = im.quantize(int(rng.integers(2, 30))) if rng.random() < 0.5 else im
        data, head = pil_bytes(im, "DIB"), 40
    data = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(0, min(head, len(data))))
        data[at] = int(rng.integers(0, 256)) if rng.random() < 0.6 else int(rng.choice(
            [0, 1, 2, 3, 4, 8, 10, 12, 0x1C, 0x20, 40, 0x0C, 0xFF, 0x80, 0x3F]))
    if rng.random() < 0.1:
        data = data[:int(rng.integers(0, len(data)))]
    return bytes(data)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_plugin_order_fuzz_of_the_new_readers(kind, tmp_path):
    """The port hands each fuzzed file of ``kind`` (every sixth case of
    NEW_FUZZ_CASES) to the plugin PIL does (or to none), and where that is
    one of its readers, reads exactly what PIL reads, with the same pixels
    and size."""
    path = tmp_path / "page"
    for case in range(NEW_KINDS.index(kind), NEW_FUZZ_CASES, len(NEW_KINDS)):
        data = _new_fuzzed(case)
        found = port_image.pil_plugin(data)
        assert (found[0] if found else None) == _pil_plugin(data), case
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = pil_rgb(data)
        if found is None or want is None:
            with pytest.raises(ValueError):
                port_image.decode_image(data, route="pil")
            continue
        got = port_image.decode_image(data, route="pil")
        assert got.shape == want[0].shape and np.array_equal(got, want[0]), case
        path.write_bytes(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert tuple(port_image.image_size(path)) == Image.open(path).size, case


def test_each_route_names_what_it_reads():
    """An unknown body is refused naming what the serve route reads (not
    the formats only PIL reads), an unknown file naming what the file
    route reads (not Radiance HDR), and a TGA body naming TGA."""
    with pytest.raises(ValueError) as body:
        port_image.decode_image(b"not an image at all", route="cv2")
    assert "serve route reads" in str(body.value) and "TGA" not in str(body.value)
    assert "Radiance HDR" in str(body.value)
    with pytest.raises(ValueError) as file:
        port_image.decode_image(b"not an image at all", route="pil")
    assert "file route reads" in str(file.value) and "Radiance" not in str(file.value)
    assert "TGA" in str(file.value)
    tga = tga_file(bytes(12), 2, 2, 2, 24)
    with pytest.raises(ValueError, match="^TGA: OpenCV cannot read it"):
        port_image.decode_image(tga, route="cv2")
