"""AVIF still images in Python and numpy, equal byte for byte to the two
decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``: Pillow 12.1's AVIF plugin on
libavif 1.3.0) and ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` for serve
bodies (``route="cv2"``: OpenCV 5.0 on libavif 1.4.2).

This module reads the HEIF container (ISO/IEC 23008-12 on the ISO base
media file format): ``ftyp``, then ``meta`` with its ``hdlr`` (``pict``),
``pitm``, ``iinf``/``infe`` (versions 2 and 3), ``iloc`` (versions 0-2,
file offsets and ``idat``, any number of extents), ``iprp`` (``ipco``
and ``ipma``, with the essential flags) and ``iref`` (``auxl``, ``prem``,
``dimg``, ``thmb``), and the properties ``ispe``, ``av1C``, ``pixi``,
``colr`` (``nclx``, ``prof``, ``rICC``), ``irot``, ``imir``, ``clap`` and
``auxC``. ``av1.py`` decodes the primary item's AV1 payload (and the
alpha item's, where the file route needs it) and ``yuv_rgb.py`` turns it
to RGB as each route's libavif does.

Both routes run libavif and read alike: a still image of 8 bits a
sample, its pixels unturned (neither applies ``irot``, ``imir`` or
``clap``, nor an EXIF orientation), an alpha item decoded and dropped,
after it un-premultiplies the colour where a ``prem`` reference says so
(limited-range alpha widened first), the matrix and range of ``colr``
``nclx`` where there is one. libavif walks the top-level boxes only to
``meta`` (``moov`` for ``avis``), checks every property box of ``ipco``
whether or not an item uses it, wants the ``avif`` or ``avis`` brand
(major or compatible), an ``ispe``, ``pixi`` depths equal to ``av1C``'s,
``clap``, ``irot``, ``imir``, ``a1op`` and ``lsel`` marked
essential and ``a1lx`` not, passes over an alpha item with an essential
property it does not know (and refuses such a primary item), and refuses
an image past 16384 x 16384 pixels in all or 32768 on a side; PIL also
refuses an image past its decompression-bomb limit.

The routes part where their libraries do: PIL's plugin takes a file by
its major brand alone (``avif``, ``avis``, ``mif1``, ``msf1``), OpenCV's
decoder one whose ``ftyp`` names ``avif`` or ``avis`` anywhere
(:func:`is_avif_body`); PIL's libavif decodes with dav1d and OpenCV's with
libaom, which check a damaged stream differently (``av1.decode_frame``'s
``strict``); libavif 1.4.2 (OpenCV's) refuses a ``pixi`` depth outside 1
to 16 and takes an alpha item without ``ispe``; OpenCV copies the Y plane
as gray, or refuses the file where it has alpha, when ``av1C`` says
monochrome, whatever the AV1 stream says.

Refused by name, on both routes, where libavif reads them: ``grid`` and
``iovl`` derived images, image sequences (``moov``), an ``ispe`` that
differs from the AV1 frame (libavif scales the frame to it), the identity
matrix outside full-range 4:4:4, AV1 of 10 or 12 bits, film grain,
superres and more than one frame (``av1_obu.py``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tdnet_torch.data import av1, plugins, yuv_rgb

__all__ = ["READS", "ROUTES", "BRANDS", "is_avif", "is_avif_body", "parse", "decode_avif",
           "avif_size"]

READS = "AVIF (8-bit still images)"
ROUTES = ("pil", "cv2")
BRANDS = (b"avif", b"avis", b"mif1", b"msf1")  # PIL's AvifImagePlugin._accept
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# properties this reader knows; an essential one outside these is refused
KNOWN_PROPERTIES = {b"ispe", b"av1C", b"pixi", b"colr", b"irot", b"imir", b"clap", b"auxC",
                    b"pasp", b"clli", b"mdcv", b"cclv", b"amve", b"a1op", b"lsel", b"a1lx",
                    b"rloc", b"udes"}
# libavif's default limits (avifDecoder imageSizeLimit, imageDimensionLimit)
SIZE_LIMIT = 16384 * 16384
DIMENSION_LIMIT = 32768


def is_avif(data: bytes) -> bool:
    """PIL's AVIF plugin takes the file: an ISO ``ftyp`` box whose major
    brand is one of :data:`BRANDS` (it then fails in the plugin where
    libavif cannot read it)."""
    return data[4:8] == b"ftyp" and data[8:12] in BRANDS


def _ftyp_brands(data: bytes) -> List[bytes]:
    """The major and compatible brands of a leading ``ftyp`` box."""
    if data[4:8] != b"ftyp" or len(data) < 16:
        return []
    size = min(int.from_bytes(data[:4], "big"), len(data))
    return [data[8:12]] + [data[i:i + 4] for i in range(16, size - 3, 4)]


def is_avif_body(data: bytes) -> bool:
    """OpenCV's AVIF decoder takes the body (libavif's
    ``avifPeekCompatibleFileType``): an ``ftyp`` box naming the ``avif``
    or ``avis`` brand, major or compatible."""
    return any(b in (b"avif", b"avis") for b in _ftyp_brands(data))


class Box:
    __slots__ = ("kind", "start", "end", "header")

    def __init__(self, kind, start, end, header):
        self.kind, self.start, self.end, self.header = kind, start, end, header


def _boxes(data: bytes, start: int, end: int, where: str) -> List[Box]:
    """The boxes of data[start:end]; a box that runs past its parent is
    refused."""
    out = []
    pos = start
    while pos < end:
        if end - pos < 8:
            raise ValueError(f"AVIF {where}: a box header runs past its parent")
        size, kind = struct.unpack_from(">I4s", data, pos)
        header = 8
        if size == 1:
            if end - pos < 16:
                raise ValueError(f"AVIF {where}: a box header runs past its parent")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if kind == b"uuid":
            header += 16
        if size < header or pos + size > end:
            raise ValueError(f"AVIF {where}: box {kind!r} of {size} bytes runs past its parent")
        out.append(Box(kind, pos, pos + size, header))
        pos += size
    return out


def _top_boxes(data: bytes) -> List[Box]:
    """libavif's walk of the file's top-level boxes: ``ftyp``, ``meta`` and
    ``moov`` must lie whole within the file, any other box is stepped over
    by its size unchecked, and the walk ends once it has seen ``ftyp`` and
    the box its brands need (``meta`` for ``avif``, ``moov`` for ``avis``)."""
    out: List[Box] = []
    pos = 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack_from(">I4s", data, pos)
        header = 8
        if size == 1:
            if pos + 16 > len(data):
                break
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = len(data) - pos
        if kind == b"uuid":
            header += 16
        if size < header:
            raise ValueError(f"AVIF file: box {kind!r} of {size} bytes")
        if kind in (b"ftyp", b"meta", b"moov") and pos + size > len(data):
            raise ValueError(f"AVIF file: box {kind!r} of {size} bytes runs past the file")
        out.append(Box(kind, pos, min(pos + size, len(data)), header))
        pos += size
        kinds = {b.kind for b in out}
        if b"ftyp" in kinds:
            brands = _ftyp_brands(data)
            if ((b"avif" not in brands or b"meta" in kinds)
                    and (b"avis" not in brands or b"moov" in kinds)):
                break
    if not out or out[0].kind != b"ftyp":
        raise ValueError("AVIF file without its ftyp box first")
    return out


class _Reader:
    """Big-endian fields of one box."""

    def __init__(self, data: bytes, start: int, end: int, what: str):
        self.data, self.pos, self.end, self.what = data, start, end, what

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise ValueError(f"AVIF {self.what} box is cut short")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self) -> Tuple[int, int]:
        v = self.uint(4)
        return v >> 24, v & 0xFFFFFF

    def cstring(self) -> bytes:
        stop = self.data.find(b"\0", self.pos, self.end)
        if stop < 0:
            raise ValueError(f"AVIF {self.what} box: a string without its end")
        out = self.data[self.pos:stop]
        self.pos = stop + 1
        return out


class Item:
    def __init__(self, item_id):
        self.id = item_id
        self.type = b""
        self.extents: List[Tuple[int, int]] = []
        self.method = 0
        self.properties: List[Tuple[int, bool]] = []  # (1-based index, essential)
        self.refs: Dict[bytes, List[int]] = {}
        self.unsupported: Optional[bytes] = None  # an essential property of no known kind

    @property
    def size(self) -> int:
        """The bytes of its extents (libavif passes over an item of none)."""
        return sum(n for _, n in self.extents)


class Container:
    """The parsed file: its items, properties and the primary item's."""

    def __init__(self):
        self.major = b""
        self.brands: List[bytes] = []
        self.items: Dict[int, Item] = {}
        self.properties: List[Tuple[bytes, bytes]] = []  # (kind, body)
        self.primary: Optional[int] = None
        self.idat = b""

    def props(self, item: Item) -> Dict[bytes, bytes]:
        out = {}
        for index, _ in item.properties:
            kind, body = self.properties[index - 1]
            out.setdefault(kind, body)
        return out

    def payload(self, data: bytes, item: Item) -> bytes:
        parts = []
        for offset, length in item.extents:
            if item.method == 1:
                src, lo = self.idat, offset
            else:
                src, lo = data, offset
            if length == 0:
                raise ValueError("AVIF item extent of no length")
            if lo < 0 or lo + length > len(src):
                raise ValueError("AVIF item data runs past the file")
            parts.append(src[lo:lo + length])
        return b"".join(parts)


def _parse_meta(data: bytes, box: Box, c: Container) -> None:
    r = _Reader(data, box.start + box.header, box.end, "meta")
    if r.full()[0]:
        raise ValueError("AVIF meta box of version other than 0")
    children = _boxes(data, r.pos, box.end, "meta")
    kinds = [b.kind for b in children]
    if b"hdlr" not in kinds:
        raise ValueError("AVIF meta box without hdlr")
    for b in children:
        body = _Reader(data, b.start + b.header, b.end, b.kind.decode("latin-1"))
        if b.kind == b"hdlr":
            if body.full()[0]:
                raise ValueError("AVIF hdlr box of version other than 0")
            if body.uint(4):
                raise ValueError("AVIF hdlr box with a non-zero pre_defined field")
            if body.take(4) != b"pict":
                raise ValueError("AVIF meta handler is not pict")
            body.take(12)
            body.cstring()
        elif b.kind == b"pitm":
            v, _ = body.full()
            c.primary = body.uint(2 if v == 0 else 4)
        elif b.kind == b"iinf":
            v, _ = body.full()
            count = body.uint(2 if v == 0 else 4)
            entries = _boxes(data, body.pos, b.end, "iinf")
            if len(entries) < count:
                raise ValueError("AVIF iinf holds fewer entries than it counts")
            for e in entries[:count]:
                if e.kind != b"infe":
                    raise ValueError(f"AVIF iinf holds a {e.kind!r} box")
                er = _Reader(data, e.start + e.header, e.end, "infe")
                ev, _ = er.full()
                if ev not in (2, 3):
                    raise ValueError(f"AVIF infe version {ev}")
                item_id = er.uint(2 if ev == 2 else 4)
                er.uint(2)
                item = c.items.setdefault(item_id, Item(item_id))
                item.type = er.take(4)
                er.cstring()  # item_name: libavif wants it terminated in the box
                if item.type == b"mime":
                    er.cstring()  # and a MIME item's content_type
        elif b.kind == b"iloc":
            v, _ = body.full()
            if v > 2:
                raise ValueError(f"AVIF iloc version {v}")
            sizes = body.uint(2)
            off_size, len_size, base_size = sizes >> 12, sizes >> 8 & 15, sizes >> 4 & 15
            index_size = sizes & 15 if v in (1, 2) else 0
            for n in (off_size, len_size, base_size, index_size):
                if n not in (0, 4, 8):
                    raise ValueError(f"AVIF iloc field of {n} bytes")
            count = body.uint(2 if v < 2 else 4)
            for _ in range(count):
                item_id = body.uint(2 if v < 2 else 4)
                item = c.items.setdefault(item_id, Item(item_id))
                if v in (1, 2):
                    item.method = body.uint(2) & 15
                    if item.method > 1:
                        raise ValueError(f"AVIF iloc construction method {item.method}")
                body.uint(2)
                base = body.uint(base_size)
                for _ in range(body.uint(2)):
                    body.uint(index_size)
                    item.extents.append((base + body.uint(off_size), body.uint(len_size)))
        elif b.kind == b"idat":
            c.idat = data[b.start + b.header:b.end]
        elif b.kind == b"iprp":
            for p in _boxes(data, b.start + b.header, b.end, "iprp"):
                if p.kind == b"ipco":
                    for prop in _boxes(data, p.start + p.header, p.end, "ipco"):
                        c.properties.append((prop.kind, data[prop.start + prop.header:prop.end]))
                elif p.kind == b"ipma":
                    pr = _Reader(data, p.start + p.header, p.end, "ipma")
                    pv, pflags = pr.full()
                    for _ in range(pr.uint(4)):
                        item_id = pr.uint(2 if pv < 1 else 4)
                        item = c.items.setdefault(item_id, Item(item_id))
                        for _ in range(pr.uint(1)):
                            if pflags & 1:
                                a = pr.uint(2)
                                item.properties.append((a & 0x7FFF, bool(a >> 15)))
                            else:
                                a = pr.uint(1)
                                item.properties.append((a & 0x7F, bool(a >> 7)))
        elif b.kind == b"iref":
            v, _ = body.full()
            if v > 1:  # libavif passes over an iref of a version it does not know
                continue
            for ref in _boxes(data, body.pos, b.end, "iref"):
                rr = _Reader(data, ref.start + ref.header, ref.end, "iref")
                w = 2 if v == 0 else 4
                src = rr.uint(w)
                targets = [rr.uint(w) for _ in range(rr.uint(2))]
                c.items.setdefault(src, Item(src)).refs.setdefault(ref.kind, []).extend(targets)


def parse(data: bytes, route: str = "pil") -> Container:
    """The container's boxes, refusing what neither route reads; ``route``
    says whose recognition the file must pass first."""
    if not (is_avif(data) if route == "pil" else is_avif_body(data)):
        raise ValueError(f"not an AVIF file; this reader takes {READS}")
    c = Container()
    top = _top_boxes(data)
    ftyp = top[0]
    r = _Reader(data, ftyp.start + ftyp.header, ftyp.end, "ftyp")
    c.major = r.take(4)
    r.uint(4)
    while r.pos + 4 <= r.end:
        c.brands.append(r.take(4))
    if not {c.major, *c.brands} & {b"avif", b"avis"}:
        raise ValueError("AVIF file type without the avif or avis brand")
    metas = [b for b in top if b.kind == b"meta"]
    if any(b.kind == b"moov" for b in top):
        raise ValueError("AVIF image sequence (moov): not read")
    if not metas:
        raise ValueError("AVIF file without a meta box")
    _parse_meta(data, metas[0], c)
    if c.primary is None or c.primary not in c.items:
        raise ValueError("AVIF file without its primary item")
    for item in c.items.values():
        # an association with property 0 means none: libavif skips it
        item.properties = [(i, e) for i, e in item.properties if i]
        for index, essential in item.properties:
            if index > len(c.properties):
                raise ValueError(f"AVIF ipma names property {index} of {len(c.properties)}")
    for kind, body in c.properties:
        _check_property(kind, body, route)
    _check_associations(c)
    for item in c.items.values():  # libavif 1.4.2 lets an alpha item go without
        if (item.type in (b"av01", b"grid", b"iovl") and item.size
                and b"ispe" not in c.props(item)
                and not (route == "cv2" and b"auxl" in item.refs
                         and _alpha_urn(c.props(item).get(b"auxC")))):
            raise ValueError(f"AVIF {item.type.decode()} item without ispe")
    return c


def _alpha_urn(auxc: Optional[bytes]) -> bool:
    return auxc is not None and auxc[4:].split(b"\0")[0] in ALPHA_URNS


def _alpha_item(c: Container, primary: Item) -> Optional[Item]:
    for item in c.items.values():
        if (primary.id in item.refs.get(b"auxl", []) and item.type == b"av01" and item.size
                and not item.unsupported and _alpha_urn(c.props(item).get(b"auxC"))):
            return item
    return None


def _check_property(kind: bytes, body: bytes, route: str) -> None:
    """What libavif checks of each property box of ``ipco`` as it parses
    the file, whether or not an item uses it: FullBox versions, the least
    sizes, ``pixi`` of 1 to 4 channels (of 1 to 16 bits in 1.4.2, OpenCV's),
    the ``av1C`` marker, ``nclx``'s reserved bits, ``auxC``'s string
    ended."""
    name = kind.decode("latin-1")
    if kind in (b"ispe", b"pixi", b"auxC") and (len(body) < 4 or body[0] != 0):
        raise ValueError(f"AVIF {name} box of version {body[0] if body else None}")
    least = {b"ispe": 12, b"pixi": 5, b"av1C": 4, b"colr": 4, b"irot": 1, b"imir": 1,
             b"clap": 32, b"pasp": 8, b"clli": 4, b"a1op": 1, b"lsel": 2,
             b"a1lx": 13 if body[:1] and body[0] & 1 else 7}.get(kind, 0)
    if len(body) < least:
        raise ValueError(f"AVIF {name} box of {len(body)} bytes")
    if kind == b"pixi":
        n = body[4]
        if not 1 <= n <= 4 or len(body) < 5 + n:
            raise ValueError(f"AVIF pixi box of {n} channels in {len(body)} bytes")
        if route == "cv2" and not all(1 <= d <= 16 for d in body[5:5 + n]):
            raise ValueError(f"AVIF pixi of {list(body[5:5 + n])} bits")
    elif kind == b"av1C" and body[0] != 0x81:
        raise ValueError(f"AVIF av1C of marker and version 0x{body[:1].hex()}")
    elif kind == b"colr" and body[:4] == b"nclx" and (len(body) < 11 or body[10] & 0x7F):
        raise ValueError("AVIF colr nclx box cut short or with its reserved bits set")
    elif kind == b"auxC" and b"\0" not in body[4:]:
        raise ValueError("AVIF auxC box with its type unended")


def _check_associations(c: Container) -> None:
    """libavif's rules for every item's properties: the transformative ones
    and ``a1op`` and ``lsel`` marked essential, ``a1lx`` not; an item with
    an essential property of no kind libavif knows is unsupported (an alpha
    item so is passed over, a primary one refused)."""
    for item in c.items.values():
        for index, essential in item.properties:
            kind = c.properties[index - 1][0]
            if essential and kind not in KNOWN_PROPERTIES:
                item.unsupported = kind
            if not essential and kind in (b"clap", b"irot", b"imir", b"a1op", b"lsel"):
                raise ValueError(f"AVIF property {kind!r} not marked essential")
            if essential and kind == b"a1lx":
                raise ValueError("AVIF a1lx property marked essential")


def _check_item(item: Item, what: str) -> None:
    if item.type in (b"grid", b"iovl"):
        raise ValueError(f"AVIF {item.type.decode()} derived image ({what}): not read")
    if item.type != b"av01":
        raise ValueError(f"AVIF {what} item of type {item.type!r}: not an AV1 image")
    if item.unsupported:
        raise ValueError(f"AVIF essential property {item.unsupported!r} of no known kind")


def _image(data: bytes, c: Container, item: Item, what: str, route: str):
    """The decoded planes of an AV1 image item and its properties, as the
    route's AV1 decoder checks the stream (PIL's libavif runs dav1d,
    OpenCV's libaom). libavif 1.4.2 (OpenCV's) takes an alpha item without
    ``ispe``."""
    _check_item(item, what)
    props = c.props(item)
    if b"av1C" not in props:
        raise ValueError(f"AVIF {what} item without av1C")
    size = _ispe(props, what, optional=what == "alpha" and route == "cv2")
    pixi = props.get(b"pixi")
    # libavif's avifCodecConfigurationBoxGetDepth: twelve_bit first, then high_bitdepth
    av1c_depth = 12 if props[b"av1C"][2] & 0x20 else 10 if props[b"av1C"][2] & 0x40 else 8
    if pixi is not None and set(pixi[5:5 + pixi[4]]) - {av1c_depth}:
        raise ValueError(f"AVIF pixi of {list(pixi[5:5 + pixi[4]])} bits against av1C's "
                         f"{av1c_depth}")
    frame = av1.decode_frame(c.payload(data, item), strict=route == "cv2")
    if size is not None and (frame.width, frame.height) != size:
        raise ValueError(f"AVIF {what}: ispe {size[0]}x{size[1]} differs from the AV1 frame's "
                         f"{frame.width}x{frame.height} (libavif scales it): not read")
    return frame, props


def _ispe(props: Dict[bytes, bytes], what: str, optional: bool = False):
    """(width, height) of an item's ``ispe``, within libavif's limits."""
    ispe = props.get(b"ispe")
    if ispe is None:
        if optional:
            return None
        raise ValueError(f"AVIF {what} item without ispe")
    width, height = struct.unpack_from(">II", ispe, 4)
    if width == 0 or height == 0:
        raise ValueError(f"AVIF {what} item of {width}x{height} pixels")
    if width * height > SIZE_LIMIT or max(width, height) > DIMENSION_LIMIT:
        raise ValueError(f"AVIF of {width}x{height} pixels: past libavif's size limits")
    return width, height


def _size(data: bytes) -> Tuple[int, int]:
    c = parse(data)
    item = c.items[c.primary]
    _check_item(item, "primary")
    return _ispe(c.props(item), "primary")


def decode_avif(data: bytes, route: str = "pil") -> np.ndarray:
    """An AVIF file -> (H, W, 3) uint8 RGB, as ``route``'s reference
    decodes it (see the module docstring)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    reader = "PIL" if route == "pil" else "OpenCV"
    try:
        c = parse(data, route)
        primary = c.items[c.primary]
        if route == "pil":
            w, h = _size(data)
            plugins.check_bomb(w, h, "AVIF")
        frame, props = _image(data, c, primary, "primary", route)
        alpha_item = _alpha_item(c, primary)
        alpha = None
        if alpha_item is not None:
            alpha, _ = _image(data, c, alpha_item, "alpha", route)
            if (alpha.width, alpha.height) != (frame.width, frame.height):
                raise ValueError("AVIF alpha of another size than its image")
        if route == "cv2" and props[b"av1C"][2] & 0x10:  # OpenCV's gray image: by av1C
            if alpha is not None:
                raise ValueError("AVIF 4:0:0 with alpha (OpenCV's CopyToMat wants 4 channels)")
            return np.repeat(frame.planes[0][:, :, None], 3, 2)
        rgb = yuv_rgb.to_rgb(frame, props.get(b"colr"), alpha is not None)
        if alpha is not None and alpha_item.id in primary.refs.get(b"prem", []):
            a = alpha.planes[0]
            if not alpha.full_range:  # libavif widens it: avifLimitedToFullY
                a = np.clip((np.maximum(a.astype(np.int64) - 16, 0) * 255 + 109) // 219, 0, 255)
            rgb = yuv_rgb.unpremultiply(rgb, a)
        return rgb
    except ValueError as e:
        if "not read" in str(e):  # the reference reads it: a limit of this reader
            raise ValueError(f"{e} (the {reader} route)") from None
        raise ValueError(f"{e}: {reader} refuses it") from None


def avif_size(data: bytes) -> Tuple[int, int]:
    """PIL's ``.size`` of an AVIF file: the primary item's ``ispe``."""
    try:
        w, h = _size(data)
    except ValueError as e:
        raise ValueError(f"{e}: PIL refuses it") from None
    plugins.check_bomb(w, h, "AVIF")
    return w, h
