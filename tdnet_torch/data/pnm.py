"""Netpbm (PNM) decoding in Python and numpy, equal byte for byte to the
two decoders the reference reads pages with: PIL's ``Image.open(path).
convert("RGB")`` for files (``route="pil"``, ``PpmImagePlugin``) and
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` for serve bodies (``route="cv2"``,
OpenCV's ``grfmt_pxm.cpp`` and ``grfmt_pam.cpp``).

Reads P1 to P6 (bitmap, graymap and pixmap, ASCII and binary), maxval 1
to 65535 at one or two bytes a sample, with comments wherever each
route's header parser takes them, P7 (PAM) on the cv2 route, PFM (``Pf``
gray on the pil route, ``PF`` colour on the cv2 route) and PIL's own
``P0CMYK``, ``PyP``, ``PyRGBA`` and ``PyCMYK`` on the pil route. Each
route parses the header by its own rules and scales samples by its own:

- PIL scales by maxval: ``round(v / maxval * 255)`` (Python's rounding,
  half to even) where maxval is not 255; gray above 255 becomes 32-bit
  ``I`` (``round(v / maxval * 65535)``, or the samples as they are at
  65535), which ``convert("RGB")`` clips to 255. An ASCII sample above
  maxval, a negative one or a P1 character other than 0 and 1 raises.
- cv2 keeps binary samples as they are (a maxval below 255 is not
  scaled) and takes the high byte of two-byte ones; ASCII samples are
  clamped to maxval and scaled ``v * 255 // maxval`` (the high byte above
  255); a P1 digit other than 0 is black. Its number reader needs a byte
  after the last ASCII sample, and raises on any other character than
  digits, whitespace and comments between them.
- PAM: PIL cannot identify it, and the port's pil route raises. cv2
  takes ``TUPLTYPE`` BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB and
  RGB_ALPHA (or guesses from ``DEPTH`` 1 or 3 and a maxval below 256), and
  converts as ``grfmt_pam.cpp`` does, its faults kept: three samples are
  copied in the file's order into its BGR output (so red and blue trade
  places), and maxval 1 reads the first ``width / 8`` bytes of each row
  as bits (1 white). The alpha formats raise on the cv2 route: OpenCV
  converts only the first ``width / depth`` pixels of each row and leaves
  the rest of its output as the memory held it.

- PFM: PIL identifies ``Pf`` only (``PF`` it cannot): a scale that is
  finite and not 0 (its sign the byte order), float rows bottom-up, then
  F -> L -> RGB, each value cut toward zero into 0..255 (NaN 0). cv2 reads
  both as :func:`_cv2_pfm` sets out, and returns ``Pf`` as one channel,
  which this route refuses.
- PIL's own magics (cv2 reads none): binary samples, scaled by maxval
  where it is not 255; CMYK through PIL's ``cmyk2rgb``, RGBA without its
  alpha, ``PyP`` black (its index image has no palette).

A file that ends before its samples do raises on both routes, as both
references fail on one.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

__all__ = ["SIGNATURES", "READS", "ROUTES", "decode_pnm", "pnm_size"]

SIGNATURES = tuple(b"P%d" % i for i in range(1, 8)) + (b"Pf", b"PF", b"P0", b"Py")
READS = ("PNM (P1-P6, ASCII and binary, maxval up to 65535; PAM (P7) by the cv2 route; "
         "PFM (Pf by both routes, PF by the cv2 route); PIL's P0CMYK, PyP, PyRGBA and "
         "PyCMYK by the pil route)")
ROUTES = ("pil", "cv2")

_WS = b" \t\n\x0b\x0c\r"
_INT_MAX = 2 ** 31 - 1
_BANDS = {b"P1": 1, b"P2": 1, b"P3": 3, b"P4": 1, b"P5": 1, b"P6": 3}
# PIL's own magics: the samples a pixel of each, binary only
_PIL_EXTENSIONS = {b"P0CMYK": 4, b"PyCMYK": 4, b"PyRGBA": 4, b"PyP": 1}
_FLOAT_RE = re.compile(rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)",
                       re.IGNORECASE)
_INT_RE = re.compile(rb"[+-]?\d+")
_CV2_MAX_SIDE, _CV2_MAX_PIXELS = 1 << 20, 1 << 30
_PIL_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")
# cv2's ReadNumber: whitespace and comments (to the end of their line),
# then digits; one byte after them is consumed
_CV2_NUMBER = re.compile(rb"(?:[ \t\n\x0b\x0c\r]+|#[^\n\r]*[\n\r])*(\d+)")
_CV2_DIGIT = re.compile(rb"(?:[ \t\n\x0b\x0c\r]+|#[^\n\r]*[\n\r])*(\d)")


# --- PIL (PpmImagePlugin)


def _pil_token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """``PpmImageFile._read_token``: whitespace before it skipped, a
    comment anywhere in it skipped to its line's end, at most 10 bytes."""
    token = b""
    while len(token) <= 10:
        c = data[pos:pos + 1]
        if not c:
            break
        pos += 1
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while True:
                c = data[pos:pos + 1]
                pos += len(c)
                if c in (b"", b"\r", b"\n"):
                    break
            continue
        token += c
    if not token:
        raise ValueError("PNM header ends early: PIL reached EOF while reading it")
    if len(token) > 10:
        raise ValueError("PNM header token longer than PIL's 10 bytes")
    return token, pos


def _pil_header(data: bytes):
    """(magic, width, height, maxval, data offset) as PIL reads them."""
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        if not c:
            break
        pos += 1
        if c in _WS:
            break
        magic += c
    if magic == b"P7":
        raise ValueError("PAM (P7): PIL cannot identify it, so the pil route does not read it")
    if magic not in _BANDS and magic not in _PIL_EXTENSIONS and magic != b"Pf":
        raise ValueError(f"PNM magic {magic!r} is not read by PIL")
    numbers = []
    for _ in range(2 if magic in (b"P1", b"P4") else 3):
        token, pos = _pil_token(data, pos)
        try:
            numbers.append(float(token) if magic == b"Pf" and len(numbers) == 2 else int(token))
        except ValueError:
            raise ValueError(f"PNM header token {token!r} is not a number") from None
    width, height = numbers[:2]
    if width <= 0 or height <= 0:
        raise ValueError(f"bad PNM size {width}x{height}: PIL does not identify the file")
    maxval = numbers[2] if len(numbers) == 3 else 1
    if magic == b"Pf":
        if maxval == 0 or not np.isfinite(maxval):
            raise ValueError(f"PFM scale {maxval}: PIL wants it finite and non-zero")
    elif not 0 < maxval < 65536:
        raise ValueError(f"PNM maxval {maxval}: PIL takes 1 to 65535")
    return magic, width, height, maxval, pos


def _pil_ascii(body: bytes, n: int, maxval: int, top: int) -> np.ndarray:
    """``PpmPlainDecoder._decode_blocks``: comments removed (a comment ends
    at its line's end, which goes with it), tokens split at whitespace, the
    first n each 0..maxval, scaled to 0..top."""
    tokens = _PIL_COMMENT.sub(b"", body).split()[:n]
    if len(tokens) < n:
        raise ValueError("PNM ASCII data ends early: PIL gets not enough image data")
    long = [t for t in tokens if len(t) > 10]
    if long:
        raise ValueError(f"PNM ASCII token {long[0][:11]!r} longer than PIL's 10 bytes")
    try:
        values = np.array([int(t) for t in tokens], np.int64)
    except ValueError as e:
        raise ValueError(f"PNM ASCII sample that is not a number: {e}") from None
    if values.min() < 0 or values.max() > maxval:
        raise ValueError(f"PNM ASCII sample outside 0..{maxval}: PIL refuses it")
    return np.round(values / maxval * top).astype(np.int64)


def _pil_float(body: bytes, w: int, h: int, scale: float) -> np.ndarray:
    """PIL's ``Pf``: mode F, float32 rows bottom-up (little-endian where the
    scale is negative, whose size is ignored), then F -> L ->
    RGB: each value cut toward zero and clipped to 0..255, NaN 0."""
    if len(body) < 4 * w * h:
        raise ValueError("PFM data ends early: image file is truncated")
    values = np.frombuffer(body, "<f4" if scale < 0 else ">f4", w * h).reshape(h, w)[::-1]
    with np.errstate(invalid="ignore"):
        gray = np.where(values <= 0, 0, np.where(values >= 255, 255,
                                                 np.nan_to_num(values, nan=0.0)))
    return _gray_rgb(gray.astype(np.uint8))


def _pil_extension(magic: bytes, body: bytes, w: int, h: int, maxval: int) -> np.ndarray:
    """PIL's own magics: binary samples, raw at maxval 255, else scaled as
    ``PpmDecoder`` does (``min(255, round(v / maxval * 255))``); then CMYK
    through PIL's ``cmyk2rgb``, RGBA without its alpha, and P (no palette
    is read) black."""
    bands = _PIL_EXTENSIONS[magic]
    size = 1 if maxval < 256 else 2
    n = w * h * bands
    if len(body) < n * size:
        raise ValueError(f"{magic.decode()} data ends early: PIL gets not enough image data")
    values = np.frombuffer(body, ">u2" if size == 2 else np.uint8, n).astype(np.int64)
    if maxval != 255:
        values = np.minimum(255, np.round(values / maxval * 255)).astype(np.int64)
    px = values.reshape(h, w, bands)
    if magic == b"PyP":
        return np.zeros((h, w, 3), np.uint8)
    if magic == b"PyRGBA":
        return px[:, :, :3].astype(np.uint8)
    nk = 255 - px[:, :, 3:]
    t = px[:, :, :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _pil_decode(data: bytes) -> np.ndarray:
    magic, w, h, maxval, pos = _pil_header(data)
    if magic == b"Pf":
        return _pil_float(data[pos:], w, h, maxval)
    if magic in _PIL_EXTENSIONS:
        return _pil_extension(magic, data[pos:], w, h, maxval)
    bands, body = _BANDS[magic], data[pos:]
    n = w * h * bands
    if magic == b"P1":
        chars = b"".join(_PIL_COMMENT.sub(b"", body).split())
        if chars.translate(None, b"01"):
            raise ValueError("PNM P1 data holds a character other than 0 and 1: PIL refuses it")
        if len(chars) < n:
            raise ValueError("PNM P1 data ends early: PIL gets not enough image data")
        bits = np.frombuffer(chars, np.uint8, n) - ord("0")
        return _gray_rgb(((1 - bits) * 255).reshape(h, w))
    if magic == b"P4":
        pitch = -(-w // 8)
        if len(body) < pitch * h:
            raise ValueError("PNM P4 data ends early: image file is truncated")
        rows = np.frombuffer(body, np.uint8, pitch * h).reshape(h, pitch)
        return _gray_rgb((1 - np.unpackbits(rows, axis=1)[:, :w]) * 255)
    # gray above maxval 255 is PIL's mode I (0..65535), which convert("RGB") clips
    top = 65535 if bands == 1 and maxval > 255 else 255
    if magic in (b"P2", b"P3"):
        values = _pil_ascii(body, n, maxval, top)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < n * size:
            raise ValueError("PNM binary data ends early: PIL gets not enough image data "
                             "(image file is truncated)")
        values = np.frombuffer(body, ">u2" if size == 2 else np.uint8, n).astype(np.int64)
        if maxval not in (255, 65535) or (maxval == 65535 and bands == 3):
            values = np.minimum(top, np.round(values / maxval * top)).astype(np.int64)
    values = np.minimum(values, 255).astype(np.uint8).reshape(h, w, bands)
    return values if bands == 3 else _gray_rgb(values[:, :, 0])


# --- cv2 (grfmt_pxm.cpp)


def _cv2_numbers(data: bytes, pos: int, n: int, one_digit: bool = False):
    """n numbers by OpenCV's ``ReadNumber`` from ``pos`` -> (values, the
    position after them). A number ends at the first byte that is not a
    digit, which is consumed (and must exist); one digit a number for
    P1 (whose end is not needed: None)."""
    body = data[pos:]
    if b"#" not in body:  # the common case: whitespace-separated tokens
        if one_digit:
            chars = b"".join(body.split())
            if len(chars) >= n and chars[:n].isdigit():
                return np.frombuffer(chars, np.uint8, n).astype(np.int64) - ord("0"), None
        tokens = body.split(maxsplit=n)
        if len(tokens) > n or (len(tokens) == n and not body[-1:].isdigit()):
            head = tokens[:n]
            if all(t.isdigit() for t in head):
                values = np.array([int(t) for t in head], np.int64)
                if values.size and values.max() > _INT_MAX:
                    raise ValueError("PNM number too large for OpenCV's reader")
                end = len(body) - len(tokens[n]) if len(tokens) > n else len(body)
                return values, pos + _after_last(body, end)
    pattern = _CV2_DIGIT if one_digit else _CV2_NUMBER
    values = []
    for _ in range(n):
        m = pattern.match(data, pos)
        if m is None:
            what = "ends" if pattern.match(data + b"0", pos) else "has a byte that is not a number"
            raise ValueError(f"PNM data {what} where OpenCV's reader wants a number")
        value = int(m.group(1))
        if value > _INT_MAX:
            raise ValueError("PNM number too large for OpenCV's reader")
        pos = m.end() + (0 if one_digit else 1)
        if pos > len(data):
            raise ValueError("PNM data ends right after its last number: OpenCV's reader "
                             "wants a byte after it")
        values.append(value)
    return np.array(values, np.int64), pos


def _after_last(body: bytes, end: int) -> int:
    """The offset past the byte that ends the last number before ``end``
    (its whitespace run starts right after the number)."""
    stripped = body[:end].rstrip(_WS)
    if len(stripped) == len(body):
        raise ValueError("PNM data ends right after its last number: OpenCV's reader "
                         "wants a byte after it")
    return len(stripped) + 1


def _cv2_header(data: bytes):
    """(magic, width, height, maxval, data offset) as OpenCV reads them."""
    if len(data) < 3 or data[2:3] not in tuple(bytes([c]) for c in _WS):
        raise ValueError("PNM magic not followed by whitespace: OpenCV does not take it")
    magic = data[:2]
    count = 2 if magic in (b"P1", b"P4") else 3
    numbers, pos = _cv2_numbers(data, 2, count)
    width, height = int(numbers[0]), int(numbers[1])
    maxval = int(numbers[2]) if count == 3 else 1
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError(f"PNM size {width}x{height}, maxval {maxval}: OpenCV refuses the header")
    return magic, width, height, maxval, pos


def _cv2_token(data: bytes, pos: int):
    """OpenCV's PFM ``read_number`` token: the bytes up to a whitespace
    byte (consumed), each below 0x80, the data not ending first."""
    end = pos
    while True:
        if end >= len(data):
            raise ValueError("PFM header ends early: OpenCV fails on it")
        c = data[end]
        if c >= 0x80:
            raise ValueError("PFM header byte past 0x7f: OpenCV fails on it")
        if c in _WS:
            return data[pos:end], end + 1
        end += 1


def _cv2_pfm(data: bytes) -> np.ndarray:
    """cv2's PFM: ``Pf`` or ``PF``, a line break, then width and height
    (``std::stoi`` of each token: a leading integer) and scale
    (a leading float, inf and nan too; past the double range inf, below it
    0). Rows bottom-up,
    little-endian where the scale is negative (or nan); each sample times
    ``float(1 / |scale|)`` in float32, then rounded half to even into
    0..255 (2**31 and past, and NaN, become 0, as cvRound overflows). A
    ``Pf`` page comes out of ``imdecode`` as one channel, not the (H, W,
    3) page this route returns, so it is refused."""
    if data[2:3] != b"\n":
        raise ValueError("PFM magic not followed by a line break: OpenCV refuses the header")
    numbers, pos = [], 3
    for i in range(3):
        token, pos = _cv2_token(data, pos)
        m = (_FLOAT_RE if i == 2 else _INT_RE).match(token)
        if m is None:
            raise ValueError(f"PFM header token {token!r}: OpenCV's reader throws")
        numbers.append(float(m.group()) if i == 2 else int(m.group()))
    w, h, scale = numbers
    if not (-2 ** 31 <= w < 2 ** 31 and -2 ** 31 <= h < 2 ** 31):
        raise ValueError("PFM size out of int range: OpenCV's reader throws")
    if w <= 0 or h <= 0 or max(w, h) > _CV2_MAX_SIDE or w * h > _CV2_MAX_PIXELS:
        raise ValueError(f"PFM size {w}x{h}: cv2 refuses it")
    if data[1:2] == b"f":
        raise ValueError("gray PFM (Pf): cv2.imdecode(IMREAD_COLOR) returns one channel, not "
                         "an (H, W, 3) page")
    if not abs(scale) > 0:
        raise ValueError(f"PFM scale {scale}: OpenCV asserts it non-zero")
    n = w * h * 3
    if len(data) < pos + 4 * n:
        raise ValueError("PFM data ends early: OpenCV fails on it")
    little = not scale >= 0
    values = np.frombuffer(data, "<f4" if little else ">f4", n, pos).reshape(h, w, 3)[::-1]
    with np.errstate(invalid="ignore"):  # inf or nan samples
        scaled = values.astype(np.float32) * np.float32(1.0 / abs(scale))
        fits = np.abs(scaled) < 2.0 ** 31
        rounded = np.where(fits, np.rint(np.where(fits, scaled, 0)), 0)
    return np.clip(rounded, 0, 255).astype(np.uint8)


def _cv2_decode(data: bytes) -> np.ndarray:
    if data[:2] == b"P7":
        return _pam(data)
    if data[:2] in (b"Pf", b"PF"):
        return _cv2_pfm(data)
    if data[:2] not in _BANDS:
        raise ValueError(f"PNM magic {data[:2]!r}: cv2 does not read it")
    magic, w, h, maxval, pos = _cv2_header(data)
    bands = _BANDS[magic]
    n = w * h * bands
    if magic == b"P1":
        values, _ = _cv2_numbers(data, pos, w * h, one_digit=True)
        return _gray_rgb(np.where(values != 0, 0, 255).astype(np.uint8).reshape(h, w))
    if magic == b"P4":
        pitch = -(-w // 8)
        if len(data) < pos + pitch * h:
            raise ValueError("PNM P4 data ends early: OpenCV fails on it")
        rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
        return _gray_rgb((1 - np.unpackbits(rows, axis=1)[:, :w]) * 255)
    if magic in (b"P2", b"P3"):
        values, _ = _cv2_numbers(data, pos, n)
        values = np.minimum(values, maxval)
        values = values >> 8 if maxval > 255 else values * 255 // maxval
    else:
        size = 1 if maxval < 256 else 2
        if len(data) < pos + n * size:
            raise ValueError("PNM binary data ends early: OpenCV fails on it")
        values = np.frombuffer(data, ">u2" if size == 2 else np.uint8, n, pos)
        values = values >> 8 if size == 2 else values
    values = values.astype(np.uint8).reshape(h, w, bands)
    return values if bands == 3 else _gray_rgb(values[:, :, 0])


# --- PAM (grfmt_pam.cpp), cv2 only

_PAM_KEYS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_PAM_FORMATS = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
                b"RGB_ALPHA": 4}


def _pam_header(data: bytes):
    """``PAMDecoder::readHeader``: lines of KEY value (keys in capitals,
    once each but TUPLTYPE), comments and blank lines skipped, up to
    ``ENDHDR`` and the one line break after it."""
    if data[:2] != b"P7" or data[2:3] not in (b"\n", b"\r"):
        raise ValueError("PAM without a line break after P7: OpenCV does not take it")
    pos, fields, tupltype = 3, {}, None
    while True:
        while pos < len(data) and data[pos] in _WS:
            pos += 1
        if pos >= len(data):
            raise ValueError("PAM header ends before ENDHDR")
        if data[pos:pos + 1] == b"#":
            ends = [i for i in (data.find(b"\n", pos), data.find(b"\r", pos)) if i >= 0]
            if not ends:
                raise ValueError("PAM header ends in a comment")
            pos = min(ends) + 1
            continue
        m = re.compile(rb"([^ \t\n\x0b\x0c\r]{1,8})([ \t\n\x0b\x0c\r]?)").match(data, pos)
        key = m.group(1)
        if key not in _PAM_KEYS:
            raise ValueError(f"PAM header field {key!r}: OpenCV does not take it")
        if key == b"ENDHDR":
            if m.group(2) not in (b"\n", b"\r"):
                raise ValueError("PAM ENDHDR not followed by a line break: OpenCV refuses it")
            pos = m.end()
            break
        line = re.compile(rb"[ \t\x0b\x0c]*([^\n\r]*)[\n\r]").match(data, m.end())
        if line is None:
            raise ValueError("PAM header ends in a field")
        value, pos = line.group(1).rstrip(_WS), line.end()
        if key == b"TUPLTYPE":
            if value not in _PAM_FORMATS:
                raise ValueError(f"PAM TUPLTYPE {value!r}: OpenCV takes "
                                 f"{', '.join(t.decode() for t in _PAM_FORMATS)}")
            tupltype = value
            continue
        if key in fields or not value.isdigit():
            raise ValueError(f"PAM {key.decode()} {value!r}: OpenCV refuses it")
        fields[key] = int(value)
        if key == b"MAXVAL" and fields[key] == 1:
            tupltype = b"BLACKANDWHITE"
    if len(fields) != 4:
        raise ValueError("PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL")
    w, h, depth, maxval = (fields[k] for k in _PAM_KEYS[:4])
    if maxval > 65535 or not 1 <= depth <= 4 or w <= 0 or h <= 0:
        raise ValueError(f"PAM {w}x{h}, depth {depth}, maxval {maxval}: OpenCV refuses it")
    if tupltype is None:
        if depth in (1, 3) and maxval < 256:
            tupltype = b"GRAYSCALE" if depth == 1 else b"RGB"
        else:
            raise ValueError(f"PAM of depth {depth}, maxval {maxval} without TUPLTYPE: OpenCV "
                             "cannot tell its format")
    if _PAM_FORMATS[tupltype] != depth:
        raise ValueError(f"PAM TUPLTYPE {tupltype.decode()} at depth {depth}: OpenCV refuses it")
    if maxval == 1 and depth != 1:
        raise ValueError(f"PAM of depth {depth} at maxval 1 is not read")
    if depth in (2, 4):
        raise ValueError(f"PAM {tupltype.decode()}: OpenCV fills the first width / {depth} "
                         "pixels of each row and leaves the rest of its output uninitialized")
    return w, h, depth, maxval, tupltype, pos


def _pam(data: bytes) -> np.ndarray:
    w, h, depth, maxval, tupltype, pos = _pam_header(data)
    size = 2 if maxval > 255 else 1
    n = w * h * depth
    if len(data) < pos + n * size:
        raise ValueError("PAM data ends early: OpenCV fails on it")
    rows = np.frombuffer(data, ">u2" if size == 2 else np.uint8, n, pos).reshape(h, w * depth)
    rows = (rows >> 8 if size == 2 else rows).astype(np.uint8)
    if maxval == 1:  # black and white: the row's first bytes as bits, 1 white
        bits = np.unpackbits(rows[:, :-(-w // 8)], axis=1)[:, :w]
        return _gray_rgb(bits * 255)
    if depth == 3:  # copied in the file's order into BGR
        return np.ascontiguousarray(rows.reshape(h, w, 3)[:, :, ::-1])
    return _gray_rgb(rows)


def _gray_rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray.astype(np.uint8)[:, :, None], 3, axis=2)


def decode_pnm(data: bytes, route: str = "pil") -> np.ndarray:
    """PNM bytes -> (H, W, 3) uint8 RGB, equal to PIL's ``convert("RGB")``
    (``route="pil"``) or to ``cv2.imdecode(..., IMREAD_COLOR)`` with its
    channels flipped (``route="cv2"``)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    data = bytes(data)
    if data[:2] not in SIGNATURES:
        raise ValueError(f"not a PNM file; this reader takes {READS}")
    return _pil_decode(data) if route == "pil" else _cv2_decode(data)


def pnm_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the header, as PIL's ``.size`` reads it (PIL
    does not identify PAM, so a P7 file raises)."""
    _, width, height, _, _ = _pil_header(bytes(data))
    return width, height
