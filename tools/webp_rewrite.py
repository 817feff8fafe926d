"""Rewrite a lossy WebP's VP8 bitstream with other loop-filter settings and
token partitions: the paths of libwebp's decoder that real ``cwebp`` files
take and Pillow's encoder cannot reach (the simple filter, sharpness, the
loop-filter deltas, 2, 4 or 8 token partitions).

The file's syntax is read with the port's boolean decoder
(``tdnet_torch/data/vp8.py``), each decision kept as (bit, probability),
and written back with libwebp's boolean encoder (``VP8PutBit`` and
``VP8BitWriterFinish``): the filter header is written anew, the token
decisions of macroblock row r go to partition r mod N, and everything else
is copied decision for decision, so a rewrite that changes nothing gives
the original bytes. The pixels a rewrite decodes to are libwebp's to say:
the tests hold the port against PIL and cv2 on them.

    python tools/webp_rewrite.py in.webp out.webp --simple --partitions 4
"""

import argparse
import contextlib
import os
import struct
import sys
from typing import List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from tdnet_torch.data import vp8  # noqa: E402

Decision = Tuple[int, int]  # (bit, probability)


_Bool = vp8._Bool


class _Recording(_Bool):
    """The port's boolean decoder, keeping each decision; reading ``get``
    starts a new row's list (the token parser reads it once a row)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.rows: List[List[Decision]] = []

    def __getattribute__(self, name):
        if name == "get":
            object.__getattribute__(self, "rows").append([])
        return object.__getattribute__(self, name)

    def get(self, prob: int) -> int:
        bit = _Bool.get(self, prob)
        self.rows[-1].append((bit, prob))
        return bit

    def sign(self, v: int) -> int:  # an even split: the encoder's uniform bit
        out = _Bool.sign(self, v)
        self.rows[-1].append((int(out < 0), 0x80))
        return out


@contextlib.contextmanager
def _recording():
    vp8._Bool = _Recording
    try:
        yield
    finally:
        vp8._Bool = _Bool


class BoolEncoder:
    """libwebp's ``VP8BitWriter``: ``range`` the range less 1, carries
    propagated over pending 0xff bytes."""

    _NORM = [7 - (r + 1).bit_length() + 1 for r in range(127)]

    def __init__(self):
        self.range, self.value, self.run, self.nb_bits = 254, 0, 0, -8
        self.buf = bytearray()

    def _flush(self):
        s = 8 + self.nb_bits
        bits = self.value >> s
        self.value -= bits << s
        self.nb_bits -= 8
        if bits & 0xFF != 0xFF:
            if bits & 0x100 and self.buf:
                self.buf[-1] = (self.buf[-1] + 1) & 0xFF
            if self.run:
                self.buf += bytes([0x00 if bits & 0x100 else 0xFF]) * self.run
                self.run = 0
            self.buf.append(bits & 0xFF)
        else:
            self.run += 1

    def put(self, bit: int, prob: int) -> None:
        split = (self.range * prob) >> 8
        if bit:
            self.value += split + 1
            self.range -= split + 1
        else:
            self.range = split
        if self.range < 127:
            shift = self._NORM[self.range]
            self.range = ((self.range + 1) << shift) - 1
            self.value <<= shift
            self.nb_bits += shift
            if self.nb_bits > 0:
                self._flush()

    def put_bits(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((value >> k) & 1, 0x80)

    def finish(self) -> bytes:
        self.put_bits(0, 9 - self.nb_bits)
        self.nb_bits = 0
        self._flush()
        return bytes(self.buf)


def _walk_segment_header(d: Sequence[Decision], i: int) -> int:
    """The index after the segment header that starts at d[i]."""
    def bits(n):
        nonlocal i
        i += n
    def flag():
        nonlocal i
        i += 1
        return d[i - 1][0]
    if flag():  # use_segment
        update_map = flag()
        if flag():  # update_data
            bits(1)
            for n in (7,) * 4 + (6,) * 4:
                if flag():
                    bits(n + 1)
        if update_map:
            for _ in range(3):
                if flag():
                    bits(8)
    return i


def _filter_header(simple: int, level: int, sharpness: int,
                   deltas: Optional[Sequence[int]]) -> List[Decision]:
    """The filter header's decisions; ``deltas`` the 4 reference-frame and
    4 mode deltas (None: none), each a flag and a signed 6-bit value."""
    out: List[Decision] = [(simple, 0x80)]
    out += [((level >> k) & 1, 0x80) for k in range(5, -1, -1)]
    out += [((sharpness >> k) & 1, 0x80) for k in range(2, -1, -1)]
    out.append((int(deltas is not None), 0x80))
    if deltas is not None:
        out.append((1, 0x80))
        for v in deltas:
            out.append((int(v != 0), 0x80))
            if v:
                out += [((abs(v) >> k) & 1, 0x80) for k in range(5, -1, -1)]
                out.append((int(v < 0), 0x80))
    return out


def _chunk(data: bytes, tag: bytes) -> Tuple[int, int]:
    pos = 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if data[pos:pos + 4] == tag:
            return pos, size
        pos += 8 + size + (size & 1)
    raise ValueError(f"no {tag!r} chunk")


def rewrite(data: bytes, simple: Optional[int] = None, level: Optional[int] = None,
            sharpness: Optional[int] = None, deltas: Optional[Sequence[int]] = None,
            partitions: Optional[int] = None) -> bytes:
    """A WebP file with its VP8 frame's filter type (``simple``), level,
    sharpness, loop-filter deltas (8 values: by reference frame, then by
    mode; ``()`` turns them off) or token partition count changed; None
    keeps a field as it is."""
    pos, size = _chunk(data, b"VP8 ")
    frame = data[pos + 8:pos + 8 + size]
    with _recording():
        hdr = vp8._Header(frame)
        mbs = vp8._parse_modes(hdr)
        vp8._parse_tokens(hdr, mbs)
    p0 = [d for row in hdr.br.rows for d in row]
    seg_end = _walk_segment_header(p0, 2)
    old = _filter_header(hdr.simple, hdr.level, hdr.sharpness,
                         (hdr.ref_lf_delta + hdr.mode_lf_delta) if hdr.use_lf_delta else None)
    filt_end = seg_end + len(old)
    if p0[seg_end:filt_end] != old:  # an update flag with all deltas 0, or the like
        raise ValueError("the filter header is not as this tool writes it")
    n_old = len(hdr.parts)
    n = n_old if partitions is None else partitions
    if n not in (1, 2, 4, 8):
        raise ValueError("partitions: 1, 2, 4 or 8")
    if deltas is None and hdr.use_lf_delta:
        deltas = hdr.ref_lf_delta + hdr.mode_lf_delta
    new_filter = _filter_header(hdr.simple if simple is None else simple,
                                hdr.level if level is None else level,
                                hdr.sharpness if sharpness is None else sharpness,
                                tuple(deltas) if deltas else None)
    count = [((n.bit_length() - 1) >> 1, 0x80), ((n.bit_length() - 1) & 1, 0x80)]
    first = BoolEncoder()
    for bit, prob in p0[:seg_end] + new_filter + count + p0[filt_end + 2:]:
        first.put(bit, prob)
    first_bytes = first.finish()
    rows = []  # each macroblock row's token decisions, in row order
    for r in range(hdr.mb_h):
        part = hdr.parts[r % n_old]
        rows.append(part.rows[r // n_old])
    parts = []
    for p in range(n):
        enc = BoolEncoder()
        for r in range(p, hdr.mb_h, n):
            for bit, prob in rows[r]:
                enc.put(bit, prob)
        parts.append(enc.finish())
    tag = frame[0] | frame[1] << 8 | frame[2] << 16
    tag = (tag & 0x1F) | (len(first_bytes) << 5)
    body = (bytes([tag & 0xFF, (tag >> 8) & 0xFF, tag >> 16]) + frame[3:10] + first_bytes
            + b"".join(len(p).to_bytes(3, "little") for p in parts[:-1]) + b"".join(parts))
    body += bytes(len(body) & 1)  # libwebp pads an odd frame inside its chunk
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body
    out = data[:pos] + chunk + data[pos + 8 + size + (size & 1):]
    return out[:4] + struct.pack("<I", len(out) - 8) + out[8:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--simple", action="store_true", help="the simple loop filter")
    ap.add_argument("--level", type=int, help="filter level 0-63")
    ap.add_argument("--sharpness", type=int, help="sharpness 0-7")
    ap.add_argument("--deltas", type=int, nargs=8, help="4 reference and 4 mode deltas")
    ap.add_argument("--partitions", type=int, help="token partitions: 1, 2, 4 or 8")
    args = ap.parse_args(argv)
    with open(args.src, "rb") as f:
        data = f.read()
    out = rewrite(data, simple=1 if args.simple else None, level=args.level,
                  sharpness=args.sharpness, deltas=args.deltas, partitions=args.partitions)
    with open(args.dst, "wb") as f:
        f.write(out)


if __name__ == "__main__":
    main()
