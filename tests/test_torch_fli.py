"""FLI/FLC (the first frame) through ``tdnet_torch.data.fli`` against
PIL's ``Image.open(...).convert("RGB")`` and ``.size``, on hand-made files
(PIL has no FLI writer): 8-bit and 6-bit colour chunks, BLACK, BRUN, COPY,
LC and SS2 (line skips, the last byte) subchunks, a postage stamp, a
prefix chunk, and the files PIL refuses or passes on; cv2 refuses FLI
bodies."""

import struct

import numpy as np
import pytest

from tdnet_torch.data import fli
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal


def _decode(d):
    return fli.decode_fli(d, route="pil")


def header(w, h, frames=1, magic=0xAF12, flags=0):
    s = bytearray(128)
    struct.pack_into("<IHHHHHHI", s, 0, 0, magic, frames, w, h, 8, flags, 5)
    return bytes(s)


def sub(kind, body):
    chunk = struct.pack("<IH", 6 + len(body), kind) + body
    return chunk + b"\0" * (len(chunk) % 2)


def frame(*subs):
    body = b"".join(subs)
    return struct.pack("<IHH", 16 + len(body), 0xF1FA, len(subs)) + bytes(8) + body


def brun(px) -> bytes:
    out = bytearray()
    for row in px:
        out += b"\x01"
        x = 0
        while x < len(row):
            if x + 3 <= len(row) and row[x] == row[x + 1] == row[x + 2]:
                n = 3
                while x + n < len(row) and row[x + n] == row[x] and n < 127:
                    n += 1
                out += bytes([n, row[x]])
            else:
                n = min(4, len(row) - x)
                out += bytes([256 - n]) + row[x:x + n].tobytes()
            x += n
    return bytes(out)


RNG = np.random.default_rng(0)
W, H = 10, 6
PX = RNG.integers(0, 256, (H, W), dtype=np.uint8)
PX_RUNS = PX.copy()
PX_RUNS[:, 3:7] = 9
PAL = struct.pack("<H", 1) + bytes([0, 0]) + RNG.integers(0, 256, 768, dtype=np.uint8).tobytes()
PAL64 = (struct.pack("<H", 2) + bytes([3, 4]) + RNG.integers(0, 64, 12, dtype=np.uint8).tobytes()
         + bytes([2, 2]) + RNG.integers(0, 64, 6, dtype=np.uint8).tobytes())
LC = struct.pack("<HH", 1, 2) + bytes([2, 1, 256 - 3, 7, 2, 2, 5, 6]) + bytes([1, 0, 3, 1, 2, 3])
SS2 = (struct.pack("<HH", 2, 2) + bytes([1, 256 - 2, 7, 8, 1, 1, 3, 4])
       + struct.pack("<HHH", 0xFFFF, 0x80AB, 1) + bytes([0, 1, 9, 9]))
CASES = {
    "copy_256": (header(W, H) + frame(sub(4, PAL), sub(16, PX.tobytes())), True),
    "copy_64": (header(W, H) + frame(sub(11, PAL64), sub(16, PX.tobytes())), True),
    "brun": (header(W, H) + frame(sub(4, PAL), sub(15, brun(PX_RUNS))), True),
    "copy_lc": (header(W, H) + frame(sub(4, PAL), sub(16, PX.tobytes()), sub(12, LC)), True),
    "black_lc": (header(W, H) + frame(sub(13, b""), sub(12, LC)), True),
    "copy_ss2": (header(W, H) + frame(sub(4, PAL), sub(16, PX.tobytes()), sub(7, SS2)), True),
    "fli_brun_stamp": (header(W, H, magic=0xAF11) + frame(sub(11, PAL64), sub(15, brun(PX_RUNS)),
                                                          sub(18, b"stmp")), True),
    # a last subchunk under 10 bytes: PIL's decoder wants 10 for a header
    "short_last_chunk": (header(W, H) + frame(sub(15, brun(PX_RUNS)), sub(18, b"xx")), False),
    "short": (header(W, H) + frame(sub(4, PAL), sub(16, PX.tobytes()))[:-3], False),
    "unknown_chunk": (header(W, H) + frame(sub(4, PAL), sub(99, b"ab")), False),
    "prefix_chunk": (header(W, H) + struct.pack("<IH", 16, 0xF100) + bytes(10)
                     + frame(sub(4, PAL), sub(16, PX.tobytes())), False),
    "brun_short_row": (header(W, H) + frame(sub(15, b"\x01\x03\x07" * H)), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fli_chunks(case):
    data, reads = CASES[case]
    assert assert_as_pil(data, _decode, fli.fli_size) == reads
    assert fli.is_fli(data)


@pytest.mark.parametrize("data", [
    header(W, H, frames=0) + frame(sub(16, PX.tobytes())),
    header(0, H) + frame(sub(16, PX.tobytes())),
    header(W, H, flags=1) + frame(sub(16, PX.tobytes())),
    header(W, H) + frame(sub(4, struct.pack("<H", 1) + bytes([255, 2]) + bytes(6)),
                         sub(16, PX.tobytes())),
    header(W, H)[:100]])
def test_fli_files_pil_passes_on(data):
    assert not fli.is_fli(data)
    assert_as_pil(data)


def test_fli_read_image_equals_reference(tmp_path):
    px = RNG.integers(0, 256, (24, 31), dtype=np.uint8)
    assert_read_image_equal(tmp_path, header(31, 24) + frame(sub(4, PAL), sub(15, brun(px))),
                            "page.flc")
