"""XPM through ``tdnet_torch.data.xpm`` against PIL's
``Image.open(...).convert("RGB")`` and ``.size``: hand-written files
(PIL has no XPM writer): palettes of 1 and 2 characters, ``None``,
a ``/* pixels */`` line, pixel lines that do not follow the rows, more
than 256 colours (PIL's RGB route), hex of any length, and the colours
and headers PIL refuses or passes on; cv2 refuses XPM bodies."""

import numpy as np
import pytest

from tdnet_torch.data import xpm
from tests.test_torch_tga import assert_as_pil, assert_read_image_equal

BASE = b'/* XPM */\nstatic char *x[] = {\n"4 2 3 1",\n"a c #FF0000",\n"b c #00ff00",\n". c None",\n'


def _decode(d):
    return xpm.decode_xpm(d, route="pil")


def many_colours(w, h, n, seed) -> bytes:
    rng = np.random.default_rng(seed)
    keys = [bytes([65 + i // 20, 97 + i % 20]) for i in range(n)]
    lines = [b"/* XPM */", b'"%d %d %d 2",' % (w, h, n)]
    lines += [b'"' + k + b' c #%06x",' % (i * 50001 % 2 ** 24) for i, k in enumerate(keys)]
    for row in rng.integers(0, n, (h, w)):
        lines.append(b'"' + b"".join(keys[i] for i in row) + b'",')
    return b"\n".join(lines) + b"\n};\n"


CASES = [
    (BASE + b'"abab",\n"baba"};\n', True),
    (BASE + b'/* pixels */\n"abab",\n"baba"};\n', True),
    (BASE + b'"ababba",\n"ba"};\n', True),
    (BASE + b'"aba"};\n', False),
    (BASE + b'"ab.b",\n"baba"};\n', False),
    (b'/* XPM */\n"4 2 2 2",\n"aa c #123456789abc",\n"bb c #0000ff",\n"aabbaabb",\n'
     b'"bbaa"\n', False),
    (b'/* XPM */\n"2 2 2 2",\n"aa c #123456789abc",\n"bb s x c #0000ff",\n"aabb",\n"bbaa"\n', True),
    (b'/* XPM */\n"4 2 2 1",\n"a c red",\n"b c #0000ff",\n"abab",\n"baba"\n', False),
    (b'/* XPM */\n"4 2 2 1",\n"a c",\n"b c #0000ff",\n"abab",\n"baba"\n', False),
    (b'/* XPM */\n"4 2 2 1",\n"a s x",\n"b c #0000ff",\n"abab",\n"baba"\n', False),
    (b'/* XPM */\n"4 2 2 0",\n"a c #000000",\n"b c #0000ff",\n"abab",\n"baba"\n', False),
    (b'/* XPM */\n"4  2 2 1",\n"a c #000000",\n', False),
    (b'/* XPM */\n" 2 2 1",\n"a c #000000",\n', False),
    (many_colours(5, 3, 300, 1), True),
    (many_colours(7, 4, 40, 2), True),
]
CASE_IDS = ["rows", "pixels_comment", "lines_across_rows", "short", "none_pixel",
            "long_hex_short", "long_hex_and_s_key", "named_colour", "c_without_colour",
            "no_c_key", "zero_chars", "double_space", "empty_width", "rgb_300_colours",
            "palette_40_colours"]


@pytest.mark.parametrize("data,reads", CASES, ids=CASE_IDS)
def test_xpm_files(data, reads):
    assert assert_as_pil(data, _decode, xpm.xpm_size) == reads


def test_xpm_read_image_equals_reference(tmp_path):
    assert_read_image_equal(tmp_path, many_colours(23, 17, 60, 3), "page.xpm")
