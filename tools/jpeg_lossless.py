"""Write lossless JPEG (SOF3, T.81 Annex H) from 8-bit samples: each
sample predicted from its neighbours by one of the seven predictors (the
first row of the scan and of each restart interval from its left
neighbour, its first sample from 2^(P - Pt - 1), the first column from the
sample above), the point transform Pt applied first, and the differences
Huffman-coded by magnitude category (16: the difference 32768, no extra
bits), as libjpeg-turbo 3's ``jclossls.c`` and ``jclhuff.c`` lay them out.
PIL's decode of the result (libjpeg-turbo) equals the source samples
shifted right and back left by Pt: the tests hold that, which checks this
encoder without the port's decoder.

No encoder installed here writes lossless JPEG. Used by
tests/test_torch_jpeg.py and tools/make_pages.py.
"""

import struct

import numpy as np

# code lengths for the 17 magnitude categories, the most frequent first
# (Kraft sum below 1)
_LENGTHS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)


def _predictions(x: np.ndarray, predictor: int, first_rows: np.ndarray,
                 initial: int) -> np.ndarray:
    """Each sample's prediction (Annex H.1.2.1) for one component's (H, W)
    samples ``x`` (after the point transform); ``first_rows``: the rows that
    open the scan or a restart interval."""
    x = x.astype(np.int64)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    pred = pred.copy()
    pred[:, 0] = rb[:, 0]
    pred[first_rows] = ra[first_rows]
    pred[first_rows, 0] = initial
    return pred


def _huffman(counts_by_symbol):
    """A canonical table giving the most frequent categories the shortest
    codes -> (DHT counts, symbols, symbol -> (code, length))."""
    order = sorted(range(17), key=lambda s: -counts_by_symbol[s])
    lengths = dict(zip(order, _LENGTHS))
    symbols = sorted(range(17), key=lambda s: (lengths[s], s))
    counts = [0] * 16
    codes, code, prev = {}, 0, 1
    for s in symbols:
        n = lengths[s]
        code <<= n - prev
        prev = n
        codes[s] = (code, n)
        counts[n - 1] += 1
        code += 1
    return bytes(counts), bytes(symbols), codes


def _categories(diff: np.ndarray):
    """Differences mod 2^16 -> (category, extra bits) of each."""
    signed = np.where(diff >= 32768, diff - 65536, diff)
    mag = np.abs(signed)
    cat = np.where(signed == -32768, 16, np.ceil(np.log2(mag + 1)).astype(np.int64))
    extra = np.where(signed >= 0, signed, signed + (1 << np.minimum(cat, 15)) - 1)
    return cat.astype(np.int64), np.where(cat == 16, 0, extra).astype(np.int64)


def _stuffed(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes (value, length in bits) in order -> bytes, MSB first, padded
    with 1 bits, each 0xFF byte stuffed with 0x00."""
    total = int(lengths.sum())
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    shift = np.repeat(lengths, lengths) - 1 - (np.arange(total) - starts)
    bits = (np.repeat(values, lengths) >> shift) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode(samples, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
           rgb: bool = False, interleaved: bool = True, sampling=None, jfif=None,
           precision: int = 8) -> bytes:
    """(H, W) or (H, W, C) uint8 samples below ``2 ** precision`` -> a
    lossless JPEG of that precision (2 to 8).
    ``restart_rows``: MCU rows a restart interval; ``rgb``: an Adobe marker
    with transform 0, so libjpeg takes three components for RGB (else a
    JFIF marker, which makes them YCbCr; ``jfif=False`` writes no marker,
    and libjpeg-turbo then takes three lossless components for RGB);
    ``interleaved``: one scan of every component, else a scan each.
    ``sampling``: each component's (h, v) sampling factors, with
    ``samples`` a list of each component's own plane (``ceil(W * h /
    hmax)`` by ``ceil(H * v / vmax)`` samples; where interleaved MCUs
    reach past a plane, its edge samples are repeated into them)."""
    if sampling is None:
        x = np.asarray(samples, np.uint8)
        if x.ndim == 2:
            x = x[:, :, None]
        planes = [x[:, :, c] for c in range(x.shape[2])]
        sampling = [(1, 1)] * len(planes)
    else:
        planes = [np.asarray(p, np.uint8) for p in samples]
    nc = len(planes)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = max(p.shape[0] for p, (_, v) in zip(planes, sampling) if v == vmax)
    width = max(p.shape[1] for p, (h, _) in zip(planes, sampling) if h == hmax)
    mcux = -(-width // hmax) if interleaved and nc > 1 else None
    if restart_rows and not (interleaved or set(sampling) == {(1, 1)}):
        raise ValueError("restart intervals are written for interleaved scans or 1x1 sampling")
    if mcux is not None:  # interleaved MCUs cover whole blocks: pad by the edge samples
        mcuy = -(-height // vmax)
        planes = [np.pad(p, ((0, mcuy * v - p.shape[0]), (0, mcux * h - p.shape[1])), "edge")
                  for p, (h, v) in zip(planes, sampling)]
    cats = []
    for p, (h, v) in zip(planes, sampling):
        rows = np.arange(p.shape[0])
        first = (rows % (restart_rows * v) == 0) if restart_rows else rows == 0
        xs = p.astype(np.int64) >> pt
        d = (xs - _predictions(xs, predictor, first, 1 << (precision - pt - 1))) & 0xFFFF
        cats.append(_categories(d))
    out = bytearray(b"\xff\xd8")
    if rgb:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    elif nc == 3 and jfif is not False:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xC3, struct.pack(">BHHB", precision, height, width, nc)
                    + b"".join(bytes([c + 1, (h << 4) | v, 0])
                               for c, (h, v) in enumerate(sampling)))
    tables = []
    for c in range(nc):
        counts = np.bincount(cats[c][0].ravel(), minlength=17)
        tables.append(_huffman(counts))
        out += _segment(0xC4, bytes([c]) + tables[c][0] + tables[c][1])
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * (mcux or width)))
    groups = [list(range(nc))] if interleaved else [[c] for c in range(nc)]
    for group in groups:
        out += _segment(0xDA, bytes([len(group)]) + b"".join(bytes([c + 1, c << 4])
                                                              for c in group)
                        + bytes([predictor, 0, pt]))
        units = []  # per component: (code, extra) and their lengths, in MCU order
        for c in group:
            h, v = sampling[c] if len(group) > 1 else (1, 1)
            cat, extra = cats[c]
            code = np.array([tables[c][2][k][0] for k in range(17)])[cat]
            size = np.array([tables[c][2][k][1] for k in range(17)])[cat]
            vals = np.stack([code, extra], axis=-1)
            lens = np.stack([size, np.where(cat < 16, cat, 0)], axis=-1)
            ph, pw = cat.shape
            # (MCU rows, v, MCUs, h, 2) -> (MCU rows, MCUs, v * h * 2)
            units.append(tuple(a.reshape(ph // v, v, pw // h, h, 2).transpose(0, 2, 1, 3, 4)
                               .reshape(ph // v, pw // h, -1) for a in (vals, lens)))
        mcu_rows = units[0][0].shape[0]
        starts = list(range(0, mcu_rows, restart_rows or mcu_rows)) + [mcu_rows]
        for n, (r0, r1) in enumerate(zip(starts[:-1], starts[1:])):
            if n:
                out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            values = np.concatenate([u[0][r0:r1] for u in units], axis=2).reshape(-1)
            lengths = np.concatenate([u[1][r0:r1] for u in units], axis=2).reshape(-1)
            out += _stuffed(values, lengths)
    return bytes(out + b"\xff\xd9")
