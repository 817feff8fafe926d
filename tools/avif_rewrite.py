"""Write AVIF containers by hand around the AV1 payloads of encoded files,
for fixtures neither encoder here writes: other ``colr`` ``nclx`` matrices
and ranges, ``irot``, ``imir`` and ``clap``, missing or mismatched
``pixi`` and ``ispe``, essential properties, ``grid`` items, alpha items
and damaged boxes.

    from avif_rewrite import items, write
    payload, props = items(open("page.avif", "rb").read())
    data = write(payload, props | {b"colr": nclx(1, 13, 9, True)})

``items`` returns the primary item's payload and properties (kind -> body,
in file order); ``write`` lays out ``ftyp``, ``meta`` (``hdlr``, ``pitm``,
``iloc`` v0, ``iinf`` v0 with ``infe`` v2, ``iprp`` with ``ipco`` and
``ipma``, optional ``iref``) and one ``mdat``.
"""

import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tdnet_torch.data import avif  # noqa: E402


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags) + body)


def nclx(primaries: int, transfer: int, matrix: int, full_range: bool) -> bytes:
    return b"nclx" + struct.pack(">HHHB", primaries, transfer, matrix, 0x80 if full_range else 0)


def ispe(width: int, height: int) -> bytes:
    return struct.pack(">III", 0, width, height)


def pixi(*depths) -> bytes:
    return struct.pack(">IB", 0, len(depths)) + bytes(depths)


def items(data: bytes):
    """(payload, {kind: body}) of the primary item of an AVIF file."""
    c = avif.parse(data)
    item = c.items[c.primary]
    return c.payload(data, item), dict(c.props(item))


def write(payload: bytes, props: dict, *, major: bytes = b"avif", item_type: bytes = b"av01",
          essential=(), alpha=None, premultiplied: bool = False, extra_items=(),
          brands=(b"avif", b"mif1", b"miaf")) -> bytes:
    """An AVIF file: item 1 (``item_type``) with ``payload`` and ``props``;
    ``alpha`` = (payload, props) adds item 2 as its alpha auxiliary (and a
    ``prem`` reference when ``premultiplied``); ``extra_items`` are (type,
    payload, props) of further items, all referenced by item 1 with
    ``dimg`` when item 1 is a grid."""
    entries = [(1, item_type, payload, list(props.items()))]
    if alpha is not None:
        aprops = list(alpha[1].items()) + [
            (b"auxC", struct.pack(">I", 0) + b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")]
        entries.append((2, b"av01", alpha[0], aprops))
    for k, (t, p, pr) in enumerate(extra_items):
        entries.append((len(entries) + 1, t, p, list(pr.items())))
    ipco = []
    assoc = []
    for item_id, _, _, plist in entries:
        ids = []
        for kind, body in plist:
            ipco.append(box(kind, body))
            ids.append((len(ipco), kind in essential))
        assoc.append((item_id, ids))
    ipma_body = struct.pack(">I", len(assoc))
    for item_id, ids in assoc:
        ipma_body += struct.pack(">HB", item_id, len(ids))
        for index, ess in ids:
            ipma_body += bytes([(0x80 if ess else 0) | index])
    iprp = box(b"iprp", box(b"ipco", b"".join(ipco)) + full(b"ipma", 0, 0, ipma_body))
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(entries)) + b"".join(
        full(b"infe", 2, 0, struct.pack(">HH", i, 0) + t + b"\0") for i, t, _, _ in entries))
    refs = b""
    if alpha is not None:
        refs += box(b"auxl", struct.pack(">HHH", 2, 1, 1))
        if premultiplied:
            refs += box(b"prem", struct.pack(">HHH", 1, 1, 2))
    if item_type == b"grid" and extra_items:
        n = len(extra_items)
        refs += box(b"dimg", struct.pack(">HH", 1, n) + b"".join(
            struct.pack(">H", i) for i in range(len(entries) - n + 1, len(entries) + 1)))
    iref = full(b"iref", 0, 0, refs) if refs else b""
    hdlr = full(b"hdlr", 0, 0, struct.pack(">I", 0) + b"pict" + bytes(12) + b"\0")
    pitm = full(b"pitm", 0, 0, struct.pack(">H", 1))
    ftyp = box(b"ftyp", major + struct.pack(">I", 0) + b"".join(brands))

    def meta_with(offsets):
        iloc_body = struct.pack(">BBH", 0x44, 0x00, len(entries))
        for (item_id, _, p, _), off in zip(entries, offsets):
            iloc_body += struct.pack(">HHHII", item_id, 0, 1, off, len(p))
        return full(b"meta", 0, 0, hdlr + pitm + full(b"iloc", 0, 0, iloc_body) + iinf + iref
                    + iprp)

    meta = meta_with([0] * len(entries))
    start = len(ftyp) + len(meta) + 8
    offsets = []
    at = start
    for _, _, p, _ in entries:
        offsets.append(at)
        at += len(p)
    meta = meta_with(offsets)
    mdat = box(b"mdat", b"".join(p for _, _, p, _ in entries))
    return ftyp + meta + mdat
