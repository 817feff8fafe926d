"""Extract the AV1 decoder's constant tables from libaom 3.14.1 (the
``libaom-a0d22147.so.3.14.1`` bundled beside OpenCV here) and write them to
``tdnet_torch/data/av1_tables.py`` for the port's AV1 decoder.

The library keeps its ``.symtab``: each table is read from the file by its
symbol (the section holding the symbol's address gives the file offset) and
checked against the symbol's size. The mode CDFs that are not objects of
their own (libaom's ``init_mode_probs`` copies them from constants merged
into its code) are taken from a ``FRAME_CONTEXT`` that the library's own
``av1_init_mode_probs`` fills, called through ctypes; the field layout of
that structure is checked against every named CDF table that lies in it.

CDFs keep libaom's form: inverted (``32768 - cumulative``, so the last
symbol's entry is 0) with a trailing adaptation counter, ``n + 1`` entries
for ``n`` symbols, padded with zeros to the widest alphabet of their array.
Scans and coefficient-context offsets are turned from libaom's transposed
(column-major) coefficient order to the row-major order of the AV1
specification.

Run from the repo root, on a machine with OpenCV's wheel (its libaom); the
card's machine has no cv2 and imports only the generated module:
    python tools/make_av1_tables.py [--check]
``--check`` compares a fresh run with the checked-in module byte for byte.
"""

import argparse
import base64
import ctypes
import glob
import os
import sys

import numpy as np
from elftools.elf.elffile import ELFFile

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tdnet_torch", "data",
                   "av1_tables.py")
LIB_NAME = "libaom-a0d22147.so.3.14.1"

# FRAME_CONTEXT of libaom 3.14.1 (av1/common/entropymode.h), in uint16
# entries, from its first mode CDF (after the coefficient CDFs) to its end
MODE_FIELDS = [
    ("newmv", (6, 3)), ("zeromv", (2, 3)), ("refmv", (6, 3)), ("drl", (3, 3)),
    ("inter_compound_mode", (8, 9)), ("compound_type", (22, 3)), ("wedge_idx", (22, 17)),
    ("interintra", (4, 3)), ("wedge_interintra", (22, 3)), ("interintra_mode", (4, 5)),
    ("motion_mode", (22, 4)), ("obmc", (22, 3)), ("palette_y_size", (7, 8)),
    ("palette_uv_size", (7, 8)), ("palette_y_color_index", (7, 5, 9)),
    ("palette_uv_color_index", (7, 5, 9)), ("palette_y_mode", (7, 3, 3)),
    ("palette_uv_mode", (2, 3)), ("comp_inter", (5, 3)), ("single_ref", (3, 6, 3)),
    ("comp_ref_type", (5, 3)), ("uni_comp_ref", (3, 3, 3)), ("comp_ref", (3, 3, 3)),
    ("comp_bwdref", (3, 2, 3)), ("txfm_partition", (21, 3)), ("compound_index", (6, 3)),
    ("comp_group_idx", (6, 3)), ("skip_mode", (3, 3)), ("skip_txfm", (3, 3)),
    ("intra_inter", (4, 3)), ("nmvc", (143,)), ("ndvc", (143,)), ("intrabc", (3,)),
    ("segment_pred", (3, 3)), ("spatial_segment_id", (3, 9)), ("filter_intra", (22, 3)),
    ("filter_intra_mode", (6,)), ("switchable_restore", (4,)), ("wiener_restore", (3,)),
    ("sgrproj_restore", (3,)), ("y_mode", (4, 14)), ("uv_mode", (2, 13, 15)),
    ("partition", (20, 11)), ("switchable_interp", (16, 4)), ("kf_y_mode", (5, 5, 14)),
    ("angle_delta", (8, 8)), ("tx_size", (4, 3, 4)), ("delta_q", (5,)),
    ("delta_lf_multi", (4, 5)), ("delta_lf", (5,)), ("intra_ext_tx", (3, 4, 13, 17)),
    ("inter_ext_tx", (4, 4, 17)), ("cfl_sign", (9,)), ("cfl_alpha", (6, 17)),
]
# the named tables that lie inside it: each must sit where the layout says
MODE_ANCHORS = {
    "wedge_idx": "default_wedge_idx_cdf", "palette_y_color_index":
    "default_palette_y_color_index_cdf", "palette_uv_color_index":
    "default_palette_uv_color_index_cdf", "uv_mode": "default_uv_mode_cdf",
    "partition": "default_partition_cdf", "kf_y_mode": "default_kf_y_mode_cdf",
    "intra_ext_tx": "default_intra_ext_tx_cdf", "inter_ext_tx": "default_inter_ext_tx_cdf",
}
# what the decoder needs of the mode CDFs (the rest is inter coding)
MODE_KEEP = ("palette_y_size", "palette_uv_size", "palette_y_color_index",
             "palette_uv_color_index", "palette_y_mode", "palette_uv_mode", "skip_txfm",
             "intrabc", "spatial_segment_id", "filter_intra", "filter_intra_mode",
             "switchable_restore", "wiener_restore", "sgrproj_restore", "uv_mode", "partition",
             "kf_y_mode", "angle_delta", "tx_size", "delta_q", "delta_lf_multi", "delta_lf",
             "intra_ext_tx", "inter_ext_tx", "cfl_sign", "cfl_alpha", "ndvc", "txfm_partition")

# (name in the module, symbol, dtype, shape); the four coefficient-CDF sets
# are indexed by libaom's TOKEN_CDF_Q_CTXS (base_q_idx <= 20, 60, 120, above)
SYMBOL_TABLES = [
    ("TXB_SKIP", "av1_default_txb_skip_cdfs", "<u2", (4, 5, 13, 3)),
    ("EOB_EXTRA", "av1_default_eob_extra_cdfs", "<u2", (4, 5, 2, 9, 3)),
    ("DC_SIGN", "av1_default_dc_sign_cdfs", "<u2", (4, 2, 3, 3)),
    ("EOB_PT_16", "av1_default_eob_multi16_cdfs", "<u2", (4, 2, 2, 6)),
    ("EOB_PT_32", "av1_default_eob_multi32_cdfs", "<u2", (4, 2, 2, 7)),
    ("EOB_PT_64", "av1_default_eob_multi64_cdfs", "<u2", (4, 2, 2, 8)),
    ("EOB_PT_128", "av1_default_eob_multi128_cdfs", "<u2", (4, 2, 2, 9)),
    ("EOB_PT_256", "av1_default_eob_multi256_cdfs", "<u2", (4, 2, 2, 10)),
    ("EOB_PT_512", "av1_default_eob_multi512_cdfs", "<u2", (4, 2, 2, 11)),
    ("EOB_PT_1024", "av1_default_eob_multi1024_cdfs", "<u2", (4, 2, 2, 12)),
    ("COEFF_BASE_EOB", "av1_default_coeff_base_eob_multi_cdfs", "<u2", (4, 5, 2, 4, 4)),
    ("COEFF_BASE", "av1_default_coeff_base_multi_cdfs", "<u2", (4, 5, 2, 42, 5)),
    ("COEFF_BR", "av1_default_coeff_lps_multi_cdfs", "<u2", (4, 5, 2, 21, 5)),
    ("DC_QLOOKUP", "dc_qlookup_QTX", "<i2", (256,)),
    ("AC_QLOOKUP", "ac_qlookup_QTX", "<i2", (256,)),
    ("DC_QLOOKUP_10", "dc_qlookup_10_QTX", "<i2", (256,)),
    ("AC_QLOOKUP_10", "ac_qlookup_10_QTX", "<i2", (256,)),
    ("DC_QLOOKUP_12", "dc_qlookup_12_QTX", "<i2", (256,)),
    ("AC_QLOOKUP_12", "ac_qlookup_12_QTX", "<i2", (256,)),
    ("DR_INTRA_DERIVATIVE", "dr_intra_derivative", "<i2", (90,)),
    ("FILTER_INTRA_TAPS", "av1_filter_intra_taps", "i1", (5, 8, 8)),
    ("SMOOTH_WEIGHTS", "smooth_weights", "u1", (124,)),
    ("SGR_PARAMS", "av1_sgr_params", "<i4", (16, 4)),
    ("X_BY_XPLUS1", "av1_x_by_xplus1", "<u4", (256,)),
    ("ONE_BY_X", "av1_one_by_x", "<i4", (25,)),
    ("CDEF_DIRECTIONS_PADDED", "cdef_directions_padded", "<i4", (12, 2)),
    ("CDEF_PRI_TAPS", "cdef_pri_taps", "<i4", (2, 2)),
    ("CDEF_SEC_TAPS", "cdef_sec_taps", "<i4", (2,)),
    ("COSPI", "av1_cospi_arr_data", "<i4", (4, 64)),
    ("SINPI", "av1_sinpi_arr_data", "<i4", (4, 5)),
    ("GAUSSIAN_SEQUENCE", "gaussian_sequence", "<i4", (2048,)),
    ("MODE_TO_ANGLE", "mode_to_angle_map", "u1", (13,)),
    ("PALETTE_COLOR_CONTEXT", "av1_palette_color_index_context_lookup", "<i4", (9,)),
    ("DIV_LUT", "div_lut", "<i2", (257,)),
]
NMV = ("default_nmv_context", "<u2", (143,))

# transform sizes in the AV1 order: (width, height)
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
           (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
           (16, 64), (64, 16)]


def _coded(w, h):
    """The size whose scan and contexts a transform's coefficients use
    (64-point sides code 32)."""
    return min(w, 32), min(h, 32)


def find_library():
    import cv2
    here = os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs", LIB_NAME)
    found = glob.glob(here)
    if not found:
        sys.exit(f"{LIB_NAME} not found beside cv2")
    return os.path.realpath(found[0])


class Library:
    def __init__(self, path):
        self.path = path
        self.raw = open(path, "rb").read()
        self.syms = {}
        with open(path, "rb") as f:
            elf = ELFFile(f)
            self.sections = [(s["sh_addr"], s["sh_size"], s["sh_offset"], s["sh_type"])
                             for s in elf.iter_sections()]
            for s in elf.get_section_by_name(".symtab").iter_symbols():
                if s.name and s.name not in self.syms:
                    self.syms[s.name] = (s["st_value"], s["st_size"], s["st_info"]["type"])

    def read(self, name, dtype, shape):
        addr, size, kind = self.syms[name]
        want = int(np.prod(shape)) * np.dtype(dtype).itemsize
        assert kind == "STT_OBJECT", (name, kind)
        assert size == want, f"{name}: symbol of {size} bytes, table of {want}"
        for start, length, offset, stype in self.sections:
            if start <= addr < start + length and stype != "SHT_NOBITS":
                at = offset + addr - start
                return np.frombuffer(self.raw[at:at + size], dtype).reshape(shape).copy()
        raise KeyError(f"{name}: no section holds 0x{addr:x}")

    def _loaded(self):
        """The library loaded, and the address it was loaded at."""
        lib = ctypes.CDLL(self.path)
        base = ctypes.cast(lib.aom_codec_av1_dx, ctypes.c_void_p).value \
            - self.syms["aom_codec_av1_dx"][0]
        return lib, base

    def pointed(self, name, index, nbytes):
        """``nbytes`` at the ``index``-th pointer of the table ``name``, as
        the loaded library has it relocated."""
        _, base = self._loaded()
        addr, size, _ = self.syms[name]
        assert (index + 1) * 8 <= size
        target = ctypes.c_uint64.from_address(base + addr + 8 * index).value
        return ctypes.string_at(target, nbytes)

    def mode_context(self):
        """The mode part of a FRAME_CONTEXT that av1_init_mode_probs fills."""
        lib, base = self._loaded()
        buf = (ctypes.c_uint16 * (1 << 16))()
        fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + self.syms["av1_init_mode_probs"][0])
        fn(ctypes.addressof(buf))
        return np.frombuffer(buf, np.uint16).copy()


def coefficient_part_size():
    n = 0
    for name, _, _, shape in SYMBOL_TABLES[:13]:
        n += int(np.prod(shape[1:]))
    return n


def mode_tables(lib):
    fc = lib.mode_context()
    at = coefficient_part_size()
    out = {}
    for field, shape in MODE_FIELDS:
        n = int(np.prod(shape))
        out[field] = fc[at:at + n].reshape(shape)
        anchor = MODE_ANCHORS.get(field)
        if anchor is not None:
            want = lib.read(anchor, "<u2", shape)
            assert np.array_equal(out[field], want), f"FRAME_CONTEXT layout: {field} at {at}"
        at += n
    assert not fc[at:].any(), "FRAME_CONTEXT layout: entries past its last field"
    # av1_setup_past_independence sets the DV context from default_nmv_context
    assert not out["ndvc"].any()
    out["ndvc"] = lib.read(*NMV)
    return {k: out[k] for k in MODE_KEEP}


def _to_spec(scan_aom, w, h):
    """libaom index c * h + r -> the specification's r * w + c."""
    a = np.asarray(scan_aom, np.int64)
    return ((a % h) * w + a // h).astype(np.int16)


def scan_tables(lib):
    default, mrow, mcol, ctx = [], [], [], []
    for w, h in TX_DIMS:
        cw, ch = _coded(w, h)
        tag = f"{cw}x{ch}"
        d = lib.read(f"default_scan_{tag}", "<i2", (cw * ch,))
        default.append(_to_spec(d, cw, ch))
        mr = lib.read(f"mrow_scan_{tag}", "<i2", (cw * ch,))
        mc = lib.read(f"mcol_scan_{tag}", "<i2", (cw * ch,))
        mrow.append(_to_spec(mr, cw, ch))
        mcol.append(_to_spec(mc, cw, ch))
        # some sizes share a table: take it through libaom's pointer table
        raw = lib.pointed("av1_nz_map_ctx_offset", TX_DIMS.index((w, h)), cw * ch)
        nz = np.frombuffer(raw, np.int8)
        full = np.zeros(cw * ch, np.int8)
        full[_to_spec(np.arange(cw * ch), cw, ch)] = nz
        full = full.reshape(ch, cw)
        off = np.zeros((5, 5), np.int8)
        off[:min(ch, 5), :min(cw, 5)] = full[:5, :5]
        ctx.append(off)
    return default, mrow, mcol, np.stack(ctx)


def qm_tables(lib):
    """libaom's inverse quantizer matrices (levels 0-14, luma and chroma),
    each transform size's matrix turned to the specification's order, and
    the offset of each size's matrix (64-point sides use the 32-point
    ones)."""
    raw = lib.read("iwt_matrix_ref", "u1", (15, 2, 3344))
    out = np.zeros_like(raw)
    offsets = []
    at = 0
    for w, h in TX_DIMS:
        if (w, h) != _coded(w, h):
            offsets.append(offsets[TX_DIMS.index(_coded(w, h))])
            continue
        offsets.append(at)
        n = w * h
        out[:, :, at + _to_spec(np.arange(n), w, h)] = raw[:, :, at:at + n]
        at += n
    assert at == 3344
    return out, np.array(offsets, np.int16)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def _emit(lines, name, a, note):
    dt = a.dtype.str
    lines.append(f"# {note}")
    b = _b64(a)
    chunks = [b[i:i + 88] for i in range(0, len(b), 88)] or [""]
    lines.append(f"{name} = _t({dt!r}, {tuple(a.shape)!r}, (")
    lines.extend(f"    {c!r}" for c in chunks)
    lines.append("))")


def render(lib) -> str:
    src = f"{LIB_NAME} (libaom 3.14.1)"
    lines = [
        '"""The AV1 decoder\'s constant tables, extracted from libaom 3.14.1 by',
        "``tools/make_av1_tables.py`` (generated: do not edit).",
        "",
        "CDFs are in libaom's form: inverted (``32768 - cumulative``: the last",
        "symbol's entry is 0) with a trailing adaptation counter, ``n + 1``",
        "entries for ``n`` symbols, zero-padded to the widest alphabet of their",
        "array. The coefficient CDFs have a leading axis of the four base-q-index",
        "sets. Scans and ``COEFF_BASE_CTX_OFFSET`` are in the specification's",
        "row-major coefficient order; ``SCAN_*[t]`` is for transform size ``t``",
        "(64-point sides use the 32-point scans).",
        '"""',
        "",
        "import base64",
        "",
        "import numpy as np",
        "",
        "",
        "def _t(dtype, shape, data):",
        "    a = np.frombuffer(base64.b64decode(''.join(data)), dtype).reshape(shape)",
        "    a.flags.writeable = False",
        "    return a",
        "",
        "",
    ]
    for name, sym, dt, shape in SYMBOL_TABLES:
        _emit(lines, name, lib.read(sym, dt, shape), f"{src}: {sym}")
    for field, a in mode_tables(lib).items():
        note = (f"{src}: default_nmv_context (the DV context)" if field == "ndvc" else
                f"{src}: FRAME_CONTEXT.{field} as av1_init_mode_probs sets it")
        _emit(lines, "CDF_" + field.upper(), a.astype("<u2"), note)
    default, mrow, mcol, ctx = scan_tables(lib)
    for label, scans, sym in (("DEFAULT", default, "default_scan_*"),
                              ("MROW", mrow, "mrow_scan_* (transposed)"),
                              ("MCOL", mcol, "mcol_scan_* (transposed)")):
        for i, s in enumerate(scans):
            w, h = TX_DIMS[i]
            _emit(lines, f"_SCAN_{label}_{i}", s, f"{src}: {sym}, {w}x{h}")
        lines.append(f"SCAN_{label} = ({', '.join(f'_SCAN_{label}_{i}' for i in range(19))})")
    qm, qm_offsets = qm_tables(lib)
    _emit(lines, "QM_INVERSE", qm, f"{src}: iwt_matrix_ref, each matrix transposed")
    _emit(lines, "QM_OFFSET", qm_offsets, "each transform size's matrix in QM_INVERSE[level][plane]")
    _emit(lines, "COEFF_BASE_CTX_OFFSET", ctx,
          f"{src}: av1_nz_map_ctx_offset[] (transposed, rows and columns 0-4)")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the checked-in module instead of writing it")
    args = ap.parse_args()
    text = render(Library(find_library()))
    if args.check:
        with open(OUT) as f:
            if f.read() != text:
                sys.exit("av1_tables.py differs from a fresh extraction")
        print("av1_tables.py: equal to a fresh extraction")
        return
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {os.path.normpath(OUT)} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
