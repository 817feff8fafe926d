"""A VP8 key frame (the lossy ``VP8 `` chunk of a WebP) in Python and numpy,
as libwebp decodes it (``vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c``,
``frame_dec.c``, ``dsp/dec.c``, ``dsp/upsampling.c``, ``dsp/yuv.h``): equal
byte for byte to what PIL and ``cv2.imdecode`` read from a lossy WebP (both
run libwebp). RFC 6386 describes the bitstream.

- the frame tag (key frame, profile 0-3, shown, the first partition's
  size), the start code ``9d 01 2a``, 14-bit sizes (the scale bits
  ignored) and the boolean decoder;
- the header: colour space and clamping type; segmentation (map
  probabilities, quantizer and filter values, absolute or deltas); filter
  type (normal or simple), level and sharpness; the loop-filter deltas by
  reference frame and by mode; 1, 2, 4 or 8 token partitions; the
  quantizer indices and their deltas; token-probability updates and the
  skip probability;
- per macroblock: the segment, the skip flag and the intra modes (16x16
  DC/V/H/TM, the ten 4x4 modes with their above/left contexts, chroma);
- tokens through the bands and contexts, dequantized by the DC/AC tables,
  Y2 through the inverse WHT, and libwebp's integer inverse DCT (20091 and
  35468); the residuals of every block are computed at once;
- prediction from the unfiltered reconstruction, its borders 127 above
  and 129 left, a 4x4 block's top-right pixels taken from the macroblock
  above-right (the right column's from above its last pixel);
- the normal and simple loop filters with per-segment and per-mode levels,
  interior and edge limits from the sharpness and the hev thresholds,
  macroblock by macroblock in libwebp's order. A macroblock's filters
  touch only it and 4 pixels to its left and above, so all macroblocks
  with the same x + 2y are filtered together, edge by edge;
- libwebp's output: fancy upsampling of the 4:2:0 chroma and the 14-bit
  fixed-point YUV -> RGB of ``dsp/yuv.h``.

A frame is refused (``ValueError``) where libwebp refuses it: a bad frame
tag, start code or size, an interframe, a frame not shown, a first
partition or partition table past the data, an empty last partition, or a
partition that macroblock rows read past its end (libwebp then reports a
premature end of file).

On a damaged stream it decodes as libwebp's x86-64 build does, which the
references are: the boolean decoder keeps libwebp's 64-bit value, 32-bit
window and its own sign read (they matter once a partition that starts at
0xff leaves the value above the range), and a block with more than three
tokens goes through the SSE2 inverse DCT's wrapping 16-bit lanes, which
part from the C code on the huge coefficients such a stream gives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decode_vp8", "vp8_info", "yuv_to_rgb"]


def _table(*shape_and_text):
    *shape, text = shape_and_text
    return np.array(text.split(), np.int64).reshape(shape).tolist()


# RFC 6386 13.5: default token probabilities [type][band][context][node], a
# context a line, 3 lines a band, 8 bands a type
COEFF_PROBS = _table(4, 8, 3, 11, """
128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
253 136 254 255 228 219 128 128 128 128 128
189 129 242 255 227 213 255 219 128 128 128
106 126 227 252 214 209 255 255 128 128 128
  1  98 248 255 236 226 255 255 128 128 128
181 133 238 254 221 234 255 154 128 128 128
 78 134 202 247 198 180 255 219 128 128 128
  1 185 249 255 243 255 128 128 128 128 128
184 150 247 255 236 224 128 128 128 128 128
 77 110 216 255 236 230 128 128 128 128 128
  1 101 251 255 241 255 128 128 128 128 128
170 139 241 252 236 209 255 255 128 128 128
 37 116 196 243 228 255 255 255 128 128 128
  1 204 254 255 245 255 128 128 128 128 128
207 160 250 255 238 128 128 128 128 128 128
102 103 231 255 211 171 128 128 128 128 128
  1 152 252 255 240 255 128 128 128 128 128
177 135 243 255 234 225 128 128 128 128 128
 80 129 211 255 194 224 128 128 128 128 128
  1   1 255 128 128 128 128 128 128 128 128
246   1 255 128 128 128 128 128 128 128 128
255 128 128 128 128 128 128 128 128 128 128
198  35 237 223 193 187 162 160 145 155  62
131  45 198 221 172 176 220 157 252 221   1
 68  47 146 208 149 167 221 162 255 223 128
  1 149 241 255 221 224 255 255 128 128 128
184 141 234 253 222 220 255 199 128 128 128
 81  99 181 242 176 190 249 202 255 255 128
  1 129 232 253 214 197 242 196 255 255 128
 99 121 210 250 201 198 255 202 128 128 128
 23  91 163 242 170 187 247 210 255 255 128
  1 200 246 255 234 255 128 128 128 128 128
109 178 241 255 231 245 255 255 128 128 128
 44 130 201 253 205 192 255 255 128 128 128
  1 132 239 251 219 209 255 165 128 128 128
 94 136 225 251 218 190 255 255 128 128 128
 22 100 174 245 186 161 255 199 128 128 128
  1 182 249 255 232 235 128 128 128 128 128
124 143 241 255 227 234 128 128 128 128 128
 35  77 181 251 193 211 255 205 128 128 128
  1 157 247 255 236 231 255 255 128 128 128
121 141 235 255 225 227 255 255 128 128 128
 45  99 188 251 195 217 255 224 128 128 128
  1   1 251 255 213 255 128 128 128 128 128
203   1 248 255 255 128 128 128 128 128 128
137   1 177 255 224 255 128 128 128 128 128
253   9 248 251 207 208 255 192 128 128 128
175  13 224 243 193 185 249 198 255 255 128
 73  17 171 221 161 179 236 167 255 234 128
  1  95 247 253 212 183 255 255 128 128 128
239  90 244 250 211 209 255 255 128 128 128
155  77 195 248 188 195 255 255 128 128 128
  1  24 239 251 218 219 255 205 128 128 128
201  51 219 255 196 186 128 128 128 128 128
 69  46 190 239 201 218 255 228 128 128 128
  1 191 251 255 255 128 128 128 128 128 128
223 165 249 255 213 255 128 128 128 128 128
141 124 248 255 255 128 128 128 128 128 128
  1  16 248 255 255 128 128 128 128 128 128
190  36 230 255 236 255 128 128 128 128 128
149   1 255 128 128 128 128 128 128 128 128
  1 226 255 128 128 128 128 128 128 128 128
247 192 255 128 128 128 128 128 128 128 128
240 128 255 128 128 128 128 128 128 128 128
  1 134 252 255 255 128 128 128 128 128 128
213  62 250 255 255 128 128 128 128 128 128
 55  93 255 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
202  24 213 235 186 191 220 160 240 175 255
126  38 182 232 169 184 228 174 255 187 128
 61  46 138 219 151 178 240 170 255 216 128
  1 112 230 250 199 191 247 159 255 255 128
166 109 228 252 211 215 255 174 128 128 128
 39  77 162 232 172 180 245 178 255 255 128
  1  52 220 246 198 199 249 220 255 255 128
124  74 191 243 183 193 250 221 255 255 128
 24  71 130 219 154 170 243 182 255 255 128
  1 182 225 249 219 240 255 224 128 128 128
149 150 226 252 216 205 255 171 128 128 128
 28 108 170 242 183 194 254 223 255 255 128
  1  81 230 252 204 203 255 192 128 128 128
123 102 209 247 188 196 255 233 128 128 128
 20  95 153 243 164 173 255 203 128 128 128
  1 222 248 255 216 213 128 128 128 128 128
168 175 246 252 235 205 255 255 128 128 128
 47 116 215 255 211 212 255 255 128 128 128
  1 121 236 253 212 214 255 255 128 128 128
141  84 213 252 201 202 255 219 128 128 128
 42  80 160 240 162 185 255 205 128 128 128
  1   1 255 128 128 128 128 128 128 128 128
244   1 255 128 128 128 128 128 128 128 128
238   1 255 128 128 128 128 128 128 128 128
""")

# RFC 6386 13.4: the probability that each token probability is updated
COEFF_UPDATE_PROBS = _table(4, 8, 3, 11, """
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
176 246 255 255 255 255 255 255 255 255 255
223 241 252 255 255 255 255 255 255 255 255
249 253 253 255 255 255 255 255 255 255 255
255 244 252 255 255 255 255 255 255 255 255
234 254 254 255 255 255 255 255 255 255 255
253 255 255 255 255 255 255 255 255 255 255
255 246 254 255 255 255 255 255 255 255 255
239 253 254 255 255 255 255 255 255 255 255
254 255 254 255 255 255 255 255 255 255 255
255 248 254 255 255 255 255 255 255 255 255
251 255 254 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255
251 254 254 255 255 255 255 255 255 255 255
254 255 254 255 255 255 255 255 255 255 255
255 254 253 255 254 255 255 255 255 255 255
250 255 254 255 254 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
217 255 255 255 255 255 255 255 255 255 255
225 252 241 253 255 255 254 255 255 255 255
234 250 241 250 253 255 253 254 255 255 255
255 254 255 255 255 255 255 255 255 255 255
223 254 254 255 255 255 255 255 255 255 255
238 253 254 254 255 255 255 255 255 255 255
255 248 254 255 255 255 255 255 255 255 255
249 254 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 255 255 255 255 255 255 255 255 255
247 254 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255
252 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 254 255 255 255 255 255 255 255 255
253 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 253 255 255 255 255 255 255 255 255
250 255 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
186 251 250 255 255 255 255 255 255 255 255
234 251 244 254 255 255 255 255 255 255 255
251 251 243 253 254 255 254 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255
236 253 254 255 255 255 255 255 255 255 255
251 253 253 254 254 255 255 255 255 255 255
255 254 254 255 255 255 255 255 255 255 255
254 254 254 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 255 255 255 255 255 255 255 255 255
254 254 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
248 255 255 255 255 255 255 255 255 255 255
250 254 252 254 255 255 255 255 255 255 255
248 254 249 253 255 255 255 255 255 255 255
255 253 253 255 255 255 255 255 255 255 255
246 253 253 255 255 255 255 255 255 255 255
252 254 251 254 254 255 255 255 255 255 255
255 254 252 255 255 255 255 255 255 255 255
248 254 253 255 255 255 255 255 255 255 255
253 255 254 254 255 255 255 255 255 255 255
255 251 254 255 255 255 255 255 255 255 255
245 251 254 255 255 255 255 255 255 255 255
253 253 254 255 255 255 255 255 255 255 255
255 251 253 255 255 255 255 255 255 255 255
252 253 254 255 255 255 255 255 255 255 255
255 254 255 255 255 255 255 255 255 255 255
255 252 255 255 255 255 255 255 255 255 255
249 255 254 255 255 255 255 255 255 255 255
255 255 254 255 255 255 255 255 255 255 255
255 255 253 255 255 255 255 255 255 255 255
250 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
""")

# RFC 6386 12.3 (kf_bmode_probs) in libwebp's mode order: [above][left][node]
BMODE_PROBS = _table(10, 10, 9, """
231 120  48  89 115 113 120 152 112  152 179  64 126 170 118  46  70  95
175  69 143  80  85  82  72 155 103   56  58  10 171 218 189  17  13 152
114  26  17 163  44 195  21  10 173  121  24  80 195  26  62  44  64  85
144  71  10  38 171 213 144  34  26  170  46  55  19 136 160  33 206  71
 63  20   8 114 114 208  12   9 226   81  40  11  96 182  84  29  16  36
134 183  89 137  98 101 106 165 148   72 187 100 130 157 111  32  75  80
 66 102 167  99  74  62  40 234 128   41  53   9 178 241 141  26   8 107
 74  43  26 146  73 166  49  23 157   65  38 105 160  51  52  31 115 128
104  79  12  27 217 255  87  17   7   87  68  71  44 114  51  15 186  23
 47  41  14 110 182 183  21  17 194   66  45  25 102 197 189  23  18  22
 88  88 147 150  42  46  45 196 205   43  97 183 117  85  38  35 179  61
 39  53 200  87  26  21  43 232 171   56  34  51 104 114 102  29  93  77
 39  28  85 171  58 165  90  98  64   34  22 116 206  23  34  43 166  73
107  54  32  26  51   1  81  43  31   68  25 106  22  64 171  36 225 114
 34  19  21 102 132 188  16  76 124   62  18  78  95  85  57  50  48  51
193 101  35 159 215 111  89  46 111   60 148  31 172 219 228  21  18 111
112 113  77  85 179 255  38 120 114   40  42   1 196 245 209  10  25 109
 88  43  29 140 166 213  37  43 154   61  63  30 155  67  45  68   1 209
100  80   8  43 154   1  51  26  71  142  78  78  16 255 128  34 197 171
 41  40   5 102 211 183   4   1 221   51  50  17 168 209 192  23  25  82
138  31  36 171  27 166  38  44 229   67  87  58 169  82 115  26  59 179
 63  59  90 180  59 166  93  73 154   40  40  21 116 143 209  34  39 175
 47  15  16 183  34 223  49  45 183   46  17  33 183   6  98  15  32 183
 57  46  22  24 128   1  54  17  37   65  32  73 115  28 128  23 128 205
 40   3   9 115  51 192  18   6 223   87  37   9 115  59  77  64  21  47
104  55  44 218   9  54  53 130 226   64  90  70 205  40  41  23  26  57
 54  57 112 184   5  41  38 166 213   30  34  26 133 152 116  10  32 134
 39  19  53 221  26 114  32  73 255   31   9  65 234   2  15   1 118  73
 75  32  12  51 192 255 160  43  51   88  31  35  67 102  85  55 186  85
 56  21  23 111  59 205  45  37 192   55  38  70 124  73 102   1  34  98
125  98  42  88 104  85 117 175  82   95  84  53  89 128 100 113 101  45
 75  79 123  47  51 128  81 171   1   57  17   5  71 102  57  53  41  49
 38  33  13 121  57  73  26   1  85   41  10  67 138  77 110  90  47 114
115  21   2  10 102 255 166  23   6  101  29  16  10  85 128 101 196  26
 57  18  10 102 102 213  34  20  43  117  20  15  36 163 128  68   1  26
102  61  71  37  34  53  31 243 192   69  60  71  38  73 119  28 222  37
 68  45 128  34   1  47  11 245 171   62  17  19  70 146  85  55  62  70
 37  43  37 154 100 163  85 160   1   63   9  92 136  28  64  32 201  85
 75  15   9   9  64 255 184 119  16   86   6  28   5  64 255  25 248   1
 56   8  17 132 137 255  55 116 128   58  15  20  82 135  57  26 121  40
164  50  31 137 154 133  25  35 218   51 103  44 131 131 123  31   6 158
 86  40  64 135 148 224  45 183 128   22  26  17 131 240 154  14   1 209
 45  16  21  91  64 222   7   1 197   56  21  39 155  60 138  23 102 213
 83  12  13  54 192 255  68  47  28   85  26  85  85 128 128  32 146 171
 18  11   7  63 144 171   4   4 246   35  27  10 146 174 171  12  26 128
190  80  35  99 180  80 126  54  45   85 126  47  87 176  51  41  20  32
101  75 128 139 118 146 116 128  85   56  41  15 176 236  85  37   9  62
 71  30  17 119 118 255  17  18 138  101  38  60 138  55  70  43  26 142
146  36  19  30 171 255  97  27  20  138  45  61  62 219   1  81 188  64
 32  41  20 117 151 142  20  21 163  112  19  12  61 195 128  48   4  24
""")

# RFC 6386 14.1: quantizer step of each index, DC and AC
DC_TABLE = (
      4,   5,   6,   7,   8,   9,  10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
     18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
     29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
     44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
     59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
     75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
     91,  93,  95,  96,  98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
)
AC_TABLE = (
      4,   5,   6,   7,   8,   9,  10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
     20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
     36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
     52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
     78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
)

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # and a sentinel for n = 16
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))

# intra modes in libwebp's order: the 16x16 and chroma modes are DC, TM, V, H
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# RFC 6386 11.2's bmode_tree: node i reads with probability i, a leaf is -mode
BMODE_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7,
              -B_VL, 8, -B_HD, -B_HU)

_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]  # shifts to bring a range to 128+


_MASK64 = (1 << 64) - 1


class _Bool:
    """libwebp's boolean decoder over one partition: ``range`` holds the
    range less 1, ``bits`` the bits of ``value`` below its top 8, bytes
    loaded 7 at a time while 8 remain, then one at a time; ``eof`` is set
    when a bit is wanted past the end (zeros are read there). ``value`` is
    64 bits and its window 32, as in libwebp: a partition that starts at
    0xff leaves the value above the range, and libwebp's then wraps."""

    __slots__ = ("buf", "pos", "end", "value", "bits", "range", "eof")

    def __init__(self, buf: bytes, start: int, size: int):
        self.buf, self.pos, self.end = buf, start, start + size
        self.value, self.bits, self.range, self.eof = 0, -8, 254, False
        self._load()

    def _load(self):
        if self.pos + 8 <= self.end:
            new = int.from_bytes(self.buf[self.pos:self.pos + 7], "big")
            self.value = ((self.value << 56) | new) & _MASK64
            self.bits += 56
            self.pos += 7
        elif self.pos < self.end:
            self.value = ((self.value << 8) | self.buf[self.pos]) & _MASK64
            self.bits += 8
            self.pos += 1
        elif not self.eof:
            self.value = (self.value << 8) & _MASK64
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng = self.range
        split = (rng * prob) >> 8
        pos = self.bits
        if ((self.value >> pos) & 0xFFFFFFFF) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = _NORM[rng]
        self.range = (rng << shift) - 1
        self.bits = pos - shift
        return bit

    def sign(self, v: int) -> int:
        """libwebp's ``VP8GetSigned``: v or -v, an even split taken by the
        sign of the 32-bit ``split - value`` and always one shift; the same
        as ``get(0x80)`` while the value stays below the range."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        negative = ((split - ((self.value >> pos) & 0xFFFFFFFF)) & 0xFFFFFFFF) >= 1 << 31
        self.bits = pos - 1
        if negative:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.get(0x80) << n
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(0x80) else v


class _Header:
    """The frame header and the first partition's header fields."""

    def __init__(self, data: bytes):
        self.width, self.height, first_size = vp8_info(data)
        if first_size > len(data) - 10:
            raise ValueError("VP8 frame: its first partition runs past the data")
        self.mb_w, self.mb_h = (self.width + 15) >> 4, (self.height + 15) >> 4
        br = self.br = _Bool(data, 10, first_size)
        self.colorspace, self.clamp_type = br.get(0x80), br.get(0x80)
        # segmentation
        self.use_segment = br.get(0x80)
        self.update_map, self.absolute, self.seg_quant, self.seg_filter = 0, 1, [0] * 4, [0] * 4
        self.seg_probs = [255, 255, 255]
        if self.use_segment:
            self.update_map = br.get(0x80)
            if br.get(0x80):
                self.absolute = br.get(0x80)
                self.seg_quant = [br.signed(7) if br.get(0x80) else 0 for _ in range(4)]
                self.seg_filter = [br.signed(6) if br.get(0x80) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.value_bits(8) if br.get(0x80) else 255 for _ in range(3)]
        if br.eof:
            raise ValueError("VP8 frame: cannot parse its segment header")
        # loop filter
        self.simple, self.level, self.sharpness = br.get(0x80), br.value_bits(6), br.value_bits(3)
        self.use_lf_delta = br.get(0x80)
        self.ref_lf_delta, self.mode_lf_delta = [0] * 4, [0] * 4
        if self.use_lf_delta and br.get(0x80):
            for deltas in (self.ref_lf_delta, self.mode_lf_delta):
                for i in range(4):
                    if br.get(0x80):
                        deltas[i] = br.signed(6)
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        if br.eof:
            raise ValueError("VP8 frame: cannot parse its filter header")
        # token partitions: their sizes follow the first partition
        n_parts = 1 << br.value_bits(2)
        start = 10 + first_size
        size_left = len(data) - start
        if size_left < 3 * (n_parts - 1):
            raise ValueError("VP8 frame: its partition sizes run past the data")
        part_start = start + 3 * (n_parts - 1)
        size_left -= 3 * (n_parts - 1)
        self.parts: List[_Bool] = []
        for p in range(n_parts - 1):
            psize = min(int.from_bytes(data[start + 3 * p:start + 3 * p + 3], "little"), size_left)
            self.parts.append(_Bool(data, part_start, psize))
            part_start += psize
            size_left -= psize
        self.parts.append(_Bool(data, part_start, size_left))
        if size_left <= 0:
            raise ValueError("VP8 frame: its last token partition is empty")
        # quantizers
        base_q = br.value_bits(7)
        dq = [br.signed(4) if br.get(0x80) else 0 for _ in range(5)]
        self.quant = [_segment_quant(self.seg_quant[s] + (0 if self.absolute else base_q)
                                     if self.use_segment else base_q, dq) for s in range(4)]
        br.get(0x80)  # refresh_entropy_probs: one frame, ignored
        self.coeff_probs = [[[[br.value_bits(8) if br.get(COEFF_UPDATE_PROBS[t][b][c][p])
                               else COEFF_PROBS[t][b][c][p] for p in range(11)]
                              for c in range(3)] for b in range(8)] for t in range(4)]
        self.use_skip = br.get(0x80)
        self.skip_prob = br.value_bits(8) if self.use_skip else 0


def _segment_quant(q: int, dq: List[int]) -> Tuple[int, ...]:
    """(y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac) steps for quantizer index
    q and the deltas (y1 dc, y2 dc, y2 ac, uv dc, uv ac)."""
    def clip(v, m):
        return 0 if v < 0 else m if v > m else v
    y2_ac = (AC_TABLE[clip(q + dq[2], 127)] * 101581) >> 16  # x * 155 / 100
    return (DC_TABLE[clip(q + dq[0], 127)], AC_TABLE[clip(q, 127)],
            DC_TABLE[clip(q + dq[1], 127)] * 2, max(y2_ac, 8),
            DC_TABLE[clip(q + dq[3], 117)], AC_TABLE[clip(q + dq[4], 127)])


def vp8_info(data: bytes, chunk_size: Optional[int] = None) -> Tuple[int, int, int]:
    """(width, height, first partition size) of a ``VP8 `` payload, checked
    as libwebp's ``VP8GetInfo`` checks it against the chunk's size."""
    if len(data) < 10:
        raise ValueError("VP8 frame shorter than its 10-byte header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bytes(data[3:6]) != b"\x9d\x01\x2a":
        raise ValueError("VP8 frame without its start code")
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"VP8 frame of profile {(bits >> 1) & 7} (0 to 3)")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame is not shown")
    if bits >> 5 >= (len(data) if chunk_size is None else chunk_size):
        raise ValueError("VP8 frame: its first partition is not smaller than its chunk")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError(f"VP8 frame of size {w}x{h}")
    return w, h, bits >> 5


def _parse_modes(hdr: _Header):
    """Partition 0 after the header: each macroblock's (segment, skip,
    is_4x4, modes, chroma mode), modes a list of 16 for 4x4 blocks."""
    get = hdr.br.get
    sp = hdr.seg_probs
    top = [B_DC] * (4 * hdr.mb_w)
    mbs = []
    for _ in range(hdr.mb_h):
        left = [B_DC] * 4
        for mb_x in range(hdr.mb_w):
            seg = (get(sp[2]) + 2 if get(sp[0]) else get(sp[1])) if hdr.update_map else 0
            skip = get(hdr.skip_prob) if hdr.use_skip else 0
            if get(145):  # 16x16
                ymode = (TM_PRED if get(128) else H_PRED) if get(156) else \
                    (V_PRED if get(163) else DC_PRED)
                top[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                left = [ymode] * 4
                modes, is4 = ymode, 0
            else:
                modes, is4 = [], 1
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        prob = BMODE_PROBS[top[4 * mb_x + x]][ymode]
                        i = BMODE_TREE[get(prob[0])]
                        while i > 0:
                            i = BMODE_TREE[2 * i + get(prob[i])]
                        ymode = -i
                        top[4 * mb_x + x] = ymode
                    modes += top[4 * mb_x:4 * mb_x + 4]
                    left[y] = ymode
            uv = DC_PRED if not get(142) else V_PRED if not get(114) else \
                TM_PRED if get(183) else H_PRED
            mbs.append((seg, skip, is4, modes, uv))
    if hdr.br.eof:
        raise ValueError("VP8 frame: premature end of its first partition")
    return mbs


def _coeffs(get, sign, probs, ctx, dq0, dq1, n, base, idx, val):
    """One block's tokens from position n -> the position after its last
    token; each coefficient's index (base + zigzag) and dequantized value
    appended."""
    p = probs[n][ctx]
    while n < 16:
        if not get(p[0]):
            return n  # end of block
        while not get(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        if not get(p[2]):
            v = 1
            p = probs[n + 1][1]
        else:
            if not get(p[3]):
                v = 2 if not get(p[4]) else 3 + get(p[5])
            elif not get(p[6]):
                if not get(p[7]):
                    v = 5 + get(159)
                else:
                    v = 7 + 2 * get(165)
                    v += get(145)
            else:
                bit1 = get(p[8])
                cat = 2 * bit1 + get(p[9 + bit1])
                v = 0
                for q in CAT_PROBS[cat]:
                    v += v + get(q)
                v += 3 + (8 << cat)
            p = probs[n + 1][2]
        idx.append(base + ZIGZAG[n])
        val.append(sign(v) * (dq1 if n else dq0))
        n += 1
    return 16


def _parse_tokens(hdr: _Header, mbs):
    """Every macroblock's tokens -> (coefficients (n_mb, 25, 16) int16, the
    block slot 24 holding Y2; each block's count of positions read
    (n_mb, 24))."""
    mb_w, n_mb = hdr.mb_w, len(mbs)
    # probs[type][n][ctx]: the band of each position, with the sentinel
    probs = [[hdr.coeff_probs[t][BANDS[n]] for n in range(17)] for t in range(4)]
    idx: List[int] = []
    val: List[int] = []
    nzs = [0] * (24 * n_mb)
    top_nz, top_dc = [0] * mb_w, [0] * mb_w
    parts = hdr.parts
    for mb_y in range(hdr.mb_h):
        part = parts[mb_y & (len(parts) - 1)]
        get, sign = part.get, part.sign
        left_nz = left_dc = 0
        for mb_x in range(mb_w):
            m = mb_y * mb_w + mb_x
            seg, skip, is4, _, _ = mbs[m]
            if skip:
                top_nz[mb_x] = left_nz = 0
                if not is4:
                    top_dc[mb_x] = left_dc = 0
                continue
            q = hdr.quant[seg]
            base = 400 * m
            if not is4:
                nz = _coeffs(get, sign, probs[1], top_dc[mb_x] + left_dc, q[2], q[3], 0, base + 384,
                             idx, val)
                top_dc[mb_x] = left_dc = int(nz > 0)
                first, ac = 1, probs[0]
            else:
                first, ac = 0, probs[3]
            tnz, lnz = top_nz[mb_x] & 0x0F, left_nz & 0x0F
            for y in range(4):
                lbit = lnz & 1
                for x in range(4):
                    b = 4 * y + x
                    nz = _coeffs(get, sign, ac, lbit + (tnz & 1), q[0], q[1], first, base + 16 * b,
                                 idx, val)
                    nzs[24 * m + b] = nz
                    lbit = int(nz > first)
                    tnz = (tnz >> 1) | (lbit << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lbit << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mb_x] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    lbit = lnz & 1
                    for x in range(2):
                        b = 16 + 2 * ch + 2 * y + x
                        nz = _coeffs(get, sign, probs[2], lbit + (tnz & 1), q[4], q[5], 0,
                                     base + 16 * b, idx, val)
                        nzs[24 * m + b] = nz
                        lbit = int(nz > 0)
                        tnz = (tnz >> 1) | (lbit << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lbit << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mb_x], left_nz = out_t, out_l
    if any(parts[y & (len(parts) - 1)].eof for y in range(hdr.mb_h)):  # the partitions read
        raise ValueError("VP8 frame: premature end of a token partition")
    coeffs = np.zeros(400 * n_mb, np.int16)
    if idx:
        coeffs[np.array(idx, np.int64)] = np.array(val, np.int64).astype(np.int16)  # int16 wraps
    return coeffs.reshape(n_mb, 25, 16), np.array(nzs, np.int64).reshape(n_mb, 24)


def _inverse_wht(c: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformWHT``: (n, 16) Y2 coefficients -> (n, 16) DCs
    of the 16 luma blocks, in raster order."""
    x = c.astype(np.int32).reshape(-1, 4, 4)
    a0, a1 = x[:, 0] + x[:, 3], x[:, 1] + x[:, 2]
    a2, a3 = x[:, 1] - x[:, 2], x[:, 0] - x[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)  # t[:, k, i]
    dc = t[:, :, 0] + 3
    b0, b1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], axis=2)
    return out.reshape(-1, 16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _inverse_dct(c: np.ndarray, lanes16: bool = False) -> np.ndarray:
    """libwebp's ``TransformOne``: (..., 16) coefficients -> (..., 4, 4) the
    residual each adds to its prediction (its ``>> 3`` applied). With
    ``lanes16``, its SSE2 form, which keeps each pass in wrapping 16-bit
    lanes: the two agree on any coefficients a sound stream gives, and
    part on the huge ones a damaged stream can."""
    x = c.astype(np.int32).reshape(c.shape[:-1] + (4, 4))  # [row][column]

    def lane(v):
        return v.astype(np.int16).astype(np.int32) if lanes16 else v

    r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    a, b = r0 + r2, r0 - r2
    cc, d = _mul2(r1) - _mul1(r3), _mul1(r1) + _mul2(r3)
    v = [lane(a + d), lane(b + cc), lane(b - cc), lane(a - d)]  # v[k][..., column]
    out = []
    for k in range(4):
        t = v[k]
        dc = t[..., 0] + 4
        a, b = dc + t[..., 2], dc - t[..., 2]
        cc, d = _mul2(t[..., 1]) - _mul1(t[..., 3]), _mul1(t[..., 1]) + _mul2(t[..., 3])
        out.append(np.stack([lane(a + d) >> 3, lane(b + cc) >> 3, lane(b - cc) >> 3,
                             lane(a - d) >> 3], -1))
    return np.stack(out, axis=-2)


def _residual_planes(hdr: _Header, mbs, coeffs: np.ndarray, nzs: np.ndarray):
    """The residual of every pixel: (Y, U, V) int32 planes of whole
    macroblocks. libwebp picks a block's transform by the position after
    its last token (``nz``): past 3 the SSE2 one, else the C ones (DC only,
    or the first three coefficients; none for a block of zeros); a chroma
    plane of a macroblock takes the SSE2 one for all four blocks once any
    of them is past 1."""
    i16 = np.array([not m[2] and not m[1] for m in mbs])
    if i16.any():
        coeffs[i16, :16, 0] = _inverse_wht(coeffs[i16, 24]).astype(np.int16)
    c = coeffs[:, :24]
    code = np.where(nzs > 3, 3, np.where(nzs > 1, 2, (c[..., 0] != 0).astype(np.int64)))
    sse2 = code == 3
    sse2[:, 16:] = np.repeat((code[:, 16:].reshape(-1, 2, 4) >= 2).any(axis=2), 4, axis=1)
    res = np.where(sse2[..., None, None], _inverse_dct(c, lanes16=True), _inverse_dct(c))
    res[(code == 0) & ~sse2] = 0
    mh, mw = hdr.mb_h, hdr.mb_w
    y = res[:, :16].reshape(mh, mw, 4, 4, 4, 4).transpose(0, 2, 4, 1, 3, 5)
    u = res[:, 16:20].reshape(mh, mw, 2, 2, 4, 4).transpose(0, 2, 4, 1, 3, 5)
    v = res[:, 20:24].reshape(mh, mw, 2, 2, 4, 4).transpose(0, 2, 4, 1, 3, 5)
    return (y.reshape(16 * mh, 16 * mw), u.reshape(8 * mh, 8 * mw), v.reshape(8 * mh, 8 * mw))


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _predict4(mode, A, B, C, D, E, F, G, H, I, J, K, L, X):
    """A 4x4 block's prediction, 16 values row by row, from the 8 pixels
    above (A-H, the last 4 above-right), the 4 to the left (I-L) and the
    one above-left (X)."""
    if mode == B_DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == B_TM:
        return [min(255, max(0, t + left - X)) for left in (I, J, K, L) for t in (A, B, C, D)]
    if mode == B_VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == B_HE:
        return [_avg3(X, I, J)] * 4 + [_avg3(I, J, K)] * 4 + [_avg3(J, K, L)] * 4 \
            + [_avg3(K, L, L)] * 4
    if mode == B_RD:
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X),
             _avg3(C, B, A), _avg3(D, C, B)]  # along the down-right diagonals
        return [e[3 - y + x] for y in range(4) for x in range(4)]
    if mode == B_VR:
        return [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D),
                _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C),
                _avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
    if mode == B_LD:
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G),
             _avg3(F, G, H), _avg3(G, H, H)]
        return [e[x + y] for y in range(4) for x in range(4)]
    if mode == B_VL:
        return [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E),
                _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G),
                _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]
    if mode == B_HD:
        return [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A),
                _avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X),
                _avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    # B_HU
    return [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L),
            _avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L),
            _avg2(K, L), _avg3(K, L, L), L, L,
            L, L, L, L]


def _predict_block(mode, top, left, corner, size, mb_x, mb_y):
    """A 16x16 luma or 8x8 chroma prediction (numpy int32) from its border:
    DC averages only the sides that exist, TM and the others take the 127
    and 129 borders as they are."""
    if mode == DC_PRED:
        shift = 4 if size == 16 else 3
        if mb_x and mb_y:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif mb_y:  # the left column: no left
            dc = (int(top.sum()) + size // 2) >> shift
        elif mb_x:  # the top row: no top
            dc = (int(left.sum()) + size // 2) >> shift
        else:
            dc = 128
        return np.full((size, size), dc, np.int32)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - corner, 0, 255)


def _reconstruct(hdr: _Header, mbs, res):
    """Predict every macroblock in raster order from the reconstruction so
    far (unfiltered) and add its residual -> (Y, U, V) uint8 planes of
    whole macroblocks."""
    mh, mw = hdr.mb_h, hdr.mb_w
    ry, ru, rv = res
    Y = np.zeros((16 * mh, 16 * mw), np.int32)
    U = np.zeros((8 * mh, 8 * mw), np.int32)
    V = np.zeros((8 * mh, 8 * mw), np.int32)
    border_top = np.full(20, 127, np.int32)
    border_left16, border_left8 = np.full(16, 129, np.int32), np.full(8, 129, np.int32)
    for mb_y in range(mh):
        y0 = 16 * mb_y
        for mb_x in range(mw):
            _, _, is4, modes, uvmode = mbs[mb_y * mw + mb_x]
            x0 = 16 * mb_x
            if mb_y:
                top = Y[y0 - 1, x0:x0 + 20] if mb_x < mw - 1 else \
                    np.concatenate([Y[y0 - 1, x0:x0 + 16], np.full(4, Y[y0 - 1, x0 + 15])])
                corner = int(Y[y0 - 1, x0 - 1]) if mb_x else 129
            else:
                top, corner = border_top, 127
            left = Y[y0:y0 + 16, x0 - 1] if mb_x else border_left16
            if not is4:
                pred = _predict_block(modes, top[:16], left, corner, 16, mb_x, mb_y)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + ry[y0:y0 + 16, x0:x0 + 16], 0, 255)
            else:
                Y[y0:y0 + 16, x0:x0 + 16] = _reconstruct4(
                    modes, top.tolist(), left.tolist(), corner,
                    ry[y0:y0 + 16, x0:x0 + 16].tolist())
            c0, cx = 8 * mb_y, 8 * mb_x
            for P, R in ((U, ru), (V, rv)):
                ctop = P[c0 - 1, cx:cx + 8] if mb_y else border_top[:8]
                cleft = P[c0:c0 + 8, cx - 1] if mb_x else border_left8
                ccorner = 127 if not mb_y else int(P[c0 - 1, cx - 1]) if mb_x else 129
                pred = _predict_block(uvmode, ctop, cleft, ccorner, 8, mb_x, mb_y)
                P[c0:c0 + 8, cx:cx + 8] = np.clip(pred + R[c0:c0 + 8, cx:cx + 8], 0, 255)
    return Y, U, V


def _reconstruct4(modes, top, left, corner, res):
    """A macroblock of 4x4 blocks in raster order, each predicted from the
    reconstructed pixels around it: the work area is 17 rows of 21, the
    border in row 0 and column 0, the above-right pixels of the right
    column's blocks repeated from the macroblock's own."""
    ws = [[corner] + top] + [[left[r]] + [0] * 20 for r in range(16)]
    for r in (4, 8, 12):
        ws[r][17:21] = top[16:20]
    for n in range(16):
        by, bx = n >> 2, n & 3
        r0, c0 = 4 * by, 4 * bx
        above = ws[r0][c0 + 1:c0 + 9]
        pred = _predict4(modes[n], *above, ws[r0 + 1][c0], ws[r0 + 2][c0], ws[r0 + 3][c0],
                         ws[r0 + 4][c0], ws[r0][c0])
        for y in range(4):
            row, rr = ws[r0 + 1 + y], res[r0 + y]
            for x in range(4):
                v = pred[4 * y + x] + rr[c0 + x]
                row[c0 + 1 + x] = 0 if v < 0 else 255 if v > 255 else v
    return np.array([row[1:17] for row in ws[1:]], np.int32)


def _filter_strengths(hdr: _Header):
    """libwebp's ``PrecomputeFilterStrengths``: for each segment and
    is_4x4, (limit, interior limit, hev threshold); limit 0 filters
    nothing."""
    out = {}
    for s in range(4):
        base = hdr.level
        if hdr.use_segment:
            base = hdr.seg_filter[s] + (0 if hdr.absolute else hdr.level)
        for is4 in (0, 1):
            level = base
            if hdr.use_lf_delta:
                level += hdr.ref_lf_delta[0] + (hdr.mode_lf_delta[0] if is4 else 0)
            level = min(63, max(0, level))
            if level == 0:
                out[s, is4] = (0, 0, 0)
                continue
            ilevel = level
            if hdr.sharpness:
                ilevel >>= 2 if hdr.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - hdr.sharpness)
            ilevel = max(ilevel, 1)
            hev = 2 if level >= 40 else 1 if level >= 15 else 0
            out[s, is4] = (2 * level + ilevel, ilevel, hev)
    return out


_OFF = np.arange(-4, 4)


def _filter_edges(P, rows, cols, across_columns, thresh, ithresh, hev_t, kind):
    """Filter one edge of each of a set of macroblocks, 16 (or 8) lines an
    edge: ``rows``/``cols`` (n,) are each line's first pixel past the edge
    (q0), the edge between columns when ``across_columns``; ``thresh``,
    ``ithresh``, ``hev_t`` (n,) per line. ``kind``: "simple", "inner" (2 or
    4 taps) or "edge" (2 or 6 taps)."""
    if across_columns:
        R, C = rows[:, None], cols[:, None] + _OFF
    else:
        R, C = rows[:, None] + _OFF, cols[:, None]
    L = P[R, C]
    p3, p2, p1, p0, q0, q1, q2, q3 = (L[:, k] for k in range(8))
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    if kind == "simple":
        hev = np.ones_like(need)
    else:
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    if not need.any():
        return
    out = L.copy()
    f2 = need & hev  # DoFilter2: the outer taps too, p0 and q0 change
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    out[f2, 3] = np.clip(p0 + a2, 0, 255)[f2]
    out[f2, 4] = np.clip(q0 - a1, 0, 255)[f2]
    rest = need & ~hev
    if kind == "inner":  # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for k, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            out[rest, k] = np.clip(v, 0, 255)[rest]
    elif kind == "edge":  # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for k, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                     (6, q2 - a3)):
            out[rest, k] = np.clip(v, 0, 255)[rest]
    P[R, C] = out


def _loop_filter(hdr: _Header, mbs, nzs, coeffs, planes):
    """The loop filter over the reconstructed planes, in place. A
    macroblock's filters read and write only it and the 4 pixels left of
    and above it, and it must follow its left, top and top-right
    neighbours: the macroblocks with the same x + 2y are filtered at once,
    each edge in libwebp's order (left, inner columns, top, inner rows)."""
    if hdr.filter_type == 0:
        return
    Y, U, V = planes
    mh, mw = hdr.mb_h, hdr.mb_w
    strengths = _filter_strengths(hdr)
    # f_inner: a 4x4 macroblock, or one with coefficients
    coded = ((nzs > 1) | (coeffs[:, :24, 0] != 0)).any(axis=1)
    params = np.array([strengths[m[0], m[2]] + (int(m[2] or coded[i]),)
                       for i, m in enumerate(mbs)], np.int64).reshape(mh, mw, 4)
    simple = hdr.filter_type == 1
    kinds = ("simple", "simple") if simple else ("edge", "inner")
    sized = [(16, Y)] if simple else [(16, Y), (8, U), (8, V)]
    for t in range(mw + 2 * (mh - 1)):
        ys = np.arange(max(0, (t - mw + 2) // 2), min(mh - 1, t // 2) + 1)
        xs = t - 2 * ys
        prm = params[ys, xs]
        on = prm[:, 0] > 0
        if on.any():
            for size, P in sized:
                _filter_front(P, size, ys[on], xs[on], prm[on], kinds)


def _filter_front(P, size, ys, xs, prm, kinds):
    """The edges of a front of macroblocks (``size`` pixels a side) in
    one plane: left, inner columns, top, inner rows."""
    limit, ilevel, hev_t, inner = prm.T
    kind_edge, kind_inner = kinds

    def run(sel, rows, cols, across, thresh, kind):
        if sel.any():
            _filter_edges(P, rows[sel].ravel(), cols[sel].ravel(), across,
                          np.repeat(thresh[sel], size), np.repeat(ilevel[sel], size),
                          np.repeat(hev_t[sel], size), kind)

    lines = np.arange(size)
    y0, x0 = ys * size, xs * size
    rows, cols = y0[:, None] + lines, x0[:, None] + lines  # each line across the edges

    def at(v):
        return np.repeat(v[:, None], size, 1)

    run(xs > 0, rows, at(x0), True, limit + 4, kind_edge)
    for k in range(4, size, 4):
        run(inner > 0, rows, at(x0 + k), True, limit, kind_inner)
    run(ys > 0, at(y0), cols, False, limit + 4, kind_edge)
    for k in range(4, size, 4):
        run(inner > 0, at(y0 + k), cols, False, limit, kind_inner)


def decode_vp8(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A ``VP8 `` chunk's payload -> the frame's (Y (h, w), U, V ((h + 1) // 2,
    (w + 1) // 2)) uint8 planes, loop-filtered."""
    data = bytes(data)
    hdr = _Header(data)
    mbs = _parse_modes(hdr)
    coeffs, nzs = _parse_tokens(hdr, mbs)
    planes = _reconstruct(hdr, mbs, _residual_planes(hdr, mbs, coeffs, nzs))
    _loop_filter(hdr, mbs, nzs, coeffs, planes)
    w, h = hdr.width, hdr.height
    Y, U, V = planes
    uw, uh = (w + 1) // 2, (h + 1) // 2
    return (Y[:h, :w].astype(np.uint8), U[:uh, :uw].astype(np.uint8),
            V[:uh, :uw].astype(np.uint8))


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler for one chroma plane -> (h, w) int32: each
    output pixel weighs its nearest chroma sample 9, the two next 3 and the
    far one 1, as the C code rounds it in two steps."""
    c = c.astype(np.int32)
    ch, cw = c.shape
    r = np.arange(h)
    near = c[r // 2]
    far = c[np.clip(r // 2 + np.where(r & 1, 1, -1), 0, ch - 1)]
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = near[:, :pairs], near[:, 1:pairs + 1], far[:, :pairs], far[:, 1:pairs + 1]
        s = n0 + n1 + f0 + f1 + 8
        out[:, 1:2 * pairs:2] = (((s + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((s + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * near[:, pairs] + far[:, pairs] + 2) >> 2
    return out


def yuv_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """4:2:0 planes -> (h, w, 3) uint8 RGB: fancy upsampling, then
    ``dsp/yuv.h``'s 14-bit fixed point (``MultHi`` keeps 8 bits of each
    product, the sum is clipped and shifted by 6)."""
    h, w = Y.shape
    y = Y.astype(np.int32)
    u, v = _upsample(U, h, w), _upsample(V, h, w)
    yy = (y * 19077) >> 8
    rgb = np.empty((h, w, 3), np.uint8)
    rgb[..., 0] = np.clip((yy + ((v * 26149) >> 8) - 14234) >> 6, 0, 255)
    rgb[..., 1] = np.clip((yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708) >> 6, 0, 255)
    rgb[..., 2] = np.clip((yy + ((u * 33050) >> 8) - 17685) >> 6, 0, 255)
    return rgb
