"""The plain JPEG decoder and encoder: numpy and Python, no library.

The same stages as ``csrc/jpeg.cpp`` (see ``jpeg.py``), written a second
time for holding the library to: the Huffman coding in Python, the IDCT,
FDCT, sampling and colour conversion vectorised in numpy over all blocks.
Its output equals the library's (and PIL's) bit for bit.  It is slow, so
it is for small images: the tests and ``chip_smoke.py`` use it, the port's
readers do not.
"""

from __future__ import annotations

import re

import numpy as np

# zigzag position -> natural (row-major) position
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jidctint.c / jfdctint.c constants (CONST_BITS 13, PASS1_BITS 2)
CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172

LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.full(64, 99)
CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# jstdhuff.c: (counts of codes of length 1..16, symbols)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
           bytes.fromhex(
    '01020300041105122131410613516107227114328191a1082342b1c11552d1f024'
    '33627282090a161718191a25262728292a3435363738393a434445464748494a53'
    '5455565758595a636465666768696a737475767778797a838485868788898a9293'
    '9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9'
    'cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa'))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             bytes.fromhex(
    '000102031104052131061241510761711322328108144291a1b1c109233352f015'
    '6272d10a162434e125f11718191a262728292a35363738393a434445464748494a'
    '535455565758595a636465666768696a737475767778797a828384858687888'
    '98a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
    'c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa'))


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _codes(counts, symbols) -> dict:
    """Canonical Huffman codes: symbol -> bit string; raises on a table
    that jdhuff.c refuses (a code of all ones)."""
    codes, code, k = {}, 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            codes[symbols[k]] = format(code, f'0{length}b')
            code += 1
            k += 1
        if code >= 1 << length:
            raise ValueError('corrupt JPEG data: bad Huffman table')
        code <<= 1
    return codes


# ------------------------------------------------------------------- IDCT
def _idct_1d(p):
    """jidctint.c's 1-D pass on p[0..7] (arrays): the 8 outputs before
    descaling."""
    z1 = (p[2] + p[6]) * F_0_541
    tmp2 = z1 + p[6] * -F_1_847
    tmp3 = z1 + p[2] * F_0_765
    tmp0 = (p[0] + p[4]) << CONST_BITS
    tmp1 = (p[0] - p[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = p[7], p[5], p[3], p[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1, t2, t3 = t0 * F_0_298, t1 * F_2_053, t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) uint8 samples, with
    jdmaster.c's range limit (the low 10 bits as a signed value, + 128,
    clamped)."""
    x = coef.astype(np.int64)
    cols = _idct_1d([x[:, k, :] for k in range(8)])
    ws = np.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], 1)
    ws = ws.astype(np.int32).astype(np.int64)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(v, CONST_BITS + PASS1_BITS + 3) for v in rows],
                   2)
    v = out & 1023
    v = np.where(v >= 512, v - 1024, v) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- decoder
class _Bits:
    """The entropy-coded bits of one restart interval: stuffing removed,
    as a string of '0' and '1'."""

    def __init__(self, data: bytes):
        raw = np.frombuffer(re.sub(rb'\xff+\x00', b'\xff', data), np.uint8)
        self.bits = ''.join(format(b, '08b') for b in raw.tolist())
        self.pos = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > len(self.bits):
            raise ValueError('truncated or corrupt JPEG data')
        v = int(self.bits[self.pos:self.pos + n], 2)
        self.pos += n
        return v

    def decode(self, table: dict) -> int:
        for n in range(1, 17):
            sym = table.get(self.bits[self.pos:self.pos + n])
            if sym is not None and self.pos + n <= len(self.bits):
                self.pos += n
                return sym
        if self.pos + 16 > len(self.bits):
            raise ValueError('truncated or corrupt JPEG data')
        raise ValueError('corrupt JPEG data: bad Huffman code')


def _extend(v: int, t: int) -> int:
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


def _entropy(data: bytes, pos: int):
    """The entropy-coded segment from ``pos``: its bytes up to the next
    marker that is not a restart marker, split at the restart markers,
    and the position of that marker."""
    parts, start = [], pos
    while True:
        i = data.find(b'\xff', pos)
        if i < 0 or i + 1 >= len(data):
            parts.append(data[start:])
            return parts, len(data)
        j = i + 1
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            parts.append(data[start:])
            return parts, len(data)
        if data[j] == 0:
            pos = j + 1
            continue
        if 0xD0 <= data[j] <= 0xD7:
            parts.append(data[start:i])
            start = pos = j + 1
            continue
        parts.append(data[start:i])
        return parts, j - 1


class _Component:
    def __init__(self, ident, h, v, tq):
        self.id, self.h, self.v, self.tq = ident, h, v, tq
        self.qt = None
        self.coef_bits = [-1] * 64
        self.dc_tbl = self.ac_tbl = 0


REFUSED = {
    0xC3: 'lossless JPEG is not supported',
    0xDC: 'JPEG DNL marker (height after the scan) is not supported',
    **{m: 'hierarchical (differential) JPEG is not supported'
       for m in (0xC5, 0xC6, 0xC7, 0xDE, 0xDF)},
    **{m: 'arithmetic-coded JPEG is not supported' for m in range(0xC9, 0xD0)},
}


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = {}
        self.dc, self.ac = {}, {}
        self.restart_interval = 0
        self.jfif = self.adobe = False
        self.adobe_transform = -1
        self.comps = None
        self.progressive = False
        self.scanned = False

    def byte(self, pos):
        if pos >= len(self.data):
            raise ValueError('truncated JPEG data')
        return self.data[pos]

    def next_marker(self, pos):
        while True:
            if self.byte(pos) != 0xFF:
                pos += 1
                continue
            pos += 1
            while self.byte(pos) == 0xFF:
                pos += 1
            if self.byte(pos) != 0:
                return self.data[pos], pos + 1
            pos += 1

    def body(self, pos):
        if pos + 2 > len(self.data):
            raise ValueError('truncated JPEG data')
        length = int.from_bytes(self.data[pos:pos + 2], 'big')
        if length < 2:
            raise ValueError('corrupt JPEG data: bad segment length')
        if pos + length > len(self.data):
            raise ValueError('truncated JPEG data')
        return self.data[pos + 2:pos + length], pos + length

    def run(self) -> np.ndarray:
        data = self.data
        if data[:2] != b'\xff\xd8':
            raise ValueError('not a JPEG file')
        pos = 2
        while True:
            marker, pos = self.next_marker(pos)
            if marker == 0xD9:
                break
            if self.comps is None and marker in (0xDA, 0xD9):
                raise ValueError('corrupt JPEG data: no frame header')
            if marker in REFUSED:
                raise ValueError(REFUSED[marker])
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if marker == 0xD8:
                raise ValueError('corrupt JPEG data: SOI inside the file')
            known = (0xC0, 0xC1, 0xC2, 0xC4, 0xDB, 0xDD, 0xDA, 0xFE)
            if marker not in known and not 0xE0 <= marker <= 0xEF:
                raise ValueError('corrupt JPEG data: unknown marker '
                                 f'0x{marker:02X}')
            body, pos = self.body(pos)
            if marker in (0xC0, 0xC1, 0xC2):
                self.frame(marker, body)
            elif marker == 0xC4:
                self.dht(body)
            elif marker == 0xDB:
                self.dqt(body)
            elif marker == 0xDD:
                if len(body) != 2:
                    raise ValueError('corrupt JPEG data: bad DRI segment')
                self.restart_interval = int.from_bytes(body, 'big')
            elif marker == 0xDA:
                pos = self.sos(body, pos)
            elif marker == 0xE0 and len(body) >= 14 and \
                    body[:5] == b'JFIF\0':
                self.jfif = True
            elif marker == 0xEE and len(body) >= 12 and body[:5] == b'Adobe':
                self.adobe, self.adobe_transform = True, body[11]
        if not self.scanned:
            raise ValueError('corrupt JPEG data: no scan')
        if self.progressive and self.smoothing_applies():
            raise ValueError(
                "progressive JPEG whose scans leave coefficients approximate "
                "(libjpeg's block smoothing) is not supported")
        return self.output()

    def dqt(self, body):
        i = 0
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            i += 1
            if tq > 3 or pq > 1:
                raise ValueError('corrupt JPEG data: bad quantisation table')
            size = 128 if pq else 64
            if i + size > len(body):
                raise ValueError('corrupt JPEG data: short quantisation table')
            values = np.frombuffer(body[i:i + size], '>u2' if pq else np.uint8)
            table = np.zeros(64, np.int64)
            table[NATURAL] = values
            self.qt[tq] = table
            i += size

    def dht(self, body):
        i = 0
        while i < len(body):
            if i + 17 > len(body):
                raise ValueError('corrupt JPEG data: short Huffman table')
            tc, th = body[i] >> 4, body[i] & 15
            if tc > 1 or th > 3:
                raise ValueError('corrupt JPEG data: bad Huffman table')
            counts = body[i + 1:i + 17]
            total = sum(counts)
            i += 17
            if total > 256 or i + total > len(body):
                raise ValueError('corrupt JPEG data: bad Huffman table')
            symbols = body[i:i + total]
            if tc == 0 and any(s > 15 for s in symbols):
                raise ValueError('corrupt JPEG data: bad Huffman table')
            codes = _codes(counts, symbols)
            (self.ac if tc else self.dc)[th] = {c: s for s, c in
                                               codes.items()}
            i += total

    def frame(self, marker, body):
        if self.comps is not None:
            raise ValueError('corrupt JPEG data: two frame headers')
        if len(body) < 6:
            raise ValueError('corrupt JPEG data: short frame header')
        precision = body[0]
        self.height = int.from_bytes(body[1:3], 'big')
        self.width = int.from_bytes(body[3:5], 'big')
        nc = body[5]
        if precision == 12:
            raise ValueError('12-bit JPEG is not supported')
        if precision != 8:
            raise ValueError(
                f'corrupt JPEG data: sample precision {precision}')
        if self.height == 0:
            raise ValueError(REFUSED[0xDC])
        if self.width == 0:
            raise ValueError('corrupt JPEG data: empty image')
        if nc not in (1, 3, 4):
            raise ValueError(f'{nc}-component JPEG is not supported')
        if len(body) != 6 + 3 * nc:
            raise ValueError('corrupt JPEG data: bad frame header length')
        self.progressive = marker == 0xC2
        self.comps = []
        for c in range(nc):
            ident, hv, tq = body[6 + 3 * c:9 + 3 * c]
            comp = _Component(ident, hv >> 4, hv & 15, tq)
            if not (1 <= comp.h <= 4 and 1 <= comp.v <= 4 and tq <= 3):
                raise ValueError(
                    'corrupt JPEG data: bad component parameters')
            self.comps.append(comp)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ValueError('JPEG with fractional sampling factors is '
                                 'not supported')
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.wib, c.hib = -(-c.dw // 8), -(-c.dh // 8)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.coef = np.zeros((c.bh, c.bw, 64), np.int64)

    def sos(self, body, pos):
        if self.comps is None:
            raise ValueError(
                'corrupt JPEG data: scan before the frame header')
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            raise ValueError('corrupt JPEG data: bad scan header')
        scan = []
        for i in range(ns):
            ident, tables = body[1 + 2 * i], body[2 + 2 * i]
            found = [c for c in self.comps if c.id == ident]
            if not found or found[0] in scan:
                raise ValueError('corrupt JPEG data: bad scan component')
            comp = found[0]
            comp.dc_tbl, comp.ac_tbl = tables >> 4, tables & 15
            if comp.dc_tbl > 3 or comp.ac_tbl > 3:
                raise ValueError('corrupt JPEG data: bad scan tables')
            scan.append(comp)
        ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
        ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
        if ns > 1 and sum(c.h * c.v for c in scan) > 10:
            raise ValueError('corrupt JPEG data: MCU of more than 10 blocks')
        for c in scan:
            if c.qt is None:
                if c.tq not in self.qt:
                    raise ValueError(
                        'corrupt JPEG data: quantisation table not defined')
                # latched as jidctint.c's ISLOW_MULT_TYPE, a short
                c.qt = self.qt[c.tq].astype(np.int16).astype(np.int64)
        if self.progressive:
            bad = se != 0 if ss == 0 else (se < ss or se > 63 or ns != 1)
            if bad or (ah != 0 and al != ah - 1) or al > 13:
                raise ValueError(
                    'corrupt JPEG data: bad progressive scan parameters')
            for c in scan:
                c.coef_bits[ss:se + 1] = [al] * (se - ss + 1)
        else:
            ss, se, ah, al = 0, 63, 0, 0
        need_dc = not self.progressive or (ss == 0 and ah == 0)
        need_ac = not self.progressive or ss > 0
        for c in scan:
            if (need_dc and c.dc_tbl not in self.dc) or \
                    (need_ac and c.ac_tbl not in self.ac):
                raise ValueError(
                    'corrupt JPEG data: Huffman table not defined')
        parts, end = _entropy(self.data, pos)
        self.scan(scan, parts, ss, se, ah, al)
        self.scanned = True
        return end

    def scan(self, scan, parts, ss, se, ah, al):
        if len(scan) == 1:
            c = scan[0]
            units = [[(c, by, bx)] for by in range(c.hib)
                     for bx in range(c.wib)]
        else:
            units = [[(c, my * c.v + y, mx * c.h + x) for c in scan
                      for y in range(c.v) for x in range(c.h)]
                     for my in range(self.mcuy) for mx in range(self.mcux)]
        interval = self.restart_interval or len(units)
        if -(-len(units) // interval) > len(parts):
            raise ValueError('truncated or corrupt JPEG data')
        for start in range(0, len(units), interval):
            bits = _Bits(parts[start // interval])
            self.eobrun = 0
            for c in self.comps:
                c.pred = 0
            for unit in units[start:start + interval]:
                for c, by, bx in unit:
                    self.block(bits, c, c.coef[by, bx], ss, se, ah, al)

    def block(self, bits, c, b, ss, se, ah, al):
        if not self.progressive or (ss == 0 and ah == 0):
            s = bits.decode(self.dc[c.dc_tbl])
            c.pred += _extend(bits.get(s), s)
            b[0] = c.pred << al   # wrapped to 16 bits in ``plane``
            if self.progressive:
                return
            table, k = self.ac[c.ac_tbl], 1
            while k < 64:
                rs = bits.decode(table)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError('corrupt JPEG data: coefficient '
                                         'run past the block')
                    b[NATURAL[k]] = _extend(bits.get(s), s)
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1
            return
        if ss == 0:   # DC refinement
            if bits.get(1):
                b[0] = int(b[0]) | (1 << al)
            return
        table = self.ac[c.ac_tbl]
        if ah == 0:
            if self.eobrun > 0:
                self.eobrun -= 1
                return
            k = ss
            while k <= se:
                rs = bits.decode(table)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > se:
                        raise ValueError('corrupt JPEG data: coefficient '
                                         'run past the band')
                    b[NATURAL[k]] = _extend(bits.get(s), s) * (1 << al)
                elif r == 15:
                    k += 15
                else:
                    self.eobrun = (1 << r) + bits.get(r) - 1
                    break
                k += 1
            return
        p1, m1 = 1 << al, -(1 << al)

        def refine(pos):
            if bits.get(1) and (int(b[pos]) & p1) == 0:
                b[pos] += p1 if b[pos] >= 0 else m1
        k = ss
        if self.eobrun == 0:
            while k <= se:
                rs = bits.decode(table)
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        raise ValueError(
                            'corrupt JPEG data: bad refinement code')
                    s = p1 if bits.get(1) else m1
                elif r != 15:
                    self.eobrun = (1 << r) + bits.get(r)
                    break
                while k <= se:
                    pos = NATURAL[k]
                    if b[pos] != 0:
                        refine(pos)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError('corrupt JPEG data: refinement '
                                         'run past the band')
                    b[NATURAL[k]] = s
                k += 1
        if self.eobrun > 0:
            for k in range(k, se + 1):
                if b[NATURAL[k]] != 0:
                    refine(NATURAL[k])
            self.eobrun -= 1

    def smoothing_applies(self) -> bool:
        """jdcoefct.c smoothing_ok (see ``csrc/jpeg.cpp``)."""
        useful = False
        for c in self.comps:
            if (c.qt[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]] == 0).any() or \
                    c.coef_bits[0] < 0:
                return False
            useful |= any(bit != 0 for bit in c.coef_bits[1:10])
        return useful

    def plane(self, c) -> np.ndarray:
        """One component's samples at full size (H, W) uint8."""
        coef = (c.coef.astype(np.int16).astype(np.int64)
                * c.qt).reshape(-1, 8, 8)
        s = idct_islow(coef).reshape(c.bh, c.bw, 8, 8)
        s = s.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        hr, vr = self.hmax // c.h, self.vmax // c.v
        return upsample(s[:c.dh, :c.dw].astype(np.int64), hr, vr,
                        self.height, self.width)

    def output(self) -> np.ndarray:
        planes = [self.plane(c) for c in self.comps]
        if len(planes) == 1:
            return np.repeat(planes[0][:, :, None], 3, 2).astype(np.uint8)
        if len(planes) == 4:
            return cmyk_to_rgb(*planes, ycck=self.adobe
                               and self.adobe_transform != 0)
        if self.jfif:
            rgb = False
        elif self.adobe:
            rgb = self.adobe_transform == 0
        else:
            rgb = [c.id for c in self.comps] == [82, 71, 66]
        if rgb:
            return np.stack(planes, 2).astype(np.uint8)
        return ycc_to_rgb(*planes)


def upsample(s: np.ndarray, hr: int, vr: int, height: int,
             width: int) -> np.ndarray:
    """A component's (dh, dw) samples -> (height, width) by jdsample.c:
    fancy h2v1, h1v2 and h2v2 (context rows replicated at the edges),
    replication for other factors and for h2v* components of 2 columns or
    fewer."""
    dh, dw = s.shape
    if hr == 1 and vr == 1:
        return s[:height, :width]
    if vr == 2 and (hr == 1 or (hr == 2 and dw > 2)):
        rows = np.arange(2 * dh) // 2
        near = np.clip(np.where(np.arange(2 * dh) % 2, rows + 1, rows - 1),
                       0, dh - 1)
        sums = s[rows] * 3 + s[near]                  # (2 dh, dw)
        if hr == 1:
            bias = np.where(np.arange(2 * dh) % 2, 2, 1)[:, None]
            return ((sums + bias) >> 2)[:height, :width]
        left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
        even = (sums * 3 + left + 8) >> 4
        odd = (sums * 3 + right + 7) >> 4
        even[:, 0] = (sums[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (sums[:, -1] * 4 + 7) >> 4
        return np.stack([even, odd], 2).reshape(2 * dh, 2 * dw)[
            :height, :width]
    if hr == 2 and vr == 1 and dw > 2:
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        even = (s * 3 + left + 1) >> 2
        odd = (s * 3 + right + 2) >> 2
        even[:, 0] = s[:, 0]
        odd[:, -1] = s[:, -1]
        return np.stack([even, odd], 2).reshape(dh, 2 * dw)[:height, :width]
    return np.repeat(np.repeat(s, vr, 0), hr, 1)[:height, :width]


def _ycc_terms(y, cb, cr):
    """jdcolor.c's table-based YCbCr -> RGB before the clamp."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (91881 * x + 32768) >> 16
    cb_b = (116130 * x + 32768) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + 32768
    return (y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb])


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's table-based YCbCr -> RGB, (H, W) each -> (H, W, 3)."""
    return np.clip(np.stack(_ycc_terms(y, cb, cr), 2), 0,
                   255).astype(np.uint8)


def cmyk_to_rgb(c, m, y, k, ycck: bool) -> np.ndarray:
    """Four components -> (H, W, 3): YCCK -> CMYK by jdcolor.c's
    ycck_cmyk_convert when ``ycck``, then Pillow's "CMYK;I" unpacking
    (each channel inverted) and Convert.c's cmyk2rgb."""
    cmy = [c, m, y]
    if ycck:
        cmy = [np.clip(255 - t, 0, 255) for t in _ycc_terms(c, m, y)]
    nk = k.astype(np.int64)
    out = []
    for v in cmy:
        t = (255 - v.astype(np.int64)) * nk + 128
        out.append(np.clip(nk - (((t >> 8) + t) >> 8), 0, 255))
    return np.stack(out, 2).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB; raises ``ValueError`` as the
    library does."""
    return _Decoder(bytes(data)).run()


# ----------------------------------------------------------------- encoder
def _fdct_1d(p, first: bool):
    """jfdctint.c's 1-D pass on p[0..7] (arrays), descaled."""
    tmp0, tmp7 = p[0] + p[7], p[0] - p[7]
    tmp1, tmp6 = p[1] + p[6], p[1] - p[6]
    tmp2, tmp5 = p[2] + p[5], p[2] - p[5]
    tmp3, tmp4 = p[3] + p[4], p[3] - p[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F_0_541
    out[2] = _descale(z1 + tmp13 * F_0_765, n)
    out[6] = _descale(z1 + tmp12 * -F_1_847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F_1_175
    tmp4, tmp5 = tmp4 * F_0_298, tmp5 * F_2_053
    tmp6, tmp7 = tmp6 * F_3_072, tmp7 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 8, 8) FDCT outputs (scaled by 8)."""
    x = samples.astype(np.int64) - 128
    rows = _fdct_1d([x[:, :, k] for k in range(8)], True)
    ws = np.stack(rows, 2)
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], False)
    return np.stack(cols, 1)


def quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's reciprocal quantisation of (N, 8, 8) by the (64,)
    natural-order table (divisors ``table << 3``; 16-bit reciprocals, as
    libjpeg-turbo computes them for its SIMD build)."""
    divisor = table.astype(np.int64).reshape(8, 8) << 3
    b = np.floor(np.log2(divisor)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // divisor
    fr = (np.int64(1) << r) % divisor
    corr = divisor // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= divisor // 2, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    corr = np.where(~pow2 & (fr <= divisor // 2), corr + 1, corr)
    a = np.abs(coef)
    q = ((a + corr) * fq) >> r
    return np.where(coef < 0, -q, q)


def quality_tables(quality: int):
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s two tables,
    natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return [np.clip((base * scale + 50) // 100, 1, 255)
            for base in (LUMA_QUANT, CHROMA_QUANT)]


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's RGB -> YCbCr, (H, W, 3) uint8 -> three (H, W)."""
    r, g, b = (rgb[:, :, i].astype(np.int64) for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    return y, cb, cr


def _pad(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """Edge replication to (height, width)."""
    return np.pad(plane, ((0, height - plane.shape[0]),
                          (0, width - plane.shape[1])), mode='edge')


def downsample_h2v2(plane: np.ndarray, out_h: int, out_w: int):
    """jcsample.c h2v2_downsample of an (H, W) plane, padded as
    jcprepct.c pads (the last row and column repeated), to (out_h, out_w):
    rows past the image's row groups repeat the last downsampled row."""
    h = plane.shape[0]
    full = _pad(plane, h + h % 2, 2 * out_w)
    s = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
         + full[1::2, 1::2])
    bias = np.where(np.arange(out_w) % 2, 2, 1)
    return _pad((s + bias) >> 2, out_h, out_w)


def _blocks(plane: np.ndarray, hib: int, wib: int) -> np.ndarray:
    """The (hib, wib) blocks of a plane as (hib, wib, 8, 8)."""
    p = plane[:hib * 8, :wib * 8]
    return p.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3)


class _Writer:
    def __init__(self):
        self.bits = []

    def put(self, bits: str):
        self.bits.append(bits)

    def value(self, v: int, n: int):
        if n:
            self.bits.append(format((v - 1 if v < 0 else v)
                                    & ((1 << n) - 1), f'0{n}b'))

    def data(self) -> bytes:
        s = ''.join(self.bits)
        s += '1' * (-len(s) % 8)
        raw = int(s, 2).to_bytes(len(s) // 8, 'big') if s else b''
        return raw.replace(b'\xff', b'\xff\x00')


def _emit(w: _Writer, block: np.ndarray, pred: int, dc: dict, ac: dict):
    """Huffman-code one quantised (8, 8) block; returns its DC."""
    zz = block.reshape(64)[NATURAL].tolist()
    diff = zz[0] - pred
    n = abs(diff).bit_length()
    w.put(dc[n])
    w.value(diff, n)
    run = 0
    for v in zz[1:]:
        if v == 0:
            run += 1
            continue
        while run > 15:
            w.put(ac[0xF0])
            run -= 16
        n = abs(v).bit_length()
        w.put(ac[(run << 4) + n])
        w.value(v, n)
        run = 0
    if run:
        w.put(ac[0])
    return zz[0]


def encode(image: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> JPEG bytes, as the library writes
    them."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] not in (1, 3)):
        raise ValueError('JPEG encoder: (H, W), (H, W, 1) or (H, W, 3) '
                         'uint8 expected')
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    height, width = image.shape[:2]
    if not (1 <= height <= 65535 and 1 <= width <= 65535):
        raise ValueError('JPEG encoder: image size out of range')
    tables = quality_tables(quality)
    grey = image.ndim == 2
    wib, hib = -(-width // 8), -(-height // 8)
    codes = [(_codes(*DC_LUMA), _codes(*AC_LUMA)),
             (_codes(*DC_CHROMA), _codes(*AC_CHROMA))]
    w = _Writer()
    if grey:
        blocks = _blocks(_pad(image.astype(np.int64), hib * 8, wib * 8),
                         hib, wib).reshape(-1, 8, 8)
        quantised = quantize(fdct_islow(blocks), tables[0])
        pred = 0
        for block in quantised:
            pred = _emit(w, block, pred, *codes[0])
        nc = 1
    else:
        mcux, mcuy = -(-width // 16), -(-height // 16)
        y, cb, cr = rgb_to_ycc(image)
        luma = _blocks(_pad(y, mcuy * 16, mcux * 16), hib, wib)
        luma = quantize(fdct_islow(luma.reshape(-1, 8, 8)),
                        tables[0]).reshape(hib, wib, 8, 8)
        chroma = [quantize(fdct_islow(_blocks(
            downsample_h2v2(p, mcuy * 8, mcux * 8), mcuy, mcux).reshape(
                -1, 8, 8)), tables[1]).reshape(mcuy, mcux, 8, 8)
            for p in (cb, cr)]
        preds = [0, 0, 0]
        for my in range(mcuy):
            for mx in range(mcux):
                # jccoefct.c: blocks past the luma's blocks are zero but
                # for the DC of the block before them in the MCU
                mcu = []
                for by in (2 * my, 2 * my + 1):
                    for bx in (2 * mx, 2 * mx + 1):
                        if by < hib and bx < wib:
                            mcu.append(luma[by, bx])
                        else:
                            dummy = np.zeros((8, 8), np.int64)
                            dummy[0, 0] = mcu[-1][0, 0]
                            mcu.append(dummy)
                for block in mcu:
                    preds[0] = _emit(w, block, preds[0], *codes[0])
                for i in (1, 2):
                    preds[i] = _emit(w, chroma[i - 1][my, mx], preds[i],
                                     *codes[1])
        nc = 3

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, 'big') \
            + body

    out = [b'\xff\xd8', segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01'
                                      b'\x00\x00')]
    for t in range(2 if nc == 3 else 1):
        out.append(segment(0xDB, bytes([t]) + bytes(
            tables[t][NATURAL].astype(np.uint8).tolist())))
    sampling = [0x22, 0x11, 0x11] if nc == 3 else [0x11]
    out.append(segment(0xC0, bytes([8]) + height.to_bytes(2, 'big')
                       + width.to_bytes(2, 'big') + bytes([nc]) + b''.join(
                           bytes([c + 1, sampling[c], min(c, 1)])
                           for c in range(nc))))
    huff = [(0x00, DC_LUMA), (0x10, AC_LUMA)]
    if nc == 3:
        huff += [(0x01, DC_CHROMA), (0x11, AC_CHROMA)]
    for index, (counts, symbols) in huff:
        out.append(segment(0xC4, bytes([index, *counts]) + symbols))
    out.append(segment(0xDA, bytes([nc]) + b''.join(
        bytes([c + 1, 0x11 if c else 0x00]) for c in range(nc))
        + b'\x00\x3f\x00'))
    out.append(w.data())
    out.append(b'\xff\xd9')
    return b''.join(out)
