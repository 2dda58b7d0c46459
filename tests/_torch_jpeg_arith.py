"""Arithmetic-coded JPEGs for the tests, which PIL cannot write.

`to_arithmetic(data, progressive=False, restart=0)` re-encodes the
quantized coefficients of a baseline (SOF0, Huffman-coded) JPEG, such as
PIL writes, with the arithmetic coder of T.81 Annexes D and F-G as
libjpeg-turbo's jcarith.c codes it: sequentially (SOF9, one scan) or
progressively (SOF10, libjpeg's jpeg_simple_progression script), with a
restart marker every `restart` MCUs, and a DAC segment with non-default
conditioning if `dac`. The coefficients are the same, so libjpeg decodes
the new file to the same pixels as the baseline one, which is how the
tests prove this module. It parses the file itself and imports numpy and
the standard library only (`chip_smoke.py` loads it by path).
"""

from __future__ import annotations

import struct

import numpy as np

NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
           37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2, packed as jaricom.c packs it: Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS
QE = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171]
# (qe, nmps, nlps | switch << 7) per state, unpacked once
_TAB = [(q >> 16, (q >> 8) & 0xFF, q & 0xFF) for q in QE]


# ------------------------------------------------------------------ parsing
def _segments(data: bytes):
    """(marker, body, start, end) of each segment up to the first SOS,
    then ("scan", entropy-coded bytes up to EOI)."""
    pos, out = 2, []
    while True:
        while data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1
        m = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((m, data[pos + 4:pos + 2 + length], pos, pos + 2 + length))
        pos += 2 + length
        if m == 0xDA:
            end = data.rindex(b"\xff\xd9")
            return out, data[pos:end]


def _huffman(body: bytes) -> dict:
    """{(class, id): {(length, code): value}} of a DHT segment."""
    tables, p = {}, 0
    while p < len(body):
        tc, th = body[p] >> 4, body[p] & 15
        counts = body[p + 1:p + 17]
        vals = body[p + 17:p + 17 + sum(counts)]
        code, k, table = 0, 0, {}
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                table[(length, code)] = vals[k]
                code += 1
                k += 1
            code <<= 1
        tables[(tc, th)] = table
        p += 17 + sum(counts)
    return tables


class _Bits:
    def __init__(self, data: bytes):
        # unstuff 0xFF00; no RST markers in the files this reads
        self.bits = np.unpackbits(np.frombuffer(data.replace(b"\xff\x00", b"\xff"), np.uint8))
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def decode(self, table: dict) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | int(self.bits[self.pos])
            self.pos += 1
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("a Huffman code in no table")


def read_baseline(data: bytes) -> dict:
    """The frame and every block's quantized coefficients (natural order)
    of a baseline JPEG in one scan (interleaved, or a grey file)."""
    segs, scan = _segments(data)
    frame, tables, keep, sos = None, {}, [], None
    for m, body, s, e in segs:
        if m == 0xC0:
            h, w = struct.unpack(">HH", body[1:5])
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4, v=body[7 + 3 * i] & 15,
                          tq=body[8 + 3 * i]) for i in range(body[5])]
            frame = dict(h=h, w=w, comps=comps)
        elif m in (0xC1, 0xC2, 0xC9, 0xCA, 0xDD):
            raise ValueError(f"not a baseline JPEG without restarts (marker {m:02x})")
        elif m == 0xC4:
            tables.update(_huffman(body))
        elif m == 0xDA:
            sos = body
        else:
            keep.append(data[s:e])
    ns = sos[0]
    sel = {sos[1 + 2 * i]: (sos[2 + 2 * i] >> 4, sos[2 + 2 * i] & 15) for i in range(ns)}
    hmax = max(c["h"] for c in frame["comps"])
    vmax = max(c["v"] for c in frame["comps"])
    mcux = -(-frame["w"] // (8 * hmax))
    mcuy = -(-frame["h"] // (8 * vmax))
    for c in frame["comps"]:
        c["width"] = -(-frame["w"] * c["h"] // hmax)
        c["height"] = -(-frame["h"] * c["v"] // vmax)
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["coef"] = np.zeros((c["bh"], c["bw"], 64), np.int32)
    bits, last = _Bits(scan), [0] * len(frame["comps"])

    def block(ci: int, by: int, bx: int) -> None:
        c = frame["comps"][ci]
        dct, act = sel[c["id"]]
        s = bits.decode(tables[(0, dct)])
        diff = bits.get(s)
        if s and diff < 1 << (s - 1):
            diff -= (1 << s) - 1
        last[ci] += diff
        c["coef"][by, bx, 0] = last[ci]
        k = 1
        while k < 64:
            rs = bits.decode(tables[(1, act)])
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                v = bits.get(s)
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                c["coef"][by, bx, NATURAL[k]] = v
                k += 1
            elif r == 15:
                k += 16
            else:
                break

    if ns == 1:
        c = frame["comps"][0]
        for by in range(-(-c["height"] // 8)):
            for bx in range(-(-c["width"] // 8)):
                block(0, by, bx)
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, c in enumerate(frame["comps"]):
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            block(ci, my * c["v"] + v, mx * c["h"] + h)
    frame.update(mcux=mcux, mcuy=mcuy, keep=keep)
    return frame


# ------------------------------------------------------------------ encoder
class _Coder:
    """jcarith.c's arith_encode, emit_byte and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _flush_zeros(self) -> None:
        if self.zc:
            self.out += b"\0" * self.zc
            self.zc = 0

    def _settle(self, temp: int) -> None:
        """One byte of C ready (temp = C >> 19), with carry handling."""
        if temp > 0xFF:
            if self.buffer >= 0:
                self._flush_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\0" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nm, nl = _TAB[sv & 0x7F]
        a = self.a - qe
        if val != sv >> 7:
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self._settle(c >> 19)
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\0" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)


class _Scan:
    """One scan's statistics and the procedures of jcarith.c that code it."""

    def __init__(self, coder: _Coder, comps: list, ss: int, se: int, dc_lu: tuple, ac_k: int):
        self.coder, self.comps, self.ss, self.se = coder, comps, ss, se
        self.L, self.U, self.K = dc_lu[0], dc_lu[1], ac_k
        self.fixed = bytearray([113])
        self.reset()

    def reset(self) -> None:
        n = len(self.comps)
        self.dc = [bytearray(64) for _ in range(n)]
        self.ac = [bytearray(256) for _ in range(n)]
        self.last, self.ctx = [0] * n, [0] * n

    def _magnitude(self, st: bytearray, i: int, v: int, ac_at: int | None) -> None:
        """Figures F.8 and F.9 from bin i of st: v - 1's category and bits
        (ac_at: the AC k for the X2 bin choice; None for DC)."""
        enc = self.coder.encode
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v
            if ac_at is None:
                i = 20
                while v2 >> 1:
                    v2 >>= 1
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
            else:
                v2 >>= 1
                if v2:
                    enc(st, i, 1)
                    m <<= 1
                    i = 189 if ac_at <= self.K else 217
                    while v2 >> 1:
                        v2 >>= 1
                        enc(st, i, 1)
                        m <<= 1
                        i += 1
        enc(st, i, 0)
        i += 14
        while m >> 1:
            m >>= 1
            enc(st, i, 1 if m & v else 0)

    def dc_first(self, ci: int, value: int) -> None:
        enc, st = self.coder.encode, self.dc[ci]
        i = self.ctx[ci]
        v = value - self.last[ci]
        if v == 0:
            enc(st, i, 0)
            self.ctx[ci] = 0
            return
        self.last[ci] = value
        enc(st, i, 1)
        if v > 0:
            enc(st, i + 1, 0)
            i += 2
            self.ctx[ci] = 4
        else:
            v = -v
            enc(st, i + 1, 1)
            i += 3
            self.ctx[ci] = 8
        # the category decides the next context: recompute m as _magnitude does
        m, v2 = 0, v - 1
        if v2:
            m = 1
            while v2 >> 1:
                v2 >>= 1
                m <<= 1
        self._magnitude(st, i, v, None)
        if m < (1 << self.L) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << self.U) >> 1:
            self.ctx[ci] += 8

    def ac_first(self, ci: int, coef: np.ndarray) -> None:
        """coef: the block's 64 coefficients in zigzag order, >> al applied
        (towards zero)."""
        enc, st = self.coder.encode, self.ac[ci]
        se = self.se
        ke = se
        while ke > 0 and coef[ke] == 0:
            ke -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            enc(st, i, 0)
            while coef[k] == 0:
                enc(st, i + 1, 0)
                i += 3
                k += 1
            enc(st, i + 1, 1)
            v = int(coef[k])
            enc(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(st, i + 2, abs(v), k)
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)

    def ac_refine(self, ci: int, coef: np.ndarray, prev: np.ndarray) -> None:
        """coef: |coefficients| >> al with signs (zigzag); prev: >> ah."""
        enc, st = self.coder.encode, self.ac[ci]
        se = self.se
        ke = se
        while ke > 0 and coef[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and prev[kex] == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc(st, i, 0)
            while True:
                v = int(coef[k])
                if v:
                    a = abs(v)
                    if a >> 1:
                        enc(st, i + 2, a & 1)
                    else:
                        enc(st, i + 1, 1)
                        enc(self.fixed, 0, 0 if v > 0 else 1)
                    break
                enc(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)


SIMPLE_PROGRESSION_3 = [  # jcparam.c jpeg_simple_progression, YCbCr
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
SIMPLE_PROGRESSION_1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                        ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def _shift(x: np.ndarray, n: int) -> np.ndarray:
    """Coefficients >> n towards zero (jcarith.c's point transform)."""
    return np.sign(x) * (np.abs(x) >> n)


def to_arithmetic(data: bytes, progressive: bool = False, restart: int = 0,
                  dac: bool = False) -> bytes:
    """The baseline JPEG `data` re-encoded with arithmetic coding."""
    f = read_baseline(data)
    comps = f["comps"]
    dc_lu, ac_k = ((1, 4), 3) if dac else ((0, 1), 5)
    out = bytearray(b"\xff\xd8")
    for seg in f["keep"]:
        out += seg
    body = struct.pack(">BHHB", 8, f["h"], f["w"], len(comps)) + b"".join(
        bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]]) for c in comps)
    out += b"\xff" + bytes([0xCA if progressive else 0xC9]) + struct.pack(">H", len(body) + 2)
    out += body
    if dac:
        dac_body = b"".join(bytes([t, dc_lu[1] << 4 | dc_lu[0], 16 + t, ac_k]) for t in range(2))
        out += b"\xff\xcc" + struct.pack(">H", len(dac_body) + 2) + dac_body
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    zig = [c["coef"][:, :, NATURAL] for c in comps]  # (bh, bw, 64) in zigzag order
    if progressive:
        script = SIMPLE_PROGRESSION_3 if len(comps) == 3 else SIMPLE_PROGRESSION_1
    else:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    for members, ss, se, ah, al in script:
        tables = {ci: (min(ci, 1), min(ci, 1)) for ci in members}
        sos = bytes([len(members)]) + b"".join(
            bytes([comps[ci]["id"], tables[ci][0] << 4 | tables[ci][1]]) for ci in members)
        sos += bytes([ss, se, ah << 4 | al])
        out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
        coder = _Coder()
        # a sequential scan's AC bands start at 1 (its DC is coded apart)
        scan = _Scan(coder, [comps[ci] for ci in members], ss if progressive else 1, se,
                     dc_lu, ac_k)
        # statistics per table: components sharing a table share its bins
        by_table = {}
        for j, ci in enumerate(members):
            t = tables[ci]
            if t in by_table:
                scan.dc[j], scan.ac[j] = scan.dc[by_table[t]], scan.ac[by_table[t]]
            else:
                by_table[t] = j
        units = []
        if len(members) == 1:
            c = comps[members[0]]
            for by in range(-(-c["height"] // 8)):
                for bx in range(-(-c["width"] // 8)):
                    units.append([(0, by, bx)])
        else:
            for my in range(f["mcuy"]):
                for mx in range(f["mcux"]):
                    units.append([(j, my * comps[ci]["v"] + v, mx * comps[ci]["h"] + h)
                                  for j, ci in enumerate(members)
                                  for v in range(comps[ci]["v"]) for h in range(comps[ci]["h"])])
        for u, blocks in enumerate(units):
            if restart and u and u % restart == 0:
                coder.finish()
                coder.out += bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
                coder.reset()
                scan.reset()
                for j, ci in enumerate(members):
                    t = tables[ci]
                    if by_table[t] != j:
                        scan.dc[j], scan.ac[j] = scan.dc[by_table[t]], scan.ac[by_table[t]]
            for j, by, bx in blocks:
                z = zig[members[j]][by, bx]
                if not progressive:
                    scan.dc_first(j, int(z[0]))
                    scan.ac_first(j, z)
                elif ss == 0 and ah == 0:
                    scan.dc_first(j, int(z[0]) >> al)
                elif ss == 0:
                    coder.encode(scan.fixed, 0, (int(z[0]) >> al) & 1)
                elif ah == 0:
                    scan.ac_first(j, _shift(z, al))
                else:
                    scan.ac_refine(j, _shift(z, al), _shift(z, ah))
        coder.finish()
        out += coder.out
    return bytes(out + b"\xff\xd9")
