"""A baseline JPEG decoder of the port's own (numpy and the standard
library), for machines without imageio: `read_jpeg(path)` returns the array
that imageio v2 (through Pillow on libjpeg-turbo, its defaults) returns for
the same file, uint8 [H, W, 3] for colour and [H, W] for grey, the EXIF
orientation not applied.

It follows libjpeg-turbo's stages at their defaults:

  * the markers SOI, APPn, COM, DQT (8- and 16-bit tables), DHT (several
    tables a segment), SOF0 / SOF1 (8-bit), SOS, DRI with RSTn, fill bytes
    and EOI;
  * Huffman decoding in Python, one 16-bit lookup a symbol; the DC
    predictions reset at each restart marker;
  * dequantisation and the integer "islow" IDCT of `jidctint.c` (CONST_BITS
    13, PASS1_BITS 2), in numpy over every block at once;
  * "fancy" (triangle) upsampling of `jdsample.c` for h2v1, h1v2 and h2v2
    with its alternating rounding biases, the edges replicated as the
    library replicates them (the row above the first, the row below the last
    real row, the column right of the last); partial MCUs are cropped;
  * YCbCr -> RGB with the fixed-point tables of `jdcolor.c`, except where an
    Adobe APP14 segment says transform 0 (or, without JFIF and Adobe
    segments, the components are named R, G, B).

It reads 1 or 3 components with sampling factors up to 2 and one interleaved
scan (what libjpeg, OpenCV and phone cameras write), and refuses, with a
ValueError naming the file, progressive, lossless, hierarchical and
arithmetic-coded files, 12-bit samples, 4-component (CMYK / YCCK) files and
baseline files in several scans.
"""
from __future__ import annotations

import re

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                   i // 8 if (i // 8 + i % 8) % 2 else i % 8)),
                  np.int64)

_SOF_NAMES = {0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
              0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
              0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
              0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
              0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
              0xCD: "SOF13 (arithmetic differential sequential)",
              0xCE: "SOF14 (arithmetic differential progressive)",
              0xCF: "SOF15 (arithmetic differential lossless)"}
_RST = re.compile(rb"\xff+[\xd0-\xd7]")
_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")

# jidctint.c's constants: FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
_CONST_BITS, _PASS1_BITS = 13, 2


def _huffman_lut(counts, symbols):
    """A 65,536-entry list: the next 16 bits of the stream -> (code length
    << 8) | symbol; 0 where no code of the table starts with those bits."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Frame:
    """What the markers before the scan said."""

    def __init__(self):
        self.qt = {}           # table id -> [64] natural order
        self.dc, self.ac = {}, {}  # table id -> lookup list
        self.restart = 0
        self.adobe = None      # APP14 transform flag, or None
        self.jfif = False
        self.H = self.W = 0
        self.comps = []        # [{"id", "h", "v", "tq"}]


def _segments(data: bytes, path: str):
    """Yield (marker, payload, offset after the segment) up to the first SOS,
    whose payload is its header; the entropy-coded data follows it."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        while data[pos:pos + 2] == b"\xff\xff":
            pos += 1  # fill bytes before a marker
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xD9:
            raise ValueError(f"{path}: JPEG without a scan (EOI before SOS)")
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if length < 2 or pos + 2 + length > len(data):
            raise ValueError(f"{path}: corrupt or truncated JPEG (marker 0x{marker:02X} at "
                             f"byte {pos} runs past the end)")
        yield marker, data[pos + 4:pos + 2 + length], pos + 2 + length
        pos += 2 + length


def _parse_header(data: bytes, path: str):
    """(_Frame, the SOS header, the offset of the entropy-coded data)."""
    fr = _Frame()
    for marker, seg, end in _segments(data, path):
        if marker in _SOF_NAMES:
            if marker not in (0xC0, 0xC1):
                raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not supported by the "
                                 "port's JPEG reader (baseline and extended sequential "
                                 "Huffman only)")
            if seg[0] != 8:
                raise ValueError(f"{path}: {seg[0]}-bit JPEG samples are not supported by the "
                                 f"port's JPEG reader ({_SOF_NAMES[marker]}; 8-bit only)")
            fr.H, fr.W = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            n = seg[5]
            if n not in (1, 3):
                raise ValueError(f"{path}: JPEG with {n} components ({_SOF_NAMES[marker]}; "
                                 "CMYK / YCCK) is not supported by the port's JPEG reader "
                                 "(1 or 3 components)")
            for i in range(n):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if h not in (1, 2) or v not in (1, 2):
                    raise ValueError(f"{path}: JPEG sampling factors {h}x{v} are not "
                                     "supported by the port's JPEG reader (at most 2x2)")
                fr.comps.append({"id": cid, "h": h, "v": v, "tq": tq})
            if fr.H == 0:
                raise ValueError(f"{path}: JPEG whose height is set by a DNL marker")
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    vals = np.frombuffer(seg[p + 1:p + 129], ">u2").astype(np.int64)
                    p += 129
                else:
                    vals = np.frombuffer(seg[p + 1:p + 65], np.uint8).astype(np.int64)
                    p += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                fr.qt[tq] = table
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                n = sum(counts)
                symbols = list(seg[p + 17:p + 17 + n])
                (fr.ac if tc else fr.dc)[th] = _huffman_lut(counts, symbols)
                p += 17 + n
        elif marker == 0xDD:  # DRI
            fr.restart = int.from_bytes(seg[0:2], "big")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            fr.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            fr.adobe = seg[11]
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG (DAC marker) is not supported "
                             "by the port's JPEG reader")
        elif marker == 0xDA:  # SOS
            if not fr.comps:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            return fr, seg, end


def _scan_segments(data: bytes, start: int):
    """The entropy-coded data from `start` to the marker that ends the scan,
    split at its restart markers, byte stuffing undone; and the offset of
    that marker."""
    m = _END_OF_SCAN.search(data, start)
    end = m.start() if m else len(data)
    # fill bytes before the ending marker belong to no segment
    while end > start and data[end - 1] == 0xFF:
        end -= 1
    parts = _RST.split(data[start:end])
    return [p.replace(b"\xff\x00", b"\xff") for p in parts], end


def _words(seg: bytes):
    """The segment as big-endian 32-bit words (a Python list), padded with
    zero bits past its end, as libjpeg pads a truncated stream."""
    pad = (-len(seg)) % 4 + 8
    return np.frombuffer(seg + b"\x00" * pad, ">u4").astype(np.int64).tolist()


def _decode_scan(fr: _Frame, sos: bytes, data: bytes, start: int, path: str):
    """Huffman-decode the scan: per component a coefficient array [rows of
    blocks, blocks a row, 64] in zigzag order (int64), and the offset after
    the scan."""
    ns = sos[0]
    if ns != len(fr.comps):
        raise ValueError(f"{path}: baseline JPEG in several scans ({ns} of "
                         f"{len(fr.comps)} components in the first) is not supported by the "
                         "port's JPEG reader")
    by_id = {c["id"]: i for i, c in enumerate(fr.comps)}
    order = []
    for i in range(ns):
        cid, t = sos[1 + 2 * i], sos[2 + 2 * i]
        ci = by_id[cid]
        order.append((ci, t >> 4, t & 15))
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    if ns == 1:  # a non-interleaved scan: one block an MCU over the component
        c = fr.comps[order[0][0]]
        bw = _ceil_div(_ceil_div(fr.W * c["h"], hmax), 8)
        bh = _ceil_div(_ceil_div(fr.H * c["v"], vmax), 8)
        mcus_x, mcus_y = bw, bh
        shapes = [(bh, bw)]
        units = [(0, 1, 1)]
    else:
        mcus_x = _ceil_div(fr.W, 8 * hmax)
        mcus_y = _ceil_div(fr.H, 8 * vmax)
        shapes = [(mcus_y * fr.comps[ci]["v"], mcus_x * fr.comps[ci]["h"])
                  for ci, _, _ in order]
        units = [(k, fr.comps[ci]["h"], fr.comps[ci]["v"]) for k, (ci, _, _) in enumerate(order)]
    for ci, td, ta in order:
        if td not in fr.dc or ta not in fr.ac:
            raise ValueError(f"{path}: JPEG scan names a Huffman table it does not define")
    coefs = [[0] * (h * w * 64) for h, w in shapes]
    dcl = [fr.dc[td] for _, td, _ in order]
    acl = [fr.ac[ta] for _, _, ta in order]
    segments, end = _scan_segments(data, start)
    n_mcus = mcus_x * mcus_y
    per = fr.restart if fr.restart else n_mcus
    n_seg = _ceil_div(n_mcus, per)
    segments += [b""] * max(0, n_seg - len(segments))  # a truncated file reads as zeros
    # blocks of each MCU: (coefficient list, DC table, AC table, prediction slot,
    # offset of the block within the MCU's rows / columns of blocks)
    plan = []
    for k, nh, nv in units:
        bw_k = shapes[k][1]
        for v in range(nv):
            for h in range(nh):
                plan.append((k, v * bw_k + h))
    extend = [0] + [(1 << s) - 1 for s in range(1, 17)]
    half = [0] + [1 << (s - 1) for s in range(1, 17)]
    masks = [(1 << n) - 1 for n in range(65)]
    for seg_i in range(n_seg):
        words = _words(segments[seg_i])
        acc, nb, wi = 0, 0, 0
        pred = [0] * len(order)
        for mcu in range(seg_i * per, min(n_mcus, (seg_i + 1) * per)):
            my, mx = divmod(mcu, mcus_x)
            for k, off in plan:
                _, nh, nv = units[k]
                bw_k = shapes[k][1]
                coef = coefs[k]
                base = ((my * nv) * bw_k + mx * nh + off) * 64
                # DC: category, then that many bits of the difference
                if nb < 32:
                    acc = ((acc & masks[nb]) << 32) | words[wi]
                    wi += 1
                    nb += 32
                e = dcl[k][(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: corrupt JPEG (bad Huffman code)")
                nb -= e >> 8
                s = e & 0xFF
                if s:  # the code took at most 16 of the >= 32 bits
                    nb -= s
                    d = (acc >> nb) & masks[s]
                    if d < half[s]:
                        d -= extend[s]
                    pred[k] += d
                coef[base] = pred[k]
                table = acl[k]
                i = 1
                while i < 64:
                    if nb < 32:
                        acc = ((acc & masks[nb]) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    e = table[(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{path}: corrupt JPEG (bad Huffman code)")
                    nb -= e >> 8
                    s = e & 15
                    if s:
                        i += (e >> 4) & 15
                        nb -= s
                        d = (acc >> nb) & masks[s]
                        if d < half[s]:
                            d -= extend[s]
                        if i < 64:
                            coef[base + i] = d
                        i += 1
                    elif (e & 0xF0) == 0xF0:
                        i += 16
                    else:
                        break
    out = [None] * len(fr.comps)
    for k, (ci, _, _) in enumerate(order):
        h, w = shapes[k]
        out[ci] = np.array(coefs[k], np.int64).reshape(h, w, 64)
    return out, end


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One pass of jidctint.c's islow IDCT on int64 arrays: the eight sums
    before the pass's descale, in output order 0..7."""
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef_zz: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Blocks [..., 64] of zigzag-ordered coefficients and a quantisation
    table [64] (natural order) -> samples uint8 [..., 8, 8], as libjpeg's
    `jpeg_idct_islow` computes them (its zero-AC shortcuts give the same
    values as the full sums)."""
    lead = coef_zz.shape[:-1]
    nat = np.empty_like(coef_zz)
    nat[..., ZIGZAG] = coef_zz
    blk = (nat * qt).reshape(-1, 8, 8)  # [n, row u, column v]
    # pass 1: down the columns (over u), scaled up by 2^PASS1_BITS
    ws = _idct_1d(*(blk[:, u, :] for u in range(8)))
    ws = np.stack([_descale(t, _CONST_BITS - _PASS1_BITS) for t in ws], 1)  # [n, y, v]
    # pass 2: along the rows (over v)
    out = _idct_1d(*(ws[:, :, v] for v in range(8)))
    out = np.stack([_descale(t, _CONST_BITS + _PASS1_BITS + 3) for t in out], 2)  # [n, y, x]
    # range_limit[x & RANGE_MASK] of jdmaster.c's post-IDCT table
    idx = out & 1023
    samples = np.where(idx < 512, np.minimum(idx + 128, 255),
                       np.where(idx < 896, 0, idx - 896))
    return samples.astype(np.uint8).reshape(lead + (8, 8))


def _plane(blocks: np.ndarray, qt: np.ndarray, h: int, w: int) -> np.ndarray:
    """A component's coefficient blocks [rows, cols, 64] -> its sample plane
    cropped to h x w real samples (int64)."""
    by, bx = blocks.shape[:2]
    px = idct_islow(blocks, qt)  # [by, bx, 8, 8]
    return px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:h, :w].astype(np.int64)


def _neighbours(x: np.ndarray, axis: int):
    """(x shifted by one towards the end, towards the start) along `axis`,
    the edge sample replicated: each sample's previous and next one."""
    x = np.moveaxis(x, axis, 0)
    prev = np.concatenate([x[:1], x[:-1]], 0)
    nxt = np.concatenate([x[1:], x[-1:]], 0)
    return np.moveaxis(prev, 0, axis), np.moveaxis(nxt, 0, axis)


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of one component plane [h, w] (its
    real samples) by (fh, fv) in {1, 2}^2; box replication for h2 on planes
    of at most 2 columns, as the library does. Uncropped: [fv h, fh w]."""
    h, w = plane.shape
    if fh == 1 and fv == 1:
        return plane
    if fv == 1:  # h2v1: 3/4 the nearer plus 1/4 the further, biases 1 and 2
        if w <= 2:
            return np.repeat(plane, 2, 1)
        left, right = _neighbours(plane, 1)
        out = np.empty((h, 2 * w), np.int64)
        out[:, 0::2] = (3 * plane + left + 1) >> 2
        out[:, 1::2] = (3 * plane + right + 2) >> 2
        out[:, 0], out[:, -1] = plane[:, 0], plane[:, -1]
        return out
    above, below = _neighbours(plane, 0)
    if fh == 1:  # h1v2
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * plane + above + 1) >> 2
        out[1::2] = (3 * plane + below + 2) >> 2
        return out
    if w <= 2:  # h2v2 box
        return np.repeat(np.repeat(plane, 2, 0), 2, 1)
    out = np.empty((2 * h, 2 * w), np.int64)
    for r, nbr in ((0, above), (1, below)):
        col = 3 * plane + nbr  # the column sums, 4x scale
        left, right = _neighbours(col, 1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
        out[r::2, 0] = (4 * col[:, 0] + 8) >> 4
        out[r::2, -1] = (4 * col[:, -1] + 7) >> 4
    return out


def _fix16(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's `ycc_rgb_convert`: integer planes -> uint8 [H, W, 3]."""
    one_half = 1 << 15
    x_cr, x_cb = cr - 128, cb - 128
    r = y + ((_fix16(1.40200) * x_cr + one_half) >> 16)
    g = y + ((-_fix16(0.34414) * x_cb + one_half - _fix16(0.71414) * x_cr) >> 16)
    b = y + ((_fix16(1.77200) * x_cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode the bytes of a baseline JPEG file (see the module note)."""
    fr, sos, start = _parse_header(data, path)
    blocks, end = _decode_scan(fr, sos, data, start, path)
    if b"\xff\xda" in data[end:].split(b"\xff\xd9", 1)[0]:  # another SOS before EOI
        raise ValueError(f"{path}: baseline JPEG in several scans is not supported by the "
                         "port's JPEG reader")
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    planes = []
    for c, blk in zip(fr.comps, blocks):
        if c["tq"] not in fr.qt:
            raise ValueError(f"{path}: JPEG component names a quantisation table it does "
                             "not define")
        h = _ceil_div(fr.H * c["v"], vmax)  # the component's real samples
        w = _ceil_div(fr.W * c["h"], hmax)
        plane = _plane(blk, fr.qt[c["tq"]], h, w)
        planes.append(upsample(plane, hmax // c["h"], vmax // c["v"])[:fr.H, :fr.W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c["id"] for c in fr.comps)
    rgb = (fr.adobe == 0) if fr.adobe is not None else (not fr.jfif and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file at `path`: uint8 [H, W, 3] (colour) or [H, W]
    (grey), as imageio v2 returns it."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)
