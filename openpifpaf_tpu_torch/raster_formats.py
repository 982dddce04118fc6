"""ICO, CUR, TGA, QOI, PSD, SGI and PCX readers without PIL (numpy).

Each gives (H, W, 3) uint8 RGB, what the JAX package gets from Pillow
12's ``np.asarray(Image.open(path).convert('RGB'))``, its plugins' choices
and quirks kept:

- ICO: the entry Pillow picks (the largest, then the fewest bits); a PNG
  payload through ``image_io.read_png``, a BMP one as the DIB it is (the
  height halved, the AND mask and any alpha dropped by the conversion);
- CUR: the entry Pillow picks (its first, or one wider and taller), a DIB;
- TGA: colour-mapped (16- and 24-bit maps), true colour at 16
  (5-5-5), 24 and 32 bits, greyscale at 8 and 16 (grey and alpha) bits,
  raw or RLE (literal packets may cross rows, runs may not), any origin
  (the flip bits);
- QOI, as Pillow's decoder reads it (an index never seen reads
  transparent black);
- PSD: the merged image, raw or PackBits; bitmap, greyscale, duotone,
  multichannel, indexed, RGB and CMYK at 8 bits (Pillow reads no other
  depth);
- SGI: raw and RLE, 8 and 16 bits (the high byte), 1, 3 and 4 channels;
- PCX: versions 0, 2, 3 and 5: 1 bit in 1, 2 or 4 planes (the header's
  16 colours), 8-bit greyscale or palette (the 769-byte trailer), 8-bit
  RGB in three planes.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .image_formats import cmyk_rgb, grey_rgb, lookup


class Fallthrough(ValueError):
    """Bytes that claim a format by their signature but fail its header
    in a way that makes Pillow's ``Image.open`` try its next plugins (a
    ``SyntaxError``, ``IndexError`` or ``TypeError`` in ``_open``)."""


def _need(data: bytes, end: int, what: str) -> None:
    if end > len(data):
        raise ValueError(f'{what}: truncated image data')


# ------------------------------------------------------------- ICO / CUR

def _dib(data: bytes, start: int, halve) -> np.ndarray:
    """The DIB at ``start`` (an ICO or CUR payload) through the BMP reader:
    the file header Pillow's DIB reader implies (pixels right after the
    header, masks and palette), the height ``halve``d."""
    from .image_io import read_bmp
    dib = bytearray(data[start:])
    if len(dib) < 16:
        raise ValueError('ICO/CUR: truncated bitmap header')
    size, = struct.unpack('<I', dib[:4])
    if size == 12:
        height, bits = struct.unpack('<H', dib[6:8])[0], dib[10]
        dib[6:8] = struct.pack('<H', halve(height))
        compression, colours, padding = 0, 0, 3
    else:
        if len(dib) < 20:
            raise ValueError('ICO/CUR: truncated bitmap header')
        field, = struct.unpack('<I', dib[8:12])
        flip = dib[11] == 0xFF
        height = 2 ** 32 - field if flip else field
        height = halve(height)
        dib[8:12] = struct.pack('<I', (2 ** 32 - height) % 2 ** 32 if flip
                                else height)
        bits, compression = struct.unpack('<HI', dib[14:20])
        colours = struct.unpack('<I', dib[32:36])[0] if len(dib) >= 36 else 0
        padding = 4
    pixels = 14 + size + (12 if size == 40 and compression == 3 else 0)
    if bits <= 8:
        pixels += padding * (colours or 1 << bits)
    return read_bmp(b'BM' + struct.pack('<IHHI', 14 + len(dib), 0, 0, pixels)
                    + bytes(dib))


def read_ico(data: bytes) -> np.ndarray:
    from .image_io import SIGNATURE, read_png, to_rgb
    if data[:4] != b'\0\0\1\0' or len(data) < 6:
        raise ValueError('not an ICO file')
    count, = struct.unpack('<H', data[4:6])
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise ValueError('ICO: truncated directory')
        width, height, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack('<HII', s[6:16])
        depth = bpp or (colours and math.ceil(math.log(colours, 2))) or 256
        entries.append((width * height, depth, offset))
    if not entries:
        raise Fallthrough('ICO: no images in the file')
    # Pillow sorts by colour depth, then (stably) by area, largest first
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    offset = entries[0][2]
    if data[offset:offset + 8] == SIGNATURE:
        return to_rgb(read_png(data[offset:]))
    return _dib(data, offset, lambda h: int(h / 2))


def read_cur(data: bytes) -> np.ndarray:
    if data[:4] != b'\0\0\2\0' or len(data) < 6:
        raise ValueError('not a CUR file')
    count, = struct.unpack('<H', data[4:6])
    best = b''
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise ValueError('CUR: truncated directory')
        if not best or (s[0] > best[0] and s[1] > best[1]):
            best = s
    if not best:
        raise Fallthrough('CUR: no cursors in the file')
    return _dib(data, struct.unpack('<I', best[12:16])[0], lambda h: h // 2)


# ------------------------------------------------------------------ TGA

TGA_MODES = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}


def tga_header(data: bytes):
    """Pillow's TGA header checks: the header's fields, or None when
    Pillow would not take the bytes for TGA."""
    if len(data) < 18:
        return None
    id_len, colormap, kind = data[0], data[1], data[2]
    width, height = struct.unpack('<HH', data[12:16])
    depth, flags = data[16], data[17]
    if colormap not in (0, 1) or width == 0 or height == 0 or depth not in (
            1, 8, 16, 24, 32) or kind not in (1, 2, 3, 9, 10, 11):
        return None
    return id_len, colormap, kind, width, height, depth, flags


def _bgr555(values: np.ndarray) -> np.ndarray:
    """Pillow's BGRA;15Z: 5-bit fields scaled by 255 // 31."""
    return np.stack([(values >> s & 31) * 255 // 31 for s in (10, 5, 0)],
                    -1).astype(np.uint8)


def _tga_rle(data: bytes, pos: int, pixels: int, size: int,
             width: int) -> bytes:
    """Pillow's TgaRleDecode: packets of ``size``-byte pixels; a literal
    may run on into the next rows, a run may not."""
    out = bytearray()
    total = pixels * size
    while len(out) < total:
        if pos >= len(data):
            raise ValueError('TGA: truncated RLE data')
        head = data[pos]
        n = (head & 0x7F) + 1
        if head & 0x80:
            if len(out) // size % width + n > width:
                raise ValueError('TGA: an RLE run across rows (PIL fails on '
                                 'it too)')
            out += data[pos + 1:pos + 1 + size] * n
            pos += 1 + size
        else:
            out += data[pos + 1:pos + 1 + n * size]
            pos += 1 + n * size
    return bytes(out[:total])


def read_tga(data: bytes) -> np.ndarray:
    header = tga_header(data)
    if header is None:
        raise ValueError('not a TGA file')
    id_len, colormap, kind, width, height, depth, flags = header
    pos = 18 + id_len
    table = None
    if colormap:
        start, count, map_depth = struct.unpack('<HHB', data[3:8])
        nbytes = {16: 2, 24: 3}.get(map_depth)
        if nbytes is None:
            raise ValueError(f'TGA with a {map_depth}-bit colour map is not '
                             'supported (PIL fails on it too)')
        raw = np.frombuffer(data[pos:pos + nbytes * count], np.uint8)
        pos += nbytes * count
        raw = np.concatenate([np.zeros(nbytes * start, np.uint8), raw])
        raw = raw[:len(raw) // nbytes * nbytes].reshape(-1, nbytes)
        table = _bgr555(raw[:, 0].astype(np.int64) | raw[:, 1].astype(
            np.int64) << 8) if nbytes == 2 else raw[:, ::-1]
    if (kind & 7, depth) not in TGA_MODES or (kind & 8 and depth == 1) or (
            (kind & 7 == 1) != bool(colormap)):
        raise ValueError(f'TGA of image type {kind} at {depth} bits is not '
                         'supported (PIL does not decode it)')
    n = width * height
    if depth == 1:
        stride = (width + 7) // 8
        _need(data, pos + stride * height, 'TGA')
        rows = np.frombuffer(data, np.uint8, stride * height, pos)
        pixels = np.unpackbits(rows.reshape(height, stride), axis=1)[
            :, :width, None]
    else:
        size = depth // 8
        raw = _tga_rle(data, pos, n, size, width) if kind & 8 else data[
            pos:pos + n * size]
        if len(raw) < n * size:
            raise ValueError('TGA: truncated image data')
        pixels = np.frombuffer(raw, np.uint8).reshape(height, width, size)
    if not flags & 0x20:   # bottom-up
        pixels = pixels[::-1]
    if flags & 0x10:       # right to left
        pixels = pixels[:, ::-1]
    kind &= 7
    if kind == 3:
        grey = pixels[:, :, 0] * (255 if depth == 1 else 1)
        return grey_rgb(grey)
    if kind == 1:
        return lookup(pixels[:, :, 0], table)
    if depth == 16:
        return _bgr555(pixels[:, :, 0].astype(np.int64)
                       | pixels[:, :, 1].astype(np.int64) << 8)
    return np.ascontiguousarray(pixels[:, :, 2::-1])


# ------------------------------------------------------------------ QOI

def read_qoi(data: bytes) -> np.ndarray:
    """QOI as Pillow's ``QoiDecoder`` reads it."""
    if data[:4] != b'qoif' or len(data) < 14:
        raise ValueError('not a QOI file')
    width, height = struct.unpack('>II', data[4:12])   # alpha is dropped
    total = width * height
    out = np.zeros((total, 4), np.uint8)
    seen = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    pos, i, n = 14, 0, len(data)
    while i < total:
        if pos >= n:
            raise ValueError('QOI: truncated image data')
        byte = data[pos]
        pos += 1
        op = byte >> 6
        if byte == 0xFE:
            value = (*data[pos:pos + 3], prev[3])
            pos += 3
        elif byte == 0xFF:
            value = tuple(data[pos:pos + 4])
            pos += 4
        elif op == 0:
            value = seen[byte & 63]
        elif op == 1:
            value = ((prev[0] + (byte >> 4 & 3) - 2) % 256,
                     (prev[1] + (byte >> 2 & 3) - 2) % 256,
                     (prev[2] + (byte & 3) - 2) % 256, prev[3])
        elif op == 2:
            second = data[pos]
            pos += 1
            green = (byte & 63) - 32
            value = ((prev[0] + green + (second >> 4) - 8) % 256,
                     (prev[1] + green) % 256,
                     (prev[2] + green + (second & 15) - 8) % 256, prev[3])
        else:
            run = min((byte & 63) + 1, total - i)
            out[i:i + run] = prev
            i += run
            continue
        if len(value) < 4:
            raise ValueError('QOI: truncated image data')
        prev = value
        seen[(value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11)
             % 64] = value
        out[i] = value
        i += 1
    return np.ascontiguousarray(out[:, :3].reshape(height, width, 3))


# ------------------------------------------------------------------ PSD

PSD_MODES = {(0, 1): 1, (0, 8): 1, (1, 8): 1, (2, 8): 1, (3, 8): 3,
             (4, 8): 4, (7, 8): 1, (8, 8): 1}


def _packbits_rows(data: bytes, pos: int, rows: int, width: int):
    """Pillow's PackBits decoder over ``rows`` rows: a run or literal that
    passes a row's end is cut there; returns the rows and the position."""
    out = np.zeros((rows, width), np.uint8)
    for y in range(rows):
        row = bytearray()
        while len(row) < width:
            if pos >= len(data):
                raise ValueError('PSD: truncated PackBits data')
            n = data[pos]
            if n == 0x80:
                pos += 1
            elif n > 0x80:
                row += data[pos + 1:pos + 2] * (257 - n)
                pos += 2
            else:
                row += data[pos + 1:pos + n + 2]
                pos += n + 2
        out[y] = np.frombuffer(bytes(row[:width]), np.uint8)
    return out, pos


def read_psd(data: bytes) -> np.ndarray:
    if data[:4] != b'8BPS' or len(data) < 26 or data[4:6] != b'\0\1':
        raise ValueError('not a Photoshop (PSD) file')
    psd_channels, height, width, depth, mode = struct.unpack(
        '>HIIHH', data[12:26])
    need = PSD_MODES.get((mode, depth))
    if need is None:
        raise ValueError(f'Photoshop (PSD) file of colour mode {mode} at '
                         f'{depth} bits is not supported (PIL reads none)')
    if need > psd_channels:
        raise ValueError('Photoshop (PSD) file with too few channels')
    channels = 4 if mode == 3 and psd_channels == 4 else need
    pos = 26
    size, = struct.unpack('>I', data[pos:pos + 4])
    palette = data[pos + 4:pos + 4 + size]
    pos += 4 + size
    if mode == 2 and size != 768:
        raise ValueError('indexed Photoshop (PSD) file without a 768-byte '
                         'colour table is not supported')
    for _ in range(2):   # image resources, layer and mask information
        size, = struct.unpack('>I', data[pos:pos + 4])
        pos += 4 + size
    compression, = struct.unpack('>H', data[pos:pos + 2])
    pos += 2
    stride = (width + 7) // 8 if depth == 1 else width
    planes = []
    if compression == 0:
        for _ in range(channels):
            _need(data, pos + stride * height, 'PSD')
            planes.append(np.frombuffer(data, np.uint8, stride * height,
                                        pos).reshape(height, stride))
            pos += width * height
    elif compression == 1:
        counts = np.frombuffer(data, '>u2', channels * height, pos)
        pos += 2 * channels * height
        for c in range(channels):
            planes.append(_packbits_rows(data, pos, height, stride)[0])
            pos += int(counts[c * height:(c + 1) * height].sum())
    else:
        raise ValueError(f'Photoshop (PSD) file with compression '
                         f'{compression} is not supported')
    if depth == 1:   # Pillow's "1" rawmode: a set bit is white
        return grey_rgb(np.unpackbits(planes[0], axis=1)[:, :width] * 255)
    if mode == 2:
        table = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        return lookup(planes[0], table)
    if channels == 1:
        return grey_rgb(planes[0])
    if mode == 4:   # CMYK stored inverted (Pillow's C;I ... K;I)
        return cmyk_rgb(255 - np.stack(planes[:4], -1))
    return np.stack(planes[:3], -1)


# ------------------------------------------------------------------ SGI

SGI_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1,
             (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4, (2, 3, 4): 4}


def _sgi_row(data: bytes, pos: int, length: int, bpc: int,
             width: int) -> np.ndarray:
    """One RLE row as Pillow's ``expandrow``: a count byte (or the low byte
    of a 16-bit word), copy when its top bit is set, else a run; a zero
    count ends the row."""
    dtype = np.dtype('>u2') if bpc == 2 else np.dtype(np.uint8)
    words = np.frombuffer(data[pos:pos + length * bpc], dtype)
    if words.size < length:
        raise ValueError('SGI: truncated RLE data')
    out = np.zeros(width, dtype.newbyteorder('='))
    x, i = 0, 0
    while i < length:
        pixel = int(words[i]) & 0xFF if bpc == 2 else int(words[i])
        i += 1
        count = pixel & 0x7F
        if not count:
            break
        if x + count > width:
            raise ValueError('SGI: an RLE row longer than the image')
        if pixel & 0x80:
            out[x:x + count] = words[i:i + count]
            i += count
        else:
            out[x:x + count] = words[i]
            i += 1
        x += count
    return out


def read_sgi(data: bytes) -> np.ndarray:
    if len(data) < 512 or data[:2] != b'\x01\xda':
        raise ValueError('not an SGI file')
    compression, bpc = data[2], data[3]
    dimension, width, height, zsize = struct.unpack('>HHHH', data[4:12])
    channels = SGI_MODES.get((bpc, dimension, zsize))
    if channels is None:
        raise ValueError(f'SGI with {bpc} bytes a sample, dimension '
                         f'{dimension} and {zsize} channels is not supported')
    if compression == 0:
        page = width * height * bpc
        _need(data, 512 + page * channels, 'SGI')
        dtype = '>u2' if bpc == 2 else np.uint8
        planes = np.frombuffer(data, dtype, width * height * channels,
                               512).reshape(channels, height, width)
    elif compression == 1:
        n = height * zsize
        _need(data, 512 + 8 * n, 'SGI')
        starts = np.frombuffer(data, '>u4', n, 512)
        lengths = np.frombuffer(data, '>u4', n, 512 + 4 * n)
        planes = np.stack([np.stack([
            _sgi_row(data, int(starts[y + c * height]),
                     int(lengths[y + c * height]) // bpc, bpc, width)
            for y in range(height)]) for c in range(channels)])
    else:
        raise ValueError(f'SGI with compression {compression} is not '
                         'supported')
    if bpc == 2:   # Pillow's ;16B rawmodes keep the high byte
        planes = planes >> 8
    planes = planes.astype(np.uint8)[:, ::-1]   # bottom-up
    if channels == 1:
        return grey_rgb(planes[0])
    return np.ascontiguousarray(np.moveaxis(planes[:3], 0, -1))


# ------------------------------------------------------------------ PCX

def pcx_accepts(data: bytes) -> bool:
    """Pillow's PCX test: 10, then version 0, 2, 3 or 5."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def read_pcx(data: bytes) -> np.ndarray:
    if not pcx_accepts(data) or len(data) < 128:
        raise ValueError('not a PCX file')
    version, bits = data[1], data[3]
    x0, y0, x1, y1 = struct.unpack('<HHHH', data[4:12])
    width, height = x1 + 1 - x0, y1 + 1 - y0
    if width <= 0 or height <= 0:
        raise Fallthrough('PCX: bad image size')
    planes, provided = data[65], struct.unpack('<H', data[66:68])[0]
    if not ((bits == 1 and planes in (1, 2, 4))
            or (version == 5 and bits == 8 and planes in (1, 3))):
        raise ValueError(f'PCX version {version} with {bits}-bit samples in '
                         f'{planes} planes is not supported (PIL reads none)')
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride
    # Pillow's PcxDecode: runs end at a line's end; then, for lines wider
    # than the image, each plane moved to a multiple of the width
    out = np.zeros((height, line), np.uint8)
    pos = 128
    for y in range(height):
        row = bytearray()
        while len(row) < line:
            if pos >= len(data):
                raise ValueError('PCX: truncated image data')
            b = data[pos]
            if b & 0xC0 == 0xC0:
                if pos + 1 >= len(data):
                    raise ValueError('PCX: truncated image data')
                if len(row) + (b & 0x3F) > line:
                    raise ValueError('PCX: a run past the end of a line')
                row += data[pos + 1:pos + 2] * (b & 0x3F)
                pos += 2
            else:
                row.append(b)
                pos += 1
        out[y] = np.frombuffer(bytes(row), np.uint8)
    if line % width and line > width:
        bands = line // width
        band_stride = line // bands
        for i in range(1, bands):
            out[:, i * width:(i + 1) * width] = out[
                :, i * band_stride:i * band_stride + width].copy()
    if bits == 1:   # bit planes, one a stride apart
        index = np.zeros((height, width), np.uint8)
        for p in range(planes):
            index |= np.unpackbits(out[:, p * stride:(p + 1) * stride],
                                   axis=1)[:, :width] << p
        if planes == 1:
            return grey_rgb(index * 255)
        return lookup(index, np.frombuffer(data[16:64], np.uint8).reshape(
            16, 3))
    if planes == 3:
        return np.stack([out[:, c * width:(c + 1) * width]
                         for c in range(3)], -1)
    grey = out[:, :width]
    trailer = data[-769:]
    if len(trailer) == 769 and trailer[0] == 12:
        table = np.frombuffer(trailer[1:], np.uint8).reshape(256, 3)
        if (table != np.arange(256)[:, None]).any():
            return lookup(grey, table)
    return grey_rgb(grey)
