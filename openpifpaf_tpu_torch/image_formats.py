"""PNM, GIF, TIFF and JPEG 2000 readers without PIL, and the WebP, LZW,
fax and JPEG 2000 libraries.

Each reader gives (H, W, 3) uint8 RGB, what the JAX package gets from
PIL's ``np.asarray(Image.open(path).convert('RGB'))`` (Pillow 12):

- PNM (numpy): P1-P6 with ``#`` comments; P1/P4 bilevel (1 is black);
  a maxval other than 255 scaled as Pillow's PPM decoders scale it
  (``round(v / maxval * 255)``, Python's rounding), greyscale above 255
  read into Pillow's 32-bit ``I`` mode (``* 65535``) and clipped at 255
  by its RGB conversion;
- GIF, the first frame: the LZW data (``csrc/lzw.cpp``), global and local
  colour tables, interlacing, on a canvas of the logical screen (grown to
  hold the frame, as Pillow grows it) that starts as the transparent index
  or 0; a table that is the identity grey ramp, or none, reads the indices
  as grey (Pillow's ``L``), any other is looked up (a transparent index
  shows its colour), indices past the table reading black;
- TIFF and BigTIFF, the first page, as libtiff hands it to Pillow:
  compression none, PackBits, LZW (libtiff's old LSB-first codes too),
  Deflate, JPEG (each strip or tile a datastream behind the JPEGTables,
  through ``jpeg.decode``) and CCITT Modified Huffman, T.4 and T.6
  (``csrc/fax.cpp``); predictors 2 and 3; strips and tiles, planar
  configuration 1 and 2, fill order 2; every layout of Pillow's
  ``OPEN_INFO`` (``TIFF_LAYOUTS``) converted as Pillow converts it: 1-,
  2-, 4- and 8-bit grey and palettes, 12-, 16- and 32-bit and signed
  samples clipped, float samples truncated, RGB and CMYK at 8 and 16 bits
  (the high byte), associated alpha divided out, YCbCr through libtiff's
  RGBA conversion (or, under JPEG, libjpeg's); old-style JPEG from a
  whole JPEG datastream (its raw components, libtiff's conversion); the
  other compressions raise a ``ValueError`` naming them;
- JPEG 2000 (JP2 and raw codestreams): ``read_jpeg2000``
  (``csrc/jpeg2000.cpp``, see its header);
- WebP: ``webp_decode`` (``csrc/webp.cpp``, see its header).

The C++ libraries are host libraries (``host_library.build``: built at
first use, never at import; a failed build raises, nothing falls back).
``WEBP_DECODES`` counts the WebP library's decodes in this process.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from . import host_library, jpeg

SOURCES = {name: host_library.CSRC / f'{name}.cpp'
           for name in ('webp', 'lzw', 'fax', 'jpeg2000')}
# the JPEG 2000 library's 9/7 wavelet and ICT must round as openjpeg's
# float operations do: no fused multiply-adds
FLAGS = {'jpeg2000': ('-ffp-contract=off',)}
WEBP_DECODES = 0

_LIBS = {}
_ERR = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library(name: str) -> ctypes.CDLL:
    """The loaded ``webp``, ``lzw``, ``fax`` or ``jpeg2000`` library,
    built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(host_library.build(
            SOURCES[name], name, name.upper(), flags=FLAGS.get(name, ()))))
        long_ = ctypes.c_long
        if name == 'webp':
            lib.webp_info.argtypes = [_U8P, long_, ctypes.POINTER(long_),
                                      ctypes.c_char_p, long_]
            lib.webp_info.restype = ctypes.c_int
            lib.webp_decode.argtypes = [_U8P, long_, _U8P, ctypes.c_char_p,
                                        long_]
            lib.webp_decode.restype = ctypes.c_int
        elif name == 'lzw':
            lib.lzw_decode.argtypes = [_U8P, long_, ctypes.c_int, _U8P,
                                       long_, ctypes.c_char_p, long_]
            lib.lzw_decode.restype = long_
        elif name == 'jpeg2000':
            lib.j2k_info.argtypes = [_U8P, long_, ctypes.POINTER(long_),
                                     ctypes.c_char_p, long_]
            lib.j2k_info.restype = ctypes.c_int
            lib.j2k_decode.argtypes = [_U8P, long_, ctypes.c_int,
                                       ctypes.c_int, _U8P, ctypes.c_char_p,
                                       long_]
            lib.j2k_decode.restype = ctypes.c_int
        else:
            lib.fax_decode.argtypes = [_U8P, long_, ctypes.c_int,
                                       ctypes.c_int, long_, long_, _U8P,
                                       ctypes.c_char_p, long_]
            lib.fax_decode.restype = long_
        _LIBS[name] = lib
    return _LIBS[name]


def _ptr(array: np.ndarray):
    return array.ctypes.data_as(_U8P)


def webp_decode(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB."""
    global WEBP_DECODES  # pylint: disable=global-statement
    lib = library('webp')
    buf = np.frombuffer(bytes(data), np.uint8)
    dims = (ctypes.c_long * 2)()
    err = ctypes.create_string_buffer(_ERR)
    if lib.webp_info(_ptr(buf), buf.size, dims, err, _ERR) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    WEBP_DECODES += 1
    if lib.webp_decode(_ptr(buf), buf.size, _ptr(out), err, _ERR) != 0:
        raise ValueError(err.value.decode())
    return out


def lzw_decode(data: bytes, size: int, min_code_size: int = 0) -> np.ndarray:
    """LZW data -> up to ``size`` bytes (fewer if the data ends first):
    GIF's codes for ``min_code_size`` 1..11, TIFF's for 0."""
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    n = library('lzw').lzw_decode(_ptr(buf), buf.size, min_code_size,
                                  _ptr(out), size, err, _ERR)
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n]


def grey_rgb(grey: np.ndarray) -> np.ndarray:
    return np.repeat(grey.astype(np.uint8)[:, :, None], 3, 2)


def lookup(indices: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Palette lookup as Pillow's P -> RGB: indices past ``table`` (N, 3)
    read black."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(table), 256)] = table[:256]
    return full[indices]


# ------------------------------------------------------------------- PNM

PNM_WHITESPACE = b' \t\n\x0b\x0c\r'


def _pnm_token(data: bytes, pos: int):
    """Pillow's ``_read_token``: the next header token, skipping
    whitespace and comments; returns it and the position after the one
    whitespace byte that ends it."""
    token = b''
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in PNM_WHITESPACE:
            if not token:
                continue
            break
        if c == b'#':
            while pos < len(data) and data[pos:pos + 1] not in b'\r\n':
                pos += 1
            pos += 1
            continue
        token += c
    if not token or len(token) > 10:
        raise ValueError('PNM: bad header')
    return token, pos


def _plain_tokens(body: bytes) -> list:
    """The data tokens of a plain PNM file, comments removed."""
    out = []
    for line in body.replace(b'\r', b'\n').split(b'\n'):
        out.extend(line.split(b'#', 1)[0].split())
    return out


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * out_max)``, half to even."""
    return np.round(values.astype(np.float64) / maxval * out_max)


def read_pnm(data: bytes) -> np.ndarray:
    """PBM, PGM or PPM bytes (P1-P6) -> (H, W, 3) uint8 RGB."""
    magic = data[:2]
    if magic not in (b'P1', b'P2', b'P3', b'P4', b'P5', b'P6') or (
            len(data) > 2 and data[2:3] not in PNM_WHITESPACE):
        raise ValueError(f'PNM variant {data[:3]!r} is not supported: only '
                         'P1-P6 are read')
    kind = int(magic[1:])
    pos = 3
    token, pos = _pnm_token(data, pos)
    width = int(token)
    token, pos = _pnm_token(data, pos)
    height = int(token)
    bands = 3 if kind in (3, 6) else 1
    n = width * height * bands
    if kind in (1, 4):
        if kind == 1:
            bits = b''.join(_plain_tokens(data[pos:]))
            if bits.translate(None, b'01'):
                raise ValueError('PBM: a data token other than 0 and 1')
            if len(bits) < n:
                raise ValueError('PNM image data is truncated')
            ones = np.frombuffer(bits[:n], np.uint8) == ord('1')
        else:
            stride = (width + 7) // 8
            raw = np.frombuffer(data[pos:], np.uint8)
            if raw.size < stride * height:
                raise ValueError('PNM image data is truncated')
            ones = np.unpackbits(raw[:stride * height].reshape(height, stride),
                                 axis=1)[:, :width] == 1
        return grey_rgb(np.where(ones, 0, 255).reshape(height, width))
    token, pos = _pnm_token(data, pos)
    maxval = int(token)
    if not 0 < maxval < 65536:
        raise ValueError('PNM: maxval must be greater than 0 and less than '
                         '65536')
    # Pillow reads greyscale above 255 into its 32-bit mode, which its RGB
    # conversion clips at 255
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    if kind in (2, 3):
        tokens = _plain_tokens(data[pos:])[:n]
        if len(tokens) < n:
            raise ValueError('PNM image data is truncated')
        values = np.array([int(t) for t in tokens], np.int64)
        if (values > maxval).any():
            raise ValueError('PNM: a channel value above maxval')
        values = _scale(values, maxval, out_max)
    else:
        dtype = np.dtype(np.uint8 if maxval < 256 else '>u2')
        raw = np.frombuffer(data[pos:pos + n * dtype.itemsize], dtype)
        if raw.size < n:
            raise ValueError('PNM image data is truncated')
        # Pillow's raw decoder for maxval 255 and for 16-bit greyscale,
        # its PPM decoder (values above maxval clipped) for the rest
        values = raw.copy()   # writable, as every reader's output
        if maxval != 255 and not (maxval == 65535 and bands == 1):
            values = np.minimum(_scale(raw, maxval, out_max), out_max)
    if values.dtype != np.uint8:
        values = np.minimum(values, 255).astype(np.uint8)
    if bands == 1:
        return grey_rgb(values.reshape(height, width))
    return values.reshape(height, width, 3)


# ------------------------------------------------------------------- GIF

def _gif_blocks(data: bytes, pos: int):
    """Data sub-blocks from ``pos``: their bytes and the position after
    the terminator."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b''.join(parts), pos


def _is_ramp(table: bytes) -> bool:
    """Pillow's ``_is_palette_needed``, negated: entry i is (i, i, i)."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return bool((t == np.arange(len(t))[:, None]).all())


def read_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame."""
    if data[:6] not in (b'GIF87a', b'GIF89a') or len(data) < 13:
        raise ValueError('not a GIF file')
    width, height, flags = struct.unpack('<HHB', data[6:11])
    pos = 13
    palette = None  # None: grey indices
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        table = data[pos:pos + size]
        pos += size
        if not _is_ramp(table):
            palette = np.frombuffer(table, np.uint8).reshape(-1, 3)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError('GIF: no image in the file')
        kind = data[pos]
        if kind == 0x21:  # extension
            label = data[pos + 1]
            _, after = _gif_blocks(data, pos + 2)
            if label == 0xF9 and data[pos + 2] >= 4 and data[pos + 3] & 1:
                transparency = data[pos + 6]
            pos = after
            continue
        if kind != 0x2C:
            pos += 1  # Pillow skips stray bytes between blocks
            continue
        x0, y0, w, h, fflags = struct.unpack('<HHHHB', data[pos + 1:pos + 10])
        pos += 10
        if fflags & 0x80:
            size = 3 << ((fflags & 7) + 1)
            table = data[pos:pos + size]
            pos += size
            palette = None if _is_ramp(table) else np.frombuffer(
                table, np.uint8).reshape(-1, 3)
        interlace = bool(fflags & 0x40)
        min_code_size = data[pos]
        lzw, _ = _gif_blocks(data, pos + 1)
        break
    # Pillow grows the canvas to hold the frame
    width, height = max(width, x0 + w), max(height, y0 + h)
    pixels = lzw_decode(lzw, w * h, min_code_size)
    if pixels.size < w * h:   # PIL raises too
        raise ValueError('GIF: truncated image data')
    frame = pixels.reshape(h, w)
    if interlace:
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        deinterlaced = np.empty_like(frame)
        deinterlaced[rows] = frame
        frame = deinterlaced
    canvas = np.full((height, width), transparency or 0, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if palette is None:
        return grey_rgb(canvas)
    return lookup(canvas, palette)


# ------------------------------------------------------------------ TIFF

TIFF_COMPRESSIONS = {
    1: 'none', 2: 'CCITT RLE', 3: 'CCITT Group 3 fax', 4: 'CCITT Group 4 fax',
    5: 'LZW', 6: 'old-style JPEG-in-TIFF', 7: 'JPEG-in-TIFF',
    8: 'Deflate', 32771: 'RLE-word', 32773: 'PackBits',
    32809: 'ThunderScan', 32946: 'Deflate', 34676: 'SGILog',
    34677: 'SGILog24', 34925: 'LZMA', 50000: 'Zstandard', 50001: 'WebP'}
TIFF_READ = (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32946)
# field type -> struct code (16-18: BigTIFF's 64-bit integers and IFD8)
TIFF_TYPES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
              8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd', 13: 'I', 16: 'Q',
              17: 'q', 18: 'Q'}


def _pil_layouts() -> dict:
    """Pillow's ``TiffImagePlugin.OPEN_INFO`` as rules: (byte order,
    photometric, sample format, fill order, bits, extra samples) -> how the
    samples become RGB.  A layout that is not here PIL does not read."""
    table = {}

    def add(kind, photos, fmt, fills, bits, extras=((),), orders='<>'):
        for order in orders:
            for photo in photos:
                for fill in fills:
                    for extra in extras:
                        table[(order, photo, fmt, fill, bits, extra)] = kind

    for depth in (1, 2, 4, 8):
        add('grey', (0, 1), (1,), (1, 2), (depth,))
        add('palette', (3,), (1,), (1, 2), (depth,))
    add('grey', (1,), (2,), (1,), (8,))          # signed bytes read raw
    add('grey', (6,), (1,), (1,), (8,))
    add('clip', (1,), (1,), (1,), (12,), orders='<')
    add('clip', (0, 1), (1,), (1,), (16,), orders='<')
    add('clip', (1,), (1,), (1,), (16,), orders='>')
    add('clip', (1,), (1,), (2,), (16,), orders='<')
    add('clip', (1,), (2,), (1,), (16,))
    add('clip', (1,), (1,), (1,), (32,), orders='<')
    add('clip', (1,), (2,), (1,), (32,))
    add('float', (0, 1), (3,), (1,), (32,))
    add('grey', (1,), (1,), (1,), (8, 8), ((2,),))
    add('rgb', (2,), (1,), (1, 2), (8, 8, 8))
    add('rgb', (2,), (1,), (1,), (8,) * 4, ((), (0,), (1,), (2,), (999,)))
    add('rgb', (2,), (1,), (1,), (8,) * 5, ((0, 0), (1, 0), (2, 0)))
    add('rgb', (2,), (1,), (1,), (8,) * 6, ((0, 0, 0), (1, 0, 0), (2, 0, 0)))
    add('rgb', (2,), (1,), (1,), (16,) * 3)
    add('rgb', (2,), (1,), (1,), (16,) * 4, ((), (0,), (1,), (2,)))
    add('palette', (3,), (1,), (1,), (8, 8), ((0,), (2,)))
    add('cmyk', (5,), (1,), (1,), (8,) * 4)
    add('cmyk', (5,), (1,), (1,), (8,) * 5, ((0,),))
    add('cmyk', (5,), (1,), (1,), (8,) * 6, ((0, 0),))
    add('cmyk', (5,), (1,), (1,), (16,) * 4)
    add('ycbcr', (6,), (1,), (1,), (8, 8, 8))
    return table


TIFF_LAYOUTS = _pil_layouts()
BIT_REVERSED = np.array([int(f'{i:08b}'[::-1], 2) for i in range(256)],
                        np.uint8)


def _tiff_tags(data: bytes, order: str, big: bool) -> dict:
    """The first IFD's tags: tag -> tuple of values."""
    count_code, entry_size, slot = ('Q', 20, 8) if big else ('H', 12, 4)
    offset, = struct.unpack(order + ('Q' if big else 'I'),
                            data[8:16] if big else data[4:8])
    head = struct.calcsize(count_code)
    if offset + head > len(data):
        raise ValueError('TIFF: truncated directory')
    count, = struct.unpack(order + count_code, data[offset:offset + head])
    tags = {}
    for i in range(count):
        at = offset + head + entry_size * i
        entry = data[at:at + entry_size]
        if len(entry) < entry_size:
            raise ValueError('TIFF: truncated directory')
        tag, kind = struct.unpack(order + 'HH', entry[:4])
        n, = struct.unpack(order + ('Q' if big else 'I'), entry[4:4 + slot])
        if kind not in TIFF_TYPES:
            continue
        code = TIFF_TYPES[kind]
        size = struct.calcsize(order + code) * n
        value = entry[4 + slot:]
        body = value[:size] if size <= slot else data[struct.unpack(
            order + ('Q' if big else 'I'), value)[0]:][:size]
        if len(body) < size:
            raise ValueError('TIFF: truncated tag data')
        values = struct.unpack(order + code * n, body)
        if kind in (5, 10):   # rationals
            values = tuple(a / b if b else 0.0
                           for a, b in zip(values[::2], values[1::2]))
        tags[tag] = values
    return tags


def _packbits(data: bytes, size: int) -> np.ndarray:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos < len(data):
                out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return np.frombuffer(bytes(out[:size]), np.uint8)


def fax_decode(raw: bytes, compression: int, options: int, width: int,
               rows: int) -> np.ndarray:
    """CCITT data (TIFF compression 2, 3 or 4, ``options`` its
    T4Options) -> (rows, width) uint8, 1 for black, rows the data does not
    reach white."""
    buf = np.frombuffer(bytes(raw), np.uint8)
    out = np.zeros((rows, width), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if library('fax').fax_decode(_ptr(buf), buf.size, compression, options,
                                 width, rows, _ptr(out), err, _ERR) < 0:
        raise ValueError(err.value.decode())
    return out


def _tiff_bytes(raw: bytes, compression: int, size: int) -> np.ndarray:
    """One strip's or tile's bytes, decompressed and padded to ``size``."""
    if compression == 1:
        out = np.frombuffer(raw[:size], np.uint8)
    elif compression == 5:
        # libtiff's test for the old, LSB-first codes of libtiff 4.x and
        # before, which are GIF's with 8-bit roots
        old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
        out = lzw_decode(raw, size, 8 if old else 0)
    elif compression in (8, 32946):
        out = np.frombuffer(zlib.decompressobj().decompress(raw, size),
                            np.uint8)
    else:
        out = _packbits(raw, size)
    full = np.zeros(size, np.uint8)
    full[:out.size] = out
    return full


def _unpack(raw: np.ndarray, rows: int, width: int, spp: int, depth: int,
            dtype: np.dtype) -> np.ndarray:
    """Decompressed rows -> (rows, width, spp) samples."""
    if depth in (1, 2, 4):
        stride = (width * spp * depth + 7) // 8
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        values = (raw.reshape(rows, stride)[:, :, None] >> shifts) & (
            (1 << depth) - 1)
        return values.reshape(rows, -1)[:, :width * spp].reshape(
            rows, width, spp)
    if depth == 12:   # two samples in three bytes, most significant first
        stride = (width * spp * 12 + 7) // 8
        b = raw.reshape(rows, stride).astype(np.uint16)
        n = width * spp
        b = np.pad(b, ((0, 0), (0, (-stride) % 3)))
        first = b[:, 0::3] << 4 | b[:, 1::3] >> 4
        second = (b[:, 1::3] & 15) << 8 | b[:, 2::3]
        values = np.stack([first, second], 2).reshape(rows, -1)[:, :n]
        return values.reshape(rows, width, spp)
    return raw.view(dtype).reshape(rows, width, spp)


def _float_predictor(raw: np.ndarray, rows: int, width: int, spp: int,
                     depth: int) -> np.ndarray:
    """libtiff's ``fpAcc``: each row's bytes summed along the row (a stride
    of ``spp``), then read as byte planes, most significant first."""
    nbytes = depth // 8
    row = raw.reshape(rows, -1).reshape(rows, width * nbytes, spp)
    row = np.cumsum(row, axis=1, dtype=np.uint8).reshape(rows, nbytes, -1)
    return np.ascontiguousarray(row.transpose(0, 2, 1)).view(
        f'>f{nbytes}').reshape(rows, width, spp)


def _tiff_jpeg(raw: bytes, tables: bytes, ycbcr: bool) -> np.ndarray:
    """A strip or tile of JPEG-in-TIFF: libtiff reads the ``JPEGTables``
    datastream before the strip's own, so the tables (but their EOI) go in
    front of the strip (but its SOI)."""
    if tables[-2:] == b'\xff\xd9' and raw[:2] == b'\xff\xd8':
        raw = tables[:-2] + raw[2:]
    return jpeg.decode(raw, 'ycbcr' if ycbcr else 'components')


def _old_jpeg(data: bytes, tags: dict, width: int, height: int):
    """Old-style JPEG-in-TIFF as libtiff's OJPEG codec and RGBA
    interface give it to Pillow: the interchange stream's components
    decoded raw (each downsampled one repeated over its block), then
    libtiff's YCbCr -> RGB.  The stream is the one JPEGInterchangeFormat
    points at, or a single strip that holds a whole datastream."""
    if 513 in tags:
        start = tags[513][0]
        stream = data[start:start + tags[514][0]] if 514 in tags else \
            data[start:]
    elif len(tags.get(273, ())) == 1 and data[tags[273][0]:][:2] == \
            b'\xff\xd8':
        start = tags[273][0]
        stream = data[start:start + tags[279][0]]
    else:
        raise ValueError('old-style JPEG-in-TIFF without a whole JPEG '
                         'datastream (JPEGInterchangeFormat, or one strip) '
                         'is not supported')
    planes = jpeg.decode(stream, 'blocks')
    if planes.shape != (height, width, 3):
        raise ValueError(f'old-style JPEG-in-TIFF whose JPEG holds '
                         f'{planes.shape}, not {width}x{height}x3, is not '
                         'supported')
    return _ycbcr_rgb(planes, tags.get(529, (0.299, 0.587, 0.114)),
                      tags.get(532, (0, 255, 128, 255, 128, 255)))


def _ycbcr_units(raw: np.ndarray, rows: int, width: int, sub: tuple):
    """YCbCr data in subsampling units (``sub`` = (h, v): h * v Y samples,
    then Cb and Cr) -> (rows, width, 3), Cb and Cr repeated over each unit
    as libtiff's RGBA interface repeats them."""
    sh, sv = sub
    uh, uw = -(-rows // sv), -(-width // sh)
    units = raw[:uh * uw * (sh * sv + 2)].reshape(uh, uw, sh * sv + 2)
    luma = units[:, :, :sh * sv].reshape(uh, uw, sv, sh).transpose(
        0, 2, 1, 3).reshape(uh * sv, uw * sh)
    chroma = np.repeat(np.repeat(units[:, :, sh * sv:], sv, 0), sh, 1)
    return np.dstack([luma, chroma])[:rows, :width]


def _ycbcr_rgb(samples: np.ndarray, luma: tuple,
               reference: tuple) -> np.ndarray:
    """libtiff's ``TIFFYCbCrToRGBInit`` and ``TIFFYCbCrtoRGB``: fixed-point
    tables from the coefficients and the reference black and white, in
    libtiff's float arithmetic."""
    f32 = np.float32
    red, green, blue = (f32(v) for v in luma)

    def fix(x):   # FIX(CLAMP(x, 0, 2)): the float scaled, then a double
        x = min(max(f32(x), f32(0)), f32(2))
        return np.int64(float(x * f32(65536)) + 0.5)

    d1 = fix(f32(2) - f32(2) * red)
    d2 = -fix(red * (f32(2) - f32(2) * red) / green)
    d3 = fix(f32(2) - f32(2) * blue)
    d4 = -fix(blue * (f32(2) - f32(2) * blue) / green)
    ref = [f32(v) for v in reference]

    def code2v(c, black, white, scale):
        black_i = np.int64(np.trunc(black))
        span = white - black
        span = span if span != 0 else f32(1)
        value = (c - black_i).astype(f32) * f32(scale) / f32(span)
        return np.trunc(np.clip(value, f32(-128 * 32), f32(128 * 32))
                        ).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    cr_r = (d1 * cr + 32768) >> 16
    cb_b = (d3 * cb + 32768) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + 32768
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    y, u, v = (samples[:, :, i].astype(np.int64) for i in range(3))
    rgb = np.stack([y_tab[y] + cr_r[v],
                    y_tab[y] + ((cb_g[u] + cr_g[v]) >> 16),
                    y_tab[y] + cb_b[u]], 2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb``: each of C, M, Y against (255 - K)."""
    c = cmyk.astype(np.int64)
    nk = 255 - c[:, :, 3:4]
    t = c[:, :, :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacker: colour divided by alpha, clipped."""
    alpha = alpha.astype(np.int64)
    divided = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(alpha, 1),
                         255)
    return np.where(alpha == 0, 0, divided).astype(np.uint8)


def read_tiff(data: bytes) -> np.ndarray:
    """TIFF or BigTIFF bytes -> (H, W, 3) uint8 RGB of the first page."""
    big = data[:4] in (b'II+\x00', b'MM\x00+')
    if data[:4] not in (b'II*\x00', b'MM\x00*') and not big:
        raise ValueError('not a TIFF file')
    order = '<' if data[:2] == b'II' else '>'
    tags = _tiff_tags(data, order, big)

    def tag(number, default=None):
        value = tags.get(number)
        if value is None:
            if default is None:
                raise ValueError(f'TIFF without tag {number}')
            return default
        return value

    width, height = tag(256)[0], tag(257)[0]
    compression = tag(259, (1,))[0]
    photometric = tag(262, (0,))[0]   # PIL's default when it is missing
    if compression == 6:   # PIL: old-style JPEG is YCbCr
        photometric = 6
    spp = tag(277, (3 if compression == 6 and photometric in (2, 6)
                    else 1,))[0]
    bits = tag(258, (1,))
    bits = bits[:spp] if len(bits) > spp else bits * spp if len(
        bits) == 1 else bits
    sample_format = tag(339, (1,))
    if len(sample_format) > 1 and set(sample_format) == {1}:
        sample_format = (1,)
    extra = tag(338, ())
    fill = tag(266, (1,))[0]
    planar = tag(284, (1,))[0]
    predictor = tag(317, (1,))[0]
    if compression not in TIFF_READ:
        name = TIFF_COMPRESSIONS.get(compression, f'compression {compression}')
        raise ValueError(f'TIFF with {name} compression is not supported')
    key = (order, photometric, sample_format, fill, bits, extra)
    kind = TIFF_LAYOUTS.get(key)
    if kind is None or len(bits) != spp:
        raise ValueError(
            f'TIFF with photometric {photometric}, '
            f'{"/".join(map(str, bits))}-bit samples, sample format '
            f'{"/".join(map(str, sample_format))}, fill order {fill} and '
            f'extra samples {extra} is not supported (PIL reads no such '
            'layout)')
    depth = bits[0]
    fax = compression in (2, 3, 4)
    if fax and bits != (1,):
        raise ValueError('TIFF: CCITT compression of samples wider than 1 '
                         'bit')
    if compression in (6, 7) and depth != 8:
        raise ValueError(f'TIFF: JPEG compression of {depth}-bit samples')
    if compression == 6:
        return _old_jpeg(data, tags, width, height)
    if kind == 'ycbcr' and compression == 1:
        raise ValueError('uncompressed YCbCr TIFF is not supported (PIL '
                         'fails on it too)')
    if kind == 'ycbcr' and planar != 1:
        raise ValueError('YCbCr TIFF with planar configuration 2 is not '
                         'supported')
    # libtiff undoes the predictor; Pillow's own raw decoder ignores it
    predictor = predictor if compression != 1 else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and depth not in (
            8, 16, 32)) or (predictor == 3 and sample_format != (3,)):
        raise ValueError(f'TIFF with predictor {predictor} on {depth}-bit '
                         'samples is not supported')
    signed = sample_format == (2,) or kind == 'clip' and depth == 32
    dtype = np.dtype({8: 'u1', 16: 'u2', 32: 'u4'}.get(depth, 'u1'))
    if sample_format == (3,):
        dtype = np.dtype('f4')
    dtype = dtype.newbyteorder(order)
    jpeg_ycbcr = compression == 7 and kind == 'ycbcr'
    units = kind == 'ycbcr' and not jpeg_ycbcr
    sub = tuple(tag(530, (2, 2))) if units else (1, 1)

    if 322 in tags:  # tiles
        chunk_w, chunk_h = tag(322)[0], tag(323)[0]
        offsets, counts = tag(324), tag(325)
        across, down = -(-width // chunk_w), -(-height // chunk_h)
    else:
        chunk_w, chunk_h = width, min(tag(278, (2 ** 32 - 1,))[0], height)
        offsets, counts = tag(273), tag(279)
        across, down = 1, -(-height // chunk_h)
    planes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    if units:
        uh = -(-chunk_h // sub[1])
        size = uh * -(-chunk_w // sub[0]) * (sub[0] * sub[1] + 2)
    else:
        size = (chunk_w * chunk_spp * depth + 7) // 8 * chunk_h
    out_dtype = np.uint8 if depth <= 8 else (
        np.uint16 if depth == 12 else dtype.newbyteorder('='))
    samples = np.zeros((down * chunk_h, across * chunk_w, spp), out_dtype)
    tables = bytes(tag(347, ()))
    for index, (offset, count) in enumerate(zip(offsets, counts)):
        plane, place = divmod(index, across * down)
        if plane >= planes:
            break
        y, x = place // across * chunk_h, place % across * chunk_w
        if y >= height:
            continue
        raw = data[offset:offset + count]
        if fill == 2:
            raw = BIT_REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        rows = min(chunk_h, height - y) if 322 not in tags else chunk_h
        if fax:
            chunk = fax_decode(raw, compression, tag(292, (0,))[0],
                               chunk_w, rows)[:, :, None]
        elif compression == 7:
            chunk = _tiff_jpeg(raw, tables, jpeg_ycbcr)
        else:
            flat = _tiff_bytes(raw, compression, size)
            if units:
                chunk = _ycbcr_units(flat, chunk_h, chunk_w, sub)
            elif predictor == 3:
                chunk = _float_predictor(flat, chunk_h, chunk_w, chunk_spp,
                                         depth)
            else:
                chunk = _unpack(flat, chunk_h, chunk_w, chunk_spp, depth,
                                dtype)
                if predictor == 2:
                    wrap = np.dtype(f'u{dtype.itemsize}')
                    chunk = np.cumsum(chunk.view(wrap.newbyteorder(order)),
                                      axis=1, dtype=wrap).view(out_dtype)
        channels = slice(plane, plane + 1) if planar == 2 else slice(None)
        h, w = min(chunk.shape[0], chunk_h), min(chunk.shape[1], chunk_w)
        samples[y:y + h, x:x + w, channels] = chunk[:h, :w]
    samples = samples[:height, :width]
    if order == '>' and compression != 1 and (signed or kind == 'float') \
            and np.little_endian:
        # libtiff hands Pillow samples in the host's byte order, which
        # Pillow's I;16BS, I;32BS and F;32BF unpackers read as big-endian
        samples = samples.byteswap()
    return _tiff_rgb(samples, kind, photometric, depth, signed, extra, tags,
                     converted=jpeg_ycbcr)


def _tiff_rgb(samples: np.ndarray, kind: str, photometric: int, depth: int,
              signed: bool, extra: tuple, tags: dict,
              converted: bool) -> np.ndarray:
    """Samples -> RGB as Pillow's unpacker and ``convert('RGB')`` do."""
    if kind == 'grey':   # 1 to 8 bits, scaled to 8 (x255, x85, x17, x1)
        grey = samples[:, :, 0].astype(np.int64) * (255 // ((1 << depth) - 1))
        return grey_rgb(255 - grey if photometric == 0 else grey)
    if kind == 'clip':   # Pillow's I;16 and I modes: clipped at 0 and 255
        values = samples[:, :, 0]
        if signed:
            values = values.view(np.int32) if depth == 32 else values.view(
                np.int16)
        return grey_rgb(np.clip(values.astype(np.int64), 0, 255))
    if kind == 'float':   # Pillow's F -> L: clipped, then truncated
        return grey_rgb(np.trunc(np.clip(samples[:, :, 0].astype(np.float64),
                                         0, 255)))
    if kind == 'palette':
        colours = np.array(tags[320], np.int64).reshape(3, -1).T // 256
        return lookup(samples[:, :, 0], colours.astype(np.uint8))
    if depth == 16:   # Pillow's ;16 unpackers keep the high byte
        samples = (samples >> 8).astype(np.uint8)
    if kind == 'cmyk':
        return cmyk_rgb(samples)
    if kind == 'ycbcr' and not converted:
        return _ycbcr_rgb(samples, tags.get(529, (0.299, 0.587, 0.114)),
                          tags.get(532, (0, 255, 128, 255, 128, 255)))
    rgb = samples[:, :, :3]
    if extra[:1] == (1,):  # associated alpha: Pillow's RGBa unpacker
        rgb = unpremultiply(rgb, samples[:, :, 3:4])
    return np.ascontiguousarray(rgb)


# ------------------------------------------------------------ JPEG 2000

J2K_SIGNATURE = b'\xff\x4f\xff\x51'
JP2_SIGNATURE = b'\x00\x00\x00\x0cjP  \r\n\x87\n'
# Pillow's modes, as the C library numbers them
J2K_MODES = ('L', 'I;16', 'LA', 'RGB', 'RGBA', 'CMYK')
# JP2 colr enumerated colour spaces -> openjpeg's OPJ_CLRSPC_* numbers
JP2_SPACES = {16: 1, 17: 2, 18: 3, 12: 5}
JP2_SPACE_NAMES = {24: 'e-sYCC', 14: 'CIELab', 15: 'bi-level'}


def _boxes(data: bytes, pos: int, end: int):
    """JP2 boxes in ``data[pos:end]``: (type, body start, body end)."""
    while pos + 8 <= end:
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        head = 8
        if length == 1:
            length, = struct.unpack('>Q', data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError('JPEG 2000: a truncated JP2 box')
        yield kind, pos + head, pos + length
        pos += length


def _jp2(data: bytes):
    """JP2 file -> (codestream, Pillow's mode, openjpeg's colour space)."""
    mode = space = None
    for kind, start, end in _boxes(data, 0, len(data)):
        if kind == b'jp2h':
            channels = 0
            for sub, s0, s1 in _boxes(data, start, end):
                if sub == b'ihdr':
                    _, _, channels, bpc = struct.unpack('>IIHB',
                                                        data[s0:s0 + 11])
                    mode = {1: 'I;16' if (bpc & 0x7F) > 8 else 'L', 2: 'LA',
                            3: 'RGB', 4: 'RGBA'}.get(channels)
                elif sub == b'colr' and space is None:
                    method = data[s0]
                    if method != 1:
                        raise ValueError('JPEG 2000 with an ICC colour '
                                         'profile is not supported')
                    enumcs, = struct.unpack('>I', data[s0 + 3:s0 + 7])
                    if enumcs not in JP2_SPACES:
                        name = JP2_SPACE_NAMES.get(enumcs, f'colour space '
                                                   f'{enumcs}')
                        raise ValueError(f'JPEG 2000 in {name} is not '
                                         'supported')
                    space = JP2_SPACES[enumcs]
                    if channels == 4 and enumcs == 12:
                        mode = 'CMYK'
                elif sub in (b'pclr', b'cmap'):
                    raise ValueError('JPEG 2000 with a palette (pclr) is not '
                                     'supported')
                elif sub == b'cdef':
                    n, = struct.unpack('>H', data[s0:s0 + 2])
                    for i in range(n):
                        channel, kind_, asoc = struct.unpack(
                            '>HHH', data[s0 + 2 + 6 * i:s0 + 8 + 6 * i])
                        if channel != i or (kind_ == 0 and asoc != i + 1):
                            raise ValueError('JPEG 2000 with reordered '
                                             'channels (cdef) is not '
                                             'supported')
        elif kind == b'jp2c':
            if mode is None or space is None:
                raise ValueError('JPEG 2000: a JP2 file without a header '
                                 'box or a colour specification')
            return data[start:end], mode, space
    raise ValueError('JPEG 2000: a JP2 file without a codestream')


def read_jpeg2000(data: bytes) -> np.ndarray:
    """JP2 or J2K bytes -> (H, W, 3) uint8 RGB, what Pillow's decoder (on
    openjpeg 2.5) and ``convert('RGB')`` give."""
    if data.startswith(JP2_SIGNATURE):
        stream, mode, space = _jp2(data)
    elif data.startswith(J2K_SIGNATURE):
        stream, mode, space = data, None, 0
    else:
        raise ValueError('not a JPEG 2000 file')
    lib = library('jpeg2000')
    buf = np.frombuffer(bytes(stream), np.uint8)
    dims = (ctypes.c_long * 4)()
    err = ctypes.create_string_buffer(_ERR)
    if lib.j2k_info(_ptr(buf), buf.size, dims, err, _ERR) != 0:
        raise ValueError(err.value.decode())
    if mode is None:   # Pillow's _parse_codestream
        mode = {1: 'I;16' if dims[3] > 8 else 'L', 2: 'LA', 3: 'RGB',
                4: 'RGBA'}.get(dims[2])
        if mode is None:
            raise ValueError(f'JPEG 2000 with {dims[2]} components is not '
                             'supported (PIL reads 1 to 4)')
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    if lib.j2k_decode(_ptr(buf), buf.size, J2K_MODES.index(mode), space,
                      _ptr(out), err, _ERR) != 0:
        raise ValueError(err.value.decode())
    return out
