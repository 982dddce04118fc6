"""Time GIF's LZW decode in Python against ``csrc/lzw.cpp``.

Run on a host with PIL (it writes the GIFs)::

    python tools/lzw_decode_time.py

For a smooth and a noisy 640x480 image that PIL saves as GIF, it prints
the ms of one decode of the frame's LZW data by a plain Python decoder
(the straightforward table-of-strings algorithm) and by the port's C++
library (median of 7), and whether both give the same bytes: the times
that decided to decode GIF's and TIFF's LZW codes in C++.
"""

import io
import os
import sys
import time

import numpy as np
import PIL.Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from openpifpaf_tpu_torch import image_formats  # noqa: E402


def python_lzw(data: bytes, min_code_size: int, size: int) -> bytes:
    clear = 1 << min_code_size
    width, prev = min_code_size + 1, None
    table = [bytes([i]) for i in range(clear)] + [b'', b'']
    out, acc, nbits, i = bytearray(), 0, 0, 0
    while len(out) < size:
        while nbits < width and i < len(data):
            acc |= data[i] << nbits
            nbits += 8
            i += 1
        if nbits < width:
            break
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            width, prev = min_code_size + 1, None
            del table[clear + 2:]
            continue
        if code == clear + 1:
            break
        entry = table[code] if code < len(table) else prev + prev[:1]
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
        prev = entry
        if len(table) >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:size])


def frame_lzw(gif: bytes):
    """The first frame's minimum code size and LZW bytes."""
    pos = 13 + (3 << ((gif[10] & 7) + 1) if gif[10] & 0x80 else 0)
    while gif[pos] == 0x21:
        _, pos = image_formats._gif_blocks(gif, pos + 2)  # pylint: disable=protected-access
    pos += 10
    data, _ = image_formats._gif_blocks(gif, pos + 1)  # pylint: disable=protected-access
    return gif[pos], data


def main():
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // w, yy * 255 // h,
                       (xx + yy) * 255 // (h + w)], -1).astype(np.uint8)
    noisy = np.clip(smooth + np.random.default_rng(0).normal(
        0, 30, smooth.shape), 0, 255).astype(np.uint8)
    for name, image in (('smooth', smooth), ('noisy', noisy)):
        buf = io.BytesIO()
        PIL.Image.fromarray(image).save(buf, 'GIF')
        min_code_size, data = frame_lzw(buf.getvalue())
        start = time.perf_counter()
        plain = python_lzw(data, min_code_size, h * w)
        python_ms = (time.perf_counter() - start) * 1e3
        image_formats.lzw_decode(data, h * w, min_code_size)
        times = []
        for _ in range(7):
            start = time.perf_counter()
            out = image_formats.lzw_decode(data, h * w, min_code_size)
            times.append((time.perf_counter() - start) * 1e3)
        print(f'{name} 640x480 GIF, {len(data)} bytes of LZW data: Python '
              f'{python_ms:.1f} ms, C++ {np.median(times):.2f} ms, equal '
              f'{plain == out.tobytes()}')


if __name__ == '__main__':
    main()
