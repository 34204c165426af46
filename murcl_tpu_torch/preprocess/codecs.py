"""TIFF tile and strip codecs on the standard library and numpy.

Decoded here: none (1), deflate (8, and Adobe's 32946) by :mod:`zlib`,
which releases the interpreter lock, and LZW (5) and PackBits (32773) in
Python. LZW runs code by code, at a few MB/s: enough for the tests' files
and for small slides; scanned slides are JPEG or deflate. JPEG (7) goes to
:mod:`murcl_tpu_torch.preprocess.nvjpeg`. Any other compression is refused
by its name and number, so that nothing is read in its place.

The encoders are the inverse of the decoders, for
:func:`murcl_tpu_torch.data.synthetic.write_tiff`.
"""

from __future__ import annotations

import zlib

NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 7, 8, 32946, 32773
NAMES = {1: "none", 2: "CCITT RLE", 3: "CCITT group 3", 4: "CCITT group 4", 5: "LZW",
         6: "old-style JPEG", 7: "JPEG", 8: "deflate", 32946: "deflate (Adobe)",
         32773: "PackBits", 33003: "JPEG 2000 (Aperio YCbCr)", 33005: "JPEG 2000 (Aperio RGB)",
         34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP",
         50002: "JPEG XL"}
PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE)  # the codecs libtiff applies Predictor 2 to
_CLEAR, _EOI = 256, 257


def name(compression: int) -> str:
    return f"{NAMES.get(compression, 'unknown')} ({compression})"


def unsupported(compression: int) -> ValueError:
    return ValueError(f"TIFF compression {name(compression)} is not supported: none, LZW, "
                      "deflate and PackBits are read on the host, JPEG by nvJPEG on the card "
                      "or by PIL on the CPU")


def lzw_decode(data: bytes) -> bytes:
    """TIFF's LZW: codes of 9-12 bits, most significant bit first, the width
    growing one code early (at 511, 1023 and 2047 table entries)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, pos, width, prev = 8 * len(data), 0, 9, None
    padded = bytes(data) + b"\0\0\0"
    while pos + width <= nbits:
        byte = pos >> 3
        word = (padded[byte] << 16) | (padded[byte + 1] << 8) | padded[byte + 2]
        code = (word >> (24 - width - (pos & 7))) & ((1 << width) - 1)
        pos += width
        if code == _CLEAR:
            del table[258:]
            width, prev = 9, None
            continue
        if code == _EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"LZW: code {code} past the table ({len(table)} entries)")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """The inverse of :func:`lzw_decode`. Each code goes out at the width the
    decoder will read it with: the decoder's table lags the encoder's by one
    entry, so the width follows the decoder's count. A clear code goes out
    before the table passes 4093 entries."""
    out, nbits, acc = bytearray(), 0, 0
    table, width, seen, dec_len, next_code = {}, 9, 0, 258, 258

    def emit(code):
        nonlocal nbits, acc, width, seen, dec_len
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
        seen += 1
        if seen > 1:
            dec_len += 1
        if dec_len >= (1 << width) - 1 and width < 12:
            width += 1

    def clear():
        nonlocal table, width, seen, dec_len, next_code
        emit(_CLEAR)
        table = {bytes([i]): i for i in range(256)}
        width, seen, dec_len, next_code = 9, 0, 258, 258

    clear()
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        if next_code >= 4094:
            clear()
        w = bytes([b])
    if w:
        emit(table[w])
    emit(_EOI)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes) -> bytes:
    """Apple's PackBits: a header byte n, then n + 1 literal bytes (n < 128)
    or one byte repeated 257 - n times (n > 128); 128 is a no-op."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """Runs of 3 to 128 equal bytes as repeats, the rest as literals of at
    most 128 bytes."""
    out = bytearray()
    i, n = 0, len(data)
    lit = bytearray()
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            for s in range(0, len(lit), 128):
                out += bytes([len(lit[s:s + 128]) - 1]) + lit[s:s + 128]
            lit.clear()
            out += bytes([257 - run, data[i]])
            i += run
        else:
            lit += data[i:i + run]
            i += run
    for s in range(0, len(lit), 128):
        out += bytes([len(lit[s:s + 128]) - 1]) + lit[s:s + 128]
    return bytes(out)


def decompress(compression: int, data: bytes) -> bytes:
    """One tile's or strip's bytes as stored -> its pixel bytes (not JPEG)."""
    if compression == NONE:
        return data
    if compression in (DEFLATE, ADOBE_DEFLATE):
        return zlib.decompress(data)
    if compression == LZW:
        return lzw_decode(data)
    if compression == PACKBITS:
        return packbits_decode(data)
    raise unsupported(compression)


def compress(compression: int, data: bytes) -> bytes:
    """Pixel bytes -> one tile's or strip's bytes, for the writer."""
    if compression == NONE:
        return data
    if compression in (DEFLATE, ADOBE_DEFLATE):
        return zlib.compress(data, 6)
    if compression == LZW:
        return lzw_encode(data)
    if compression == PACKBITS:
        return packbits_encode(data)
    raise unsupported(compression)
