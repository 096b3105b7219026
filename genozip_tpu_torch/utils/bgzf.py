"""Block-aware readers of gz-family inputs (BGZF and the multi-member gz
dialects, recording per-block isizes for byte-exact re-emission) and the
BGZF / multi-member gz writers (reference src/mgzip.c).

genozip_tpu_torch's own copy of genozip_tpu/utils/bgzf.py on its zlib path
only: the deflate level is discovered among zlib's levels and every block
is deflated by zlib, as the JAX package does where its C++ host runtime
(libdeflate) does not load. An input only libdeflate re-creates is recorded
`exact: False` and re-emitted as standard BGZF. Blocks are deflated on a
thread pool (zlib releases the GIL) and written in order.
"""

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

BLOCK = 65280  # uncompressed payload per BGZF block (htslib convention)

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def is_bgzf(head: bytes) -> bool:
    return (len(head) >= 18 and head[0] == 0x1F and head[1] == 0x8B
            and head[3] & 4 and head[12] == 0x42 and head[13] == 0x43)


class BgzfBlockReader:
    """Block-aware BGZF reader recording per-block isizes + the info needed
    for byte-exact re-emission (reference src/mgzip.c: SEC_GZ_ISIZES +
    FlagsMgzip library/level discovery)."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.isizes = []
        self.header_template = None   # first block's 12-byte fixed header
        self.exact_level = None       # discovered zlib level, or None
        self.uniform_headers = True
        self._probe = None            # (payload, deflate_bytes) of 1st block
        self._raw = b""               # compressed tail awaiting a full block

    def read(self, want: int) -> bytes:
        out = bytearray()
        while len(out) < want:
            hdr = self.f.read(18)
            if not hdr:
                break
            assert is_bgzf(hdr), "BGZF stream corrupt"
            if self.header_template is None:
                self.header_template = hdr[:12]
            elif hdr[:12] != self.header_template:
                self.uniform_headers = False
            bsize = int.from_bytes(hdr[16:18], "little") + 1
            rest = self.f.read(bsize - 18)
            comp = rest[: bsize - 18 - 8]
            isize = int.from_bytes(rest[-4:], "little")
            payload = zlib.decompress(comp, -15) if comp else b""
            assert len(payload) == isize, "BGZF isize mismatch"
            self.isizes.append(isize)
            if self._probe is None and isize > 0:
                self._probe = (payload, comp)
            out += payload
        return bytes(out)

    def discover_level(self):
        """Trial zlib levels 1..9 against the first block (reference
        txtfile_discover_specific_gz). Returns (lib, level) or None."""
        if self._probe is None:
            return None
        payload, comp = self._probe
        for lvl in range(1, 10):
            co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            if co.compress(payload) + co.flush() == comp:
                self.exact_level = ("zlib", lvl)
                return self.exact_level
        return None

    def mgzip_info(self):
        disc = self.discover_level()
        if disc is None or not self.uniform_headers or \
                self.header_template is None or \
                self.header_template[10:12] != b"\x06\x00":  # XLEN == 6 (BC only)
            return {"kind": "bgzf", "exact": False}
        lib, lvl = disc
        return {"kind": "bgzf", "exact": True, "level": lvl, "lib": lib,
                "header": self.header_template.hex()}

    def close(self):
        self.f.close()


def _gz_header_len(buf: bytes) -> int:
    """Length of one gzip member header (enough of buf must be present)."""
    assert buf[:2] == b"\x1f\x8b" and buf[2] == 8, "not a gzip member"
    flg = buf[3]
    off = 10
    if flg & 4:                            # FEXTRA
        xlen = int.from_bytes(buf[off:off + 2], "little")
        off += 2 + xlen
    if flg & 8:                            # FNAME
        off = buf.index(b"\x00", off) + 1
    if flg & 16:                           # FCOMMENT
        off = buf.index(b"\x00", off) + 1
    if flg & 2:                            # FHCRC
        off += 2
    return off


def classify_mgzip(header: bytes, isizes) -> str:
    """Dialect name from the first member header + isize pattern
    (mgzip.h:14-33)."""
    body = [i for i in isizes[:-1] if i > 0] if len(isizes) > 1 else isizes
    if len(header) >= 16 and header[3] & 4 and header[12:14] == b"IG":
        return "mgzf"                       # MGI 32-bit BGZF variant
    if body and all(i == (1 << 20) for i in body):
        return "il1m"                       # Illumina 1MB members
    if body and all(i == (4 << 20) for i in body):
        return "il4m"
    if header[8:10] == b"\x00\x03" and len(set(body)) <= 1:
        return "mgsp"                       # MGI same-isize groups
    if isizes and isizes[0] == 0:
        return "emvl"                       # Element: leading empty block
    if body and len(set(body)) == 1:
        return "emfl"                       # Element fixed-length
    return "gzbl"                           # generic gz blocks


class MgzipBlockReader:
    """Member-splitting reader for the non-BGZF multi-member gz dialects.
    Records per-member isizes + headers for dialect classification and
    byte-exact re-emission."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.isizes = []
        self.headers_uniform = True
        self.header0 = None
        self._probe = None                  # (payload, deflate bytes)
        self._raw = b""                     # unparsed input bytes
        self._eof_in = False
        self._out = bytearray()

    def _fill(self, n=1 << 20):
        if not self._eof_in:
            chunk = self.f.read(n)
            if not chunk:
                self._eof_in = True
            self._raw += chunk

    def _read_member(self) -> bool:
        while len(self._raw) < 10 and not self._eof_in:
            self._fill()
        if not self._raw:
            return False
        while True:
            try:
                hl = _gz_header_len(self._raw)
                break
            except (IndexError, ValueError):
                if self._eof_in:
                    raise AssertionError("truncated gz member header")
                self._fill()
        hdr = self._raw[:hl]
        if self.header0 is None:
            self.header0 = hdr
        elif hdr != self.header0:
            self.headers_uniform = False
        d = zlib.decompressobj(-15)
        pos = hl
        payload = bytearray()
        comp_parts = []
        while True:
            if pos >= len(self._raw):
                if self._eof_in:
                    raise AssertionError("truncated gz member")
                self._fill()
            chunk = self._raw[pos:]
            out = d.decompress(chunk)
            payload += out
            if d.eof:
                used = len(chunk) - len(d.unused_data)
                comp_parts.append(chunk[:used])
                pos += used
                break
            comp_parts.append(chunk)
            pos += len(chunk)
        # trailer: crc32 + isize
        while len(self._raw) < pos + 8 and not self._eof_in:
            self._fill()
        isize = int.from_bytes(self._raw[pos + 4:pos + 8], "little")
        assert (len(payload) & 0xFFFFFFFF) == isize, "gz isize mismatch"
        self._raw = self._raw[pos + 8:]
        self.isizes.append(len(payload))
        if self._probe is None and payload:
            self._probe = (bytes(payload), b"".join(comp_parts))
        self._out += payload
        return True

    def read(self, want: int) -> bytes:
        while len(self._out) < want:
            if not self._read_member():
                break
        out = bytes(self._out[:want])
        del self._out[:want]
        return out

    def discover_level(self):
        if self._probe is None:
            return None
        payload, comp = self._probe
        for lvl in range(1, 10):
            co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            if co.compress(payload) + co.flush() == comp:
                return lvl
        return None

    def mgzip_info(self):
        # drain remaining members so the isize list is complete
        while self._read_member():
            pass
        kind = classify_mgzip(self.header0 or b"", self.isizes)
        lvl = self.discover_level()
        if lvl is None or not self.headers_uniform or self.header0 is None:
            return {"kind": kind, "exact": False}
        return {"kind": kind, "exact": True, "level": lvl,
                "header": self.header0.hex()}

    def close(self):
        self.f.close()


def _deflate(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


def _map_blocks(fn, payloads):
    """`fn` of each block payload, in order, on a thread pool."""
    if len(payloads) < 2:
        return [fn(p) for p in payloads]
    with ThreadPoolExecutor(max_workers=min(len(payloads),
                                            os.cpu_count() or 2)) as pool:
        return list(pool.map(fn, payloads))


def _bgzf_block(payload: bytes, comp: bytes, header: bytes = None) -> bytes:
    """One BGZF member: `header` (the 12 fixed bytes, magic..XLEN; htslib's
    when None), the BC subfield with BSIZE, the deflate bytes, CRC32 and
    ISIZE."""
    if header is None:
        header = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    bsize = len(comp) + len(header) + 6 + 8
    return b"".join((header, struct.pack("<BBHH", 0x42, 0x43, 2, bsize - 1),
                     comp, struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                       len(payload) & 0xFFFFFFFF)))


def _one_block(payload: bytes, level: int) -> bytes:
    """One standard BGZF block of `payload` deflated at zlib `level`."""
    return _bgzf_block(payload, _deflate(payload, level))


class BgzfWriter:
    """Standard BGZF output: 65280-byte blocks, htslib's header, an EOF
    marker (the non-exact re-compression of PIZ output)."""

    def __init__(self, fileobj, level: int = 6):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()

    def _emit(self, payloads):
        comps = _map_blocks(lambda p: _deflate(p, self.level), payloads)
        for p, c in zip(payloads, comps):
            self.f.write(_bgzf_block(p, c))

    def write(self, data: bytes):
        self.buf += data
        nfull = len(self.buf) // BLOCK
        if nfull:
            take = nfull * BLOCK
            mv = bytes(self.buf[:take])
            self._emit([mv[i:i + BLOCK] for i in range(0, take, BLOCK)])
            del self.buf[:take]

    def close(self):
        if self.buf:
            self._emit([bytes(self.buf)])
            self.buf.clear()
        self.f.write(EOF_BLOCK)
        self.f.close()


def open_bgzf(path: str, level: int = 6) -> BgzfWriter:
    return BgzfWriter(open(path, "wb"), level)


class _ExactWriter:
    """Byte-exact re-emission from recorded isizes + level + header: each
    block's plaintext is cut at its recorded isize and deflated again."""

    def __init__(self, fileobj, isizes, level: int, header: bytes):
        self.f = fileobj
        self.isizes = list(isizes)
        self.level = level
        self.header = header
        self.buf = bytearray()
        self.block_i = 0

    def _member(self, payload: bytes, comp: bytes) -> bytes:
        raise NotImplementedError

    def _deflate_block(self, payload: bytes) -> bytes:
        return _deflate(payload, self.level)

    def _emit(self, payloads):
        for p, c in zip(payloads, _map_blocks(self._deflate_block, payloads)):
            self.f.write(self._member(p, c))

    def write(self, data: bytes):
        self.buf += data
        payloads = []
        at = 0
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if need == 0 or len(self.buf) - at < need:
                break  # zero blocks are handled at close
            payloads.append(bytes(self.buf[at:at + need]))
            at += need
            self.block_i += 1
        if payloads:
            del self.buf[:at]
            self._emit(payloads)

    def close(self):
        payloads = []
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if len(self.buf) < need:
                raise ValueError("gz-exact: short plaintext")
            payloads.append(bytes(self.buf[:need]))
            del self.buf[:need]
            self.block_i += 1
        if self.buf:
            raise ValueError("gz-exact: plaintext longer than recorded")
        self._emit(payloads)
        self.f.close()


class ExactBgzfWriter(_ExactWriter):
    """Re-emit a BGZF file byte-exactly (only when discover_level matched
    a zlib level)."""

    def __init__(self, fileobj, isizes, level: int, header: bytes,
                 lib: str = "zlib"):
        if lib != "zlib":
            raise NotImplementedError(
                f"BGZF-exact output written by {lib}: not available in "
                "genozip_tpu_torch (zlib only)")
        super().__init__(fileobj, isizes, level, header)

    def _deflate_block(self, payload: bytes) -> bytes:
        if not payload:
            # empty block (EOF marker): canonical 2-byte final block,
            # constant across writer libraries (htslib bgzf.c)
            return b"\x03\x00"
        return _deflate(payload, self.level)

    def _member(self, payload: bytes, comp: bytes) -> bytes:
        return _bgzf_block(payload, comp, self.header)


class MgzipExactWriter(_ExactWriter):
    """Byte-exact re-emission of a multi-member gz file (any non-BGZF
    dialect) from recorded isizes + uniform header + discovered level."""

    def _member(self, payload: bytes, comp: bytes) -> bytes:
        return b"".join((self.header, comp, struct.pack(
            "<II", zlib.crc32(payload) & 0xFFFFFFFF,
            len(payload) & 0xFFFFFFFF)))
