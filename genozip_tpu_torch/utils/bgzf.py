"""Block-aware readers of gz-family inputs: BGZF and the multi-member gz
dialects, recording per-block isizes for byte-exact re-emission (reference
src/mgzip.c).

genozip_tpu_torch's own copy of the readers of genozip_tpu/utils/bgzf.py,
on their zlib path only: the deflate level is discovered among zlib's
levels, as the JAX package does where its C++ host runtime does not load.
"""

import zlib


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
