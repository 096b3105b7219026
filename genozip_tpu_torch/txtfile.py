"""Input text-file reading: VBlock chunking with record-boundary alignment.

genozip_tpu_torch's own copy of genozip_tpu/txtfile.py. URL inputs and
inputs read through external tools (.cram, .bcf, .ora) come through the
bridges of `stream`. Reference parity: src/txtfile.c:1228 txtfile_read_vblock (unconsumed-tail
handoff), src/mgzip.c (gz-family inflation — here the Python stdlib gz/bz2/xz
decompressors feed the chunker; BGZF-exact re-emission is a later milestone).
"""

import bz2
import gzip
import io
import lzma

import numpy as np

DEFAULT_VB_SIZE = 16 * 1024 * 1024


def open_input(path: str):
    if path == "-":
        return io.BufferedReader(io.FileIO(0, "r", closefd=False))
    if path.startswith(("http://", "https://", "ftp://")):
        from .stream import url_reader
        return url_reader(path)
    if path.endswith((".cram", ".bcf", ".ora")):
        from .stream import external_reader
        return external_reader(path)[0]
    if path.endswith((".gz", ".bgz", ".bam")):
        # BGZF gets a block-aware reader that records per-block isizes for
        # byte-exact re-emission (reference src/mgzip.c)
        from .utils.bgzf import is_bgzf, BgzfBlockReader, MgzipBlockReader
        raw = open(path, "rb")
        head = raw.read(18)
        raw.seek(0)
        if is_bgzf(head):
            return BgzfBlockReader(raw)
        if head[:2] == b"\x1f\x8b":
            # non-BGZF gz dialects (IL1M/IL4M/MGZF/MGSP/EMFL/EMVL/GZBL,
            # reference mgzip.h:14-33): member-splitting reader with
            # byte-exact re-emission discovery
            return MgzipBlockReader(raw)
        return gzip.open(raw, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    return open(path, "rb")


class TxtReader:
    def __init__(self, path: str, truncate: bool = False):
        self.f = open_input(path)
        self.buf = b""
        self.eof = False
        # on-disk size + compressed-ness for segconf vb_size auto-tuning
        # (reference segconf.c:101 segconf_set_vb_size)
        import os
        self.disk_size = None
        self.is_compressed = path.endswith(
            (".gz", ".bgz", ".bam", ".bz2", ".xz", ".cram", ".bcf", ".ora"))
        if path != "-" and not path.startswith(("http://", "https://",
                                                "ftp://")):
            try:
                self.disk_size = os.path.getsize(path)
            except OSError:
                pass
        # --truncate (reference zip.c:774): tolerate inputs cut mid-record /
        # mid-gz-member — compress the whole-record prefix
        self.truncate = truncate

    def peek(self, n: int) -> bytes:
        while len(self.buf) < n and not self.eof:
            chunk = self.f.read(n - len(self.buf))
            if not chunk:
                self.eof = True
                break
            self.buf += chunk
        return self.buf[:n]

    def read_header_lines(self, prefix: bytes) -> bytes:
        """Consume leading lines starting with `prefix` (e.g. b'@' for SAM,
        b'##'/b'#' for VCF handled by caller via repeated calls)."""
        out = bytearray()
        while True:
            line = self._read_line_peek()
            if line is None or not line.startswith(prefix):
                break
            out += line
            self.buf = self.buf[len(line):]
        return bytes(out)

    def _read_line_peek(self):
        """Peek one full line (incl. newline) without consuming."""
        while b"\n" not in self.buf and not self.eof:
            chunk = self.f.read(1 << 20)
            if not chunk:
                self.eof = True
                break
            self.buf += chunk
        if not self.buf:
            return None
        i = self.buf.find(b"\n")
        return self.buf[: i + 1] if i >= 0 else self.buf

    def vblocks(self, dt, vb_size: int | None = DEFAULT_VB_SIZE):
        """Yield np.uint8 arrays of whole records, ~vb_size each.
        vb_size None = caller didn't choose: segconf suggestion or default."""
        import zlib as _z
        import gzip as _g
        if vb_size is None:
            vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
        while True:
            while len(self.buf) < vb_size and not self.eof:
                try:
                    chunk = self.f.read(vb_size - len(self.buf))
                except (EOFError, _z.error, _g.BadGzipFile, AssertionError):
                    if not self.truncate:
                        raise
                    chunk = b""
                if not chunk:
                    self.eof = True
                    break
                self.buf += chunk
            if not self.buf:
                return
            data = np.frombuffer(self.buf, dtype=np.uint8)
            at_eof = self.eof and len(self.buf) <= vb_size
            if at_eof and self.truncate:
                # keep only whole records; silently drop the cut tail
                consumed = dt.vb_boundary(data, False)
                if consumed == 0:
                    return
                vb = data[:consumed].copy()
                yield dt.optimize_vb(vb) if dt.optimize_enabled else vb
                return
            consumed = dt.vb_boundary(data, at_eof)
            if consumed == 0:
                if self.eof:
                    raise ValueError(
                        "input ends mid-record (use --truncate to accept)")
                vb_size *= 2
                continue
            vb = data[:consumed].copy()
            yield dt.optimize_vb(vb) if dt.optimize_enabled else vb
            self.buf = self.buf[consumed:]

    def read_fastq_records(self, n: int) -> np.ndarray:
        """Consume exactly n FASTQ records (4n lines); fewer only at EOF.
        Used for R2 pairing (reference fastq_txtfile_sync_to_R1)."""
        need_nl = 4 * n
        while not self.eof:
            if self.buf.count(b"\n") >= need_nl:
                break
            chunk = self.f.read(1 << 22)
            if not chunk:
                self.eof = True
                break
            self.buf += chunk
        data = np.frombuffer(self.buf, dtype=np.uint8)
        nl = np.nonzero(data == ord("\n"))[0]
        take = min(need_nl, nl.shape[0])
        end = int(nl[take - 1]) + 1 if take else 0
        if take < need_nl and self.eof and len(self.buf) > end:
            end = len(self.buf)  # trailing partial line at EOF
        out = data[:end].copy()
        self.buf = self.buf[end:]
        return out

    def close(self):
        self.f.close()
