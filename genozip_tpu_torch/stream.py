"""External input bridges: CRAM, BCF and ORA through child processes, URLs
through curl or wget.

Counterpart of genozip_tpu/stream.py. Reference parity: src/stream.c:248
stream_create and src/file.c:39-40,560,660 (CRAM crosses a pipe to
`samtools view`, BCF to `bcftools view`, .ora to `orad`), src/url.c:36-82
(remote inputs through curl or wget). Each bridge raises a clear error when
its tool is not on PATH.
"""

import io
import shutil
import subprocess


class _PipeReader(io.RawIOBase):
    """File-like over a child process' stdout; reaps the child on close."""

    def __init__(self, proc):
        self.proc = proc
        self.raw = proc.stdout

    def read(self, n=-1):
        return self.raw.read(n)

    def close(self):
        try:
            self.raw.close()
        finally:
            rc = self.proc.wait()
            if rc != 0:
                raise RuntimeError(f"external decoder exited with {rc}")


def _spawn(argv):
    return _PipeReader(subprocess.Popen(
        argv, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL))


def _tool(name: str, message: str) -> str:
    tool = shutil.which(name)
    if not tool:
        raise FileNotFoundError(message)
    return tool


def external_reader(path: str):
    """(file-like of the decoded text, datatype hint) for an input that
    needs an external decoder; None if `path` is not such an input."""
    if path.endswith(".cram"):
        tool = _tool("samtools", "CRAM input needs `samtools` on PATH "
                     "(reference bridges CRAM the same way, file.c:560)")
        return _spawn([tool, "view", "-h", path]), "sam"
    if path.endswith(".bcf"):
        tool = _tool("bcftools", "BCF input needs `bcftools` on PATH "
                     "(reference parity file.c:660)")
        return _spawn([tool, "view", path]), "vcf"
    if path.endswith(".ora"):
        tool = _tool("orad", ".ora input needs DRAGEN `orad` on PATH")
        return _spawn([tool, "--raw", "--stdout", path]), "fastq"
    return None


def url_reader(url: str):
    """A remote input, streamed (reference src/url.c through curl/wget)."""
    for argv in (["curl", "-fsSL", url], ["wget", "-qO-", url]):
        if shutil.which(argv[0]):
            return _spawn(argv)
    raise FileNotFoundError("URL input needs curl or wget on PATH "
                            "(reference url.c:36-82)")
