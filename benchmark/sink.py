"""A restored file's consumer: a named pipe that a thread of this process
drains, as `genocat ... | aligner` consumes it, so that nothing restored is
written to disk.

The program opens the pipe by its path (`piz_file(archive, sink.path)`,
BGZF and all for a `.bam`); the thread reads it in 1 MiB reads, which
release the interpreter lock, into a SHA-256 where the comparison wants
the file, and otherwise only counts its bytes.
"""

import fcntl
import hashlib
import os
import threading

F_SETPIPE_SZ = 1031


class HashSink:
    """`sink.restore(write, digest)` has `write(sink.path)` restore a file
    into the pipe and returns (its SHA-256, or None unless `digest`; its
    bytes). `close()` at the end."""

    def __init__(self, path: str):
        self.path = path
        os.mkfifo(path)

    def close(self):
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _drain(self, digest: bool, out: list):
        fd = os.open(self.path, os.O_RDONLY)
        try:
            try:
                fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
            except OSError:
                pass
            h, n = hashlib.sha256() if digest else None, 0
            while chunk := os.read(fd, 1 << 20):
                if h:
                    h.update(chunk)
                n += len(chunk)
        finally:
            os.close(fd)
        out.append((h.hexdigest() if h else None, n))

    def _release(self):
        """Open the pipe's writing end and close it: a reader that waits
        for a writer (one that never came) then sees the file end."""
        try:
            os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
        except OSError:          # no reader waits: it has finished
            pass

    def restore(self, write, digest: bool = True) -> tuple:
        """`write(path)` restores a file into the pipe; returns (digest or
        None, bytes). What `write` raises is raised once the reader has
        ended."""
        out = []
        t = threading.Thread(target=self._drain, args=(digest, out),
                             daemon=True)
        t.start()
        try:
            write(self.path)
        finally:
            while t.is_alive():      # the reader may not have opened yet
                self._release()
                t.join(0.05)
        if not out:
            raise RuntimeError(f"{self.path}: the reader ended without a "
                               "result")
        return out[0]
