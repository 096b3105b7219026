"""Progress reporting (genozip_tpu_torch's own copy of
genozip_tpu/utils/progress.py, unchanged; reference parity: src/progress.c — percent + MB/s on
stderr, silent when not a tty or disabled)."""

import os
import sys
import time

# --quiet / GXZ_QUIET: suppress progress globally (reference flags.quiet)
QUIET = bool(os.environ.get("GXZ_QUIET"))


def set_quiet(q: bool):
    global QUIET
    QUIET = q


class Progress:
    def __init__(self, label: str, total_bytes: int | None, enabled=None):
        self.label = label
        self.total = total_bytes
        self.done = 0
        self.start = time.time()
        self.last = 0.0
        self.enabled = (sys.stderr.isatty() if enabled is None else enabled) \
            and not QUIET

    def update(self, nbytes: int):
        self.done += nbytes
        now = time.time()
        if not self.enabled or now - self.last < 0.25:
            return
        self.last = now
        mbps = self.done / 1e6 / max(now - self.start, 1e-9)
        if self.total:
            pct = 100.0 * self.done / self.total
            sys.stderr.write(f"\r{self.label}: {pct:5.1f}%  {mbps:6.1f} MB/s ")
        else:
            sys.stderr.write(f"\r{self.label}: {self.done / 1e6:8.1f} MB  {mbps:6.1f} MB/s ")
        sys.stderr.flush()

    def finish(self, extra: str = ""):
        if not self.enabled:
            return
        dt = time.time() - self.start
        mbps = self.done / 1e6 / max(dt, 1e-9)
        sys.stderr.write(f"\r{self.label}: done  {self.done / 1e6:.1f} MB in "
                         f"{dt:.1f}s ({mbps:.1f} MB/s) {extra}\n")
        sys.stderr.flush()
