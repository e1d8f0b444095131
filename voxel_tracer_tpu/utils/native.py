"""Build the native libraries (`native/`) from their sources at first use.

The compiled files are not committed: `ensure_built` runs
`native/build.sh` once per checkout, under a file lock so that concurrent
processes build once.  Without a C compiler it returns False and callers
fall back to their pure-Python paths.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_tried = False


def ensure_built(path: str) -> bool:
    """True once ``path`` (a file `native/build.sh` makes) exists."""
    global _tried
    if os.path.exists(path):
        return True
    if _tried or not os.path.exists(os.path.join(NATIVE_DIR, "build.sh")):
        return False
    _tried = True
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                subprocess.run(["sh", os.path.join(NATIVE_DIR, "build.sh")],
                               check=True, capture_output=True, timeout=600)
            except (OSError, subprocess.SubprocessError):
                return False
    return os.path.exists(path)
