"""Native C++ libraries: libnucio.so (BAM ingest, wire encoders, bedgraph
format/parse) and libnucrefine.so (the float64 nuc refinisher).

Both are built from the tracked sources with the Makefile in this
directory on first use in each process, under a file lock so that
concurrent processes build once; make rebuilds a library whose source
changed and leaves an up-to-date one alone. Callers that can run without a library get ``None`` from
:func:`load` and use their numpy fallback; the first failure logs one
warning naming the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))


def build(name: str) -> str:
    """Path of lib<name>.so, brought up to date with its source by the
    Makefile. Raises OSError when the build fails."""
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "-s", f"lib{name}.so"], cwd=NATIVE_DIR,
                check=True, capture_output=True, text=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise OSError(f"building lib{name}.so failed: {detail}") from e
    return os.path.join(NATIVE_DIR, f"lib{name}.so")


@functools.cache
def load(name: str):
    """ctypes handle of lib<name>.so (built on first use), or None with
    one logged warning when it cannot be built or loaded."""
    try:
        return ctypes.CDLL(build(name))
    except OSError as e:
        from nucleoatac_jax.utils.logging import log

        log.warning(
            "lib%s.so unavailable, using the numpy fallback: %s", name, e
        )
        return None
