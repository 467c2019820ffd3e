"""Host-keyed locations of compiled code.

Counterpart of ``multih_tpu/utils/cache.py``, kept as its own copy (the
port imports nothing of the JAX package). There it keys XLA's persistent
compile cache; here it keys the directory of the nvcc-built kernel
library (``ops/kernels/_build.py``), the one piece of compiled code that
outlives a process.

A library built on one host and loaded on another is the hazard the
reference met as SIGILL / SIGSEGV from a reused ``/tmp`` cache: the host
code around the kernels is compiled for the build machine's CPU.
Keying the DIRECTORY by a digest of the host's CPU flags turns a
feature-set change into a clean miss: each distinct host builds once
into its own directory and never loads another machine's code. The
device side has keys of its own: the library's file name hashes the
sources, the nvcc flags (``sm_90a``), the nvcc release and
``torch.version.cuda``, and `_build.load` refuses a card of another
compute capability.
"""

from __future__ import annotations

import hashlib
import platform


def host_fingerprint() -> str:
    """8-hex-char digest of the host's CPU feature flags (order-free)."""
    flags = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    flags = " ".join(
                        sorted(line.split(":", 1)[1].split())
                    )
                    break
    except OSError:
        pass
    return hashlib.sha256(flags.encode()).hexdigest()[:8]


def compile_cache_dir(base: str) -> str:
    """`base` suffixed with the host fingerprint: the kernel library's
    directory under a cache root (`_build.library_dir`)."""
    return f"{base}-{host_fingerprint()}"
