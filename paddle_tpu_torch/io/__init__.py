"""Native data-IO runtime bindings (recordio + prefetch).

The C++ library lives in the port's native/recordio.cc; `recordio` loads it
via ctypes, building it on first use with g++ into the package's _build/, and falls back to a pure-Python
implementation of the identical on-disk format when no toolchain exists.
"""

from paddle_tpu_torch.io.recordio import (  # noqa: F401
    Chunk,
    Prefetcher,
    Reader,
    Writer,
    native_available,
    scan_chunks,
)
