"""ctypes bindings for the native host IO library (native/tsio.cc).

The library is compiled on demand from the committed source with the
system toolchain (g++ + zlib) into native/build/; when the toolchain or
zlib is missing, callers fall back to the pure-Python reader and the
engine logs which reader ran and why (pipeline honors
TopsicleConfig.native_io)."""

from topsicle_tpu.native.loader import (  # noqa: F401
    Block,
    NativeReader,
    native_available,
    unavailable_reason,
    write_subset_native,
)
