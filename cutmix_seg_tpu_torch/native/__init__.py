"""Native (C++) host-runtime components (a copy of cutmix_seg_tpu.native).

`decode` wraps the C++ PNG/JPEG decoder (decode.cpp, libpng + libjpeg)
behind a ctypes interface with a transparent PIL fallback. The shared library
is compiled on first use with g++ into ``build/kernels/`` at the checkout
root, keyed by the source hash, so editing the C++ invalidates it and fresh
checkouts need no build step. Set ``CUTMIX_SEG_NATIVE_DECODE=0`` to force the
PIL path, ``1`` to require the native one.
"""

from cutmix_seg_tpu_torch.native.decode import (  # noqa: F401
    decode_array,
    encode_png,
    native_available,
)
