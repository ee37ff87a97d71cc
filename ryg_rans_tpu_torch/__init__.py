"""ryg_rans_tpu_torch: the rANS codec on PyTorch and CUDA for NVIDIA Hopper.

The same TRNS container and stream format as the ``ryg_rans_tpu`` package
(docs/FORMAT.md), with each variant's encode and decode as hand-written
CUDA kernels (``csrc/*.cu``).  Entry points run on the card by default;
pass ``device="cpu"`` to run the kernels' plain PyTorch versions instead,
or ``backend="native"`` (the C++ host core, ``csrc/rans_core.cpp``) or
``backend="numpy"`` (the NumPy oracle) to code any ``RansConfig`` on the
host.

    >>> import ryg_rans_tpu_torch as rt
    >>> blob = rt.compress(b"hello hello hello", device="cpu")
    >>> rt.decompress(blob, device="cpu")
    b'hello hello hello'
"""

from .api import (compress, compress_from_device, decompress,
                  decompress_block, decompress_to_device)
from .config import RansConfig, Variant

__all__ = ["compress", "decompress", "decompress_block",
           "compress_from_device", "decompress_to_device", "RansConfig",
           "Variant"]
