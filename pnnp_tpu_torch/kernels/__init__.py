"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), bound through ctypes.

The tiled-reduction SSIM (:mod:`.ssim`), the port of the JAX package's only
Pallas kernel, and the proxy NLL's bin law (:mod:`.proxy_core`), which has
no TPU counterpart. Importing this package builds nothing; each kernel
builds at its first launch (:mod:`.build`).
"""

from pnnp_tpu_torch.kernels.build import CSRC_DIR, build_all

# Every CUDA source of the package, built together by build_all.
SOURCES = tuple(sorted(CSRC_DIR.glob("*.cu")))
