"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), bound through ctypes.

One kernel so far: the tiled-reduction SSIM (:mod:`.ssim`), the port of the
JAX package's only Pallas kernel. Importing this package builds nothing;
each kernel builds at its first launch (:mod:`.build`).
"""

from pnnp_tpu_torch.kernels.build import CSRC_DIR, build_all

# Every CUDA source of the package, built together by build_all.
SOURCES = tuple(sorted(CSRC_DIR.glob("*.cu")))
