from pnnp_tpu_torch.ops.bayer import (
    pack_bayer,
    unpack_bayer,
    bayer2rggb,
    rggb2bayer,
    bayer2rows,
    rows2bayer,
    raw2bayer,
    bayer2raw,
    bayer2gray,
    repair_bad_pixels,
)
from pnnp_tpu_torch.ops.isp import (
    apply_gains,
    apply_ccms,
    gamma_compression,
    raw2lrgb,
    process,
    simple_isp,
    fast_isp,
    bilinear_demosaic,
)
from pnnp_tpu_torch.ops.vst import vst, inverse_vst, inverse_vst_batch
from pnnp_tpu_torch.ops.metrics import psnr, ssim, ssim_sum, quality_assess
from pnnp_tpu_torch.ops.tiling import eval_crop, eval_merge, tiled_apply
from pnnp_tpu_torch.ops.correct import illuminance_correct
from pnnp_tpu_torch.ops.filters import stdfilt, guided_filter, fast_guided_filter, row_denoise
