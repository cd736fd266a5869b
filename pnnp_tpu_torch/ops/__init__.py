from pnnp_tpu_torch.ops.metrics import psnr, ssim, ssim_sum
from pnnp_tpu_torch.ops.correct import illuminance_correct
