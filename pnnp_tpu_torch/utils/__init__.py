from pnnp_tpu_torch.utils.logging import AverageMeter, StepTimer, log
from pnnp_tpu_torch.utils.device import resolve_device
