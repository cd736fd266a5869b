from pnnp_tpu_torch.models.flows.base import Bijector, sum_except_batch
from pnnp_tpu_torch.models.flows.conv1x1 import InvertibleConv1x1
from pnnp_tpu_torch.models.flows.coupling import AffineCoupling, FlaxBatchNorm, ShiftAndLogScale
from pnnp_tpu_torch.models.flows.sdn import GainISO, SignalDependantISO
