from pnnp_tpu_torch.models.flows.base import Bijector, sum_except_batch
from pnnp_tpu_torch.models.flows.conv1x1 import InvertibleConv1x1
from pnnp_tpu_torch.models.flows.coupling import (
    AffineCoupling,
    AffineCouplingV2,
    FlaxBatchNorm,
    ShiftAndLogScale,
    ShiftAndLogScaleV2,
)
from pnnp_tpu_torch.models.flows.sdn import GainISO, SignalDependantISO, SignalDependantNS
from pnnp_tpu_torch.models.flows.basic import (
    ActNorm,
    actnorm_data_init,
    Squeeze,
    Logit,
    UniformDequantization,
    NoiseExtraction,
)
from pnnp_tpu_torch.models.flows.conditional import (
    ConditionalAffineCoupling,
    ConditionalAffine,
    ConditionalLinear,
    ConditionalInvertibleConv1x1,
    SdnModelScale,
    iso_cam_index,
    iso_cam_onehot,
)
from pnnp_tpu_torch.models.flows.spline import (
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
)
