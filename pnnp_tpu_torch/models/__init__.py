from pnnp_tpu_torch.models.unet import UNetSeeInDark
from pnnp_tpu_torch.models.registry import build_model
from pnnp_tpu_torch.models.convert import (
    flax_to_torch_state,
    params_from_jax,
    params_to_jax,
    torch_state_to_flax,
    torch_state_to_flax_full,
)
