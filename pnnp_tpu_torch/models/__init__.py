from pnnp_tpu_torch.models.unet import DeepResUNet, DeepUNet, ResidualBlock, ResUNet, UNetSeeInDark
from pnnp_tpu_torch.models.proxy import HeadParams, PixelWiseISOProxy, QuantileHead
from pnnp_tpu_torch.models.noise_flow import NoiseFlow
from pnnp_tpu_torch.models.registry import (
    build_model,
    build_proxy,
    example_input_channels,
    load_proxy_jax,
    proxy_to_jax,
    register,
)
from pnnp_tpu_torch.models.convert import (
    eld_checkpoint_state_dict,
    flax_to_torch_state,
    flow_params_from_jax,
    flow_params_to_jax,
    load_tolerant,
    params_from_jax,
    params_to_jax,
    torch_state_to_flax,
    torch_state_to_flax_full,
)
