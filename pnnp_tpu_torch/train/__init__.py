from pnnp_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_any,
    load_checkpoint,
    save_checkpoint,
)
from pnnp_tpu_torch.train.losses import (
    charbonnier_loss,
    gan_loss,
    grad_loss,
    gradient,
    l1_loss,
    psnr_loss,
    pyramid_loss,
    pyramid_sample,
    unet_dpsv_loss,
    unet_dpsv_up_loss,
    unet_loss,
)
from pnnp_tpu_torch.train.schedules import (
    build_lr_schedule,
    cosine_warm_restart,
    multistep,
)
from pnnp_tpu_torch.train.state import apply_scaled_updates, clip_by_global_norm, make_adam
from pnnp_tpu_torch.train.steps import (
    HybridParams,
    TrainStep,
    clip_lr_hr,
    identity_synth,
    make_eval_metrics_step,
    make_eval_step,
    make_mix_synth,
    make_proxy_synth,
    make_raw_synth,
    make_train_step,
    pad_split,
    pad_to_multiple,
    params_key,
)
