from pnnp_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_any,
    load_checkpoint,
    save_checkpoint,
)
from pnnp_tpu_torch.train.steps import (
    make_eval_metrics_step,
    make_eval_step,
    pad_split,
    pad_to_multiple,
)
