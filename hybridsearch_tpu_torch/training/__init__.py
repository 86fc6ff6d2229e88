from hybridsearch_tpu_torch.training.contrastive import (  # noqa: F401
    ContrastiveTrainer,
    info_nce_loss,
    make_train_step,
)
from hybridsearch_tpu_torch.training.cross import (  # noqa: F401
    CrossEncoderTrainer,
    make_cross_train_step,
    pointwise_bce_loss,
)
