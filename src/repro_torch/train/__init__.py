from repro_torch.train.losses import cross_entropy, total_loss
from repro_torch.train.step import (
    TrainSettings,
    cast_for_compute,
    init_train_state,
    make_grad_fn,
    make_train_step,
    train_state_defs,
)
