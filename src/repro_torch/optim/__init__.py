from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    opt_state_defs,
)
from repro_torch.optim.schedule import warmup_cosine
