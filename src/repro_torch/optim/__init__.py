from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    SgdState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_scale,
    global_norm,
    scaled,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_annealing,
    linear_warmup_cosine,
)
