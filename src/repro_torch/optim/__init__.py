from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_annealing,
)
