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
from repro_torch.optim.quantized_state import (  # noqa: F401
    BLOCK,
    Adam8bitState,
    QTensor,
    adamw8bit,
    dequantize_blockwise,
    quantize_blockwise,
)
from repro_torch.optim.grad_compress import (  # noqa: F401
    compress_with_feedback,
    compressed_allreduce_mean,
    init_error_feedback,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_annealing,
    linear_warmup_cosine,
)
