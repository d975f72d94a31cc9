from repro_torch.data.synthetic import (  # noqa: F401
    DENSITIES, density_sampler, synthetic_images, token_batches,
)
from repro_torch.data.loader import ShardedLoader  # noqa: F401
