from repro_torch.data.synthetic import synthetic_images  # noqa: F401
