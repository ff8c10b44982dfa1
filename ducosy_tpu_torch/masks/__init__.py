from ducosy_tpu_torch.masks.anatomy import generate_anatomical_masks  # noqa: F401
