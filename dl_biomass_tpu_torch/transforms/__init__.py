from dl_biomass_tpu_torch.transforms.augment import (
    augment_batch,
    augment_cloud,
    point_removal,
    random_noise,
    random_scale,
    rotate_points,
)

__all__ = [
    "augment_cloud",
    "augment_batch",
    "point_removal",
    "random_noise",
    "random_scale",
    "rotate_points",
]
