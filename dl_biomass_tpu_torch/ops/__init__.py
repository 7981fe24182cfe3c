"""Point-cloud ops. Each ``*_kernel`` module holds a CUDA kernel's wrapper, which
launches it for a CUDA tensor, and its plain PyTorch version, which runs for a
CPU tensor; ``_build.launch_counts`` counts the launches by kernel."""

from dl_biomass_tpu_torch.ops.ball_group_kernel import ball_group  # noqa: F401
from dl_biomass_tpu_torch.ops.ball_query_kernel import ball_query_first_k  # noqa: F401
from dl_biomass_tpu_torch.ops.ballquery import ball_query  # noqa: F401
from dl_biomass_tpu_torch.ops.fps import farthest_point_sample, fps_sectored  # noqa: F401
from dl_biomass_tpu_torch.ops.fps_kernel import fps_rows  # noqa: F401
from dl_biomass_tpu_torch.ops.gather_kernel import gather_rows, scatter_rows  # noqa: F401
from dl_biomass_tpu_torch.ops.grouping import gather_points, group_neighborhoods  # noqa: F401
from dl_biomass_tpu_torch.ops.pooling import masked_max, masked_mean  # noqa: F401

