from dl_biomass_tpu_torch.models.inference import compile_inference, fold_bn  # noqa: F401
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor, build_model  # noqa: F401
