from dl_biomass_tpu_torch.eval.metrics import build_results_frame, metrics_table
from dl_biomass_tpu_torch.eval.testing import test_model

__all__ = ["build_results_frame", "metrics_table", "test_model"]
