from dl_biomass_tpu_torch.sweep.study import (
    GridSampler,
    MedianPruner,
    RandomSampler,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    TrialState,
    create_study,
    load_study,
)
from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep

__all__ = [
    "Study",
    "Trial",
    "TrialPruned",
    "TrialState",
    "TPESampler",
    "RandomSampler",
    "GridSampler",
    "MedianPruner",
    "create_study",
    "load_study",
    "VmappedSweep",
]
