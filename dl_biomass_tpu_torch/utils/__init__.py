from dl_biomass_tpu_torch.utils.tboard import SummaryWriter

__all__ = ["SummaryWriter"]
