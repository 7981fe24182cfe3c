from dl_biomass_tpu_torch.native import pointops

__all__ = ["pointops"]
