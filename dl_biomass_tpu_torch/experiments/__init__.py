from dl_biomass_tpu_torch.experiments.density import point_density_effect

__all__ = ["point_density_effect"]
