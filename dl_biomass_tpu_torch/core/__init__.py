from dl_biomass_tpu_torch.core.cloud import CloudBatch, resolve_device, round_up  # noqa: F401
