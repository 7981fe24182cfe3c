"""Training: the weighted biomass loss, the Trainer and its checkpoints."""
