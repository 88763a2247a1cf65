"""Optimizers: Adam with per-subdomain learning rates."""
from repro_torch.optim.adam import AdamConfig, adam_update, init_adam
