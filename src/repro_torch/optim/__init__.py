"""Optimizers: Adam with per-subdomain learning rates; gradient compression
with error feedback for the data-parallel baseline."""
from repro_torch.optim.adam import AdamConfig, adam_update, init_adam
from repro_torch.optim.compress import (CompressionConfig,
                                        compress_decompress, wire_bytes)
