"""Optimizers: Adam with per-subdomain learning rates; L-BFGS refinement;
gradient compression with error feedback for the data-parallel baseline."""
# the optimizers use core's tree helpers, and core's trainer imports
# optim.adam: load core first, so importing optim first finds it whole
import repro_torch.core  # noqa: F401
from repro_torch.optim.adam import AdamConfig, adam_update, init_adam
from repro_torch.optim.compress import (CompressionConfig,
                                        compress_decompress, wire_bytes)
from repro_torch.optim.lbfgs import (LBFGSConfig, init_lbfgs, lbfgs_refine,
                                     lbfgs_step)
