"""Training-point pipeline (collocation, boundary, interface points)."""
from repro_torch.data.points import (StackedBatch, make_batch,
                                     make_vanilla_batch, stack_batches)
