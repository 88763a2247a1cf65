"""Training-point pipeline (collocation, boundary, interface points)."""
from repro_torch.data.points import StackedBatch, make_batch, stack_batches
