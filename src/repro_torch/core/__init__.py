"""Domain-decomposed PINNs (cPINN/XPINN): geometry, networks, PDEs, fused
derivative bundles, losses, the halo exchange and the trainers."""
from repro_torch.core.domain import (
    CartesianDecomposition, PolygonDecomposition, Topology, build_topology,
    us_map_decomposition,
)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   params_from_numpy, params_to_numpy,
                                   stacked_init)
from repro_torch.core.pdes import (Burgers1D, Euler1D, HeatConduction2D,
                                   NavierStokes2D)
from repro_torch.core.losses import (CPINN, XPINN, LossWeights, ResidualPath,
                                     SubBatch)
from repro_torch.core.trainer import (DataParallelTrainer, DDConfig,
                                      DistributedDDTrainer, ReferenceTrainer,
                                      TrainState, evaluate_l2,
                                      restore_train_state, save_train_state)
