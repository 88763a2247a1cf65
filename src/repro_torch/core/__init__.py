"""Domain-decomposed PINNs (cPINN/XPINN): geometry, networks, PDEs, fused
derivative bundles — the parts the field-serving path needs."""
from repro_torch.core.domain import (
    CartesianDecomposition, PolygonDecomposition, Topology, build_topology,
    us_map_decomposition,
)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   params_from_numpy, params_to_numpy,
                                   stacked_init)
from repro_torch.core.pdes import (Burgers1D, Euler1D, HeatConduction2D,
                                   NavierStokes2D)
