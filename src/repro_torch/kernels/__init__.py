"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

pinn_mlp — fused PINN MLP forward + input-Jacobian (K1) and the second-order
           variant with the diagonal input-Hessian (K2): the field-serving
           hot path.  Built from ``repro_torch/csrc/`` at first use on a card.
"""
from repro_torch.kernels.ops import (pack_mlp, pinn_mlp_forward,
                                     pinn_mlp_forward2,
                                     pinn_mlp_forward2_segments,
                                     pinn_mlp_forward2_select)
