"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

pinn_mlp — fused PINN MLP forward + input-Jacobian (K1), the second-order
           variant with the diagonal input-Hessian (K2): the field-serving
           hot path; K2 with the reverse sweep's spills (K3) and the fused
           reverse sweep (K4): the training hot path, differentiable
           through ``ops.pinn_mlp_forward2``.
flash_attention — causal GQA flash-attention forward (K5): the dense
           models' prefill attention.
wkv6     — RWKV-6 chunked WKV forward from a zero state (K6): the rwkv
           prefill's recurrence.
Each kernel is built from ``repro_torch/csrc/`` at first use on a card.
"""
from repro_torch.kernels.ops import (pack_mlp, pinn_mlp_forward,
                                     pinn_mlp_forward2,
                                     pinn_mlp_forward2_segments,
                                     pinn_mlp_forward2_select)
