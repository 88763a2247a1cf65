"""The LLM side of the port: the dense (GQA) and RWKV6 families.

``build_model(cfg)`` returns a :class:`CausalLM` with the reference's entry
points ``init``, ``init_cache``, ``prefill`` and ``decode_step``; prefill on
a card runs the flash-attention (K5) and WKV6 (K6) kernels.
"""
from repro_torch.models.api import (build_model, make_batch,
                                    params_from_numpy, params_to_numpy)
from repro_torch.models.causal_lm import CausalLM
