"""The LLM side of the port: the dense (GQA), MLA, MoE and RWKV6 families.

``build_model(cfg)`` returns a :class:`CausalLM` with the reference's entry
points ``init``, ``init_cache``, ``prefill``, ``decode_step`` and ``loss``;
prefill and training on a card run the flash-attention (K5: dense, MLA,
MoE) and WKV6 (K6: RWKV6) kernels.  Still to port (ROADMAP Queue 1): the
VLM, hybrid (Zamba2) and encoder-decoder families.
"""
from repro_torch.models.api import (build_model, make_batch,
                                    params_from_numpy, params_to_numpy)
from repro_torch.models.causal_lm import CausalLM
