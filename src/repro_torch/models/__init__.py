"""The LLM side of the port: the dense (GQA), VLM, MLA, MoE, RWKV6,
hybrid (Zamba2: Mamba2 + shared attention) and encoder-decoder families,
all seven of the reference's.

``build_model(cfg)`` returns a :class:`CausalLM` (``Zamba2Model`` for the
hybrid, ``EncDecModel`` for the encoder-decoder) with the reference's entry
points ``init``, ``init_cache``, ``prefill``, ``decode_step`` and
``loss``; prefill and training on a card run the flash-attention (K5:
dense, VLM, MLA, MoE, the hybrid's shared attention, the encoder-decoder's
encoder, decoder and cross-attention) and WKV6 (K6: RWKV6) kernels.  Its
sharding trees (``param_specs``, ``cache_specs``) follow the rules of
``models/sharding.py`` (``rules_for``, ``use_rules``).
"""
from repro_torch.models.api import (batch_struct, build_model, make_batch,
                                    params_from_numpy, params_to_numpy)
from repro_torch.models.causal_lm import CausalLM
from repro_torch.models.sharding import rules_for, use_rules
