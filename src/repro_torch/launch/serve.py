"""Batched LLM serving: prefill a batch of prompts, then decode tokens.

Counterpart of the reference package's ``launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        [--no-reduced] [--batch 4 --prompt-len 16 --gen 16] [--device cpu]

Greedy decoding feeds the prompt through ``decode_step`` one token at a time
and then decodes ``--gen`` tokens, as the reference does; weights are drawn
from ``--seed`` on the device (the encoder-decoder's frames from the
reference's fixed seed).  It runs on the CUDA card unless ``--device cpu``
is given.  ``--reduced`` (the default, as in the reference) serves the
config's tiny same-family variant; ``--no-reduced`` serves the published
width and depth (the reference's flag cannot be turned off).  Prints the
reference's two lines and, last, one JSON object with the token count,
seconds and tokens/s.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model


def generate(model, params, prompts: torch.Tensor, max_len: int, gen: int):
    """Greedy decode. prompts: (B, P) int. Returns (B, P+gen) int64.

    The encoder-decoder first encodes ``max_len // enc_ratio`` frames drawn
    from ``default_rng(0)`` (the reference's, whatever the seed) and fills
    its cross cache from them once."""
    cfg = model.cfg
    B, P = prompts.shape
    cache = model.init_cache(B, max_len)
    if cfg.family == "encdec":
        rng = np.random.default_rng(0)
        frames = torch.as_tensor(
            rng.normal(0, 1, (B, max(1, max_len // cfg.enc_ratio),
                              cfg.d_model)),
            dtype=getattr(torch, cfg.dtype), device=prompts.device)
        cache = model.fill_cross_cache(params, cache, frames)
    toks = [prompts[:, i] for i in range(P)]
    for t in range(P + gen - 1):
        cur = toks[t][:, None]
        logits, cache = model.decode_step(params, cache, {"tokens": cur}, t)
        if t >= P - 1:
            toks.append(torch.argmax(logits[:, 0], dim=-1))
    return torch.stack(toks, dim=1)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve cfg.reduced() (default); --no-reduced serves "
                         "the published config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    dev = model.device
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=dev)
    max_len = args.prompt_len + args.gen
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, max_len, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    print(f"[serve] generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s)")
    print(f"[serve] sample: {out[0, -args.gen:].cpu().numpy()}")
    if tuple(out.shape) != (args.batch, max_len):
        raise RuntimeError(f"generated {tuple(out.shape)}, expected "
                           f"{(args.batch, max_len)}")
    print(json.dumps({"serve": {
        "arch": cfg.name, "reduced": args.reduced, "device": str(dev),
        "shape": list(out.shape), "new_tokens": n_new, "seconds": dt,
        "tokens_per_s": n_new / dt,
        "sample": out[0, -args.gen:].tolist()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
