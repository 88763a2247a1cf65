"""Entry ``lm_prefill``: the port's causal prefill, ``CausalLM.prefill``
(the logits of every position), one request an item: a batch of the
cell's prompts, issued when the last has come back, timed from issue to
the logits on the device after a synchronise.

Which requests are checked, and at which rows (every sequence's last
position and positions drawn from the seed), is drawn from the seed before
the window; a checked request keeps those rows of its logits.  A checked
request that the window did not reach runs after it.  Then the reference
(``portbench/reference``) prefills the same prompts with the same weights
in float32 and the rows are compared.
"""
from __future__ import annotations

import random

import torch

from portbench import program, traffic
from portbench.reference import lm as ref


class Runner:
    def __init__(self, cell: dict, model: dict, seed: int, device,
                 fault: str | None = None):
        self.p = cell["params"]
        self.m, self.seed, self.device, self.fault = model, seed, device, fault
        self.B, self.S = self.p["batch"], self.p["seq"]
        rng = random.Random(traffic.derive(seed, "check"))
        self.checked = sorted(rng.sample(range(self.p["check_horizon"]),
                                         self.p["check_requests"]))
        self.rows = {}
        for i in self.checked:
            seqs = sorted(rng.sample(range(self.B), self.p["check_seqs"]))
            b, s = [], []
            for q in seqs:
                pos = rng.sample(range(self.S - 1), self.p["check_rows"] - 1)
                b += [q] * len(pos) + [q]
                s += sorted(pos) + [self.S - 1]
            self.rows[i] = (torch.tensor(b, device=device),
                            torch.tensor(s, device=device))
        self.kept = {}
        self.done = -1

    def prompt(self, index: int) -> torch.Tensor:
        return traffic.tokens(self.seed, index, self.B, self.S,
                              self.m["vocab"], self.device)

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        self.model = program.build_model(self.m, self.device)
        self.params = traffic.make_weights(program.param_shapes(self.model),
                                           self.seed, self.device)
        for w in range(self.p["warmup"]):
            self._prefill(-1 - w)

    def _prefill(self, index: int):
        tokens = self.prompt(index)
        if self.fault == "half_batch":
            half = self.model.prefill(self.params,
                                      {"tokens": tokens[:self.B // 2]})
            return torch.cat([half, half])
        logits = self.model.prefill(self.params, {"tokens": tokens})
        if self.fault == "altered_answer":
            V = self.m["vocab"]
            logits[:, -1, :V] = logits[:, -1, :V].roll(1, dims=-1)
        return logits

    # ----------------------------------------------------------------- item
    def item(self, index: int) -> bool:
        logits = self._prefill(index)
        if index in self.rows:
            self.kept[index] = logits[self.rows[index]][:, :self.m["vocab"]]
        del logits
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.done = index
        return True

    # --------------------------------------------------------------- window
    def end_to_end(self, spans, window_s: float, peak_bytes: int) -> dict:
        out = {"prefill_tokens_per_s":
               (len(spans) * self.B * self.S / window_s, "tokens/s")}
        if len(spans) >= 100:   # ten or more beyond the 90th percentile
            lat = sorted(e - s for s, e in spans)
            out["latency_p90_ms"] = (1e3 * lat[-(-9 * len(lat) // 10) - 1],
                                     "ms")
        return out

    def close_window(self) -> None:
        """Run the checked requests the window did not reach, then free
        the program's state (the weights are the benchmark's)."""
        for i in self.checked:
            if i > self.done:
                self.item(i)
        del self.model

    # ---------------------------------------------------------------- check
    def readings(self, control: bool = False) -> dict:
        """The numbers compared over the checked rows: the program's
        logits (or, with ``control``, the reference's in float8, put in
        its place) against the float32 reference's.

        - ``logit_err``: the largest gap of a logit, over the largest
          reference logit in magnitude;
        - ``top1_gap``: the widest gap by which the logit of the token the
          program ranks first lies below the reference's best."""
        err = gap = 0.0
        for i in self.checked:
            tokens = self.prompt(i)
            want = ref.logits_at(self.params, tokens, self.rows[i], self.m)
            got = (ref.logits_at(self.params, tokens, self.rows[i], self.m,
                                 ref.FP8) if control
                   else self.kept[i].float())
            err = max(err, float((got - want).abs().max()
                                 / want.abs().max()))
            top = want.gather(1, got.argmax(dim=1, keepdim=True))[:, 0]
            gap = max(gap, float((want.max(dim=1).values - top).max()))
            del want, got
        return {"logit_err": err, "top1_gap": gap}
