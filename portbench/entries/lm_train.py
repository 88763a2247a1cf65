"""Entry ``lm_train``: the port's LM training step,
``repro_torch.launch.train.lm_train_step`` (loss and gradient through
``CausalLM.loss``, the global norm clipped to 1, warmup-cosine, Adam),
one step an item, each on a fresh batch of the cell's size.

Set-up builds the model, makes the weights from the seed and Adam's
state, and warms up on three steps of batches the window never sees, with
the check's readings taken as in the window (so that every kernel is
loaded and the allocator holds its blocks); then it draws the weights
again and starts Adam afresh, so that the window's first three steps are
the recipe's first three from the seed.  Those are the
checked steps: the window keeps each one's loss, the first step's clipped
gradient a leaf as Adam holds it (its first moment over 1 - b1), and,
once the third has finished, the change of each leaf (the weights drawn
again from the seed for it).  After the window the reference
(``portbench/reference``) runs the same three steps in float32 from the
same weights and batches, and the three are compared.
"""
from __future__ import annotations

import statistics

import torch

from portbench import program, traffic
from portbench.reference import lm as ref

B1 = 0.9            # Adam's first-moment decay (``optim.adam.AdamConfig``)
FIRST_STEPS = 3     # the window's first steps, which the reference follows
SAMPLE = 65536      # elements a leaf of the first gradient kept to compare


def _norms(tensors: list) -> list:
    """Each tensor's 2-norm, in one launch and one wait."""
    if not tensors:
        return []
    return torch.stack(torch._foreach_norm(tensors)).tolist()


class Runner:
    def __init__(self, cell: dict, model: dict, seed: int, device,
                 fault: str | None = None):
        self.p = cell["params"]
        self.m, self.seed, self.device, self.fault = model, seed, device, fault
        self.B, self.S = self.p["batch"], self.p["seq"]
        self.checked = list(range(FIRST_STEPS))
        self.min_items = FIRST_STEPS   # the window holds the checked steps

    # ----------------------------------------------------------------- feed
    def batch(self, step: int) -> dict:
        t = traffic.tokens(self.seed, step, self.B, self.S + 1,
                           self.m["vocab"], self.device)
        out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if self.fault == "half_batch":
            mask = torch.ones((self.B, self.S), device=self.device)
            mask[:, self.S // 2:] = 0.0
            out["loss_mask"] = mask
        return out

    def weights(self):
        return traffic.make_weights(self.shapes, self.seed, self.device)

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        self.model = program.build_model(self.m, self.device)
        self.shapes = program.param_shapes(self.model)
        self.start(-FIRST_STEPS)
        for i in range(FIRST_STEPS):   # warm-up, thrown away
            self.item(i)
        del self.params, self.opt
        self.start(0)

    def start(self, feed: int) -> None:
        """Weights from the seed, Adam afresh; step ``i`` is fed batch
        ``feed + i``."""
        self.params = self.weights()
        self.opt = program.init_adam(self.params)
        self.feed, self.step_no, self.losses = feed, 0, []

    def change(self) -> None:
        """Each leaf's norm of its change since the weights were drawn
        (the weights drawn again, less the leaves, in place)."""
        p0 = [t for _, t in traffic.leaves(self.weights())]
        torch._foreach_sub_(p0, [t for _, t in traffic.leaves(self.params)])
        self.change_norms = _norms(p0)
        del p0

    def first_gradient(self) -> None:
        """The first clipped gradient as Adam holds it (its first moment
        over 1 - b1): each leaf's norm, and its values at elements drawn
        from the seed."""
        self.grad_norms = [n / (1 - B1) for n in _norms(
            [t for _, t in traffic.leaves(self.opt["m"])])]
        g = traffic.generator(self.device, self.seed, "gradient sample")
        self.samples, self.grad_samples = [], []
        for _, mom in traffic.leaves(self.opt["m"]):
            idx = torch.randint(0, mom.numel(), (min(SAMPLE, mom.numel()),),
                                generator=g, device=self.device)
            self.samples.append(idx)
            self.grad_samples.append(mom.reshape(-1)[idx] / (1 - B1))

    # ----------------------------------------------------------------- item
    def item(self, _index: int) -> bool:
        """One training step, waited for; False where its loss is not
        finite."""
        params, opt, loss, _ = program.lm_train_step(
            self.model, self.params, self.opt,
            self.batch(self.feed + self.step_no),
            self.step_no, self.p["peak_lr"], self.p["total_steps"])
        if self.fault != "unchanged":
            self.params, self.opt = params, opt
        del params, opt
        value = float(loss)
        self.step_no += 1
        if self.step_no <= FIRST_STEPS:
            self.losses.append(value)
            if self.step_no == 1:
                self.first_gradient()
            if self.step_no == FIRST_STEPS:
                self.change()
        return value == value and abs(value) != float("inf")

    # --------------------------------------------------------------- window
    def end_to_end(self, spans, window_s: float, peak_bytes: int) -> dict:
        return {"train_step_ms": (1e3 * window_s / len(spans), "ms"),
                "train_peak_mem_gib": (peak_bytes / 2 ** 30, "GiB")}

    def close_window(self) -> None:
        del self.params, self.opt, self.model

    # ---------------------------------------------------------------- check
    def readings(self, control: bool = False) -> dict:
        """The numbers compared: the program's (or, with ``control``, the
        reference's in float8, put in its place) against the float32
        reference's, over the first three steps.

        - ``loss_gap``: the largest gap of a step's loss (nats);
        - ``grad_gap``: the worst leaf's gap between the two norms of the
          first clipped gradient, over the reference's norm of that leaf
          or of the median leaf, the larger;
        - ``grad_err``: the median over the leaves of the norm of the
          difference of the two first gradients at the elements drawn from
          the seed, over the reference's norm there (of that leaf or of the
          median leaf, the larger).  A norm's gap moves with the square of
          random rounding, this with its size.  The median, not the worst
          leaf: a route that flips at a near tie of the router moves a
          token to another expert, so the experts' leaves read tenfold the
          others' in sound runs (``detail`` keeps every leaf's);
        - ``change_gap``: the same of each leaf's change after three
          steps, over the leaves whose reference gradient is at least a
          thousandth of the median leaf's."""
        p0 = self.weights()
        batches = [(b["tokens"], b["labels"])
                   for b in map(self.batch, range(FIRST_STEPS))]
        kw = dict(peak_lr=self.p["peak_lr"], total=self.p["total_steps"])
        kw = dict(kw, samples=self.samples)
        want = ref.train(p0, batches, self.m, **kw)
        if control:
            got = ref.train(p0, batches, self.m, P=ref.FP8, **kw)
            losses, grads, change, at = (got["losses"], got["grad_norms"],
                                         got["change_norms"],
                                         got["grad_samples"])
        else:
            losses, grads, change, at = (self.losses, self.grad_norms,
                                         self.change_norms, self.grad_samples)
        del p0
        med_g = statistics.median(want["grad_norms"])
        moved = [g >= 1e-3 * med_g for g in want["grad_norms"]]
        med_c = statistics.median(
            c for c, k in zip(want["change_norms"], moved) if k)

        def worst(got, ref_norms, med, keep):
            return max(abs(a - b) / max(b, med)
                       for a, b, k in zip(got, ref_norms, keep) if k)

        ref_at = [float(torch.linalg.vector_norm(w.double()))
                  for w in want["grad_samples"]]
        med_s = statistics.median(ref_at)
        diff_at = [float(torch.linalg.vector_norm((a - w).double()))
                   for a, w in zip(at, want["grad_samples"])]
        leaf_err = [d / max(r, med_s) for d, r in zip(diff_at, ref_at)]
        self.detail = {".".join(p): e for p, e in zip(want["paths"],
                                                      leaf_err)}
        self.detail["left_out"] = [".".join(p) for p, k in
                                   zip(want["paths"], moved) if not k]
        return {
            "loss_gap": max(abs(a - b)
                            for a, b in zip(losses, want["losses"])),
            "grad_err": statistics.median(leaf_err),
            "grad_gap": worst(grads, want["grad_norms"], med_g,
                              [True] * len(moved)),
            "change_gap": worst(change, want["change_norms"], med_c, moved),
        }
