"""Plain PyTorch reference of the benchmark's language models.

A causal LM over the parameter tree the benchmark makes (``embed``, an
optional ``prelude`` of dense layers, ``layers``, ``final_norm``,
``head``), written from the models' equations in float32 with TF32 off:
RMSNorm, interleaved RoPE, causal softmax attention (grouped heads; MLA's
latent projections expanded per head, its q/k head wider than its v
head), SwiGLU, and the fine-grained MoE layer with the grouped
capacity-based dispatch (top-k of the router's softmax with the lower
expert first on ties, the k gates normalised, a pair dropped at or past
its expert's capacity in its group, shared experts always on, the
Switch load-balance term).  The training step is the recipe's: the mean
next-token NLL plus 0.01 times the mean balance term, the global norm
clipped to 1, warmup-cosine and Adam.

Every matrix product goes through a :class:`Precision`: ``FP32`` is the
reference; ``FP8`` rounds both operands of each product to float8 e4m3
with one scale a tensor, the control that a lower precision has to fail.
This module imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


class Precision:
    """Matrix products in float32 (``fp8=False``) or with both operands
    rounded to float8 e4m3, one scale a tensor (the rounding passes the
    gradient straight through)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x):
        if not self.fp8:
            return x
        xd = x.detach()
        scale = 448.0 / xd.abs().amax().clamp(min=1e-30)
        xq = (xd * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return x + (xq - xd) if x.requires_grad else xq

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


FP32 = Precision(False)
FP8 = Precision(True)


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (not TF32) on a card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------------ layers

def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (B, S, H, dh) rotated by position: the pairs (x[2i], x[2i+1]) at
    angle s / theta^(2i / dh), the angle taken in float64."""
    S, dh = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, P: Precision, block: int = 1024):
    """Causal softmax attention, q (B, S, H, dh), k (B, S, Hk, dh), v (B,
    S, Hk, dv), head h reading kv head h // (H / Hk), scaled by
    1 / sqrt(dh); query blocks see keys up to their last row."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    qh = (q * (1.0 / math.sqrt(dh))).transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    outs = []
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        s = P.mm(qh[:, :, i0:i1], kh[:, :, :i1].transpose(-1, -2))
        # only the block's own keys can lie above the diagonal
        rows = torch.arange(i1 - i0, device=q.device)
        s[..., i0:i1].masked_fill_(rows[None, :] > rows[:, None],
                                   float("-inf"))
        outs.append(P.mm(torch.softmax(s, dim=-1), vh[:, :, :i1]))
        del s
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(p, x, P):
    return P.mm(F.silu(P.mm(x, p["wg"])) * P.mm(x, p["wi"]), p["wo"])


def gqa(p, h, m, P):
    B, S, _ = h.shape
    H, Hk = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    q = rope(P.mm(h, p["wq"]).reshape(B, S, H, hd), m["rope_theta"])
    k = rope(P.mm(h, p["wk"]).reshape(B, S, Hk, hd), m["rope_theta"])
    v = P.mm(h, p["wv"]).reshape(B, S, Hk, hd)
    return P.mm(attention(q, k, v, P).reshape(B, S, H * hd), p["wo"])


def mla(p, h, m, P):
    """Latent attention, expanded: q from its low-rank path, k's nope part
    and v from the normed kv latent, one rope key shared by the heads."""
    B, S, _ = h.shape
    H, nope, rd, vd = (m["n_heads"], m["nope_dim"], m["rope_dim"],
                       m["v_head_dim"])
    eps, theta = m["norm_eps"], m["rope_theta"]
    cq = rms_norm(P.mm(h, p["wdq"]), p["q_norm"], eps)
    q = P.mm(cq, p["wuq"]).reshape(B, S, H, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    ckv = rms_norm(P.mm(h, p["wdkv"]), p["kv_norm"], eps)
    kr = rope(P.mm(h, p["wkr"])[:, :, None, :], theta)
    k_nope = P.mm(ckv, p["wuk"]).reshape(B, S, H, nope)
    k = torch.cat([k_nope, kr.expand(B, S, H, rd)], dim=-1)
    v = P.mm(ckv, p["wuv"]).reshape(B, S, H, vd)
    return P.mm(attention(q, k, v, P).reshape(B, S, H * vd), p["wo"])


def n_groups(T: int) -> int:
    """Token groups of the dispatch: the most, up to 256, of >= 64 tokens."""
    g = 256
    while g > 1 and T // g < 64:
        g //= 2
    return g


def capacity(m: dict, group_tokens: int) -> int:
    return max(4, math.ceil(group_tokens * m["top_k"] / m["n_experts"]
                            * m["capacity_factor"]))


def moe(p, h, m, P):
    """The MoE FFN: (out, balance term).  In each group the (token, slot)
    pairs, token-major, take their rank within their expert; a pair at
    rank >= capacity is dropped.  Each kept pair adds its gate times its
    expert's SwiGLU of the token."""
    B, S, d = h.shape
    E, k = m["n_experts"], m["top_k"]
    T = B * S
    G = n_groups(T)
    t = T // G
    C = capacity(m, t)
    xg = h.reshape(G, t, d)
    probs = torch.softmax(P.mm(xg, p["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    aux = E * torch.sum(probs.mean(dim=(0, 1)) * counts / (T * k))

    e_pair = idx.reshape(G, t * k)
    rank = (F.one_hot(e_pair, E).cumsum(dim=1) - 1).gather(
        2, e_pair[..., None])[..., 0]
    kept = rank < C
    g_pair = gate.reshape(G, t * k)
    tok = torch.arange(t, device=h.device).repeat_interleave(k)
    y = torch.zeros_like(xg)
    ex = p["experts"]
    for e in range(E):
        gi, pi = torch.nonzero((e_pair == e) & kept, as_tuple=True)
        if gi.numel() == 0:
            continue
        ti = tok[pi]
        xe = xg[gi, ti]
        oe = P.mm(F.silu(P.mm(xe, ex["wg"][e])) * P.mm(xe, ex["wi"][e]),
                  ex["wo"][e])
        y = y.index_put((gi, ti), oe * g_pair[gi, pi][:, None],
                        accumulate=True)
    out = y.reshape(B, S, d)
    if "shared" in p:
        out = out + swiglu(p["shared"], h, P)
    return out, aux


def layer(kind, lp, x, m, P):
    """One residual layer of ``kind`` (``dense``, ``mla`` or ``moe``):
    (x, balance term or None)."""
    eps = m["norm_eps"]
    h = rms_norm(x, lp["attn_norm"], eps)
    x = x + (mla(lp["attn"], h, m, P) if kind == "mla"
             else gqa(lp["attn"], h, m, P))
    h = rms_norm(x, lp["mlp_norm"], eps)
    if kind == "moe":
        ff, aux = moe(lp, h, m, P)
        return x + ff, aux
    return x + swiglu(lp["mlp"], h, P), None


def _at(tree, i):
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(params, tokens, m, P):
    """The final-normed hidden states (B, S, d) and the MoE layers'
    balance terms."""
    x = params["embed"]["table"][tokens]
    auxes = []
    if "prelude" in params:
        pm = dict(m, d_ff=m.get("d_ff_dense") or m["d_ff"])
        for i in range(params["prelude"]["attn_norm"].shape[0]):
            x, _ = layer("dense", _at(params["prelude"], i), x, pm, P)
    kind = {"mla": "mla", "moe": "moe"}.get(m["family"], "dense")
    for i in range(params["layers"]["attn_norm"].shape[0]):
        x, aux = layer(kind, _at(params["layers"], i), x, m, P)
        if aux is not None:
            auxes.append(aux)
    return rms_norm(x, params["final_norm"], m["norm_eps"]), auxes


def logits_at(params, tokens, rows, m, P=FP32):
    """Float32 logits (n, vocab) over the real vocabulary at ``rows``, a
    pair of index tensors (sequence, position)."""
    with torch.no_grad(), no_tf32():
        x, _ = hidden(params, tokens, m, P)
        return P.mm(x[rows], params["head"]["w"][:, :m["vocab"]])


def loss(params, tokens, labels, m, P=FP32, loss_mask=None):
    """Mean next-token NLL over the real vocabulary (over ``loss_mask``
    where given), plus 0.01 times the mean balance term."""
    x, auxes = hidden(params, tokens, m, P)
    lg = P.mm(x, params["head"]["w"][:, :m["vocab"]])
    nll = torch.logsumexp(lg, dim=-1) - torch.gather(
        lg, -1, labels[..., None])[..., 0]
    if loss_mask is None:
        out = nll.mean()
    else:
        out = (nll * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)
    if auxes:
        out = out + 0.01 * torch.stack(auxes).mean()
    return out


# ------------------------------------------------------------- training

def warmup_cosine(step, peak, warmup, total, floor=0.1):
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rebuild(like, values, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in like.items()}
    return values[prefix]


def train(params, batches, m, *, peak_lr, total, warmup=20, P=FP32,
          b1=0.9, b2=0.999, eps=1e-8, clip=1.0, samples=None):
    """The recipe's first ``len(batches)`` steps from ``params`` (float32
    leaves, left as they are): each step's loss, each leaf's norm of the
    first step's clipped gradient and its values at ``samples`` (a flat
    index tensor a leaf), and each leaf's norm of the change after the last
    step.  ``batches``: (tokens, labels[, loss_mask])."""
    paths = [p for p, _ in _paths(params)]
    p0 = [t for _, t in _paths(params)]
    cur = [t.clone() for t in p0]
    mom = [torch.zeros_like(t) for t in p0]
    vel = [torch.zeros_like(t) for t in p0]
    losses, g0, g0_at = [], None, None

    with no_tf32():
        for step, batch in enumerate(batches):
            leaves = [t.requires_grad_(True) for t in cur]
            value = loss(_rebuild(params, dict(zip(paths, leaves))),
                         *batch[:2], m, P,
                         batch[2] if len(batch) > 2 else None)
            grads = torch.autograd.grad(value, leaves)
            losses.append(float(value.detach()))
            with torch.no_grad():
                for t in cur:
                    t.requires_grad_(False)
                gn = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
                scale = min(1.0, clip / (float(gn) + 1e-12))
                grads = [g * scale for g in grads]
                if step == 0:
                    g0 = [float(torch.linalg.vector_norm(g.double()))
                          for g in grads]
                    if samples is not None:
                        g0_at = [g.reshape(-1)[i] for g, i in
                                 zip(grads, samples)]
                lr = warmup_cosine(step, peak_lr, warmup, total)
                bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                for p, mu, nu, g in zip(cur, mom, vel, grads):
                    mu.mul_(b1).add_(g, alpha=1 - b1)
                    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))
            del grads, value
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm((a - b).double()))
                  for a, b in zip(cur, p0)]
    return {"paths": paths, "losses": losses, "grad_norms": g0,
            "grad_samples": g0_at, "change_norms": change}
