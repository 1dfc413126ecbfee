"""Mixture-of-experts FFN (DeepSeek-V2/V3: shared + routed experts,
token-choice top-k routing with normalised gates).

Counterpart of ``repro/models/moe.py``, step for step: the router
matmul in the activation dtype, then softmax in fp32; each token's top-k
experts, their gates renormalised to sum to 1 (DeepSeek's rule); the
(G, E) gate matrix; capacity-based gather dispatch, in which expert e
takes the C tokens of largest gate (``capacity``; tokens past it are
dropped); ``act(x W_gate) * (x W_up) W_down`` for every expert at once
as three ``torch.bmm``; the gated combine in the activation dtype; the
shared MLP; the switch-style load-balance loss.  The reference computes
all of it outside any Pallas kernel, so the port runs plain torch.

The combine adds, for each token, the kept contributions of its
experts in increasing expert order, one gather at a time.  That is the
order of the reference's scatter-add (its updates run expert by expert),
and it is the same on every device: an ``index_add_`` on CUDA adds with
atomics, in an order that changes from run to run.

At decode G = B, so ``capacity`` gives C = G: every expert takes every
token and a step reads every expert's weights, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .layers import MLP, frozen, init_dense, init_mlp, init_normal, mlp

Tensor = torch.Tensor

#: the leaves that stay float32 whatever the activation dtype (the
#: reference's ``init_moe`` keeps the router so).
FP32_LEAVES = ("router",)


class MoE(nn.Module):
    """Weights under the reference's names: router (d, E) in float32;
    w_gate, w_up (E, d, f) and w_down (E, f, d) in the activation dtype;
    shared, an ``MLP`` of width n_shared_experts * f, where the config
    has shared experts.

    ``routing_log``: None, or a list to which every ``moe_ffn`` call
    appends the routing tensors it has already computed (probs (G, E),
    top_idx (G, K), the dispatch's w_ec and idx_ec (E, C), routed
    (G, E)), and nothing else; the caller sets it, and reads C, the
    dropped pairs (``dropped``) and the top-k gap (``topk_gap``) after
    the call."""

    LEAVES = ("router", "w_gate", "w_up", "w_down")

    def __init__(self, shared: Optional[MLP] = None, **leaves: Tensor):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, frozen(leaves[name]))
        self.shared = shared
        self.routing_log: Optional[list] = None


def init_moe(generator: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype, device=None) -> MoE:
    """The reference's distributions: the router N(0, 1/d) in float32,
    each expert's matrices N(0, 1/d_in).  ``init_normal`` draws the
    (E, d_in, d_out) stacks a few experts at a time, so no float32 copy
    of a whole stack is made (deepseek-v3's would be 15 GB)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def experts(d_in, d_out):
        return init_normal(generator, (E, d_in, d_out), d_in ** -0.5, dtype,
                           device)

    return MoE(router=init_dense(generator, d, E, torch.float32, device),
               w_gate=experts(d, f), w_up=experts(d, f),
               w_down=experts(f, d),
               shared=(init_mlp(generator, d, cfg.n_shared_experts * f,
                                dtype, device)
                       if cfg.n_shared_experts else None))


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Token slots per expert: tokens * topk / E * capacity_factor,
    rounded up to a multiple of 8 (at least 8) and at most the tokens."""
    c = int(n_tokens * cfg.topk / cfg.n_experts * cfg.capacity_factor)
    return min(max(8, -(-c // 8) * 8), n_tokens)


def _combine(y_ec: Tensor, w_ec: Tensor, idx_ec: Tensor, top_idx: Tensor,
             dtype: torch.dtype) -> Tensor:
    """sum over a token's kept (expert, slot) pairs of gate * y, in the
    activation dtype, in increasing expert order.  y_ec (E, C, d); w_ec,
    idx_ec (E, C) the dispatch's gates and tokens; top_idx (G, K) each
    token's experts -> (G, d)."""
    E, C, d = y_ec.shape
    G = top_idx.shape[0]
    dev = y_ec.device
    contrib = (y_ec.to(dtype) * w_ec[..., None].to(dtype)).reshape(E * C, d)
    # slot[g * E + e]: (token g, expert e)'s row of contrib; -1 where the
    # token was dropped (or not routed to e).  A token fills at most one
    # slot of an expert, so the kept indices are unique; the others are
    # sent to a spare last entry.
    kept = (w_ec > 0).reshape(-1)
    pair = (idx_ec * E + torch.arange(E, device=dev)[:, None]).reshape(-1)
    slot = torch.full((G * E + 1,), -1, dtype=torch.long, device=dev)
    slot.scatter_(0, torch.where(kept, pair, G * E),
                  torch.arange(E * C, device=dev))
    rows = slot[:-1].view(G, E).gather(1, top_idx.sort(dim=-1).values)
    out = torch.zeros((G, d), dtype=dtype, device=dev)
    for k in range(rows.shape[1]):
        r = rows[:, k]
        out = out + torch.where((r >= 0)[:, None], contrib[r.clamp_min(0)],
                                0)
    return out


def dropped(rec: dict) -> Tensor:
    """The routed (token, expert) pairs past capacity in one
    ``routing_log`` record (a device scalar)."""
    return rec["routed"].sum() - (rec["w_ec"] > 0).sum()


def topk_gap(rec: dict) -> Tensor:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability in one ``routing_log`` record (how near the top-k came
    to a tie); inf when every expert is in the top-k."""
    probs, K = rec["probs"], rec["top_idx"].shape[1]
    if K == probs.shape[1]:
        return torch.full((), float("inf"), device=probs.device)
    v = torch.topk(probs, K + 1, dim=-1).values
    return (v[:, K - 1] - v[:, K]).min()


def moe_ffn(cfg: ArchConfig, p: MoE, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss (fp32 scalar))."""
    B, S, d = x.shape
    G, E, K = B * S, cfg.n_experts, cfg.topk
    xf = x.reshape(G, d)

    probs = torch.softmax((xf @ p.router.to(xf.dtype)).float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate = torch.zeros((G, E), dtype=torch.float32, device=x.device
                       ).scatter_(1, top_idx, top_vals)

    # expert-side capacity: each expert's top-C tokens by gate value
    C = capacity(cfg, G)
    w_ec, idx_ec = torch.topk(gate.T, C, dim=-1)               # (E, C)
    x_ec = xf[idx_ec]                                          # (E, C, d)
    act = (F.silu(torch.bmm(x_ec, p.w_gate)) if cfg.act == "silu" else
           F.gelu(torch.bmm(x_ec, p.w_gate), approximate="tanh"))
    y_ec = torch.bmm(act * torch.bmm(x_ec, p.w_up), p.w_down)  # (E, C, d)
    yf = _combine(y_ec, w_ec, idx_ec, top_idx, x.dtype)
    if p.shared is not None:
        yf = yf + mlp(p.shared, xf, cfg.act)

    routed = gate > 0
    aux = cfg.router_aux_weight * E * torch.sum(
        probs.mean(0) * routed.float().mean(0))
    if p.routing_log is not None:
        p.routing_log.append({"probs": probs, "top_idx": top_idx,
                              "w_ec": w_ec, "idx_ec": idx_ec,
                              "routed": routed})
    return yf.reshape(B, S, d), aux
