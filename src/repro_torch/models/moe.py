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

On a mesh (DTensor activations) ``moe_ffn`` computes the same function
partitioned, as an SPMD partitioner partitions it (``_moe_ffn_sharded``):
the routing on each rank's own tokens; each expert's top-C over all G
tokens of the step in two stages (a top-C in each token shard, then the
top-C of the gathered candidates: the same C tokens, ties broken by
token index); the dispatch as each rank's gather of its own tokens,
summed over the token split into the expert placement that
``moe_ecd`` names; the combine back from it, each rank adding its own
experts' contributions to its own tokens, summed over the expert split.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import local
from .config import ArchConfig
from .layers import (MLP, frozen, init_dense, init_mlp, init_normal, matmul,
                     mlp)
from .shard_ctx import constrain, layout_placements

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


def _route(logits: Tensor, K: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Router logits (G, E) -> (probs fp32, each token's top-K experts
    (G, K), the (G, E) gate matrix of their renormalised gates)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate = torch.zeros(probs.shape, dtype=torch.float32, device=probs.device
                       ).scatter_(1, top_idx, top_vals)
    return probs, top_idx, gate


def moe_ffn(cfg: ArchConfig, p: MoE, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss (fp32 scalar))."""
    if local.is_dtensor(x):
        return _moe_ffn_sharded(cfg, p, x)
    B, S, d = x.shape
    G, E, K = B * S, cfg.n_experts, cfg.topk
    xf = x.reshape(G, d)

    probs, top_idx, gate = _route(xf @ p.router.to(xf.dtype), K)

    # expert-side capacity: each expert's top-C tokens by gate value
    C = capacity(cfg, G)
    w_ec, idx_ec = torch.topk(gate.T, C, dim=-1)               # (E, C)
    x_ec = constrain(xf[idx_ec], "moe_ecd")                    # (E, C, d)
    y_ec = constrain(_experts(cfg, p, x_ec), "moe_ecd")        # (E, C, d)
    yf = _combine(y_ec, w_ec, idx_ec, top_idx, x.dtype)
    if p.shared is not None:
        yf = yf + mlp(p.shared, xf, cfg.act)
    return yf.reshape(B, S, d), _aux(cfg, p, probs, top_idx, gate, w_ec,
                                     idx_ec)


def _experts(cfg: ArchConfig, p: MoE, x_ec: Tensor) -> Tensor:
    """``act(x W_gate) * (x W_up) W_down`` for every expert at once."""
    act = (F.silu(torch.bmm(x_ec, p.w_gate)) if cfg.act == "silu" else
           F.gelu(torch.bmm(x_ec, p.w_gate), approximate="tanh"))
    return torch.bmm(act * torch.bmm(x_ec, p.w_up), p.w_down)


def _aux(cfg: ArchConfig, p: MoE, probs: Tensor, top_idx: Tensor,
         gate: Tensor, w_ec: Tensor, idx_ec: Tensor) -> Tensor:
    """The switch-style load-balance loss; logs the routing where the
    caller asked for it (``MoE.routing_log``)."""
    routed = gate > 0
    aux = cfg.router_aux_weight * cfg.n_experts * torch.sum(
        probs.mean(0) * routed.float().mean(0))
    if p.routing_log is not None:
        p.routing_log.append({"probs": probs, "top_idx": top_idx,
                              "w_ec": w_ec, "idx_ec": idx_ec,
                              "routed": routed})
    return aux


def _top_c_shard(gate: Tensor, C: int, g0: int) -> Tuple[Tensor, Tensor]:
    """Stage 1: the top-min(C, G_l) of one token shard's (G_l, E) gates for
    every expert, (E, min(C, G_l)) values and token indices (offset by
    the shard's first token ``g0``); a stable sort keeps ties in token
    order."""
    k = min(C, gate.shape[0])
    vals, order = torch.sort(gate.T, dim=-1, descending=True, stable=True)
    return vals[:, :k], order[:, :k] + g0


def _top_c_merge(vals: Tensor, idx: Tensor, C: int) -> Tuple[Tensor, Tensor]:
    """Stage 2: the top-C of the candidates (E, n), which lie in token
    order among equal values: (E, C) values and token indices."""
    top, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return top[:, :C], idx.gather(1, order[:, :C])


def _combine_own(y_ec: Tensor, w_ec: Tensor, idx_ec: Tensor,
                 top_idx: Tensor, dtype: torch.dtype, experts: Tensor,
                 n_experts: int, g0: int) -> Tensor:
    """``_combine`` on one rank: the kept contributions of the experts
    ``experts`` (ids among ``n_experts``, (n,); y_ec, w_ec, idx_ec their
    (n, C, ...) rows) to the rank's own tokens g0..g0 + G_l - 1 (top_idx
    (G_l, K)), in increasing expert order -> (G_l, d), this rank's part
    of the sum."""
    n, C, d = y_ec.shape
    G = top_idx.shape[0]
    dev = y_ec.device
    contrib = (y_ec.to(dtype) * w_ec[..., None].to(dtype)).reshape(n * C, d)
    tokens = idx_ec - g0
    kept = ((w_ec > 0) & (tokens >= 0) & (tokens < G)).reshape(-1)
    pair = (tokens.clamp(0, G - 1) * n
            + torch.arange(n, device=dev)[:, None]).reshape(-1)
    slot = torch.full((G * n + 1,), -1, dtype=torch.long, device=dev)
    slot.scatter_(0, torch.where(kept, pair, G * n),
                  torch.arange(n * C, device=dev))
    # each token's experts, in increasing order, as rows of ``experts``
    where = torch.full((n_experts,), -1, dtype=torch.long, device=dev)
    where[experts] = torch.arange(n, device=dev)
    pos = where[top_idx.sort(dim=-1).values]
    rows = torch.where(pos >= 0, slot[:-1].view(G, n).gather(
        1, pos.clamp_min(0)), -1)
    out = torch.zeros((G, d), dtype=dtype, device=dev)
    for k in range(rows.shape[1]):
        r = rows[:, k]
        out = out + torch.where((r >= 0)[:, None], contrib[r.clamp_min(0)],
                                0)
    return out


def _moe_ffn_sharded(cfg: ArchConfig, p: MoE,
                     x: Tensor) -> Tuple[Tensor, Tensor]:
    """``moe_ffn`` on DTensors, partitioned (the module docstring).

    Tokens are split over the token mesh dims (those splitting x's
    batch).  The expert placement of (E, C, d) is ``moe_ecd``'s: over
    mesh dims that split no token (DeepSeek-V2: E over "model"), or
    jointly over a token dim too (DeepSeek-V3 on 16x16: E over "data"
    and "model", one expert a rank).  Each rank forms the dispatch rows
    of a set of experts from its own tokens: those whose home shares its
    coordinates on the expert-only dims, over every coordinate of the
    joint dims, so that a reduce-scatter over each joint dim leaves every
    rank its own experts' rows, summed over the token split; over a
    token dim that splits no expert the rows are a partial sum (all
    reduced by the constraint).  The combine gathers those rows back
    over the joint dims, and each rank adds its set's contributions to
    its own tokens: a partial sum over the expert-only dims."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, S, d = x.shape
    G, E, K = B * S, cfg.n_experts, cfg.topk
    mesh = x.device_mesh
    xf = x.reshape(G, d)
    tok = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
                else Replicate() for pl in xf.placements)
    if tuple(xf.placements) != tok:
        xf = xf.redistribute(mesh, tok)
    rep = (Replicate(),) * mesh.ndim
    tdims = [m for m, pl in enumerate(tok) if isinstance(pl, Shard)]
    g0, G_l = local.local_range(xf, 0)

    probs, top_idx, gate = local.call_local(
        lambda lg: _route(lg, K), (matmul(xf, p.router.to(xf.dtype)),),
        (tok,), (tok, tok, tok), mesh)

    # expert-side capacity: each expert's top-C tokens over all G
    C = capacity(cfg, G)
    cand = tuple(Shard(1) if m in tdims else Replicate()
                 for m in range(mesh.ndim))
    c_vals, c_idx = local.call_local(
        lambda g: _top_c_shard(g, C, g0), (gate,), (tok,), (cand, cand),
        mesh)
    w_ec, idx_ec = local.call_local(
        lambda v, i: _top_c_merge(v, i, C), (c_vals, c_idx), (rep, rep),
        (rep, rep), mesh)                                      # (E, C)

    # the expert placement and this rank's set of experts
    target = layout_placements("moe_ecd", (E, C, d)) or rep
    sdims = [m for m, pl in enumerate(target) if isinstance(pl, Shard)]
    jdims = [m for m in sdims if m in tdims]
    per = E // math.prod(mesh.size(m) for m in sdims)
    base = 0
    for m in sdims:
        base = base * mesh.size(m) + (0 if m in jdims
                                      else mesh.get_local_rank(m))
    steps = [math.prod(mesh.size(n) for n in sdims if n > m) for m in jdims]
    chunks = [base]
    for m, step in zip(jdims, steps):
        chunks = [c + j * step for c in chunks for j in range(mesh.size(m))]
    experts = torch.tensor([c * per + r for c in chunks for r in range(per)],
                           device=x.device)
    # the differentiable collectives under this release's names
    scatter = getattr(funcol, "reduce_scatter_single_autograd", None) \
        or funcol.reduce_scatter_tensor_autograd
    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd

    def dispatch(xl, idx):
        rows = idx[experts] - g0
        mine = (rows >= 0) & (rows < G_l)
        xs = torch.where(mine[..., None], xl[rows.clamp(0, G_l - 1)], 0)
        for m in jdims:
            xs = scatter(xs, "sum", 0, (mesh, m))
        return xs

    sent = [Partial() if (m in tdims and m not in jdims) else pl
            for m, pl in enumerate(target)]
    x_ec = constrain(local.call_local(dispatch, (xf, idx_ec), (tok, rep),
                                      sent, mesh), "moe_ecd")  # (E, C, d)
    y_ec = constrain(_experts(cfg, p, x_ec), "moe_ecd")        # (E, C, d)

    def combine(y, w, idx, tops):
        for m in reversed(jdims):
            y = gather(y, 0, (mesh, m))
        return _combine_own(y, w[experts], idx[experts], tops, x.dtype,
                            experts, E, g0)

    own = [Shard(0) if m in tdims
           else Partial() if m in sdims else Replicate()
           for m in range(mesh.ndim)]
    # each rank reads every gate but weighs only its own (token, expert)
    # pairs: the gates' gradient is a partial sum
    w_grad = [Partial() if m in tdims or m in sdims else Replicate()
              for m in range(mesh.ndim)]
    yf = local.call_local(combine, (y_ec, w_ec, idx_ec, top_idx),
                          (target, rep, rep, tok), own, mesh,
                          grad_placements=(target, w_grad, rep, tok)
                          ).redistribute(mesh, tok)
    if p.shared is not None:
        yf = yf + mlp(p.shared, xf, cfg.act)
    return yf.reshape(B, S, d), _aux(cfg, p, probs, top_idx, gate, w_ec,
                                     idx_ec)
