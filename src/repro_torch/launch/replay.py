"""The rule a replayed train step is held to.

A train step replayed on another device (the card's step on the CPU, or
the port's step against the reference's) starts from the same params,
optimizer state and batch, and is held, per quantity:

- **loss, per-example loss and sigma**: rtol ``RTOL`` (1e-4);
- **selection**: per client, the smallest relative gap between two of
  its sigmas (``sigma_gaps``).  Where it exceeds ``GAP_FACTOR`` (10) x
  the step's measured sigma error, the two selections must be equal;
  elsewhere fp32 cannot order those sigmas, so the replay takes the
  other side's ``delta`` (``selection_given``) and says so;
- **gradients, per leaf**: rtol ``RTOL`` with an atol of ``RTOL`` x the
  leaf's largest |g| (``check_grads``);
- **params after the step** (``check_params``): an entry whose gradient
  is above that atol is held at 1e-6 + 1e-5 |w|.  An entry at gradient
  noise is held, under adam(w), at |the other side's own update of it| +
  lr (1 + wd |w|): m/sqrt(v) of a gradient at fp32 noise is about +-1,
  so its direction is decided by the noise and the entry may move by lr
  either way.  Under adafactor every entry is held at its own update
  plus its leaf's largest (the factored second moment lets one entry's
  noise scale the whole leaf's step); under sgd and momentum at
  1e-6 + 1e-5 |w| + lr x the gradient's own bound.

No one fixed rule holds every entry: that is what a fixed atol/rtol
missed on Adam's noise entries.  The functions raise ``AssertionError``
on a breach and return what they measured.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from ..models import model as tm

Tensor = torch.Tensor

RTOL = 1e-4
GAP_FACTOR = 10.0
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def max_rel(got: Tensor, want: Tensor) -> float:
    """Largest |got - want| / |want| (float64)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def check_rel(name: str, got: Tensor, want: Tensor,
              rtol: float = RTOL) -> float:
    """|got - want| <= rtol |want| elementwise; returns the largest
    relative error."""
    err = max_rel(got, want)
    if not err <= rtol:
        raise AssertionError(f"{name}: relative error {err:.3g} above "
                             f"{rtol}")
    return err


def sigma_gaps(sigma: Tensor, n_clients: int) -> Tensor:
    """(K,) smallest relative gap between two sigmas of each client:
    consecutive sorted values' difference over the larger's |value|
    (inf for a client of one example)."""
    s = sigma.double().cpu().reshape(n_clients, -1).sort(dim=1).values
    if s.shape[1] < 2:
        return torch.full((n_clients,), float("inf"), dtype=torch.float64)
    gap = (s[:, 1:] - s[:, :-1]) / s[:, 1:].abs().clamp_min(1e-300)
    return gap.min(dim=1).values


def selection_given(sigma_want: Tensor, sigma_err: float,
                    n_clients: int) -> bool:
    """True where fp32 cannot be asked for the same selection: some
    client's smallest sigma gap is within ``GAP_FACTOR`` x
    ``sigma_err``."""
    return bool((sigma_gaps(sigma_want, n_clients)
                 <= GAP_FACTOR * sigma_err).any())


def _chunks(*ts: Tensor, n: int = 1 << 24):
    """Float32 CPU pieces of ``ts``' flattened entries, at most ``n`` at
    a time (a full-width embedding would otherwise take GBs of
    temporaries)."""
    flat = [t.detach().reshape(-1) for t in ts]
    for i in range(0, flat[0].numel(), n):
        yield i, [f[i:i + n].float().cpu() for f in flat]


def check_grads(got: Dict[str, Tensor], want: Dict[str, Tensor]
                ) -> Tuple[float, str]:
    """Per leaf: |got - want| <= RTOL |want| + RTOL max|want|.  Returns
    the largest error in units of that bound, and its leaf."""
    worst, where = 0.0, ""
    for name, w in want.items():
        atol = RTOL * float(w.detach().abs().max())
        for _, (g, wc) in _chunks(got[name], w):
            ratio = float(((g - wc).abs() / (RTOL * wc.abs() + atol)
                           .clamp_min(1e-30)).max())
            if ratio > worst:
                worst, where = ratio, name
            if not ratio <= 1.0:
                raise AssertionError(
                    f"gradient of {name}: max abs err "
                    f"{float((g - wc).abs().max()):.3g} beyond rtol {RTOL} "
                    f"+ atol {RTOL} x max |g| ({atol:.3g})")
    return worst, where


def check_params(before: Dict[str, Tensor], got: Dict[str, Tensor],
                 want: Dict[str, Tensor], grads: Dict[str, Tensor],
                 optimizer: str, lr: float, wd: float = 0.0
                 ) -> Dict[str, float]:
    """The params after the step, ``got`` against ``want`` (both from
    ``before``), by the module docstring's rule; ``grads`` are ``want``'s
    side's.  Returns the largest error, the largest error of an entry
    whose gradient is above the atol, and the count of entries at
    gradient noise.  Entries within 1e-6 + 1e-5 |w| pass at once; only
    the others are weighed against their optimizer's bound."""
    out = {"max_abs_err": 0.0, "decided_max_abs_err": 0.0, "noise": 0,
           "entries": 0}
    for name, want1 in want.items():
        g_max = float(grads[name].detach().abs().max())
        u_max = (float((want1.detach().float().cpu()
                        - before[name].detach().float().cpu()).abs().max())
                 if optimizer == "adafactor" else 0.0)
        for i0, (w0, w1, g1, g) in _chunks(before[name], want1, got[name],
                                           grads[name]):
            err = (g1 - w1).abs_()
            noise = g.abs() <= RTOL * g_max
            out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
            out["decided_max_abs_err"] = max(
                out["decided_max_abs_err"],
                float(torch.where(noise, 0.0, err).max()))
            out["noise"] += int(noise.sum())
            out["entries"] += noise.numel()
            over = (err > PARAM_ATOL + PARAM_RTOL * w1.abs()).nonzero()[:, 0]
            if not over.numel():
                continue
            err, w0, w1, g, noise = (t[over] for t in (err, w0, w1, g, noise))
            tight = PARAM_ATOL + PARAM_RTOL * w1.abs()
            u = (w1 - w0).abs()
            if optimizer in ("adam", "adamw"):
                bound = torch.where(noise, u + lr * (1.0 + wd * w0.abs()),
                                    tight)
            elif optimizer == "adafactor":
                bound = u + u_max + tight
            else:  # sgd, momentum: the step is linear in the gradient
                bound = tight + lr * RTOL * (g.abs() + g_max)
            if not bool((err <= bound).all()):
                i = int(torch.argmax(err - bound))
                raise AssertionError(
                    f"param {name}: entry {i0 + int(over[i])} differs by "
                    f"{float(err[i]):.3g}, beyond its bound "
                    f"{float(bound[i]):.3g} ({optimizer}, gradient "
                    f"{float(g[i]):.3g}, "
                    f"{'at noise' if bool(noise[i]) else 'decided'})")
    return out


# ------------------------------------------------------------- a replay

def _state_to(state, device):
    """A copy of an optimizer state (dicts of tensors, a NamedTuple of
    them and a count, or ()) on ``device``."""
    if isinstance(state, dict):
        return {n: t.detach().to(device, copy=True) for n, t in state.items()}
    if hasattr(state, "_fields"):
        return state._replace(**{f: _state_to(v, device) for f, v in
                                 state._asdict().items()
                                 if isinstance(v, dict)})
    return state


@torch.no_grad()
def sigma64(cfg, model, batch) -> Tensor:
    """sigma of ``batch`` recomputed in float64 from ``model``'s final
    hidden state (its own forward) and its LM head (for audio its C
    codebook heads, summed over the valid codebooks and divided by
    codebook 0's valid count, as ``sigma_scores``): the yardstick for
    each side's fp32 sigma."""
    _, hidden, _ = tm.make_forward(cfg)(model, batch)
    h = hidden.double()
    head = (model.embed.double().T
            if cfg.modality == "text" and cfg.tie_embeddings
            else model.lm_head.double())
    logits = h @ head
    labels = batch["labels"]
    if cfg.modality == "audio":
        logits = logits.view(*h.shape[:-1], cfg.n_codebooks, cfg.vocab)
        labels = labels.transpose(1, 2)
    p = torch.softmax(logits, dim=-1)
    p.scatter_add_(-1, labels.clamp_min(0)[..., None],
                   torch.full(labels.shape + (1,), -1.0, dtype=p.dtype))
    valid = (labels >= 0).double()
    dn2 = (p.square().sum(-1) * valid)
    if cfg.modality == "audio":
        dn2, valid = dn2.sum(-1), valid[..., 0]
    tok = (h.square().sum(-1) + 1.0) * dn2
    return tok.sum(-1) / valid.sum(-1).clamp_min(1.0)


def replay_step(cfg, opt, feel, model, state, batch, optimizer: str,
                wd: float = 0.0):
    """One FEEL train step of ``model`` (on the card) from ``state``,
    replayed on the CPU from the same params, state and batch and held
    by the rule of the module docstring.  Returns (the card's new state,
    a report of what was measured).  ``optimizer`` names ``opt``'s kind
    (adamw, adam, adafactor, sgd, momentum) and ``wd`` its weight
    decay."""
    loss_fn = tm.make_loss_fn(cfg, feel)
    params = dict(model.named_parameters())
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    state_cpu = _state_to(state, "cpu")
    batch_cpu = {k: v.cpu() for k, v in batch.items()}

    grads, m_card = tm.grads_of(loss_fn, model, batch)
    grads_card = {n: g.detach().to("cpu", copy=True)
                  for n, g in grads.items()}
    state = tm.apply_optimizer(opt, grads, state, params)
    after = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    m_card = {k: v.detach().cpu() for k, v in m_card.items()}

    t0 = time.perf_counter()
    cpu = tm.init_model(cfg, None, "meta").to_empty(device="cpu")
    cpu.load_state_dict(before)
    tm.trainable(cpu)
    want64 = sigma64(cfg, cpu, batch_cpu)
    grads_cpu, m_cpu = tm.grads_of(loss_fn, cpu, batch_cpu)
    K = feel.n_clients
    sig_err = max_rel(m_cpu["sigma"], m_card["sigma"])
    gaps = sigma_gaps(m_card["sigma"], K)
    given = selection_given(m_card["sigma"], sig_err, K)
    same = bool(torch.equal(m_cpu["delta"], m_card["delta"]))
    if not same:
        if not given:
            raise AssertionError(
                f"selection differs: card {m_card['delta'].tolist()} cpu "
                f"{m_cpu['delta'].tolist()}, with every client's smallest "
                f"sigma gap ({gaps.min():.3g}) above {GAP_FACTOR} x the "
                f"sigma error {sig_err:.3g}")
        # the card's selection taken as given: the CPU step again with it
        cpu.load_state_dict(before)
        grads_cpu, m_cpu = tm.grads_of(loss_fn, cpu, batch_cpu,
                                       m_card["delta"])
    report = {
        "loss_card": float(m_card["loss"]), "loss_cpu": float(m_cpu["loss"]),
        "loss_rel": check_rel("loss", m_cpu["loss"], m_card["loss"]),
        "ex_loss_rel": check_rel("per-example loss", m_cpu["ex_loss"],
                                 m_card["ex_loss"]),
        "sigma_rel": check_rel("sigma", m_cpu["sigma"], m_card["sigma"]),
        "sigma64_card": max_rel(m_card["sigma"], want64),
        "sigma64_cpu": max_rel(m_cpu["sigma"], want64),
        "sigma_range": (float(m_card["sigma"].min()),
                        float(m_card["sigma"].max())),
        "gaps": gaps.tolist(), "given": given and not same,
        "selection_equal": same,
        "selected": int(m_card["delta"].sum()), "examples": m_card[
            "delta"].numel(),
        "aux_card": float(m_card["aux_loss"]),
        "aux_cpu": float(m_cpu["aux_loss"]),
    }
    report["grad_ratio"], report["grad_leaf"] = check_grads(grads_cpu,
                                                            grads_card)
    tm.apply_optimizer(opt, grads_cpu, state_cpu,
                       dict(cpu.named_parameters()))
    report["params"] = check_params(
        before, {n: p.detach() for n, p in cpu.named_parameters()}, after,
        grads_card, optimizer, cfg.learning_rate, wd)
    report["cpu_s"] = time.perf_counter() - t0
    return state, report
