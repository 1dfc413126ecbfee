"""Model-level API for text decoders: embeddings, the LM head, losses,
and the train / prefill / decode step functions the drivers call.

Counterpart of ``repro/models/model.py`` for the text modality
(attention, sliding-window attention, latent attention, mamba and
RG-LRU decoders, dense or MoE FFNs).  The model is an ``nn.Module``
(``Model``) holding the decoder, the embedding table and the LM head.
Serving holds it frozen and runs its steps under ``torch.no_grad``;
training turns its gradients on (``trainable``).

The FEEL integration (``make_train_step(..., feel=...)``) is the
paper's technique inside the train step, as in the reference: each
example's last-layer gradient-norm score sigma (``sigma_scores``,
through the row-norm kernel ``kernels.ops.gradnorm_sigma`` on the card),
the exact Problem-4 selection per client (``core.selection.
exact_selection``), and the eq.-(19) inverse-propensity weights with
Bernoulli availability; the batch's ``n_clients`` equal slices play the
K federated devices.  The optimizer step is applied leaf by leaf in
place (``apply_optimizer``), the port's counterpart of the reference
driver's buffer donation.  The vlm/audio modalities are not ported yet
(ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.selection import exact_selection
from ..core.types import SystemParams
from ..kernels import ops
from ..optim import GradientTransformation, apply_updates
from .config import ArchConfig
from . import mla, moe, rglru, ssm
from .layers import MLP, Attention, _TODO, frozen, init_dense, init_normal
from .transformer import (Block, Cache, Decoder, MambaBlock, RGLRUBlock,
                          _layer_plan, _uses_moe, apply_decoder,
                          check_supported, init_cache, init_decoder)

Tensor = torch.Tensor


class Model(nn.Module):
    """decoder, embed (vocab, d) and lm_head (d, vocab; absent when the
    embeddings are tied).  Built frozen (``layers.frozen``); ``trainable``
    turns the gradients on."""

    def __init__(self, decoder: Decoder, embed: Tensor,
                 lm_head: Optional[Tensor] = None):
        super().__init__()
        self.decoder = decoder
        self.embed = frozen(embed)
        self.lm_head = None if lm_head is None else frozen(lm_head)


# ---------------------------------------------------------------- params

def init_model(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> Model:
    """Random weights with the reference's distributions, drawn on
    ``device`` (the generator's device) tensor by tensor, the large ones
    in blocks (``layers.init_normal``), so full-size weights never pass
    through the host.  On the ``meta`` device it allocates nothing (parameter
    counts of configs that fit no card)."""
    check_supported(cfg)
    dtype = cfg.act_dtype
    decoder = init_decoder(cfg, generator, device)
    embed = init_normal(generator, (cfg.vocab, cfg.d_model),
                        cfg.d_model ** -0.5, dtype, device)
    lm_head = (None if cfg.tie_embeddings else
               init_dense(generator, cfg.d_model, cfg.vocab, dtype, device))
    return Model(decoder, embed, lm_head)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def trainable(model: Model) -> Model:
    """Turn the gradients of every parameter on, in place (serving keeps
    them off); returns the model."""
    return model.requires_grad_(True)


def _tensor(a, dtype: torch.dtype, device) -> Tensor:
    # via float32: exact for the bf16 and fp32 arrays of the reference
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


def params_from_numpy(cfg: ArchConfig, tree: Mapping,
                      device=None) -> Model:
    """The reference's ``init_model`` pytree (as numpy arrays) -> the
    port's ``Model``.

    Dense weights keep the reference's (d_in, d_out) layout (the port
    applies them as ``x @ w``), so nothing is transposed.  The scan axis
    of ``tree["decoder"]["body"]["pos{p}"]`` is unstacked into one
    ``Block`` per layer, repeat r and pattern position p at
    ``decoder.body[r * P + p]``.  Values are carried exactly, in
    ``cfg.act_dtype``, except the float32 leaves (``ssm.FP32_LEAVES``,
    ``rglru.FP32_LEAVES``, the MoE router ``moe.FP32_LEAVES``), which
    stay float32 as in the reference.  An MoE FFN keeps its ``shared``
    MLP.
    """
    check_supported(cfg)
    dtype = cfg.act_dtype

    def t(a, dt=dtype):
        return _tensor(a, dt, device)

    def mixer(cls, fp32, m):
        return cls(**{n: t(m[n], torch.float32 if n in fp32 else dtype)
                      for n in cls.LEAVES})

    def dense(f):
        return MLP(t(f["w_gate"]), t(f["w_up"]), t(f["w_down"]))

    def block(kind, p, use_moe=False):
        if kind == "mamba":
            return MambaBlock(t(p["ln1"]), mixer(ssm.Mamba, ssm.FP32_LEAVES,
                                                 p["mixer"]))
        f = p["ffn"]
        ffn = (moe.MoE(shared=dense(f["shared"]) if "shared" in f else None,
                       **{n: t(f[n], torch.float32 if n in moe.FP32_LEAVES
                               else dtype) for n in moe.MoE.LEAVES})
               if use_moe else dense(f))
        if kind == "rglru":
            return RGLRUBlock(t(p["ln1"]), mixer(rglru.RGLRU,
                                                 rglru.FP32_LEAVES,
                                                 p["mixer"]),
                              t(p["ln2"]), ffn)
        a = p["attn"]
        if kind == "mla":
            return Block(t(p["ln1"]),
                         mla.MLA(**{n: t(a[n]) for n in mla.leaves(cfg)}),
                         t(p["ln2"]), ffn)
        norms = [t(a["q_norm"]), t(a["k_norm"])] if cfg.qk_norm else []
        return Block(t(p["ln1"]),
                     Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]),
                               t(a["wo"]), *norms),
                     t(p["ln2"]), ffn)

    dec = tree["decoder"]
    head, n_body, pattern, tail = _layer_plan(cfg)
    use_moe = _uses_moe(cfg)
    body = []
    for r in range(n_body):
        for p, kind in enumerate(pattern):
            stacked = dec["body"][f"pos{p}"]
            body.append(block(kind, _index(stacked, r), use_moe))
    decoder = Decoder([block(k, p) for k, p in zip(head, dec["head"])], body,
                      [block(k, p, use_moe)
                       for k, p in zip(tail, dec["tail"])],
                      t(dec["final_norm"]))
    return Model(decoder, t(tree["embed"]),
                 None if cfg.tie_embeddings else t(tree["lm_head"]))


def _index(tree, r: int):
    """Slice r of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ------------------------------------------------------------ embeddings

def embed_input(cfg: ArchConfig, model: Model,
                batch: Dict[str, Tensor]) -> Tensor:
    if cfg.modality != "text":
        raise NotImplementedError(f"the {cfg.modality!r} modality is {_TODO}")
    return model.embed[batch["tokens"]].to(cfg.act_dtype)


def _positions(cfg: ArchConfig, B: int, S: int, offset: int = 0,
               device=None) -> Tensor:
    pos = offset + torch.arange(S, device=device)
    return pos[None, :].expand(B, S)


def unembed(cfg: ArchConfig, model: Model, hidden: Tensor) -> Tensor:
    """Logits in fp32.  The untied head multiplies in the activation
    dtype and casts afterwards, as the reference does (greedy ties
    depend on it)."""
    if cfg.tie_embeddings:
        return hidden.float() @ model.embed.float().T
    return (hidden @ model.lm_head).float()


# ------------------------------------------------------------------ loss

def per_example_loss(cfg: ArchConfig, logits: Tensor,
                     batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """Mean cross-entropy per example over its valid tokens (labels
    >= 0): ((B,), valid-token counts (B,), at least 1)."""
    labels = batch["labels"]
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    tok_loss = -tok_ll * valid
    n = valid.sum(dim=-1).clamp_min(1)
    return tok_loss.sum(dim=-1) / n, n


@torch.no_grad()
def sigma_scores(cfg: ArchConfig, hidden: Tensor, logits: Tensor,
                 batch: Dict[str, Tensor]) -> Tensor:
    """Per-example last-layer gradient-norm^2 proxy (GraNd-style): the
    mean over valid tokens of ||softmax - onehot||^2 * (||h_t||^2 + 1),
    exact per token (the reference drops the cross-token terms of the
    full-sequence norm, O(S) not O(S^2)).  Tokens go through
    ``ops.sigma_from_head``: the row-norm kernel on CUDA tensors, its
    plain version on CPU ones.  No gradient."""
    labels = batch["labels"]
    B, S = labels.shape
    valid = (labels >= 0).float()
    tok = ops.sigma_from_head(hidden.reshape(B * S, -1).float(),
                              logits.reshape(B * S, -1),
                              labels.clamp_min(0).reshape(-1))
    return (tok.view(B, S) * valid).sum(-1) / valid.sum(-1).clamp_min(1.0)


# ----------------------------------------------------------- FEEL wiring

@dataclasses.dataclass(frozen=True)
class FeelIntegration:
    """Paper technique inside the train step.

    ``n_clients`` equal slices of the batch act as the K federated
    devices; ``eps`` is each client's availability probability (eq. 19
    weights); selection is the exact Problem-4 solver over per-example
    sigmas."""
    n_clients: int
    eps: float = 0.8
    lam: float = 1e-3
    q_reward: float = 0.002

    def system(self, per_client: int, device=None) -> SystemParams:
        """The reference's system constants on ``device``."""
        K = self.n_clients
        return SystemParams.from_arrays(K, max(K // 2, 1), 2, dict(
            B=2e6, T=0.5, L=1e6, N0=1e-9, p_max=np.full(K, 10.0),
            q=np.full(K, self.q_reward), c=np.full(K, 5.0),
            f=np.full(K, 1e9), F=np.full(K, 20.0), kappa=1e-28,
            eps=np.full(K, self.eps), D_hat=np.full(K, float(per_client)),
            lam=self.lam), device)


# ------------------------------------------------------------ step fns

def _no_mark(stage: str) -> None:
    """The default stage mark of the train step: nothing."""


def make_forward(cfg: ArchConfig) -> Callable:
    """forward(model, batch) -> (logits (B, S, V) fp32, hidden (B, S, d),
    the summed MoE aux loss): the decoder in train mode."""

    def forward(model: Model, batch: Dict[str, Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor]:
        x = embed_input(cfg, model, batch)
        B, S = x.shape[:2]
        pos = _positions(cfg, B, S, device=x.device)
        hidden, _, aux = apply_decoder(cfg, model.decoder, x, pos,
                                       mode="train")
        return unembed(cfg, model, hidden), hidden, aux

    return forward


def make_loss_fn(cfg: ArchConfig, feel: Optional[FeelIntegration] = None
                 ) -> Callable:
    """loss_fn(model, batch, delta=None, mark=...) -> (total loss,
    metrics), the reference's train-step loss.  Without ``feel`` the
    loss is the mean per-example loss.  With it, batch["alpha"] (n_clients,) holds the
    availability draws, and each example's weight is eq. (19)'s:
    (|D̂_k| / eps) * alpha_k / (K |D̂_k|) / m_k on the m_k examples the
    exact selection keeps in client k (``delta``, (K, B / K)), 0 on the
    others; given a ``delta``, the step takes it instead of solving
    (a replay taking another run's selection).  The total adds the MoE
    aux loss.  Metrics (detached): the reference's ``loss``,
    ``aux_loss``, ``selected_frac`` and, with FEEL, ``sigma_mean``; and
    ``ex_loss`` (B,), with FEEL also ``sigma`` (B,) and ``delta``.
    ``mark``, if given, is called with each stage's name as it ends
    ("forward", "loss", "sigma", "selection"), for a caller that times
    them."""
    forward = make_forward(cfg)

    def loss_fn(model: Model, batch: Dict[str, Tensor],
                delta: Optional[Tensor] = None,
                mark: Callable[[str], None] = _no_mark
                ) -> Tuple[Tensor, dict]:
        logits, hidden, aux = forward(model, batch)
        mark("forward")
        ex_loss, _ = per_example_loss(cfg, logits, batch)
        mark("loss")
        B = ex_loss.shape[0]
        metrics = {"ex_loss": ex_loss.detach()}
        if feel is None:
            loss = ex_loss.mean()
            metrics["selected_frac"] = torch.ones((), device=loss.device)
        else:
            K = feel.n_clients
            if B % K:
                raise ValueError(f"batch {B} does not split into {K} "
                                 "clients")
            per_client = B // K
            sigma = sigma_scores(cfg, hidden, logits, batch)
            mark("sigma")
            del logits, hidden
            sig_k = sigma.reshape(K, per_client)
            if delta is None:
                delta = exact_selection(feel.system(per_client, sigma.device),
                                        sig_k, torch.ones_like(sig_k))
            mark("selection")
            m_k = delta.sum(dim=1).clamp_min(1.0)
            alpha = batch["alpha"].float()
            # eq. (19): (1/|D̂|) (|D̂_k|/eps_k) alpha_k mean over selected;
            # summed, (1/K) sum_k (alpha_k/eps) mean_selected(loss_k), an
            # unbiased estimate of the mean loss (Lemma 1)
            w_k = (per_client / feel.eps) * alpha / (K * per_client)
            w = (delta * (w_k / m_k)[:, None]).reshape(B)
            loss = torch.sum(w * ex_loss)
            metrics.update(selected_frac=delta.mean(),
                           sigma_mean=sigma.mean(), sigma=sigma,
                           delta=delta)
        metrics["loss"] = loss.detach()
        metrics["aux_loss"] = aux.detach()
        return loss + aux, metrics

    return loss_fn


def grads_of(loss_fn: Callable, model: Model, batch: Dict[str, Tensor],
             delta: Optional[Tensor] = None,
             mark: Callable[[str], None] = _no_mark
             ) -> Tuple[Dict[str, Tensor], dict]:
    """(gradient of the total loss per named parameter, metrics).  The
    parameters must track gradients (``trainable``).  ``mark``: as in
    ``make_loss_fn``, and "backward" once the gradients are taken (the
    rematerialised repeats' forward runs again inside it)."""
    params = dict(model.named_parameters())
    frozen_names = [n for n, p in params.items() if not p.requires_grad]
    if frozen_names:
        raise ValueError(f"{len(frozen_names)} parameters are frozen (e.g. "
                         f"{frozen_names[0]}): call trainable(model) first")
    total, metrics = loss_fn(model, batch, delta, mark)
    grads = torch.autograd.grad(total, list(params.values()))
    mark("backward")
    return dict(zip(params, grads)), metrics


def _leaf_state(state, name: str):
    """The part of an optimizer state that belongs to leaf ``name``: the
    leaf's entry of every dict field (and the shared fields, the step
    count) of a NamedTuple state, or of a dict state; () as it is."""
    if isinstance(state, dict):
        return {name: state[name]}
    if hasattr(state, "_fields"):
        return state._replace(**{f: {name: v[name]} for f, v in
                                 state._asdict().items()
                                 if isinstance(v, dict)})
    return state


def _store_leaf(state, name: str, leaf):
    """Write leaf ``name``'s new state into ``state``'s dicts (in place)
    and take its shared fields; returns the state."""
    if isinstance(state, dict):
        state[name] = leaf[name]
        return state
    if hasattr(state, "_fields"):
        shared = {}
        for f, v in state._asdict().items():
            if isinstance(v, dict):
                v[name] = getattr(leaf, f)[name]
            else:
                shared[f] = getattr(leaf, f)
        return state._replace(**shared)
    return leaf


@torch.no_grad()
def apply_optimizer(opt: GradientTransformation, grads: Dict[str, Tensor],
                    state, params: Dict[str, Tensor]):
    """One step of a per-leaf optimizer (``opt.per_leaf``), taken leaf by
    leaf: each leaf's update is computed, added to the parameter in place
    and its state written into ``state``'s own dicts before the next
    leaf's, and each gradient is dropped from ``grads`` once used.  The
    values are those of ``opt.update`` on the whole dict then
    ``apply_updates``; only one leaf's update and new moments are alive
    at a time.  ``state`` and ``grads`` are donated (the reference's
    driver donates params and state to its jitted step): read only the
    returned state afterwards."""
    if not opt.per_leaf:
        raise ValueError("apply_optimizer takes an optimizer that updates "
                         "each leaf alone (sgd, momentum, adam, adamw, "
                         "adafactor)")
    old = state  # its step count; its dicts are the ones written below
    for name in list(grads):
        g = grads.pop(name)
        upd, leaf = opt.update({name: g}, _leaf_state(old, name),
                               {name: params[name]})
        del g
        apply_updates({name: params[name]}, upd)
        state = _store_leaf(state, name, leaf)
    return state


def make_train_step(cfg: ArchConfig, opt: GradientTransformation,
                    feel: Optional[FeelIntegration] = None) -> Callable:
    """train_step(model, opt_state, batch, delta=None, mark=None) ->
    (model, opt_state, metrics): the loss of ``make_loss_fn``, its
    gradient by autograd, then the optimizer step in place
    (``apply_optimizer``; the state passed in is donated).  With
    ``feel``, batch must carry "alpha" (n_clients,) availability
    indicators.  ``mark``: as in ``grads_of``, and "optimizer" at the
    end."""
    loss_fn = make_loss_fn(cfg, feel)

    def train_step(model: Model, opt_state, batch: Dict[str, Tensor],
                   delta: Optional[Tensor] = None,
                   mark: Callable[[str], None] = _no_mark):
        grads, metrics = grads_of(loss_fn, model, batch, delta, mark)
        opt_state = apply_optimizer(opt, grads, opt_state,
                                    dict(model.named_parameters()))
        mark("optimizer")
        return model, opt_state, metrics

    return train_step



def make_prefill_step(cfg: ArchConfig) -> Callable:
    """prefill_step(model, batch, cache=None) -> (last-position logits
    (B, 1, V), cache).  With a cache (of at least S slots) prefill fills
    its slots [0, S) in place; without one it returns a new S-slot
    cache, as the reference does."""

    @torch.no_grad()
    def prefill_step(model: Model, batch: Dict[str, Tensor],
                     cache: Optional[Cache] = None) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        B, S = x.shape[:2]
        pos = _positions(cfg, B, S, device=x.device)
        hidden, cache, _ = apply_decoder(cfg, model.decoder, x, pos,
                                         mode="prefill", cache=cache)
        return unembed(cfg, model, hidden[:, -1:]), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, mla_absorbed: bool = False
                     ) -> Callable:
    """decode_step(model, cache, batch) -> (logits (B, 1, V), cache): one
    new token per sequence at position ``batch["cache_index"]`` (an int),
    written into the cache in place.  ``mla_absorbed``: the absorbed
    decode path of ``mla`` blocks (``mla.py``)."""

    @torch.no_grad()
    def decode_step(model: Model, cache: Cache,
                    batch: Dict[str, Tensor]) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        idx = int(batch["cache_index"])
        pos = _positions(cfg, x.shape[0], 1, offset=idx, device=x.device)
        hidden, cache, _ = apply_decoder(cfg, model.decoder, x, pos,
                                         mode="decode", cache=cache,
                                         cache_index=idx,
                                         mla_absorbed=mla_absorbed)
        return unembed(cfg, model, hidden), cache

    return decode_step


make_cache = init_cache  # re-export with the model-level name
