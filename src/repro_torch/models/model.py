"""Model-level API: embeddings and heads per modality, the losses, and
the train / prefill / decode step functions the launchers call.

Counterpart of ``repro/models/model.py``.  Modalities, as the
reference's:
  text   tokens (B, S) -> the embedding table (vocab, d)
  vlm    precomputed patch/text embeddings (B, S, d) with M-RoPE
         positions (B, 3, S) (the ViT frontend is the reference's stub);
         no embedding table
  audio  a codebook token grid (B, C, S) -> the sum of C per-codebook
         embeddings (C, vocab, d); C parallel heads, one (d, C vocab)
         matrix, logits (B, S, C, vocab)
over every decoder the port runs (attention, sliding-window attention,
latent attention, mamba and RG-LRU, dense or MoE FFNs).  The model is an
``nn.Module`` (``Model``) holding the decoder, the embedding table and
the LM head.  Serving holds it frozen and runs its steps under
``torch.no_grad``; training turns its gradients on (``trainable``).

The FEEL integration (``make_train_step(..., feel=...)``) is the
paper's technique inside the train step, as in the reference: each
example's last-layer gradient-norm score sigma (``sigma_scores``,
through the row-norm kernel ``kernels.ops.gradnorm_sigma`` on the card),
the exact Problem-4 selection per client (``core.selection.
exact_selection``), and the eq.-(19) inverse-propensity weights with
Bernoulli availability; the batch's ``n_clients`` equal slices play the
K federated devices.  The optimizer step is applied leaf by leaf in
place (``apply_optimizer``; adafactor steps each stacked body group of
``stacked_groups`` at once), the port's counterpart of the buffer
donation of the reference's training loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.selection import exact_selection
from ..core.types import SystemParams
from ..kernels import local, ops
from ..optim import GradientTransformation, apply_updates
from .config import ArchConfig
from . import mla, moe, rglru, ssm
from .layers import (MLP, Attention, embedding, frozen, init_dense,
                     init_normal, linear)
from .shard_ctx import constrain, replicated, view_as
from .transformer import (Block, Cache, Decoder, MambaBlock, RGLRUBlock,
                          _layer_plan, _uses_moe, apply_decoder,
                          check_supported, init_cache, init_decoder)

Tensor = torch.Tensor


class Model(nn.Module):
    """decoder, embed and lm_head, by modality: text (vocab, d) and (d,
    vocab), the head absent when the embeddings are tied; vlm no embed
    and (d, vocab); audio (C, vocab, d) and (d, C vocab).  Built frozen
    (``layers.frozen``); ``trainable`` turns the gradients on."""

    def __init__(self, decoder: Decoder, embed: Optional[Tensor] = None,
                 lm_head: Optional[Tensor] = None):
        super().__init__()
        self.decoder = decoder
        self.embed = None if embed is None else frozen(embed)
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
    dtype, d = cfg.act_dtype, cfg.d_model
    decoder = init_decoder(cfg, generator, device)
    if cfg.modality == "vlm":
        return Model(decoder, None,
                     init_dense(generator, d, cfg.vocab, dtype, device))
    if cfg.modality == "audio":
        C = cfg.n_codebooks
        embed = init_normal(generator, (C, cfg.vocab, d), d ** -0.5, dtype,
                            device)
        return Model(decoder, embed, init_dense(generator, d, C * cfg.vocab,
                                                dtype, device))
    embed = init_normal(generator, (cfg.vocab, d), d ** -0.5, dtype, device)
    lm_head = (None if cfg.tie_embeddings else
               init_dense(generator, d, cfg.vocab, dtype, device))
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
    MLP.  The vlm tree has no ``embed``; the audio tree's is stacked
    over codebooks, (C, vocab, d), as the reference's.
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
    return Model(decoder, t(tree["embed"]) if "embed" in tree else None,
                 t(tree["lm_head"]) if "lm_head" in tree else None)


def stacked_groups(cfg: ArchConfig) -> Dict[str, Tuple[str, ...]]:
    """The reference's stacked body leaves by the port's parameter names:
    ``decoder.body.pos{p}.<path>`` (the reference's tree path, dotted) ->
    the names of that leaf in repeats 0..n_body-1,
    ``decoder.body.{r * P + p}.<path>``.  Head and tail layers are not
    stacked in the reference and are in no group.  Taken from a model of
    ``cfg`` on the ``meta`` device (nothing is allocated)."""
    P = len(_layer_plan(cfg)[2])
    groups: Dict[str, list] = {}
    for name, _ in init_model(cfg, None, "meta").named_parameters():
        parts = name.split(".", 3)
        if parts[:2] == ["decoder", "body"]:
            key = f"decoder.body.pos{int(parts[2]) % P}.{parts[3]}"
            groups.setdefault(key, []).append(name)
    return {g: tuple(ms) for g, ms in groups.items()}


def _index(tree, r: int):
    """Slice r of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ------------------------------------------------------------ embeddings

def embed_input(cfg: ArchConfig, model: Model,
                batch: Dict[str, Tensor]) -> Tensor:
    """(B, S, d) in the activation dtype: text tokens' embeddings, vlm
    ``embeds`` as given, or the sum of the audio tokens' (B, C, S)
    per-codebook embeddings, codebook 0 first, as the reference adds
    them."""
    if cfg.modality == "vlm":
        return batch["embeds"].to(cfg.act_dtype)
    toks = batch["tokens"]
    if cfg.modality == "audio":
        x = embedding(model.embed[0], toks[:, 0])
        for c in range(1, cfg.n_codebooks):
            x = x + embedding(model.embed[c], toks[:, c])
        return x.to(cfg.act_dtype)
    return embedding(model.embed, toks).to(cfg.act_dtype)


def _positions(cfg: ArchConfig, batch: Dict[str, Tensor], B: int, S: int,
               offset: int = 0, device=None) -> Tensor:
    """RoPE positions: the vlm batch's own (B, 3, S) M-RoPE ids, else
    offset + 0..S-1 for every sequence, (B, S)."""
    if cfg.modality == "vlm":
        return batch["positions"]
    pos = offset + torch.arange(S, device=device)
    return pos[None, :].expand(B, S)


def unembed(cfg: ArchConfig, model: Model, hidden: Tensor) -> Tensor:
    """Logits in fp32: (B, S, vocab), or (B, S, C, vocab) for audio.  The
    untied head multiplies in the activation dtype and casts afterwards,
    as the reference does (greedy ties depend on it)."""
    if cfg.modality == "text" and cfg.tie_embeddings:
        logits = linear(hidden.float(), model.embed.float().T)
    else:
        logits = linear(hidden, model.lm_head).float()
    if cfg.modality == "audio":
        logits = view_as(logits, (*hidden.shape[:-1], cfg.n_codebooks,
                                  cfg.vocab), "logits_btv")
    return constrain(logits, "logits_btv")


# ------------------------------------------------------------------ loss

def _labels(cfg: ArchConfig, batch: Dict[str, Tensor]) -> Tensor:
    """The labels aligned with the logits: (B, S), or for audio the
    batch's (B, C, S) swapped to (B, S, C)."""
    labels = batch["labels"]
    return labels.transpose(1, 2) if cfg.modality == "audio" else labels


def per_example_loss(cfg: ArchConfig, logits: Tensor,
                     batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """Mean cross-entropy per example over its valid tokens (labels
    >= 0; for audio every valid (position, codebook) pair): ((B,),
    valid counts (B,), at least 1).  On DTensor logits it runs on each
    shard's examples: the logits keep their batch split and gather the
    rest (the vocabulary), so each example's full row is local and no
    rank holds the whole (B, S, vocab) plane, in the forward pass or the
    backward."""
    labels = _labels(cfg, batch)
    if local.is_dtensor(logits):
        mesh, B = logits.device_mesh, logits.shape[0]
        pl = local.keep_shards(logits, (0,), lambda dim, n: B % n == 0)
        return local.call_local(_example_loss, (logits, local.on_mesh(
            labels, mesh)), (pl, pl), (pl, pl), mesh)
    return _example_loss(logits, labels)


def _example_loss(logits: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor]:
    valid = labels >= 0
    label = labels.clamp_min(0).long()[..., None]
    if logits.device.type == "cpu":
        # log p of each label as its logit less its row's logsumexp:
        # torch's CPU log_softmax sums a long row with a relative error
        # near 5e-5 at 262144 columns, where its logsumexp stays near
        # 3e-6; the card's fused log_softmax is accurate and cheaper
        tok_ll = (logits.gather(-1, label)[..., 0]
                  - torch.logsumexp(logits, dim=-1))
    else:
        tok_ll = torch.log_softmax(logits, dim=-1).gather(-1, label)[..., 0]
    tok_loss = -tok_ll * valid
    dims = tuple(range(1, tok_loss.dim()))
    n = valid.sum(dim=dims).clamp_min(1)
    return tok_loss.sum(dim=dims) / n, n


@torch.no_grad()
def sigma_scores(cfg: ArchConfig, hidden: Tensor, logits: Tensor,
                 batch: Dict[str, Tensor]) -> Tensor:
    """Per-example last-layer gradient-norm^2 proxy (GraNd-style): the
    mean over valid tokens of ||softmax - onehot||^2 * (||h_t||^2 + 1),
    exact per token (the reference drops the cross-token terms of the
    full-sequence norm, O(S) not O(S^2)).  For audio a position's term
    sums ||p_c - y_c||^2 over its valid codebooks c, and the mean
    divides by codebook 0's valid count, as the reference's does.
    Tokens go through ``ops.gradnorm_sigma`` in one call, the row-norm
    kernel on CUDA tensors (one launch), its plain version on CPU ones:
    text through ``ops.sigma_from_head``; audio with p - y formed in
    place on the fp32 softmax (1 taken off at each label, no one-hot),
    the rows of invalid codebooks zeroed, and the codebooks folded into
    one (B S, C vocab) row each.  No gradient."""
    labels = _labels(cfg, batch)
    B, S = labels.shape[:2]
    valid = labels >= 0
    h = hidden.reshape(B * S, -1).float()
    if cfg.modality != "audio":
        tok = ops.sigma_from_head(h, logits.reshape(B * S, -1),
                                  labels.clamp_min(0).reshape(-1))
        return ((view_as(tok, (B, S), None) * valid).sum(-1)
                / valid.sum(-1).clamp_min(1.0))
    if local.is_dtensor(logits):
        # each example's rows whole on the rank that holds it (as the
        # loss takes them), so that p - y is formed on local tensors
        mesh = logits.device_mesh
        pl = local.keep_shards(logits, (0,), lambda dim, n: B % n == 0)
        p = local.call_local(
            _audio_p_minus_y, (logits, local.on_mesh(labels, mesh),
                               local.on_mesh(valid, mesh)),
            (pl, pl, pl), pl, mesh)
    else:
        p = _audio_p_minus_y(logits, labels, valid)
    tok = ops.gradnorm_sigma(h, p.view(B * S, -1))
    return (view_as(tok, (B, S), None).sum(-1)
            / valid[..., 0].sum(-1).clamp_min(1.0))


def _audio_p_minus_y(logits: Tensor, labels: Tensor,
                     valid: Tensor) -> Tensor:
    """p - y of audio logits (B, S, C, vocab) in place on their fp32
    softmax, the rows of invalid codebooks zeroed."""
    p = ops.softmax_rows(logits)
    rows = p.view(-1, p.shape[-1])
    rows[torch.arange(rows.shape[0], device=p.device),
         labels.clamp_min(0).reshape(-1).long()] -= 1.0
    p.masked_fill_(~valid[..., None], 0.0)
    return p


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
    """forward(model, batch) -> (logits (B, S, V) fp32, or (B, S, C, V)
    for audio; hidden (B, S, d); the summed MoE aux loss): the decoder in
    train mode."""

    def forward(model: Model, batch: Dict[str, Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor]:
        x = embed_input(cfg, model, batch)
        B, S = x.shape[:2]
        pos = _positions(cfg, batch, B, S, device=x.device)
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
            # whole on every rank of a mesh, so that the view is local
            sig_k = replicated(sigma).reshape(K, per_client)
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
    """The part of an optimizer state that belongs to leaf (or group)
    ``name``: its entry of every dict field (and the shared fields, the
    step count) of a NamedTuple state, or of a dict state; () as it
    is."""
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


def _laid_out_as(g: Tensor, p: Tensor) -> Tensor:
    """A DTensor gradient laid out as its parameter (a partial sum
    reduce-scattered to the parameter's split, as a data-parallel step
    reduces it), so the optimizer steps each rank's own shard; a plain
    tensor as it is."""
    if local.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply_optimizer(opt: GradientTransformation, grads: Dict[str, Tensor],
                    state, params: Dict[str, Tensor]):
    """One step of a per-leaf optimizer (``opt.per_leaf``), taken leaf by
    leaf, or group by group for the leaves of one of ``opt.groups``
    (adafactor on the reference's stacked body): each leaf's or group's
    update is computed, added to the parameters in place and its state
    written into ``state``'s own dicts before the next one's, and each
    gradient is dropped from ``grads`` once used.  The values are those
    of ``opt.update`` on the whole dict then ``apply_updates``; only one
    leaf's or group's update and new moments are alive at a time.
    ``state`` and ``grads`` are donated (the reference's training loop
    donates params and state to its jitted step): read only the
    returned state afterwards."""
    if not opt.per_leaf:
        raise ValueError("apply_optimizer takes an optimizer that updates "
                         "each leaf alone (sgd, momentum, adam, adamw, "
                         "adafactor)")
    group_of = {m: g for g, ms in opt.groups.items() for m in ms}
    old = state  # its step count; its dicts are the ones written below
    for name in list(grads):
        if name not in grads:  # stepped with its group
            continue
        key = group_of.get(name, name)
        members = opt.groups.get(key, (name,))
        g = {m: _laid_out_as(grads.pop(m), params[m]) for m in members}
        p = {m: params[m] for m in members}
        upd, leaf = opt.update(g, _leaf_state(old, key), p)
        del g
        apply_updates(p, upd)
        state = _store_leaf(state, key, leaf)
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
    (B, 1, V), or (B, 1, C, V) for audio; cache).  ``batch`` is the
    reference's: "tokens" (B, S), vlm "embeds" (B, S, d) and "positions"
    (B, 3, S), audio "tokens" (B, C, S).  With a cache (of at least S
    slots) prefill fills its slots [0, S) in place; without one it
    returns a new S-slot cache, as the reference does."""

    @torch.no_grad()
    def prefill_step(model: Model, batch: Dict[str, Tensor],
                     cache: Optional[Cache] = None) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        B, S = x.shape[:2]
        pos = _positions(cfg, batch, B, S, device=x.device)
        hidden, cache, _ = apply_decoder(cfg, model.decoder, x, pos,
                                         mode="prefill", cache=cache)
        return unembed(cfg, model, hidden[:, -1:]), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, mla_absorbed: bool = False
                     ) -> Callable:
    """decode_step(model, cache, batch) -> (logits (B, 1, V), or (B, 1, C,
    V) for audio; cache): one new token per sequence into cache slot
    ``batch["cache_index"]`` (an int), written in place.  ``batch`` is
    the reference's: "tokens" (B, 1), vlm "embeds" (B, 1, d) and
    "positions" (B, 3, 1) (RoPE reads these, not the slot), audio
    "tokens" (B, C, 1).  ``mla_absorbed``: the absorbed decode path of
    ``mla`` blocks (``mla.py``)."""

    @torch.no_grad()
    def decode_step(model: Model, cache: Cache,
                    batch: Dict[str, Tensor]) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        idx = int(batch["cache_index"])
        pos = _positions(cfg, batch, x.shape[0], 1, offset=idx,
                         device=x.device)
        hidden, cache, _ = apply_decoder(cfg, model.decoder, x, pos,
                                         mode="decode", cache=cache,
                                         cache_index=idx,
                                         mla_absorbed=mla_absorbed)
        return unembed(cfg, model, hidden), cache

    return decode_step


make_cache = init_cache  # re-export with the model-level name
