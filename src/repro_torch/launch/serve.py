"""Batched serving driver: prefill a batch of prompts, then greedy
decode with the cache (KV for attention, a rolling window-sized KV
buffer for sliding-window attention, the compressed latent and rotary
key for latent attention, conv and recurrent state for mamba and
RG-LRU).

Counterpart of ``repro/launch/serve.py`` for every arch of the zoo
(``llama3.2-3b``, ``falcon-mamba-7b``, ``recurrentgemma-9b``,
``gemma3-12b``, ``stablelm-12b``, ``command-r-35b``,
``deepseek-v2-236b``, ``deepseek-v3-671b``, ``qwen2-vl-2b``,
``musicgen-medium``), with the reference's requests per modality
(``prefill_batch``, ``decode_batch``): text prompts; vlm embeddings with
M-RoPE positions, decoded from zero embeddings at text positions; audio
codebook grids, decoded greedily per codebook.  ``--mla-absorbed`` takes
the absorbed decode of the DeepSeek configs' latent attention, as the
reference's flag does.  Runs on the GPU unless ``--device cpu`` is
given; without a GPU and without it, it raises.

    python -m repro_torch.launch.serve --full --batch 4 \\
        --prompt-len 2048 --new-tokens 32                      # GPU
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --full \\
        --batch 4 --prompt-len 2048 --new-tokens 32            # GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 2 --prompt-len 16 --new-tokens 4               # smoke

``--arch`` takes every name above.  The full DeepSeek configs (238 and
671 G parameters) fit no single card; ``serve`` also takes an
``ArchConfig``, such as one cut in depth, and a ``mesh``: the weights
then become DTensors laid out by the reference's sharding rules and
each step runs under the activation constrainer
(``sharding.sharded_step``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..configs import ALIASES, ARCHS, get_config, smoke_config
from ..device import DeviceLike, resolve_device, synchronize
from ..kernels import flash_attention, lru_scan
from ..models import (ArchConfig, init_model, make_cache, make_decode_step,
                      make_prefill_step, param_count)
from ..models.moe import MoE, dropped
from . import sharding


@dataclasses.dataclass
class ServeResult:
    # (batch, new_tokens + 1), audio (batch, new_tokens + 1, codebooks):
    # prefill's, then each step's
    tokens: torch.Tensor
    prefill_s: float          # prefill wall time, device synchronized
    decode_s: List[float]     # wall time of each decode step
    launches: Dict[str, Dict[str, int]]  # per phase, per kernel
    n_params: int
    # per MoE layer of the prefill: (token slots per expert C, routed
    # (token, expert) pairs dropped past capacity); empty without MoE
    moe_dispatch: List[Tuple[int, int]]
    # the prefill's last-position logits, fp32 on the host
    prefill_logits: Optional[torch.Tensor] = None


def _launch_counts() -> Dict[str, int]:
    """The serving path's kernels and their launch counts so far (serving
    runs no backward, so the scan's gradient kernel is not among them)."""
    return {**flash_attention.LAUNCHES,
            "lru_scan": lru_scan.LAUNCHES["lru_scan"]}


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def prefill_batch(cfg: ArchConfig, batch: int, prompt_len: int,
                  generator: torch.Generator, device=None
                  ) -> Dict[str, torch.Tensor]:
    """The reference's request: text "tokens" (batch, prompt_len); vlm
    standard-normal "embeds" (batch, prompt_len, d) in the activation
    dtype with "positions" (batch, 3, prompt_len), the text positions
    0..prompt_len-1 on all three M-RoPE rows; audio "tokens" (batch, C,
    prompt_len).  Drawn from ``generator``."""
    if cfg.modality == "vlm":
        pos = torch.arange(prompt_len, device=device)
        return {"embeds": torch.randn(
                    (batch, prompt_len, cfg.d_model), generator=generator,
                    device=device).to(cfg.act_dtype),
                "positions": pos.expand(batch, 3, prompt_len)}
    shape = ((batch, cfg.n_codebooks, prompt_len) if cfg.modality == "audio"
             else (batch, prompt_len))
    return {"tokens": torch.randint(0, cfg.vocab, shape, generator=generator,
                                    device=device)}


def decode_batch(cfg: ArchConfig, tok: torch.Tensor, index: int,
                 position: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One decode step's batch, the reference's: the greedy tokens ``tok``
    ((batch,), audio (batch, C)) into cache slot ``index``.  A vlm
    continuation has no patch embedding: zero embeds at the text
    position ``position`` (default ``index``) on all three rows."""
    if cfg.modality == "vlm":
        B = tok.shape[0]
        return {"embeds": torch.zeros((B, 1, cfg.d_model),
                                      dtype=cfg.act_dtype, device=tok.device),
                "positions": torch.full((B, 3, 1), index if position is None
                                        else position, device=tok.device),
                "cache_index": index}
    return {"tokens": tok[..., None], "cache_index": index}


def serve(arch: Union[str, ArchConfig] = "llama3.2-3b", batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, smoke: bool = True,
          seed: int = 0, device: DeviceLike = None,
          mla_absorbed: bool = False, mesh=None) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``new_tokens`` greedy steps.  ``arch`` is a name (its smoke config,
    or with ``smoke=False`` its full one) or an ``ArchConfig``, taken as
    it is.  Weights and prompts are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device; the request is the reference's
    for the config's modality (``prefill_batch``, ``decode_batch``).
    The cache holds ``prompt_len + new_tokens`` slots; prefill fills [0,
    prompt_len) and step i writes slot prompt_len + i (a sliding-window
    layer's rolling buffer holds ``window`` slots and writes position p
    at slot p % window).  Greedy decoding takes the argmax per sequence,
    for audio per codebook.  ``mla_absorbed`` picks the absorbed decode
    of latent attention.  ``mesh``: a ``DeviceMesh`` on ``device``'s
    type; the weights and the cache become DTensors by
    ``sharding.param_shardings`` and ``sharding.cache_shardings``, and
    each step runs under ``sharding.sharded_step`` (its logits are read
    back whole)."""
    dev = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
        cfg.validate()
    else:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_model(cfg, gen, dev)
    n_params = param_count(model)
    if mesh is not None:
        sharding.distribute_model(model, mesh, cfg)
    print(f"arch={cfg.name} params={n_params:,} device={dev}")
    request = prefill_batch(cfg, batch, prompt_len, gen, dev)
    cache = make_cache(cfg, batch, prompt_len + new_tokens, device=dev)
    if mesh is not None:
        cache = sharding.distribute_tree(
            cache, sharding.cache_shardings(mesh, cache, batch))
    prefill = _on_mesh(make_prefill_step(cfg), mesh)
    decode = _on_mesh(make_decode_step(cfg, mla_absorbed=mla_absorbed), mesh)
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    for m in moes:
        m.routing_log = []

    synchronize(dev)
    n0 = _launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, request, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)  # greedy
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    n1 = _launch_counts()
    first = logits[:, -1].float().cpu()
    dispatch = [(r["w_ec"].shape[1], int(dropped(r))) for m in moes
                for r in m.routing_log]
    for m in moes:
        m.routing_log = None
    if moes:
        print(f"MoE prefill dispatch (C, dropped) per layer: {dispatch}")

    toks, steps = [tok], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        logits, cache = decode(model, cache,
                               decode_batch(cfg, tok, prompt_len + i))
        tok = torch.argmax(logits[:, -1], dim=-1)
        synchronize(dev)
        steps.append(time.perf_counter() - t0)
        toks.append(tok)
    launches = {"prefill": _diff(n1, n0),
                "decode": _diff(_launch_counts(), n1)}
    ms = 1e3 * sum(steps) / max(new_tokens, 1)
    print(f"prefill {prompt_len} toks x{batch}: {t_prefill:.3f}s; decode "
          f"{new_tokens} steps: {sum(steps):.3f}s ({ms:.2f} ms/step); "
          f"kernel launches {launches}")
    return ServeResult(torch.stack(toks, dim=1).cpu(), t_prefill, steps,
                       launches, n_params, dispatch, first)


def _on_mesh(step, mesh):
    """``step`` run under ``sharding.sharded_step(mesh)``,
    its logits whole; ``step`` itself without a mesh."""
    if mesh is None:
        return step

    def on_mesh(*args):
        with sharding.sharded_step(mesh):
            logits, cache = step(*args)
            return sharding.full(logits), cache
    return on_mesh


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS + sorted(ALIASES),
                    default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    ap.add_argument("--mla-absorbed", action="store_true",
                    help="absorbed decode of latent attention (DeepSeek)")
    args = ap.parse_args(argv)
    return serve(args.arch, args.batch, args.prompt_len, args.new_tokens,
                 smoke=not args.full, device=args.device,
                 mla_absorbed=args.mla_absorbed)


if __name__ == "__main__":
    main()
