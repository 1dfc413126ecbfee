"""Batched serving driver: prefill a batch of prompts, then greedy
decode with the cache (KV for attention, a rolling window-sized KV
buffer for sliding-window attention, the compressed latent and rotary
key for latent attention, conv and recurrent state for mamba and
RG-LRU).

Counterpart of ``repro/launch/serve.py`` for text decoders
(``llama3.2-3b``, ``falcon-mamba-7b``, ``recurrentgemma-9b``,
``gemma3-12b``, ``stablelm-12b``, ``command-r-35b``,
``deepseek-v2-236b``, ``deepseek-v3-671b``).  ``--mla-absorbed`` takes
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
``ArchConfig``, such as one cut in depth.
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


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor      # (batch, new_tokens + 1): prefill's, then each step's
    prefill_s: float          # prefill wall time, device synchronized
    decode_s: List[float]     # wall time of each decode step
    launches: Dict[str, Dict[str, int]]  # per phase, per kernel
    n_params: int
    # per MoE layer of the prefill: (token slots per expert C, routed
    # (token, expert) pairs dropped past capacity); empty without MoE
    moe_dispatch: List[Tuple[int, int]]


def _launch_counts() -> Dict[str, int]:
    """The serving path's kernels and their launch counts so far."""
    return {**flash_attention.LAUNCHES, **lru_scan.LAUNCHES}


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def serve(arch: Union[str, ArchConfig] = "llama3.2-3b", batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, smoke: bool = True,
          seed: int = 0, device: DeviceLike = None,
          mla_absorbed: bool = False) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``new_tokens`` greedy steps.  ``arch`` is a name (its smoke config,
    or with ``smoke=False`` its full one) or an ``ArchConfig``, taken as
    it is.  Weights and prompts are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device.  The cache holds ``prompt_len +
    new_tokens`` slots; prefill fills [0, prompt_len) and step i writes
    slot prompt_len + i (a sliding-window layer's rolling buffer holds
    ``window`` slots and writes position p at slot p % window).
    ``mla_absorbed`` picks the absorbed decode of latent attention."""
    dev = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
        cfg.validate()
    else:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_model(cfg, gen, dev)
    n_params = param_count(model)
    print(f"arch={cfg.name} params={n_params:,} device={dev}")
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen, device=dev)
    cache = make_cache(cfg, batch, prompt_len + new_tokens, device=dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, mla_absorbed=mla_absorbed)
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    for m in moes:
        m.routing_log = []

    synchronize(dev)
    n0 = _launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": prompts}, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)  # greedy
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    n1 = _launch_counts()
    dispatch = [(r["w_ec"].shape[1], int(dropped(r))) for m in moes
                for r in m.routing_log]
    for m in moes:
        m.routing_log = None
    if moes:
        print(f"MoE prefill dispatch (C, dropped) per layer: {dispatch}")

    toks, steps = [tok], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        logits, cache = decode(model, cache, {"tokens": tok[:, None],
                                              "cache_index": prompt_len + i})
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
                       launches, n_params, dispatch)


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
