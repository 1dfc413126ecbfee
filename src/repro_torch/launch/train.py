"""Training driver: the zoo's decoders trained with the paper's data
selection.

Counterpart of ``repro/launch/train.py``.  Runs real steps (allocating
parameters) for any ported ``--arch``.  The FEEL integration (per-sample
sigma scoring through the row-norm kernel, exact Problem-4 selection per
client, eq.-(19) weights over the batch's client slices) is on by
default: the paper's technique applied to LM training.  ``--full-100m``
trains the ~100M-parameter llama-family config of
``examples/train_llm_feel.py``.  Runs on the GPU unless ``--device cpu``
is given; without a GPU and without it, it raises.

    python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 10 --batch 16 --seq 512                        # GPU
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --steps 3 --device cpu                                 # smoke

``run`` also takes a ``mesh``: the parameters (and the optimizer state
that follows them) then become DTensors laid out by the reference's
sharding rules, and each step runs under the activation constrainer
(``sharding.sharded_step``).

Each step reads its metrics back, so its wall time ends with the
device's work.  Per step the result holds the kernels' launches: with
FEEL one ``gradnorm_sigma`` (sigma), none of flash attention (train
attention is plain torch), and a recurrent layer's two ``lru_scan``
(the forward and its recompute under remat) and one
``lru_scan_backward``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List, Optional, Union

import torch

from ..configs import ALIASES, ARCHS, get_config, smoke_config
from ..data.synthetic import synthetic_lm_batch
from ..device import DeviceLike, resolve_device, synchronize
from ..kernels import flash_attention, gradnorm, lru_scan
from ..models import (ArchConfig, FeelIntegration, init_model,
                      make_train_step, param_count, trainable)
from . import sharding
from .shapes import make_optimizer

#: ``examples/train_llm_feel.py --full-100m``: a ~100M-parameter
#: llama-family config
FULL_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab=32000, head_dim=64)


@dataclasses.dataclass
class TrainResult:
    n_params: int
    losses: List[float]          # the step's loss (eq. 19 with FEEL)
    ex_loss: List[float]         # mean per-example loss of the step
    selected_frac: List[float]
    sigma_mean: List[float]      # empty without FEEL
    aux_loss: List[float]        # the summed MoE aux loss
    step_s: List[float]          # wall time of each step
    launches: List[Dict[str, int]]  # kernel launches of each step
    # the parameters after the last step, on the host (``keep_params``)
    params: Optional[Dict[str, torch.Tensor]] = None


def launch_counts() -> Dict[str, int]:
    """The train path's kernels and their launch counts so far."""
    return {"gradnorm_sigma": gradnorm.LAUNCHES["gradnorm_sigma"],
            "flash_attention": flash_attention.LAUNCHES["flash_attention"],
            "lru_scan": lru_scan.LAUNCHES["lru_scan"],
            "lru_scan_backward": lru_scan.LAUNCHES["lru_scan_backward"]}


def synth_batch(cfg: ArchConfig, generator: torch.Generator, batch: int,
                seq: int, n_clients: int, feel: bool, eps: float = 0.8,
                device=None) -> Dict[str, torch.Tensor]:
    """The reference's batch for the config's modality: text a power-law
    token batch (``synthetic_lm_batch``); vlm standard-normal "embeds"
    (batch, seq, d) in the activation dtype, "positions" (batch, 3, seq)
    with the text positions on all three M-RoPE rows, and uniform
    "labels" (batch, seq); audio a uniform (batch, C, seq + 1) codebook
    grid, "tokens" its first seq columns and "labels" its last seq.  With
    ``feel`` also "alpha" (n_clients,), each client available with
    probability ``eps``.  Drawn from ``generator``."""
    if cfg.modality == "vlm":
        b = {"embeds": torch.randn((batch, seq, cfg.d_model),
                                   generator=generator,
                                   device=device).to(cfg.act_dtype),
             "positions": torch.arange(seq, device=device).expand(
                 batch, 3, seq),
             "labels": torch.randint(0, cfg.vocab, (batch, seq),
                                     generator=generator, device=device)}
    elif cfg.modality == "audio":
        t = torch.randint(0, cfg.vocab, (batch, cfg.n_codebooks, seq + 1),
                          generator=generator, device=device)
        b = {"tokens": t[..., :-1], "labels": t[..., 1:]}
    else:
        b = synthetic_lm_batch(generator, batch, seq, cfg.vocab, device)
    if feel:
        b["alpha"] = (torch.rand(n_clients, generator=generator,
                                 device=device) < eps).float()
    return b


def config_of(arch: Union[str, ArchConfig], smoke: bool = False,
              full_100m: bool = False) -> ArchConfig:
    """A name (its full config, its smoke config, or the 100M llama-family
    config) or an ``ArchConfig``, taken as it is."""
    if isinstance(arch, ArchConfig):
        cfg = arch
    elif full_100m:
        cfg = get_config(arch).scaled(**FULL_100M)
    else:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg.validate()
    return cfg


def setup(cfg: ArchConfig, seed: int = 0, device=None, feel: bool = True,
          n_clients: int = 4, mesh=None):
    """(model with gradients on, optimizer, its state, train step):
    weights drawn on ``device`` from a generator seeded with ``seed``,
    ``cfg``'s optimizer (``make_optimizer``).  With a ``mesh`` the
    weights are DTensors (``sharding.distribute_model``), the state
    follows them, and the step runs under ``sharding.sharded_step`` and
    returns its metrics whole."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = trainable(init_model(cfg, gen, device))
    if mesh is not None:
        sharding.distribute_model(model, mesh, cfg)
    opt = make_optimizer(cfg)
    feel_cfg = FeelIntegration(n_clients=n_clients) if feel else None
    step = make_train_step(cfg, opt, feel=feel_cfg)
    if mesh is not None:
        plain_step = step

        def step(*args, **kwargs):
            with sharding.sharded_step(mesh):
                model, state, m = plain_step(*args, **kwargs)
                return model, state, {k: sharding.full(v)
                                      for k, v in m.items()}
    return model, opt, opt.init(dict(model.named_parameters())), step


def run(arch: Union[str, ArchConfig] = "llama3.2-3b", steps: int = 20,
        batch: int = 8, seq: int = 128, smoke: bool = False,
        feel: bool = True, n_clients: int = 4, log_every: int = 5,
        seed: int = 0, device: DeviceLike = None,
        full_100m: bool = False, mesh=None,
        keep_params: bool = False) -> TrainResult:
    """``steps`` train steps of ``batch`` x ``seq`` synthetic tokens; batch
    i is drawn from a generator seeded with ``seed + 1000 + i``.  Raises
    if the last loss is not finite.  ``mesh``: as in ``setup``;
    ``keep_params``: copy the parameters to the host at the end."""
    dev = resolve_device(device)
    cfg = config_of(arch, smoke, full_100m)
    model, _, opt_state, step_fn = setup(cfg, seed, dev, feel, n_clients,
                                         mesh)
    res = TrainResult(param_count(model), [], [], [], [], [], [], [])
    print(f"arch={cfg.name} params={res.n_params:,} feel={feel} "
          f"dtype={cfg.dtype} device={dev}")
    for i in range(steps):
        b = synth_batch(cfg, torch.Generator(device=dev).manual_seed(
            seed + 1000 + i), batch, seq, n_clients, feel, device=dev)
        synchronize(dev)
        n0 = launch_counts()
        t0 = time.perf_counter()
        model, opt_state, m = step_fn(model, opt_state, b)
        res.losses.append(float(m["loss"]))
        synchronize(dev)
        res.step_s.append(time.perf_counter() - t0)
        res.launches.append({k: v - n0[k] for k, v in launch_counts().items()})
        res.ex_loss.append(float(m["ex_loss"].mean()))
        res.selected_frac.append(float(m["selected_frac"]))
        res.aux_loss.append(float(m["aux_loss"]))
        if feel:
            res.sigma_mean.append(float(m["sigma_mean"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss={res.losses[-1]:.4f} "
                  f"ex_loss={res.ex_loss[-1]:.4f} "
                  f"sel={res.selected_frac[-1]:.3f} "
                  f"ms={res.step_s[-1] * 1e3:.1f}", flush=True)
    if not math.isfinite(res.losses[-1]):
        raise RuntimeError("training diverged: the last loss is not finite")
    if keep_params:
        res.params = {n: sharding.full(p).detach().cpu()
                      for n, p in model.named_parameters()}
    return res


def main(argv: Optional[List[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCHS + sorted(ALIASES),
                    default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--full-100m", action="store_true",
                    help="~100M-parameter llama-family config")
    ap.add_argument("--no-feel", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, args.batch, args.seq, args.smoke,
               feel=not args.no_feel, n_clients=args.clients,
               device=args.device, full_100m=args.full_100m)


if __name__ == "__main__":
    main()
