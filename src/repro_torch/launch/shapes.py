"""The optimizer factory of the launchers (counterpart of
``repro/launch/shapes.py``'s ``make_optimizer``).  The rest of the
reference's module, the dry-run shapes and abstract input specs, comes
with mesh and sharding (ROADMAP.md queue 1, item 12)."""
from __future__ import annotations

import functools

from .. import optim
from ..models.config import ArchConfig
from ..models.model import stacked_groups


def make_optimizer(cfg: ArchConfig) -> optim.GradientTransformation:
    """``cfg.optimizer`` at ``cfg.learning_rate``; adamw with weight decay
    0.01, as the reference builds it.  Adafactor steps each of the
    reference's stacked body leaves as one (``stacked_groups``), as the
    reference's adafactor sees them; the other optimizers are
    elementwise and step leaf by leaf."""
    if cfg.optimizer == "adafactor":
        return optim.adafactor(cfg.learning_rate,
                               groups=stacked_groups(cfg))
    builder = {"adamw": functools.partial(optim.adamw, weight_decay=0.01),
               "adam": optim.adam, "sgd": optim.sgd,
               "momentum": optim.momentum}[cfg.optimizer]
    return builder(cfg.learning_rate)
