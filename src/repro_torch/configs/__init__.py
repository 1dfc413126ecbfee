"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Counterpart of ``repro/configs``.  ``ARCHS`` lists only the
architectures the port runs so far; the others of the reference are
queued in ROADMAP.md.  ``smoke_config(name)`` returns the reduced
same-family variant (a few layers, narrow widths) the CPU tests use.
"""
from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

ARCHS: List[str] = [
    "llama3_2-3b",
    "falcon-mamba-7b",
    "recurrentgemma-9b",
    "gemma3-12b",
    "stablelm-12b",
    "command-r-35b",
    "deepseek-v2-236b",
    "deepseek-v3-671b",
]

ALIASES = {"llama3.2-3b": "llama3_2-3b"}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise ValueError(f"unknown or not yet ported architecture {name!r}; "
                         f"the port has {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ArchConfig:
    cfg = _module(name).CONFIG
    cfg.validate()
    return cfg


def smoke_config(name: str) -> ArchConfig:
    cfg = _module(name).smoke()
    cfg.validate()
    return cfg
