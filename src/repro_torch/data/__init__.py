"""Synthetic non-IID FEEL data (counterpart of ``repro.data``)."""
from .federated import FederatedDataset, non_iid_split
from .mislabel import mislabel
from .synthetic import SyntheticImages

__all__ = ["SyntheticImages", "mislabel", "FederatedDataset",
           "non_iid_split"]
