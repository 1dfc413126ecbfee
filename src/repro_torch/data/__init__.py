"""FEEL data (counterpart of ``repro.data``): the synthetic non-IID set
and the local MNIST reader."""
from .federated import FederatedDataset, non_iid_split
from .mislabel import mislabel
from .mnist import available, load_mnist
from .synthetic import SyntheticImages

__all__ = ["SyntheticImages", "mislabel", "FederatedDataset",
           "non_iid_split", "load_mnist", "available"]
