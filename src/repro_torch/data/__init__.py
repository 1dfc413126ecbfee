"""FEEL data (counterpart of ``repro.data``): the synthetic non-IID set,
the local MNIST reader, and synthetic LM batches."""
from .federated import FederatedDataset, non_iid_split
from .mislabel import mislabel
from .mnist import available, load_mnist
from .synthetic import SyntheticImages, synthetic_lm_batch

__all__ = ["SyntheticImages", "synthetic_lm_batch", "mislabel", "FederatedDataset",
           "non_iid_split", "load_mnist", "available"]
