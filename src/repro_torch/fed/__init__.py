"""FEEL runtime of the port (counterpart of ``repro.fed``)."""
from .client import (batched_sigma, device_sigma, local_deltas,
                     local_gradient, local_gradients, per_sample_sigma)
from .faults import CHAOS_SPEC, FaultPlan, FaultSpec, RoundFaults
from .rounds import FEELConfig, FEELTrainer, ResilienceConfig, RoundMetrics
from .server import aggregate_gradients, ipw_mass, ipw_weights

__all__ = ["batched_sigma", "device_sigma", "local_gradient",
           "local_gradients", "local_deltas", "per_sample_sigma",
           "aggregate_gradients", "ipw_mass", "ipw_weights", "FEELConfig",
           "FEELTrainer", "RoundMetrics", "ResilienceConfig", "FaultSpec",
           "FaultPlan", "RoundFaults", "CHAOS_SPEC"]
