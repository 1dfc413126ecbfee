"""The paper's contribution in PyTorch: joint resource allocation + data
selection for FEEL (counterpart of ``repro.core``).

  * SystemParams / RoundState / default_system
  * channel: NOMA + SIC rates and feasibility
  * cost: energy / reward / net-cost model (eqs. 7-18)
  * delta: convergence-gap objective (eqs. 22/26)
  * power: exact closed-form power allocation + Algorithm 3 (CCP)
  * matching: Algorithm 2 (swap matching)
  * selection: Algorithms 4-5 + exact oracle
  * joint: Algorithm 1 + baselines 1-4
"""
from . import channel, cost, delta, joint, matching, power, selection  # noqa: F401
from .joint import RoundDecision, baseline_scheme, proposed_scheme  # noqa: F401
from .types import RoundState, SystemParams, default_system  # noqa: F401
