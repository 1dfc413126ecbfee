"""Seeded, deterministic fault injection for FEEL rounds.

Counterpart of ``repro/fed/faults.py``, copied: the plan is pure numpy,
so the port draws the reference's faults bit for bit.  The paper's
system model already admits unreliability — availability is
Bernoulli (``alpha_k ~ Bern(eps_k)``, Lemma 1) and channels fade every
round — but those draws happen *before* the server fixes the round
decision.  This module injects the failures that happen *after* the
allocation was fixed, which is where a deployed FEEL system actually
breaks:

* **dropout** — a scheduled device vanishes mid-round and its upload
  never arrives (post-matching, unlike the pre-matching ``alpha``);
* **straggler** — an upload arrives, but later than the eq. (8)+(16)
  latency model predicts (an extra exponential delay on top of
  ``tau_k + T``);
* **nan_upload** — the upload arrives corrupted: every gradient leaf of
  that device is replaced with NaN;
* **solver_fail** — the round's matching (Alg. 2) or power (Alg. 3)
  solve is forced to fail so the fallback chain in ``core/joint.py``
  gets exercised.

Determinism and replay
----------------------
Every draw is keyed by ``(spec.seed, round)`` — and, for retry delays,
``(spec.seed, round, device, attempt)`` — through independent
``np.random.SeedSequence`` streams.  Faults for round *i* therefore do
not depend on call order or on how many other rounds were queried,
which is what makes ``FEELTrainer.resume()`` replay the exact same
faults after a crash.  A plan is fully described by its ``FaultSpec``;
``FaultSpec.to_dict()``/``from_dict`` round-trip through JSON so a
chaos run can be replayed from its checkpoint's metadata.

The plan is pure host-side numpy and never touches the trainer's RNG
streams: a plan whose probabilities are all zero (or ``faults=None``)
leaves the training trajectory bit-for-bit identical.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["FaultSpec", "RoundFaults", "FaultPlan", "CHAOS_SPEC"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative description of a fault plan (all rates per round).

    ``dropout_prob``/``straggler_prob``/``nan_prob`` are per-device
    Bernoulli rates applied to devices that would otherwise upload;
    ``straggler_delay_s`` is the mean of the exponential extra delay a
    straggling upload suffers; ``matching_fail_prob`` and
    ``power_fail_prob`` force the round's solver calls to fail.
    ``start_round``/``stop_round`` bound the window in which faults
    fire (``stop_round=None`` means forever).
    """

    seed: int = 0
    dropout_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_delay_s: float = 0.25
    nan_prob: float = 0.0
    matching_fail_prob: float = 0.0
    power_fail_prob: float = 0.0
    start_round: int = 0
    stop_round: Optional[int] = None

    def enabled_at(self, i: int) -> bool:
        if i < self.start_round:
            return False
        return self.stop_round is None or i < self.stop_round

    @property
    def any_rate(self) -> float:
        return max(self.dropout_prob, self.straggler_prob, self.nan_prob,
                   self.matching_fail_prob, self.power_fail_prob)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown FaultSpec fields: {sorted(unknown)}")
        return cls(**d)


#: the aggressive preset (30% dropout, stragglers, NaN uploads,
#: forced solver failures); ``python -m repro_torch --faults chaos``.
CHAOS_SPEC = FaultSpec(seed=0, dropout_prob=0.3, straggler_prob=0.3,
                       straggler_delay_s=0.5, nan_prob=0.15,
                       matching_fail_prob=0.2, power_fail_prob=0.2)


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """The materialized faults for one round (arrays of length K)."""

    round: int
    dropout: np.ndarray          # (K,) bool: upload silently lost
    straggler: np.ndarray        # (K,) bool: upload delayed
    delay_s: np.ndarray          # (K,) float: extra delay (0 if not)
    nan_upload: np.ndarray       # (K,) bool: upload corrupted to NaN
    fail_matching: bool          # force Alg. 2 to fail this round
    fail_power: bool             # force Alg. 3 / power solve to fail

    def any(self) -> bool:
        return bool(self.dropout.any() or self.straggler.any()
                    or self.nan_upload.any() or self.fail_matching
                    or self.fail_power)


def _round_rng(seed: int, *key: int) -> np.random.Generator:
    """Independent stream keyed by (seed, *key) — call-order free."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=tuple(key)))


class FaultPlan:
    """Replayable fault schedule: ``for_round(i, K)`` is a pure
    function of ``(spec, i, K)``."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(FaultSpec.from_dict(d))

    def to_dict(self) -> Dict[str, Any]:
        return self.spec.to_dict()

    # ------------------------------------------------------------------
    def for_round(self, i: int, K: int) -> RoundFaults:
        s = self.spec
        if not s.enabled_at(i) or s.any_rate <= 0.0:
            z = np.zeros(K, bool)
            return RoundFaults(round=i, dropout=z, straggler=z,
                               delay_s=np.zeros(K), nan_upload=z,
                               fail_matching=False, fail_power=False)
        rng = _round_rng(s.seed, i)
        # fixed draw order => the same spec always yields the same plan
        dropout = rng.random(K) < s.dropout_prob
        straggler = rng.random(K) < s.straggler_prob
        delay = rng.exponential(max(s.straggler_delay_s, 1e-12), K)
        nan_upload = rng.random(K) < s.nan_prob
        fail_matching = bool(rng.random() < s.matching_fail_prob)
        fail_power = bool(rng.random() < s.power_fail_prob)
        # a dropped upload never arrives, so it cannot also straggle or
        # corrupt; keeping the classes disjoint makes accounting exact
        straggler &= ~dropout
        nan_upload &= ~dropout
        return RoundFaults(round=i, dropout=dropout, straggler=straggler,
                           delay_s=np.where(straggler, delay, 0.0),
                           nan_upload=nan_upload,
                           fail_matching=fail_matching,
                           fail_power=fail_power)

    def retry_delay_s(self, i: int, k: int, attempt: int) -> float:
        """Extra delay of device ``k``'s ``attempt``-th retry in round
        ``i``.  With probability ``straggler_prob`` the retry straggles
        again (fresh exponential delay), otherwise it is prompt."""
        s = self.spec
        if not s.enabled_at(i) or s.straggler_prob <= 0.0:
            return 0.0
        rng = _round_rng(s.seed, i, k + 1, attempt)
        if rng.random() >= s.straggler_prob:
            return 0.0
        return float(rng.exponential(max(s.straggler_delay_s, 1e-12)))
