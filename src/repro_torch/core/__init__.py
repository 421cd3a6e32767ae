from repro_torch.core.protocol import (DySTop, Mechanism, RoundContext,
                                       RoundDecision)
from repro_torch.core.staleness import StalenessState, drift_plus_penalty

__all__ = ["DySTop", "Mechanism", "RoundContext", "RoundDecision",
           "StalenessState", "drift_plus_penalty"]
