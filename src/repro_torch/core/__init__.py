"""The federated optimisers (the port of ``repro.core``): GPDMM, AGPDMM,
SCAFFOLD, FedAvg and Inexact FedSplit, on the flat client arena or the
per-leaf pytree path.

    from repro_torch.core import make
    fed = make(FederatedConfig(algorithm="agpdmm", inner_steps=5, eta=1e-4,
                               use_arena=True))
    state = fed.init(params, m)            # params on the card
    state, metrics = fed.round(state, grad_fn, batch)
"""
from repro_torch.core.api import FedOpt, make, make_oracle, resolved_rho

__all__ = ["FedOpt", "make", "make_oracle", "resolved_rho"]
