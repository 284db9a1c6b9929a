"""The federated optimisers (the port of ``repro.core``): GPDMM, AGPDMM,
SCAFFOLD, FedAvg and Inexact FedSplit on the star, on the flat client arena
or the per-leaf pytree path; graph-PDMM over general topologies; auto-tuned
stepsizes and residual-based early exit.

    from repro_torch.core import autotune, make, make_scan_rounds
    cfg = autotune.resolve(FederatedConfig(algorithm="gpdmm", eta="auto",
                                           topology="ring"),
                           grad_fn, params, m, batch)
    fed = make(cfg)                        # gpdmm on a ring: graph-PDMM
    state = fed.init(params, m)            # params on the card
    state, metrics = fed.round(state, grad_fn, batch)
"""
from repro_torch.core.api import FedOpt, make, make_oracle, make_scan_rounds, resolved_rho

__all__ = ["FedOpt", "make", "make_oracle", "make_scan_rounds", "resolved_rho"]
