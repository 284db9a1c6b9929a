"""Quickstart on the PyTorch/CUDA port: solve the paper's least-squares
problem with GPDMM, the port of ``examples/quickstart.py`` on the same
problem (``generate_from_key(prng.key(0), ...)`` is the reference's
``generate(jax.random.key(0), ...)``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, prng, quadratic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # A federated least-squares problem: 8 clients, heterogeneous data.
    prob = quadratic.generate_from_key(prng.key(0), m=8, n=400, d=64, device=args.device)

    # GPDMM (paper Alg. 1): K=5 local prox-gradient steps per round,
    # rho = 1/(K*eta) -- the paper's default coupling.
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=5, eta=0.5 / prob.L)
    opt = make(cfg)
    state = opt.init(torch.zeros(prob.d, device=args.device), prob.m)

    for r in range(args.rounds):
        state, metrics = opt.round(state, prob.grad, prob.batch())
        if r % 20 == 0 or r == args.rounds - 1:
            dist = float(prob.dist(opt.server_params(state)))
            print(f"round {r:3d}  ||x - x*|| {dist:.3e}  "
                  f"dual-sum invariant {float(metrics['lam_sum_norm']):.2e}")

    # iterate distance, not the f32 functional gap (F ~ 1e5: F - F* is pure
    # rounding noise once converged)
    dist = float(prob.dist(opt.server_params(state)))
    assert dist < 1e-3, dist
    print("converged -- GPDMM solves the centralised-network problem.")
    return dist


if __name__ == "__main__":
    main()
