"""Decentralized PDMM over a ring on the PyTorch/CUDA port -- no server at
all; the port of ``examples/ring_pdmm.py`` on the same problem.  Each node
talks only to its two ring neighbours, and every node still converges to the
global least-squares optimum.

    PYTHONPATH=src python examples/torch_ring_pdmm.py [--rounds 300] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, prng, quadratic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rounds = args.rounds

    # The same federated least-squares problem as torch_quickstart.py -- but
    # solved over a ring of 8 peers instead of a client-server star.
    prob = quadratic.generate_from_key(prng.key(0), m=8, n=400, d=64, device=args.device)
    cfg = FederatedConfig(algorithm="gpdmm", topology="ring", inner_steps=5, eta=0.5 / prob.L)
    opt = make(cfg)  # topology != "star" routes gpdmm to graph-PDMM
    assert opt.name == "gpdmm_graph"
    state = opt.init(torch.zeros(prob.d, device=args.device), prob.m)

    for r in range(rounds):
        state, metrics = opt.round(state, prob.oracle(), prob.batch())
        if r % max(1, rounds // 5) == 0 or r == rounds - 1:
            dist = float(prob.dist(opt.server_params(state)))
            print(f"round {r:3d}  ||x - x*|| {dist:.3e}  "
                  f"consensus {float(metrics['consensus_err']):.2e}")

    # every node individually (not just the mean) reaches the global optimum
    worst = float(torch.max(torch.linalg.vector_norm(
        state["x"][:, :prob.d] - prob.x_star[None], dim=1)))
    print(f"worst per-node distance to x*: {worst:.3e}")
    assert worst < 1e-2, worst
    print("converged -- decentralized PDMM solves the global problem on a ring.")
    return worst


if __name__ == "__main__":
    main()
