"""Beyond-paper demo on the PyTorch/CUDA port: the EF21 delta-quantised
uplink for GPDMM/AGPDMM, the port of ``examples/quantized_uplink.py`` on the
same problem.  Each client transmits q(u_i - u_hat_i) at ``--bits`` bits
with both sides integrating u_hat_i += q(.), so the iterates converge to the
exact optimum.

    PYTHONPATH=src python examples/torch_quantized_uplink.py --bits 4 [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, prng, quadratic


def run(algo: str, bits, prob, rounds, device):
    cfg = FederatedConfig(algorithm=algo, inner_steps=5, eta=0.5 / prob.L, uplink_bits=bits)
    opt = make(cfg)
    s = opt.init(torch.zeros(prob.d, device=device), prob.m)
    for _ in range(rounds):
        s, metrics = opt.round(s, prob.grad, prob.batch())
    return float(prob.dist(opt.server_params(s))), float(metrics["lam_sum_norm"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--algo", default="gpdmm", choices=["gpdmm", "agpdmm"])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prob = quadratic.generate_from_key(prng.key(0), m=8, n=400, d=64, device=args.device)
    d_exact, _ = run(args.algo, None, prob, args.rounds, args.device)
    d_quant, lam = run(args.algo, args.bits, prob, args.rounds, args.device)

    bytes_exact = prob.d * 4  # f32 wire
    bytes_quant = prob.d * args.bits / 8 + 4  # int<bits> + one f32 scale
    print(f"{args.algo} after {args.rounds} rounds on the paper's least-squares problem:")
    print(f"  exact uplink      : ||x - x*|| = {d_exact:.3e}   ({bytes_exact:,.0f} B/client/round)")
    print(f"  {args.bits}-bit EF21 uplink : ||x - x*|| = {d_quant:.3e}   "
          f"({bytes_quant:,.0f} B/client/round, {bytes_exact/bytes_quant:.1f}x less wire)")
    print(f"  dual-sum invariant (eq. 25) under quantisation: {lam:.2e}")
    assert d_quant < 50 * d_exact + 1e-3, "quantised run diverged from exact"
    print("EF21 delta compression preserves convergence.")
    return d_exact, d_quant


if __name__ == "__main__":
    main()
