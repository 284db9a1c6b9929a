"""The paper's Fig. 1 story on the PyTorch/CUDA port: why Inexact FedSplit
fails, and how GPDMM/AGPDMM fix it; the port of
``examples/fedsplit_vs_pdmm.py`` on the same problem.

    PYTHONPATH=src python examples/torch_fedsplit_vs_pdmm.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import fedsplit, make, pdmm, prng, quadratic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prob = quadratic.generate_from_key(prng.key(0), m=25, n=1000, d=200, device=args.device)
    x0 = torch.zeros(prob.d, device=args.device)
    out = {}

    # --- 1. Exact PDMM == exact FedSplit (SSIII-B) --------------------------
    cfg = FederatedConfig(rho=prob.L / 10)
    p, f = pdmm.make_exact(cfg), fedsplit.make_exact(cfg)
    sp, sf = p.init(x0, prob.m), f.init(x0, prob.m)
    prox = prob.make_client_prox()
    for _ in range(10):
        sp, _ = p.round(sp, prox)
        sf, _ = f.round(sf, prox)
    out["exact_diff"] = float(torch.max(torch.abs(sp["x_s"] - sf["x_s"])))
    print(f"exact PDMM vs FedSplit trajectory diff: {out['exact_diff']:.2e}  (identical)")

    # --- 2. Inexact FedSplit: improper init stalls --------------------------
    eta = 1.0 / prob.L
    for init, label in [("z", "z_{s|i} init (paper: improper)"), ("xs", "x_s init (fixed)")]:
        opt = make(FederatedConfig(algorithm="fedsplit", inner_steps=3, eta=eta,
                                   fedsplit_init=init, rho=prob.L / 10))
        s = opt.init(x0, prob.m)
        for _ in range(args.rounds):
            s = opt.round(s, prob.grad, prob.batch())[0]
        out[f"fedsplit_{init}"] = float(prob.gap(s["x_s"]))
        print(f"Inexact FedSplit, {label:32s} gap = {out[f'fedsplit_{init}']:.3e}")

    # --- 3. GPDMM / AGPDMM converge -----------------------------------------
    for algo in ["gpdmm", "agpdmm"]:
        opt = make(FederatedConfig(algorithm=algo, inner_steps=3, eta=0.5 / prob.L))
        s = opt.init(x0, prob.m)
        for _ in range(args.rounds):
            s = opt.round(s, prob.grad, prob.batch())[0]
        out[algo] = float(prob.gap(opt.server_params(s)))
        print(f"{algo.upper():8s} (paper's fix)                   gap = {out[algo]:.3e}")
    return out


if __name__ == "__main__":
    main()
