"""End-to-end driver on the PyTorch/CUDA port: federated training of a
transformer LM with the paper's optimisers on heterogeneous synthetic data
(each client draws from its own topic distribution, the reference's
``lm_batches`` stream), comparing GPDMM / AGPDMM / FedAvg; the port of
``examples/train_federated_lm.py``.

The default preset is small (~20M params, 60 rounds); ``--preset 100m``
(d_model 768, 12 layers, ~110M params, 300 rounds) is the larger driver;
``--preset tiny`` only checks that the driver runs.
On the card the attention runs as kernels 16 (forward) and 16b (backward).

    PYTHONPATH=src python examples/torch_train_federated_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch_train_federated_lm.py --preset 100m --algos gpdmm
"""
import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make as make_fed
from repro_torch.core import prng
from repro_torch.core import tree_util as T
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import build

PRESETS = {
    # (d_model, n_layers, d_ff, vocab, heads, steps, per_client_batch, seq)
    "tiny": (64, 2, 128, 256, 2, 4, 2, 32),  # a check that the driver runs
    "small": (256, 4, 1024, 4096, 4, 60, 4, 128),
    "100m": (768, 12, 3072, 16384, 12, 300, 8, 256),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--algos", default="gpdmm,agpdmm,fedavg")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    # eta 0.05 is in the stable region for these presets (0.5 diverges:
    # the prox-gradient step stops contracting on the non-convex loss)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--steps", type=int, default=None, help="rounds (default: the preset's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    d, L, ff, vocab, heads, steps, pcb, seq = PRESETS[args.preset]
    steps = args.steps or steps
    base = get_arch("olmo-1b").reduced()
    cfg = dataclasses.replace(base, d_model=d, n_layers=L, d_ff=ff, vocab_size=vocab,
                              n_heads=heads, n_kv_heads=heads, head_dim=d // heads)
    model = build(cfg)
    dev = args.device
    n_params = sum(x.numel() for x in T.leaves(model.init(prng.key(0), device=dev)))
    print(f"# preset={args.preset}: {n_params/1e6:.1f}M params, "
          f"{steps} rounds, m={args.clients}, K={args.k}")

    m = args.clients
    results = {}
    for algo in args.algos.split(","):
        fed = make_fed(FederatedConfig(algorithm=algo, inner_steps=args.k, eta=args.eta))
        params = model.init(prng.key(0), device=dev)
        state = fed.init(params, m)

        def grad_fn(p, b):
            return torch.func.grad(lambda q: model.loss(q, b)[0])(p)

        @torch.no_grad()
        def eval_loss(p, batch):
            return torch.func.vmap(lambda b: model.loss(p, b)[0])(batch).mean()

        curve = []
        for i, batch in enumerate(lm_batches(prng.key(1), steps, m, pcb, seq, cfg.vocab_size,
                                             device=dev)):
            state, _ = fed.round(state, grad_fn, batch)
            if i % max(1, steps // 10) == 0 or i == steps - 1:
                loss = float(eval_loss(fed.server_params(state), batch))
                curve.append((i, loss))
                print(f"[{algo:8s}] round {i:4d}  server loss {loss:.4f}", flush=True)
        results[algo] = curve

    print(f"\n# final server losses (heterogeneous clients, K={args.k}):")
    for algo, curve in results.items():
        print(f"#   {algo:8s} {curve[-1][1]:.4f}")
    print(json.dumps({a: c for a, c in results.items()}))
    return results


if __name__ == "__main__":
    main()
