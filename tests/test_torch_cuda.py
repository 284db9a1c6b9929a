"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the reference, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bitwise where the kernel and the plain version run the same f32
operations (``fused_update``, ``scaffold_cv``, ``dual_from_uplink``,
``fused_update_arena``, ``lam_is``, the EF21 kernels, a NaN included) or
copy (``row_gather``, ``row_scatter``); the uplink of ``round_tail`` to one
rounding (the plain version divides by a scalar as a multiply by its
reciprocal on the card); the inner loop to rtol = atol = 1e-4 (the matvec
sums in another order).
"""
import pytest
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make, quadratic
from repro_torch.kernels import ops as P, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run nowhere else")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_elementwise_kernels_match_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    m, w = 500, 512
    x, lam, gr = (torch.randn(m, w, generator=g, device=cuda).to(dtype) for _ in range(3))
    xs = torch.randn(w, generator=g, device=cuda).to(dtype)
    step = torch.rand(m, generator=g, device=cuda)
    got = P.round_tail(x, lam, xs, 3.7)
    want = ref.round_tail_ref(x, lam, xs, 3.7)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    # the plain version divides by a scalar as a multiply by its reciprocal
    # on the card; the kernel divides: one rounding of difference
    torch.testing.assert_close(got[1], want[1], rtol=1e-6 if dtype == torch.float32
                               else 8e-3, atol=1e-6)
    torch.testing.assert_close(P.dual_from_uplink(x, xs, 2.5),
                               ref.dual_from_uplink_ref(x, xs, 2.5), rtol=0, atol=0)
    for st in (0.13, step):
        torch.testing.assert_close(P.fused_update_arena(x, gr, xs, lam, st, 1.7),
                                   ref.fused_update_arena_ref(x, gr, xs, lam, st, 1.7),
                                   rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_update_matches_plain(cuda, dtype):
    """Kernel 6 at the Fig. 2 leaf, the softmax arena and ragged leaves
    (numel % 8 != 0, a 0-d leaf per client), with and without lam, scalar
    and per-client (m, 1) steps, a full or a broadcast server leaf."""
    g = torch.Generator(device="cuda").manual_seed(2)
    for shape in [(500, 500), (10, 7936), (7, 13), (6,), (3, 5, 3)]:
        x, gr, lam, xs = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                          for _ in range(4))
        step = torch.rand((shape[0],) + (1,) * (len(shape) - 1), generator=g, device=cuda)
        for s_ in (xs, xs[0].contiguous()):
            for st in (0.13, step):
                for lm in (lam, None):
                    torch.testing.assert_close(
                        P.fused_update(x, gr, s_, lm, st, 1.7),
                        ref.fused_update_ref(x, gr, s_, lm, st, 1.7), rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scaffold_cv_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(3)
    for m, w in [(500, 512), (10, 7936)]:
        ci, xk = (torch.randn(m, w, generator=g, device=cuda).to(dtype) for _ in range(2))
        c, xs = (torch.randn(w, generator=g, device=cuda).to(dtype) for _ in range(2))
        alpha = 1.0 + 40.0 * torch.rand(m, generator=g, device=cuda)
        for a in (37.5, alpha):
            torch.testing.assert_close(P.scaffold_cv(ci, xk, c, xs, a),
                                       ref.scaffold_cv_ref(ci, xk, c, xs, a), rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_inner_loop_with_off_and_no_lam_matches_plain(cuda):
    """The variants SCAFFOLD and FedAvg run on the arena: an ``off`` row,
    no lam and rho = 0, per-client or scalar step."""
    g = torch.Generator(device="cuda").manual_seed(4)
    m, w, K = 64, 512, 5
    A = torch.randn(m, w, w, generator=g, device=cuda) / w ** 0.5
    H = A @ A.transpose(1, 2) / 4.0
    x0, c, off = (torch.randn(m, w, generator=g, device=cuda) for _ in range(3))
    xs = torch.randn(w, generator=g, device=cuda)
    step = 0.05 + 0.1 * torch.rand(m, generator=g, device=cuda)
    for st in (0.1, step):
        for o in (off, None):
            got = P.inner_loop_affine(x0, H, c, xs, None, st, 0.0, K, off=o)
            want = ref.inner_loop_affine_ref(x0, H, c, xs, None, st, 0.0, K, off=o)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_inner_loop_matches_plain(cuda):
    g = torch.Generator(device="cuda").manual_seed(1)
    m, w, K = 64, 512, 5
    A = torch.randn(m, w, w, generator=g, device=cuda) / w ** 0.5
    H = A @ A.transpose(1, 2) / 4.0
    x0, c, lam = (torch.randn(m, w, generator=g, device=cuda) for _ in range(3))
    xs = torch.randn(w, generator=g, device=cuda)
    got = P.inner_loop_affine(x0, H, c, xs, lam, 0.1, 0.9, K)
    want = ref.inner_loop_affine_ref(x0, H, c, xs, lam, 0.1, 0.9, K)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 256, device=cuda)
    xs = torch.zeros(256, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        P.dual_from_uplink(x.double(), xs.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        P.round_tail(x.t().contiguous().t(), x, xs, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        P.inner_loop_affine(x.bfloat16(), torch.zeros(4, 256, 256, device=cuda), x, xs,
                            None, 0.1, 1.0, 2)
    with pytest.raises(ValueError, match="width"):
        z = torch.zeros(2, 200, device=cuda)
        P.inner_loop_affine(z, torch.zeros(2, 200, 200, device=cuda), z,
                            torch.zeros(200, device=cuda), None, 0.1, 1.0, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        z = torch.zeros(2, 200, device=cuda)
        P.ef21_rowmax(z, z)
    with pytest.raises(ValueError, match="multiple of 16"):
        P.row_gather(torch.zeros(4, 6, device=cuda), torch.zeros(1, dtype=torch.int64,
                                                                 device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        P.row_gather(x, torch.zeros(1, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ef21_kernels_match_plain(cuda, dtype):
    """Kernels 7 and 8 at the least-squares arena (one leaf of 4 rows, and
    two leaves of 3 and 1) and the softmax arena, bits 8 and 4, with a NaN
    in one client's leaf."""
    g = torch.Generator(device="cuda").manual_seed(5)
    for (m, w), leaf_rows in [((500, 512), (4,)), ((500, 512), (3, 1)), ((10, 7936), (62,))]:
        u_hat = torch.randn(m, w, generator=g, device=cuda)
        u = (u_hat + 0.1 * torch.randn(m, w, generator=g, device=cuda)).to(dtype)
        u_hat = u_hat.to(dtype)
        u[1, 7] = float("nan")
        rowmax = P.ef21_rowmax(u, u_hat)
        torch.testing.assert_close(rowmax, ref.ef21_rowmax_ref(u, u_hat), rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(rowmax).sum() == 1
        for bits in (8, 4):
            scales = P._ef21_row_scales(rowmax, leaf_rows, float(2 ** (bits - 1) - 1))
            torch.testing.assert_close(P.ef21_apply(u, u_hat, scales, bits),
                                       ref.ef21_apply_ref(u, u_hat, scales, bits),
                                       rtol=0, atol=0, equal_nan=True)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_gather_and_scatter_match_plain(cuda, dtype):
    """Kernels 9 and 10 at the least-squares arena (cohorts of 50 and 250
    of 500), the softmax arena (5 of 10) and a population of 65,536 (656,
    1%: offsets past 2^31 bytes in bf16 and f32 alike), int32 and int64
    ids; the scatter leaves its input as it was."""
    g = torch.Generator(device="cuda").manual_seed(6)
    for m, w, mc in [(500, 512, 50), (500, 512, 250), (10, 7936, 5), (65536, 512, 656)]:
        arr = torch.randn(m, w, generator=g, device=cuda).to(dtype)
        idx = torch.sort(torch.randperm(m, generator=g, device=cuda)[:mc]).values
        rows = torch.randn(mc, w, generator=g, device=cuda).to(dtype)
        for ids in (idx, idx.to(torch.int32)):
            assert torch.equal(P.row_gather(arr, ids), ref.row_gather_ref(arr, ids))
        before = arr.clone()
        got = P.row_scatter(arr, idx, rows)
        assert torch.equal(arr, before)
        assert torch.equal(got, arr.index_copy(0, idx, rows))
    torch.cuda.synchronize()


def _problems(cuda):
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=64, d=64, device="cpu")
    fields = ("AtA", "Atb", "btb", "evals", "evecs", "x_star", "f_star")
    gprob = quadratic.LeastSquares(**{f: getattr(prob, f).to(cuda) for f in fields},
                                   L=prob.L, mu=prob.mu)
    return prob, gprob


# launches per round on the arena with the affine oracle
ARENA_LAUNCHES = {
    "gpdmm": {"inner_loop_affine": 1, "round_tail": 1, "dual_from_uplink": 1},
    "agpdmm": {"inner_loop_affine": 1, "round_tail": 1, "dual_from_uplink": 1},
    "scaffold": {"inner_loop_affine": 1, "scaffold_cv": 1},
    "fedavg": {"inner_loop_affine": 1},
}
STATE = {"gpdmm": ("x_s", "lam_s"), "agpdmm": ("x_s", "lam_s"), "scaffold": ("x_s", "c_i"),
         "fedavg": ("x_s",), "fedsplit": ("x_s", "z_s")}
CACHE = ("u_hat",)


def _card_vs_cpu(cuda, cfg, grad_of, rounds=3):
    """``rounds`` rounds on the card (kernels) and on the CPU (plain
    versions); returns the launches on the card."""
    prob, gprob = _problems(cuda)
    opt = make(cfg)
    s_cpu, s_gpu = opt.init(torch.zeros(64), 8), opt.init(torch.zeros(64, device=cuda), 8)
    P.reset_launches()
    for _ in range(rounds):
        s_cpu, _ = opt.round(s_cpu, grad_of(prob), prob.batch())
        s_gpu, _ = opt.round(s_gpu, grad_of(gprob), gprob.batch())
    counts = P.launches()
    for k in STATE[cfg.algorithm] + (CACHE if "u_hat" in s_cpu else ()):
        torch.testing.assert_close(s_gpu[k].cpu(), s_cpu[k], rtol=1e-4, atol=1e-4)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_cuda_rounds_match_cpu_and_count_launches(cuda, algo):
    """Three arena rounds on the card (kernels) against the same rounds on
    the CPU (plain versions), rtol = atol = 1e-4: the matvec and the client
    mean sum in other orders on the two devices."""
    eta = 0.5 / _problems("cpu")[0].L
    counts = _card_vs_cpu(cuda, FederatedConfig(algorithm=algo, inner_steps=5, eta=eta,
                                                use_arena=True), lambda p: p.oracle())
    want = {k.name: 0 for k in P.KERNELS} | {k: 3 * v for k, v in ARENA_LAUNCHES[algo].items()}
    assert counts == want


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg", "fedsplit"])
def test_cuda_pytree_rounds_match_cpu_and_count_launches(cuda, algo):
    """The per-leaf path (``use_arena="auto"`` at W = 128, plain grad): one
    ``fused_update`` per step and no arena kernel."""
    eta = 0.5 / _problems("cpu")[0].L
    counts = _card_vs_cpu(cuda, FederatedConfig(algorithm=algo, inner_steps=4, eta=eta),
                          lambda p: p.grad)
    assert counts == {k.name: 0 for k in P.KERNELS} | {"fused_update": 3 * 4}


# launches per round of the partial-participation rounds on the arena (the
# affine oracle): the cohort rounds gather and scatter, the masked rounds
# select; EF21 adds its two kernels (and, on the cohort, the u_hat gather)
COHORT_LAUNCHES = {
    "gpdmm": dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=2,
                  row_scatter=2),
    "agpdmm": dict(inner_loop_affine=1, round_tail=1, dual_from_uplink=1, row_gather=1,
                   row_scatter=1),
    "scaffold": dict(inner_loop_affine=1, scaffold_cv=1, row_gather=1, row_scatter=1),
    "fedavg": dict(inner_loop_affine=1, row_scatter=1),
}
EF21_LAUNCHES = dict(ef21_rowmax=1, ef21_apply=1)


VARIANTS = [("gpdmm", None), ("gpdmm", 8), ("agpdmm", None), ("agpdmm", 8),
            ("scaffold", None), ("fedavg", None), ("fedavg", 8)]  # SCAFFOLD refuses EF21


@pytest.mark.cuda
@pytest.mark.parametrize("cohort", [True, False], ids=["cohort", "masked"])
@pytest.mark.parametrize("algo,bits", VARIANTS,
                         ids=[f"{a}-{'ef21' if b else 'plain'}" for a, b in VARIANTS])
def test_cuda_partial_participation_rounds_match_cpu(cuda, algo, bits, cohort):
    """Three rounds at participation 0.5 (a cohort of 4 of 8) on the card
    against the CPU, rtol = atol = 1e-4, with the launches of each path.
    EF21's rounding to its grid can put one element a quantisation step
    apart between the two devices (see tests/test_torch_participation.py),
    so with EF21 only the first round, which starts from the same state,
    is compared."""
    eta = 0.5 / _problems("cpu")[0].L
    cfg = FederatedConfig(algorithm=algo, inner_steps=5, eta=eta, use_arena=True,
                          participation=0.5, cohort=cohort, uplink_bits=bits)
    rounds = 1 if bits else 3
    counts = _card_vs_cpu(cuda, cfg, lambda p: p.oracle(), rounds=rounds)
    per_round = dict(COHORT_LAUNCHES[algo]) if cohort else {
        k: v for k, v in COHORT_LAUNCHES[algo].items() if not k.startswith("row_")}
    if bits:
        per_round |= EF21_LAUNCHES
        if cohort:
            per_round["row_gather"] = per_round.get("row_gather", 0) + 1
    assert counts == {k.name: 0 for k in P.KERNELS} | {k: rounds * v
                                                        for k, v in per_round.items()}
