"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the reference, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bitwise where the kernel and the plain version run the same f32
operations; the uplink of ``round_tail`` to one rounding (the plain version
divides by a scalar as a multiply by its reciprocal on the card); the
inner loop to rtol = atol = 1e-4 (the matvec sums in another order).
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


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm"])
def test_cuda_rounds_match_cpu_and_count_launches(cuda, algo):
    """Three rounds on the card (kernels) against the same rounds on the CPU
    (plain versions), rtol = atol = 1e-4: the matvec and the client mean sum
    in other orders on the two devices."""
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=64, d=64, device="cpu")
    fields = ("AtA", "Atb", "btb", "evals", "evecs", "x_star", "f_star")
    gprob = quadratic.LeastSquares(**{f: getattr(prob, f).to(cuda) for f in fields},
                                   L=prob.L, mu=prob.mu)
    opt = make(FederatedConfig(algorithm=algo, inner_steps=5, eta=0.5 / prob.L,
                               use_arena=True))
    s_cpu, s_gpu = opt.init(torch.zeros(64), 8), opt.init(torch.zeros(64, device=cuda), 8)
    P.reset_launches()
    for _ in range(3):
        s_cpu, _ = opt.round(s_cpu, prob.oracle(), prob.batch())
        s_gpu, _ = opt.round(s_gpu, gprob.oracle(), gprob.batch())
    assert P.launches() == {"inner_loop_affine": 3, "round_tail": 3,
                            "dual_from_uplink": 3, "fused_update_arena": 0}
    for k in ("x_s", "lam_s"):
        torch.testing.assert_close(s_gpu[k].cpu(), s_cpu[k], rtol=1e-4, atol=1e-4)
