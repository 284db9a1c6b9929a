"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the reference, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bitwise where the kernel and the plain version run the same f32
operations (``fused_update``, ``fused_update_leaves`` and x_bar's running
sum in every mode, ``scaffold_cv``, ``dual_from_uplink`` (and the server
step's dual given its own x_s'),
``fused_update_arena``, ``lam_is``, the EF21 kernels and the EF21 uplink
in one pass on each of its routes, a NaN and an Inf included) or
copy (``row_gather``, ``row_scatter``) or select and mix (``stale_mix``);
``screen_uplink``'s finite flags exactly and its sums to rtol
1e-6 * sqrt(W / 128) (a fixed order of its own, not torch.sum's;
``screen_keep``'s sq bitwise ``screen_uplink``'s, its mask and median
bitwise the plain rule's on that sq), and
``residual_norm``'s sums likewise; the server step's mean and column sum
within (d + 2) 2^-24 of the summed magnitudes from float64, twice that from
``torch.mean`` and ``torch.sum`` (d the kernel's summation depth), bf16
means one bf16 step; SCAFFOLD's server step: c_i' bitwise ``scaffold_cv``'s,
x_s' and c' within the mean's depth roundings carried through the plain
code's few ops (bitwise on integer data), the column sum of c_i' - c'
within (d + 2) 2^-24 of its summed magnitudes; ``neighbor_reduce`` and ``edge_flip``
bitwise (the same f32 operations, the sums in slot order); the
uplink of ``round_tail`` to one rounding (the plain version divides by a
scalar as a multiply by its reciprocal on the card); the inner loop to
rtol = atol = 1e-4 (the matvec sums in another order; bf16 rows one
bf16 ulp, 2^-7, once rounded), its two routes bitwise one another (the
same f32 operations in the same order); ``flash_attention``
and ``wkv6`` relative to the largest magnitude, 1e-4 in f32 (sums and exps
in another order) and 2^-7 in bf16 (one rounding of the f32 result).
"""
import pytest
import torch

from repro_torch.configs.base import FaultConfig, FederatedConfig
from repro_torch.core import (
    autotune, make, make_oracle, make_scan_rounds, pdmm_graph, quadratic, topology,
)
from repro_torch.core import tree_util as T
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import inner_loop as IL
from repro_torch.kernels import ops as P, ref
from repro_torch.kernels import round_tail as RT


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


# the server step (kernels 2-3): rows not a multiple of the slices (S > 1
# with a short last slice), the Fig. 2 arena, lm_flat's 2^20 columns (S = 1),
# a width that is not a multiple of the 16-byte vector, one client
SERVER_SHAPES = [(130001, 128), (500, 512), (8, 2 ** 20), (7, 130), (1, 128)]


def _column_sums_f64(a):
    """(sum_i a[i, j], sum_i |a[i, j]|) in float64."""
    d = a.double()
    return d.sum(0), d.abs().sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,w", SERVER_SHAPES)
def test_cuda_server_step_matches_plain(cuda, m, w, dtype):
    """The server step's passes and the round tail with the mean: x_s'
    within (d + 2) 2^-24 of each column's mean |u| from the float64 mean and
    twice that from ``torch.mean`` (d = ``round_tail.depth``, the kernel's
    summation depth, ``round_tail.depth_on``; bf16 one bf16 step from
    ``torch.mean``); lam' bitwise
    the plain dual given the kernel's x_s' and given a random row; lam's
    column sum likewise relative to each column's sum |lam|, against the
    float64 sum and ``torch.sum``; on integer data, where every order sums
    exactly, the exact mean rounded once and the exact column sum; lam_is and the uplink as ``round_tail``'s, the mean
    bitwise ``client_mean`` of that uplink; a second run bitwise the first;
    one launch of each pass."""
    from repro_torch.kernels import round_tail as RT

    g = torch.Generator(device="cuda").manual_seed(m + w)
    u = (torch.randn(m, w, generator=g, device=cuda) + 0.5).to(dtype)
    tol_u = (RT.depth_on(u) + 2) * 2.0 ** -24
    P.reset_launches()
    x_s, lam, colsum = P.server_step(u, 2.5)
    assert P.launches()["client_mean"] == 1 and P.launches()["dual_from_uplink"] == 1
    s64, a64 = _column_sums_f64(u)
    err_t = (x_s.double() - torch.mean(u, dim=0).double()).abs()
    if dtype == torch.float32:
        assert bool(((x_s.double() - s64 / m).abs() <= tol_u * a64 / m).all())
        assert bool((err_t <= 2 * tol_u * a64 / m).all())
    else:
        _, e = torch.frexp(torch.maximum(x_s.float().abs(), torch.mean(u, dim=0).float().abs()))
        assert bool((err_t <= torch.ldexp(torch.ones_like(err_t), e - 8)).all())
    assert torch.equal(lam, ref.dual_from_uplink_ref(u, x_s, 2.5))
    c64, ca64 = _column_sums_f64(lam)
    assert bool(((colsum.double() - c64).abs() <= tol_u * ca64).all())
    cs_t = torch.sum(lam.to(torch.float32), dim=0).double()
    assert bool(((colsum.double() - cs_t).abs() <= 2 * tol_u * ca64).all())
    # given a random row lam's columns do not cancel: their sums are O(m)
    x_r = torch.randn(w, generator=g, device=cuda).to(dtype)
    lam_r, cs_r = P.server_dual(u, x_r, 2.5)
    assert torch.equal(lam_r, ref.dual_from_uplink_ref(u, x_r, 2.5))
    assert torch.equal(P.dual_from_uplink(u, x_r, 2.5), lam_r)
    c64, ca64 = _column_sums_f64(lam_r)
    assert bool(((cs_r.double() - c64).abs() <= tol_u * ca64).all())
    # integer data (u, x_s in [0, 4], rho 2) sums exactly in any order: the
    # exact mean rounded once, the exact column sum
    u_i = torch.randint(0, 5, (m, w), generator=g, device=cuda).to(dtype)
    x_i = torch.randint(0, 5, (w,), generator=g, device=cuda).to(dtype)
    sum_i = u_i.double().sum(0)
    assert torch.equal(P.client_mean(u_i), (sum_i / m).float().to(dtype))
    lam_i, cs_i = P.server_dual(u_i, x_i, 2.0)
    assert torch.equal(lam_i, ref.dual_from_uplink_ref(u_i, x_i, 2.0))
    assert torch.equal(cs_i, (2.0 * (sum_i - m * x_i.double())).float())
    for a, b in zip(P.server_step(u, 2.5), (x_s, lam, colsum), strict=True):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2 else torch.int32))
    xr, lm = (torch.randn(m, w, generator=g, device=cuda).to(dtype) for _ in range(2))
    xs = torch.randn(w, generator=g, device=cuda).to(dtype)
    li, up, mean = P.round_tail_mean(xr, lm, xs, 3.7, with_lam_is=True)
    li2, up2 = P.round_tail(xr, lm, xs, 3.7)
    assert torch.equal(li, li2) and torch.equal(up, up2)
    assert torch.equal(li, ref.round_tail_ref(xr, lm, xs, 3.7)[0])
    assert torch.equal(mean, P.client_mean(up))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_server_step_leaves_no_ticket_behind(cuda):
    """Every tile's counter is back at 0 after a launch that reduced over
    slices, so back-to-back launches of every shape agree with each other."""
    from repro_torch.kernels import _args

    u = torch.randn(130001, 256, device=cuda)
    first = P.client_mean(u)
    for _ in range(3):
        assert torch.equal(P.client_mean(u), first)
        P.server_dual(u, first, 1.5)
    torch.cuda.synchronize()
    assert int(_args.workspace(u.device, 1).abs().sum()) == 0


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


LM_TREE = [(512, 384), (768, 512), (512, 768), (768, 512), (512, 768), (768,)]


def _bits(a, b) -> bool:
    """Bit for bit (so -0.0 differs from 0.0)."""
    ity = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(ity), b.view(ity))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_eq20_segments_match_plain(cuda, dtype):
    """Kernels 4 and 6 as one kernel: a tree of leaves in one launch
    (lm_tree's six at m = 8, ragged leaves, a 0-d leaf a client, a server
    leaf broadcast or full, lam or none, x as its own server leaf), the
    arena with its server row, every acc mode, scalar and per-client steps,
    bitwise the plain versions; a list longer than the small table and one
    of two dtypes."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda s, dt=dtype: torch.randn(s, generator=g, device=cuda).to(dt)  # noqa: E731
    for m, shapes in ((8, LM_TREE), (5, [(), (7,), (13,), (3, 50), (130,)])):
        xs = [rnd((m,) + s) for s in shapes]
        srv = [rnd(s) if i % 2 == 0 else rnd((m,) + s) for i, s in enumerate(shapes)]
        step_arr = torch.rand(m, generator=g, device=cuda)
        for st in (0.13, step_arr):
            for with_lam in (True, False):
                lams = [rnd(x.shape) if with_lam else None for x in xs]
                for mode in ("first", "add", "last", "only"):
                    gs = [rnd(x.shape) for x in xs]
                    acc0 = [rnd(x.shape) for x in xs]
                    got_acc, want_acc = [a.clone() for a in acc0], [a.clone() for a in acc0]
                    P.reset_launches()
                    got = P.fused_update_leaves(xs, gs, srv, lams, st, 1.7, accs=got_acc,
                                                acc_mode=mode, acc_scale=1.0 / 3)
                    assert P.launches()["fused_update"] == 1
                    want = ref.fused_update_leaves_ref(xs, gs, srv, lams, st, 1.7,
                                                       accs=want_acc, acc_mode=mode,
                                                       acc_scale=1.0 / 3)
                    assert all(_bits(a, b) for a, b in zip(got, want)), (m, mode)
                    assert all(_bits(a, b) for a, b in zip(got_acc, want_acc)), (m, mode)
        # rho = 0 with x as its own server leaf (SCAFFOLD, FedAvg)
        gs = [rnd(x.shape) for x in xs]
        got = P.fused_update_leaves(xs, gs, xs, [None] * len(xs), step_arr, 0.0)
        want = ref.fused_update_leaves_ref(xs, gs, xs, [None] * len(xs), step_arr, 0.0)
        assert all(_bits(a, b) for a, b in zip(got, want))
    # the arena, every mode
    x, gr, lam, acc = (rnd((10, 7936)) for _ in range(4))
    xs_row = rnd(7936)
    for mode in ("first", "add", "last", "only"):
        a, b = acc.clone(), acc.clone()
        got = P.fused_update_arena(x, gr, xs_row, lam, 0.05, 4.0, acc=a, acc_mode=mode,
                                   acc_scale=0.2)
        want = ref.fused_update_arena_ref(x, gr, xs_row, lam, 0.05, 4.0, acc=b, acc_mode=mode,
                                          acc_scale=0.2)
        assert _bits(got, want) and _bits(a, b), mode
    # 20 leaves: the large table; mixed dtypes: one launch each
    leaves = [rnd((4, 3 + i)) for i in range(20)]
    P.reset_launches()
    got = P.fused_update_leaves(leaves, leaves, leaves, leaves, 0.1, 2.0)
    assert P.launches()["fused_update"] == 1
    want = ref.fused_update_leaves_ref(leaves, leaves, leaves, leaves, 0.1, 2.0)
    assert all(_bits(a, b) for a, b in zip(got, want))
    mixed = [rnd((4, 9), torch.bfloat16), rnd((4, 5), torch.float32), rnd((4, 2), torch.bfloat16)]
    P.reset_launches()
    got = P.fused_update_leaves(mixed, mixed, mixed, [None] * 3, 0.1, 2.0)
    assert P.launches()["fused_update"] == 2
    want = ref.fused_update_leaves_ref(mixed, mixed, mixed, [None] * 3, 0.1, 2.0)
    assert all(_bits(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg", "fedsplit"])
def test_cuda_lm_tree_pytree_rounds_match_cpu(cuda, algo):
    """The reference benchmark's lm_tree (six f32 leaves, m = 8, K = 4,
    the 0.3 x tree gradient) on the pytree path: two rounds on the card
    equal the CPU's to rtol = atol = 1e-5 (the client mean sums in another
    order), with one ``fused_update`` launch per step, not one per leaf."""
    cfg = FederatedConfig(algorithm=algo, inner_steps=4, eta=0.1, use_arena=False)
    gen = torch.Generator().manual_seed(5)
    params = {f"p{i}": torch.randn(s, generator=gen) for i, s in enumerate(LM_TREE)}
    grad = lambda p, b: {k: 0.3 * v for k, v in p.items()}  # noqa: E731
    opt = make(cfg)
    s_cpu = opt.init(params, 8)
    s_gpu = opt.init({k: v.to(cuda) for k, v in params.items()}, 8)
    b_cpu, b_gpu = {"d": torch.zeros(8, 1)}, {"d": torch.zeros(8, 1, device=cuda)}
    P.reset_launches()
    for _ in range(2):
        s_cpu, _ = opt.round(s_cpu, grad, b_cpu)
        s_gpu, _ = opt.round(s_gpu, grad, b_gpu)
    assert P.launches() == {k.name: 0 for k in P.KERNELS} | {"fused_update": 2 * 4}
    for k in STATE[algo]:
        for name in params:
            torch.testing.assert_close(s_gpu[k][name].cpu(), s_cpu[k][name], rtol=1e-5,
                                       atol=1e-5)


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


def _affine_inputs(cuda, g, m, w, dtype):
    A = torch.randn(m, w, w, generator=g, device=cuda) / w ** 0.5
    H = A @ A.transpose(1, 2) / 4.0
    x0, c, lam, off = (torch.randn(m, w, generator=g, device=cuda) for _ in range(4))
    xs = torch.randn(w, generator=g, device=cuda)
    step = 0.05 + 0.1 * torch.rand(m, generator=g, device=cuda)
    return H, c, x0.to(dtype), xs.to(dtype), lam.to(dtype), off.to(dtype), step


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,want_route", [(512, "resident"), (1024, "stream"), (128, "resident"),
                                           (256, "resident"), (384, "resident"),
                                           (640, "resident")])
def test_cuda_inner_loop_routes_match_plain(cuda, w, want_route, dtype):
    """Each route at m = 37 (a multiple of no cluster size) against the
    plain version: lam with rho, then an ``off`` row, no lam and rho = 0,
    each with a scalar and a per-client step; f32 within 1e-4, bf16 rows
    within one bf16 ulp (2^-7) or 1e-4.  At each resident width (every
    cluster the route takes: 1 block at 128, 2 at 256, 8 at 384 and 512, a
    non-portable 16 at 640, whose warps own padded rows) the streaming
    route, launched directly, gives the resident route's bits."""
    g = torch.Generator(device="cuda").manual_seed(w)
    m, K = 37, 5
    H, c, x0, xs, lam, off, step = _affine_inputs(cuda, g, m, w, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for lm, o, rho in ((lam, None, 0.9), (None, off, 0.0), (None, None, 0.0)):
        for st in (0.1, step):
            IL.last_route = None
            got = P.inner_loop_affine(x0, H, c, xs, lm, st, rho, K, off=o)
            assert IL.last_route == want_route
            want = ref.inner_loop_affine_ref(x0, H, c, xs, lm, st, rho, K, off=o)
            for a, b in zip(got, want):
                assert a.dtype == dtype
                torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4)
            if want_route == "resident":
                streamed = IL.launch(x0, H, c, xs, lm, st, rho, K, off=o, path="stream")
                for a, b in zip(got, streamed):
                    assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "scaffold"])
def test_cuda_bf16_affine_rounds_match_cpu(cuda, algo):
    """A bf16 parameter tree on the arena with the affine oracle: bf16 rows
    and f32 (H, c) reach the kernel on the card, one launch a round, and
    each of three rounds, from the CPU's state carried to the card, agrees
    with the CPU's within 4 bf16 ulps of each state's largest value (the
    f32 loops differ by rounding, which can move a bf16 rounding)."""
    prob, gprob = _problems(cuda)
    cfg = FederatedConfig(algorithm=algo, inner_steps=5, eta=0.5 / prob.L, use_arena=True)
    opt = make(cfg)
    bf16 = torch.bfloat16
    s_cpu = opt.init(torch.zeros(64, dtype=bf16), 8)
    P.reset_launches()
    for _ in range(3):
        s_gpu = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in s_cpu.items()}
        s_cpu, _ = opt.round(s_cpu, prob.oracle(), prob.batch())
        s_gpu, _ = opt.round(s_gpu, gprob.oracle(), gprob.batch())
        for k in STATE[algo]:
            got, want = s_gpu[k], s_cpu[k]
            assert got.dtype == want.dtype == bf16
            scale = float(want.float().abs().max())
            torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                                       atol=4 * 2.0 ** -8 * max(scale, 1e-3))
    assert P.launches()["inner_loop_affine"] == 3 and IL.last_route == "resident"


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 256, device=cuda)
    xs = torch.zeros(256, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        P.dual_from_uplink(x.double(), xs.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        P.round_tail(x.t().contiguous().t(), x, xs, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        P.inner_loop_affine(x.double(), torch.zeros(4, 256, 256, device=cuda), x, xs,
                            None, 0.1, 1.0, 2)
    with pytest.raises(TypeError, match="dtype"):
        P.inner_loop_affine(x.bfloat16(), torch.zeros(4, 256, 256, device=cuda).bfloat16(),
                            x, xs, None, 0.1, 1.0, 2)
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
    with pytest.raises(ValueError, match="acc_mode"):
        P.fused_update_arena(x, x, xs, None, 0.1, 1.0, acc=x.clone(), acc_mode="sum")
    with pytest.raises(TypeError, match="acc has dtype"):
        P.fused_update_leaves([x], [x], [xs], [None], 0.1, 1.0, accs=[x.bfloat16()])
    with pytest.raises(ValueError, match="client count"):
        P.fused_update_leaves([x, torch.zeros(3, 8, device=cuda)], [x, x], [xs, xs],
                              [None, None], 0.1, 1.0)


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


# (m, W, leaf_rows) for the EF21 uplink in one pass: the least-squares arena
# (one leaf, two), the softmax arena (the block route), a leaf of 200 rows
# and lm_tree's six leaves at a fifth of their rows (the wide route), twelve
# leaves (the large leaf table)
EF21_SHAPES = [(500, 512, (4,)), (500, 512, (3, 1)), (10, 7936, (62,)), (6, 25600, (200,)),
               (3, 128 * 2767, (2, 614, 614, 614, 614, 309)),
               (40, 128 * 78, (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12))]


def _ef21_update_inputs(g, m, w, leaf_rows, dtype):
    """u = u_hat + a delta; a NaN in client 1's first leaf, an Inf and a
    -Inf in the last client's last leaf, and client 0's last leaf equal to
    u_hat (scale 1e-12)."""
    u_hat = torch.randn(m, w, generator=g, device="cuda")
    u = u_hat + 0.1 * torch.randn(m, w, generator=g, device="cuda")
    u[1, 7] = float("nan")
    u[m - 1, w - 5] = float("inf")
    u[m - 1, w - 2] = -float("inf")
    last = 128 * leaf_rows[-1]
    u[0, w - last:] = u_hat[0, w - last:]
    return u.to(dtype), u_hat.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ef21_update_matches_plain(cuda, dtype):
    """``ef21_update`` bitwise its plain composition (the row max, the
    per-leaf scales, the apply pass) on its route and forced onto the wide
    route, bits 8, 4 and 2, with a NaN, an Inf and an all-zero leaf; one
    launch on a resident route, two on the wide one (its apply pass in
    either order)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for m, w, leaf_rows in EF21_SHAPES:
        u, u_hat = _ef21_update_inputs(g, m, w, leaf_rows, dtype)
        routes = [None] + (["wide"] if RT.ef21_route(leaf_rows, dtype) != "wide" else [])
        for bits in (8, 4, 2):
            want = ref.ef21_update_ref(u, u_hat, bits, leaf_rows)
            for route in routes:
                for reverse in (True, False):
                    P.reset_launches()
                    got = RT.ef21_update(u, u_hat, bits, leaf_rows, route, reverse=reverse)
                    wide = (route or RT.ef21_route(leaf_rows, dtype)) == "wide"
                    assert P.launches()["ef21_update"] == (2 if wide else 1)
                    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                               msg=f"{(m, w, leaf_rows, bits, route)}")
                    nan = want.isnan()
                    ity = torch.int32 if dtype == torch.float32 else torch.int16
                    assert torch.equal(got.isnan(), nan)
                    assert torch.equal(got[~nan].view(ity), want[~nan].view(ity))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_ef21_update_runs_no_torch_op(cuda):
    """On the card ``ops.ef21_update`` dispatches no tensor op but the
    ``torch.empty`` of its output (and, on the wide route, of its max
    table): the scales are formed inside the kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    g = torch.Generator(device="cuda").manual_seed(9)
    for m, w, leaf_rows in EF21_SHAPES[:4]:
        u, u_hat = _ef21_update_inputs(g, m, w, leaf_rows, torch.float32)
        P.ef21_update(u, u_hat, 8, leaf_rows)  # the plan, cached per layout
        with Ops() as ops_seen:
            P.ef21_update(u, u_hat, 8, leaf_rows)
        wide = RT.ef21_route(leaf_rows, torch.float32) == "wide"
        assert ops_seen.seen == ["aten.empty.memory_format"] * (2 if wide else 1), ops_seen.seen
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_gather_and_scatter_match_plain(cuda, dtype):
    """Kernels 9 and 10 at the least-squares arena (cohorts of 50 and 250
    of 500), the softmax arena (5 of 10), lm_flat (4 of 8 rows of 2^20:
    256 blocks a row) and a population of 65,536 (656, 1%: offsets past
    2^31 bytes in bf16 and f32 alike), int32 and int64 ids, one buffer and
    a table of three; the in-place scatter writes the cohort's rows and
    leaves every other row's bits as they were, the functional one leaves
    its input as it was."""
    g = torch.Generator(device="cuda").manual_seed(6)
    for m, w, mc in [(500, 512, 50), (500, 512, 250), (10, 7936, 5), (8, 1 << 20, 4),
                     (65536, 512, 656)]:
        arrs = tuple(torch.randn(m, w, generator=g, device=cuda).to(dtype) for _ in range(3))
        idx = torch.sort(torch.randperm(m, generator=g, device=cuda)[:mc]).values
        rows = tuple(torch.randn(mc, w, generator=g, device=cuda).to(dtype) for _ in range(3))
        for ids in (idx, idx.to(torch.int32)):
            assert torch.equal(P.row_gather(arrs[0], ids), ref.row_gather_ref(arrs[0], ids))
            for got, a in zip(P.row_gather_buffers(arrs, ids), arrs, strict=True):
                assert torch.equal(got, ref.row_gather_ref(a, ids))
        before = tuple(a.clone() for a in arrs)
        got = P.row_scatter(arrs[0], idx, rows[0])
        assert torch.equal(arrs[0], before[0])
        assert torch.equal(got, arrs[0].index_copy(0, idx, rows[0]))
        for ids in (idx, idx.to(torch.int32)):
            done = P.row_scatter_buffers_(arrs, ids, rows)
            for d, a, b, r in zip(done, arrs, before, rows, strict=True):
                assert d is a and torch.equal(a, b.index_copy(0, idx, r))
        del arrs, rows, before, got, done
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_row_buffers_mixed_table_match_plain(cuda):
    """A table of f32 and bf16 buffers of four widths (a round's lam,
    x_c, u_hat and c_i could differ so), one launch each way, bitwise."""
    g = torch.Generator(device="cuda").manual_seed(7)
    m, mc = 300, 37
    shapes = [(torch.float32, 512), (torch.bfloat16, 7936), (torch.float32, 8),
              (torch.bfloat16, 1 << 14)]
    arrs = tuple(torch.randn(m, w, generator=g, device=cuda).to(dt) for dt, w in shapes)
    rows = tuple(torch.randn(mc, w, generator=g, device=cuda).to(dt) for dt, w in shapes)
    idx = torch.sort(torch.randperm(m, generator=g, device=cuda)[:mc]).values
    P.reset_launches()
    for got, a in zip(P.row_gather_buffers(arrs, idx), arrs, strict=True):
        assert torch.equal(got, ref.row_gather_ref(a, idx))
    before = tuple(a.clone() for a in arrs)
    P.row_scatter_buffers_(arrs, idx.to(torch.int32), rows)
    for a, b, r in zip(arrs, before, rows, strict=True):
        assert torch.equal(a, b.index_copy(0, idx, r))
    assert P.launches()["row_gather"] == 1 and P.launches()["row_scatter"] == 1
    torch.cuda.synchronize()


def _problems(cuda):
    prob = quadratic.generate(torch.Generator().manual_seed(0), m=8, n=64, d=64, device="cpu")
    fields = ("AtA", "Atb", "btb", "evals", "evecs", "x_star", "f_star")
    gprob = quadratic.LeastSquares(**{f: getattr(prob, f).to(cuda) for f in fields},
                                   L=prob.L, mu=prob.mu)
    return prob, gprob


# launches per round on the arena with the affine oracle: a full GPDMM or
# AGPDMM round's tail is the round tail with the client mean in its pass and
# the dual pass; a round with a cache (``CACHED_TAIL``) runs the round tail,
# then the server step's two passes
ARENA_LAUNCHES = {
    "gpdmm": {"inner_loop_affine": 1, "round_tail_mean": 1, "dual_from_uplink": 1},
    "agpdmm": {"inner_loop_affine": 1, "round_tail_mean": 1, "dual_from_uplink": 1},
    "scaffold": {"inner_loop_affine": 1, "scaffold_step": 2},
    "fedavg": {"inner_loop_affine": 1},
}
STATE = {"gpdmm": ("x_s", "lam_s"), "agpdmm": ("x_s", "lam_s"), "scaffold": ("x_s", "c_i"),
         "fedavg": ("x_s",), "fedsplit": ("x_s", "z_s"), "gpdmm_graph": ("x_s", "x", "z")}
CACHE = ("u_hat",)
CACHED_TAIL = {"round_tail": 1, "client_mean": 1, "dual_from_uplink": 1}


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
# affine oracle): the cohort rounds gather every buffer they read in one
# launch and scatter every buffer they write in one, the masked rounds
# select; EF21 adds its one kernel (and, on the cohort, the u_hat rows to
# the gather: FedAvg's first)
COHORT_LAUNCHES = {
    "gpdmm": dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                  row_gather=1, row_scatter=1),
    "agpdmm": dict(inner_loop_affine=1, round_tail=1, client_mean=1, dual_from_uplink=1,
                   row_gather=1, row_scatter=1),
    "scaffold": dict(inner_loop_affine=1, scaffold_cv=1, row_gather=1, row_scatter=1),
    "fedavg": dict(inner_loop_affine=1, row_scatter=1),
}
EF21_LAUNCHES = dict(ef21_update=1)


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
    if algo == "scaffold" and not cohort:  # the masked round: SCAFFOLD's server step
        per_round = dict(ARENA_LAUNCHES[algo])
    if bits:
        per_round |= EF21_LAUNCHES
        if cohort:
            per_round["row_gather"] = 1
    assert counts == {k.name: 0 for k in P.KERNELS} | {k: rounds * v
                                                        for k, v in per_round.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
def test_cuda_donated_cohort_rounds_equal_functional(cuda, algo):
    """Four cohort rounds on the card through ``make_scan_rounds`` (the
    last three donated: the scatter in place) equal four ``fed.round``
    calls bitwise, with EF21 (not SCAFFOLD) and screened faults; the
    caller's state is left as it was, and every round launches one gather
    and one scatter."""
    _, gprob = _problems(cuda)
    eta = 0.5 / gprob.L
    extra = {} if algo == "scaffold" else dict(uplink_bits=8)
    opt = make(FederatedConfig(algorithm=algo, inner_steps=5, eta=eta, use_arena=True,
                               participation=0.5, screen=True,
                               faults=FaultConfig(dropout=0.2, corrupt=0.2, seed=3), **extra))
    state = opt.init(torch.zeros(64, device=cuda), 8)
    grad, batch = gprob.oracle(), gprob.batch()
    want = state
    for _ in range(4):
        want, _ = opt.round(want, grad, batch)
    caller = {k: T.tmap(torch.clone, v) for k, v in state.items()}
    P.reset_launches()
    got, _ = make_scan_rounds(opt, grad)(state, T.tmap(lambda x: torch.stack([x] * 4), batch))
    assert P.launches()["row_gather"] == 4 and P.launches()["row_scatter"] == 4
    for a, b in ((state, caller), (got, want)):
        assert sorted(a) == sorted(b)
        for k in a:
            for x, y in zip(T.leaves(a[k]), T.leaves(b[k]), strict=True):
                assert torch.equal(x, y), k
    torch.cuda.synchronize()


def _screen_and_mix_inputs(cuda, g, m, w, dtype, per_row):
    u = torch.randn(m, w, generator=g, device=cuda)
    u[1 % m, w // 2] = float("nan")
    u[(m - 1), 0] = float("inf")
    u[2 % m] *= 1e4
    other = torch.randn((m, w) if per_row else (w,), generator=g, device=cuda)
    buf = torch.randn(m, w, generator=g, device=cuda)
    buf[0] = float("nan")  # w = 0 on row 0: must not leak
    buf[1 % m] = float("inf")
    return u.to(dtype), other.to(dtype), buf.to(dtype)


SCREEN_SHAPES = [(500, 512), (50, 512), (8, 2 ** 20), (5, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_screen_uplink_matches_plain(cuda, dtype, per_row):
    """Kernel 11 at the arena, cohort, lm_flat and a ragged width: finite
    flags exactly, the sums to rtol 1e-6 * sqrt(W / 128), and the same
    result from run to run (a fixed order, no atomics)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, w in SCREEN_SHAPES:
        u, r, _ = _screen_and_mix_inputs(cuda, g, m, w, dtype, per_row)
        fin, sq = P.screen_uplink(u, r)
        fin_p, sq_p = ref.screen_uplink_ref(u, r)
        assert torch.equal(fin, fin_p), (m, w)
        torch.testing.assert_close(sq, sq_p, rtol=1e-6 * (w / 128) ** 0.5, atol=0)
        fin2, sq2 = P.screen_uplink(u, r)
        assert torch.equal(fin2, fin) and torch.equal(sq2, sq)
    torch.cuda.synchronize()


# screen_keep at the screened arena and cohort, the softmax arena, lm_flat
# (128 chunks a row), a ragged width, one client, the last block's
# shared-memory bound and past it (the cooperative select)
KEEP_SHAPES = [(500, 512), (50, 512), (10, 7936), (8, 2 ** 20), (5, 130), (1, 128),
               (8192, 128), (8193, 128), (100000, 128)]


def _keep_cases(cuda, g, m, w, dtype, per_row):
    """``screen_keep``'s inputs: the faulted rows of ``_screen_and_mix_inputs``
    (a NaN entry, an Inf entry, a blown-up row), the same with one more
    non-finite row (the other parity of the finite count), ties (three
    distinct rows repeated), every row non-finite, and a NaN in the
    reference (finite rows whose sq is NaN: every row broadcast, the first
    half per row)."""
    u, r, _ = _screen_and_mix_inputs(cuda, g, m, w, dtype, per_row)
    parity = u.clone()
    parity[3 % m] = float("nan")
    ties = (torch.arange(m, device=cuda) % 3).float()[:, None].expand(m, w).to(dtype).contiguous()
    nan_ref = r.clone()
    if per_row:
        nan_ref[: (m + 1) // 2, 0] = float("nan")
    else:
        nan_ref[0] = float("nan")
    return [("faulted", u, r), ("parity", parity, r), ("ties", ties, torch.zeros_like(r)),
            ("all_non_finite", torch.full_like(u, float("nan")), r), ("nan_ref", u, nan_ref)]


def _int_bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,w", KEEP_SHAPES)
def test_cuda_screen_keep_matches_plain(cuda, m, w, dtype, per_row):
    """Kernel 11 with the keep rule in its launch: sq bitwise
    ``screen_uplink``'s on the card and finite equal; the mask bitwise
    ``_keep_from``'s rule (``ref.keep_from_ref``) on that sq, and the median
    bitwise ``faults.nanmedian``'s, at screen_mult 0, 100 and 3; one launch
    (two past ``SELECT_ROWS`` with the rule), the same from run to run."""
    from repro_torch.kernels import screen as SC

    g = torch.Generator(device="cuda").manual_seed(m + w)
    for label, u, r in _keep_cases(cuda, g, m, w, dtype, per_row):
        fin_u, sq_u = P.screen_uplink(u, r)
        for mult in (0.0, 100.0, 3.0):
            P.reset_launches()
            keep, fin, sq, med = SC.keep_parts(u, r, mult)
            n = P.launches()["screen_keep"]
            route = SC.keep_route(m, mult > 0)
            what = (label, mult, route)
            assert n == (2 if route == "select" else 1), what
            assert torch.equal(fin, fin_u) and torch.equal(_int_bits(sq), _int_bits(sq_u)), what
            assert torch.equal(keep, ref.keep_from_ref(fin_u, sq_u, mult)), what
            if mult > 0:
                want = ref.nanmedian_ref(torch.where(fin_u, sq_u, float("nan")))
                assert _bitwise(med.reshape(1), want.reshape(1)), (what, med, want)
            else:
                assert med is None
            assert torch.equal(P.screen_keep(u, r, mult), keep), what
        if label == "all_non_finite" or (label == "nan_ref" and not per_row):
            assert not bool(P.screen_keep(u, r, 100.0).any())
    torch.cuda.synchronize()


def _host_ops(fn) -> int:
    """Tensor ops ``fn`` dispatches, allocations (``empty*``) aside."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.__name__.startswith("empty")
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,mult", [(500, 512, 100.0), (500, 512, 0.0), (8, 2 ** 20, 100.0),
                                      (100000, 128, 100.0), (100000, 128, 0.0)])
def test_cuda_screen_keep_runs_no_torch_op(cuda, m, w, mult):
    """From the uplink to the mask no tensor op runs besides ``torch.empty``
    on either route (the last block, the cooperative select), with and
    without the rule; the workspace is zero again after each call."""
    from repro_torch.kernels import _args
    from repro_torch.kernels import screen as SC

    g = torch.Generator(device="cuda").manual_seed(5)
    u, r, _ = _screen_and_mix_inputs(cuda, g, m, w, torch.float32, False)
    P.screen_keep(u, r, mult)  # the workspace is allocated once per device and stream
    assert _host_ops(lambda: P.screen_keep(u, r, mult)) == 0
    ws = _args.workspace(u.device, SC.WS_INTS)
    torch.cuda.synchronize()
    assert not bool(ws[: SC.WS_INTS].any())


SCAFFOLD_SHAPES = [(500, 512), (10, 7936), (8, 2 ** 20), (7, 130), (130001, 128), (1, 128)]
UNIT = 2.0 ** -24


def _after_mean_tol(d, m, summed, mean_p, *steps, unit):
    """Bound on |a - b| for a value the plain code forms from a column mean
    through a few rounded ops: the two means within 2 (d + 2) 2^-24 of the
    summed magnitudes over m (two orders of depth at most d) and one
    rounding each, then 3 roundings (``unit``) of each later op's result."""
    tol = 2 * (d + 2) * UNIT * summed / m + 2 * unit * mean_p.abs()
    for scale, mag in steps:
        tol = scale * tol + 3 * unit * mag.abs()
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,w", SCAFFOLD_SHAPES)
def test_cuda_scaffold_step_matches_plain(cuda, m, w, dtype):
    """SCAFFOLD's full-arena server step on the card, two launches and no
    ``scaffold_cv``: c_i' bitwise ``scaffold_cv``'s (c_i's bits on
    masked-out rows); x_s' = x_s + eta_g (mean x_up - x_s) and c' = c +
    mean (c_i' - c_i) within ``_after_mean_tol`` of the plain composition
    (d = ``round_tail.depth_on``); the column sum of c_i' - c' within
    (d + 2) 2^-24 of its summed magnitudes from float64 and twice that from
    ``torch.sum``, given the kernel's c'; c_sum_norm against the plain one
    within the norm of (3 (d + 2) 2^-24 and two dtype roundings of the
    summed magnitudes + m |c'_card - c'_plain|, a column); scalar and
    per-client alpha, with and without a mask, eta_g 1 and 0.7; a second
    run bitwise the first."""
    from repro_torch.kernels import round_tail as RT

    g = torch.Generator(device="cuda").manual_seed(m * 7 + w)
    ci, xt = (torch.randn(m, w, generator=g, device=cuda).to(dtype) for _ in range(2))
    c, xs = (torch.randn(w, generator=g, device=cuda).to(dtype) for _ in range(2))
    d = RT.depth_on(ci)
    unit = UNIT if dtype == torch.float32 else 2.0 ** -8
    f64 = torch.float64
    for alpha in (2.5, 1.0 + 40.0 * torch.rand(m, generator=g, device=cuda)):
        for mask in (None, torch.rand(m, generator=g, device=cuda) < 0.6):
            for eta_g in (1.0, 0.7):
                P.reset_launches()
                got = P.scaffold_step(ci, xt, c, xs, alpha, eta_g, mask)
                counts = P.launches()
                assert counts["scaffold_step"] == 2 and counts["scaffold_cv"] == 0
                want = ref.scaffold_step_ref(ci, xt, c, xs, alpha, eta_g, mask)
                cv = P.scaffold_cv(ci, xt, c, xs, alpha)
                if mask is not None:
                    cv = torch.where(mask[:, None], cv, ci)
                assert torch.equal(_int_bits(got[0]), _int_bits(cv))
                assert torch.equal(_int_bits(got[0]), _int_bits(want[0]))
                x_up = xt if mask is None else torch.where(mask[:, None], xt, xs[None])
                m_x = torch.mean(x_up, dim=0)
                dx = m_x - xs
                tol_x = _after_mean_tol(d, m, x_up.to(f64).abs().sum(0), m_x.to(f64),
                                        (1.0, dx.to(f64)), (eta_g, eta_g * dx.to(f64)),
                                        (1.0, want[1].to(f64)), unit=unit)
                err_x = (got[1].to(f64) - want[1].to(f64)).abs()
                assert bool((err_x <= tol_x).all()), float((err_x - tol_x).max())
                delta = want[0] - ci
                m_c = torch.mean(delta, dim=0)
                tol_c = _after_mean_tol(d, m, delta.to(f64).abs().sum(0), m_c.to(f64),
                                        (1.0, want[2].to(f64)), unit=unit)
                err_c = (got[2].to(f64) - want[2].to(f64)).abs()
                assert bool((err_c <= tol_c).all()), float((err_c - tol_c).max())
                terms = (got[0] - got[2][None]).to(torch.float32)
                s64, a64 = _column_sums_f64(terms)
                ctol = (d + 2) * UNIT * a64
                assert bool(((got[3].to(f64) - s64).abs() <= ctol).all())
                assert bool(((got[3].to(f64) - torch.sum(terms, 0).to(f64)).abs()
                             <= 2 * ctol).all())
                # c_sum_norm: the column sums' orders, each term's dtype
                # rounding, and the two c' (m of them a column)
                col_tol = 3 * ctol + 2 * unit * a64 + m * err_c
                norm_k, norm_p = (torch.linalg.vector_norm(x.to(f64)) for x in (got[3], want[3]))
                assert float((norm_k - norm_p).abs()) <= float(torch.linalg.vector_norm(col_tol))
                again = P.scaffold_step(ci, xt, c, xs, alpha, eta_g, mask)
                assert all(torch.equal(_int_bits(a), _int_bits(b)) for a, b in zip(again, got))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,w", [(512, 512), (8, 2 ** 20), (4096, 128)])
def test_cuda_scaffold_step_exact_on_integer_data(cuda, m, w, dtype):
    """On integer data with m a power of two, alpha 2 and eta_g 0.5 every
    sum of the first pass is exact in any order and every mean exact (or
    rounded once, the same way): x_s', c' and c_i' bitwise the plain
    composition on the card, so a lost or doubled row or slice would show."""
    g = torch.Generator(device="cuda").manual_seed(m + 3 * w)
    ci, xt = (torch.randint(-4, 5, (m, w), generator=g, device=cuda).to(dtype) for _ in range(2))
    c, xs = (torch.randint(-4, 5, (w,), generator=g, device=cuda).to(dtype) for _ in range(2))
    for mask in (None, torch.rand(m, generator=g, device=cuda) < 0.5):
        got = P.scaffold_step(ci, xt, c, xs, 2.0, 0.5, mask)
        want = ref.scaffold_step_ref(ci, xt, c, xs, 2.0, 0.5, mask)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(_int_bits(a), _int_bits(b))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_scaffold_step_runs_no_torch_op(cuda):
    """SCAFFOLD's server step dispatches nothing but ``torch.empty``: no
    ``torch.where``, no ``torch.mean``, no column sum."""
    g = torch.Generator(device="cuda").manual_seed(9)
    ci, xt = (torch.randn(500, 512, generator=g, device=cuda) for _ in range(2))
    c, xs = (torch.randn(512, generator=g, device=cuda) for _ in range(2))
    mask = torch.rand(500, generator=g, device=cuda) < 0.5
    P.scaffold_step(ci, xt, c, xs, 2.5, 1.0, mask)
    assert _host_ops(lambda: P.scaffold_step(ci, xt, c, xs, 2.5, 1.0, mask)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["bcast", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stale_mix_matches_plain(cuda, dtype, per_row):
    """Kernel 12, bitwise: rows with w = 0 over a NaN or Inf buffer, rows
    with w > 0, fresh and cached bases, stored and carried slots."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for m, w in SCREEN_SHAPES:
        u, c, buf = _screen_and_mix_inputs(cuda, g, m, w, dtype, per_row)
        ar = torch.arange(m, device=cuda)
        fresh, store = ar % 2 == 0, ar % 3 == 0
        wt = torch.where(ar % 2 == 1, 0.5 ** (1 + ar % 3).float(), torch.zeros((), device=cuda))
        got = P.stale_mix(u, c, buf, fresh, store, wt)
        want = ref.stale_mix_ref(u, c, buf, fresh, store, wt)
        for a, b in zip(got, want):
            assert torch.equal(a.isnan(), b.isnan()), (m, w)
            assert torch.equal(a[~a.isnan()], b[~b.isnan()]), (m, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["gpdmm", "agpdmm", "scaffold", "fedavg"])
@pytest.mark.parametrize("mode", ["screened", "async"])
def test_cuda_fault_rounds_match_cpu_and_count_launches(cuda, algo, mode):
    """Three faulted arena rounds on the card against the CPU: screening
    adds one ``screen_keep`` per round, async rounds (whose ``screen``
    is on by "auto") one ``stale_mix`` more, and SCAFFOLD's async round
    refreshes c_i with ``scaffold_cv`` (its server step stays plain)."""
    eta = 0.5 / _problems("cpu")[0].L
    kw = (dict(faults=FaultConfig(dropout=0.2, corrupt=0.3, seed=7), screen=True)
          if mode == "screened" else dict(faults=FaultConfig(delay=0.3, seed=9), max_staleness=2))
    counts = _card_vs_cpu(cuda, FederatedConfig(algorithm=algo, inner_steps=5, eta=eta,
                                                use_arena=True, **kw), lambda p: p.oracle())
    per_round = dict(ARENA_LAUNCHES[algo], screen_keep=1)
    if "round_tail_mean" in per_round:  # faults need the cache
        del per_round["round_tail_mean"]
        per_round |= CACHED_TAIL
    if mode == "async":
        per_round["stale_mix"] = 1
        if algo == "scaffold":
            del per_round["scaffold_step"]
            per_round["scaffold_cv"] = 1
    assert counts == {k.name: 0 for k in P.KERNELS} | {k: 3 * v for k, v in per_round.items()}


def _bitwise(a, b):
    """Equal bits where not NaN, NaN at the same places."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~b.isnan()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_residual_norm_matches_plain(cuda, dtype):
    """Kernel 13 at the Fig. 2 arena, lm_flat and a ragged width, a NaN row
    included: sums to rtol 1e-6 * sqrt(W / 128), the same from run to
    run."""
    g = torch.Generator(device="cuda").manual_seed(6)
    for m, w in ((500, 512), (8, 1 << 20), (5, 130)):
        x = torch.randn(m, w, generator=g, device=cuda)
        xp = x + 0.01 * torch.randn(m, w, generator=g, device=cuda)
        x[1, w // 2] = float("nan")
        x, xp = x.to(dtype), xp.to(dtype)
        got, want = P.residual_norm(x, xp), ref.residual_norm_ref(x, xp)
        for a, b in zip(got, want):
            assert torch.equal(a.isnan(), b.isnan()), (m, w)
            torch.testing.assert_close(a, b, rtol=1e-6 * (w / 128) ** 0.5, atol=0,
                                       equal_nan=True)
        again = P.residual_norm(x, xp)
        assert all(_bitwise(a, b) for a, b in zip(again, got))
    torch.cuda.synchronize()


GRAPHS = {"ring": lambda: topology.ring(8), "star": lambda: topology.star(8),
          "complete": lambda: topology.complete(8), "torus": lambda: topology.torus2d(3, 4),
          "er": lambda: topology.erdos_renyi(9, 0.3, seed=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_cuda_neighbor_reduce_and_edge_flip_match_plain(cuda, family, dtype):
    """Kernels 14-15 bitwise their plain versions, masked and unmasked,
    at an arena width and a ragged one, a NaN entry included."""
    t = GRAPHS[family]()
    g = torch.Generator(device="cuda").manual_seed(7)
    for w in (384, 130):
        z = torch.randn(t.n_slots, w, generator=g, device=cuda)
        x = torch.randn(t.n, w, generator=g, device=cuda)
        z[0, 3] = float("nan")
        z, x = z.to(dtype), x.to(dtype)
        kw = dict(seg=t.src, first=t.first_flags(), sgn=t.sgn, n=t.n)
        indptr, sgn = (torch.as_tensor(a, device=cuda) for a in (t.indptr, t.sgn))
        assert _bitwise(P.neighbor_reduce(z, **kw), ref.neighbor_reduce_ref(z, indptr, sgn, t.n))
        rev, nbr = (torch.as_tensor(a, dtype=torch.int64, device=cuda) for a in (t.rev, t.nbr))
        for mask in (None, (torch.arange(t.n_slots, device=cuda) % 3 == 0).to(torch.int32)):
            got = P.edge_flip(z, x, 0.85, rev=t.rev, nbr=t.nbr, sgn=t.sgn, mask=mask)
            assert _bitwise(got, ref.edge_flip_ref(z, x, 0.85, rev, nbr, sgn, mask))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("topo", ["ring", "star", "complete", "er:0.5"])
def test_cuda_graph_rounds_match_cpu_and_count_launches(cuda, topo):
    """Three graph rounds on the card against the CPU (rtol = atol =
    1e-4): per colour phase one neighbor_reduce, one inner_loop_affine when
    data nodes fire, one edge_flip."""
    eta = 0.5 / _problems("cpu")[0].L
    cfg = FederatedConfig(algorithm="gpdmm_graph", topology=topo, inner_steps=3, eta=eta)
    counts = _card_vs_cpu(cuda, cfg, lambda p: p.oracle())
    t = pdmm_graph.topo_for(cfg, 8)
    phases = len(t.colors)
    data_phases = sum(int((c < t.n_data).any()) for c in t.colors)
    want = {k.name: 0 for k in P.KERNELS} | dict(
        neighbor_reduce=3 * phases, edge_flip=3 * phases, inner_loop_affine=3 * data_phases)
    assert counts == want


@pytest.mark.cuda
def test_cuda_residual_and_autotune_run_on_the_card(cuda):
    """``state_residual`` launches one residual_norm per 2-D buffer, the
    card's L_i agree with the CPU's, and an oracle that launches a kernel
    is refused as a jvp target by name."""
    prob, gprob = _problems(cuda)
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=3, eta="auto", use_arena=True)
    L_cpu = autotune.estimate_L(prob.oracle(), torch.zeros(64), 8, prob.batch())
    L_gpu = autotune.estimate_L(gprob.oracle(), torch.zeros(64, device=cuda), 8, gprob.batch())
    torch.testing.assert_close(torch.from_numpy(L_gpu), torch.from_numpy(L_cpu), rtol=1e-5,
                               atol=0)
    rc = autotune.resolve(cfg, gprob.oracle(), torch.zeros(64, device=cuda), 8, gprob.batch())
    opt = make(rc)
    s0 = opt.init(torch.zeros(64, device=cuda), 8)
    s1, _ = opt.round(s0, gprob.oracle(), gprob.batch())
    P.reset_launches()
    autotune.state_residual(s0, s1)
    assert P.launches()["residual_norm"] == 2  # lam_s and x_c; x_s is 1-D

    def kernel_grad(xa, b):
        return P.fused_update_arena(xa, xa, torch.zeros(xa.shape[1], device=cuda), None, 1.0,
                                    0.0)

    with pytest.raises(TypeError, match="kernel_grad.*jvp"):
        autotune.estimate_L(make_oracle(lambda p, b: p, grad_arena=lambda spec: kernel_grad),
                            torch.ones(128, device=cuda), 3, None, iters=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_model_kernels_match_plain(cuda, dtype):
    """Kernels 16-17 at small shapes: causal, windowed, grouped and suffix
    attention, the edges of the tensor-core tiles, each on its route; the
    recurrence at lengths around its chunk with a zero and a nonzero
    initial state."""
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    for (B, Sq, Sk, H, Hkv, hd, window) in ((2, 128, 128, 4, 4, 64, None),
                                            (1, 200, 200, 8, 2, 128, 48),
                                            (2, 64, 192, 4, 1, 32, None),
                                            # the edges of the tensor-core tiles, as
                                            # chip_smoke.py's FLASH_EDGES
                                            (2, 200, 1000, 8, 8, 128, None),
                                            (2, 200, 1000, 8, 8, 64, None),
                                            (2, 333, 333, 8, 2, 128, 40),
                                            (2, 200, 200, 8, 2, 64, None),
                                            (1, 77, 130, 4, 1, 80, 100),
                                            (1, 100, 100, 2, 2, 72, None)):
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
        k, v = (torch.randn(B, Sk, Hkv, hd, generator=g, device=cuda).to(dtype)
                for _ in range(2))
        off = Sk - Sq
        got = P.flash_attention(q, k, v, window=window, q_offset=off)
        want = ref.flash_attention_ref(q, k, v, torch.arange(off, Sk, device=cuda),
                                       torch.arange(Sk, device=cuda), window=window)
        assert rel(got, want) <= tol
        tc = dtype == torch.bfloat16 and hd % 16 == 0
        assert FA.last_route == ("wgmma" if tc else "cuda_cores")
    for S in (1, 63, 65, 100):
        for s0_zero in (True, False):
            r, k, v = (torch.randn(2, S, 3, 64, generator=g, device=cuda).to(dtype)
                       for _ in range(3))
            w = torch.rand(2, S, 3, 64, generator=g, device=cuda)
            u = torch.randn(3, 64, generator=g, device=cuda)
            s0 = (torch.zeros(2, 3, 64, 64, device=cuda) if s0_zero
                  else torch.randn(2, 3, 64, 64, generator=g, device=cuda))
            for a, b in zip(P.wkv6(r, k, v, w, u, s0), ref.wkv6_ref(r, k, v, w, u, s0)):
                assert rel(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [(torch.bfloat16, 128, "wgmma"),
                                            (torch.bfloat16, 48, "wgmma"),
                                            (torch.bfloat16, 72, "cuda_cores"),
                                            (torch.float32, 128, "cuda_cores")])
def test_cuda_flash_route_by_dtype(cuda, dtype, hd, route):
    """bf16 with hd a multiple of 16 runs on the tensor cores, f32 and other
    bf16 head dims on the CUDA cores; one launch counted on either route."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(1, 96, 2, hd, generator=g, device=cuda).to(dtype) for _ in range(3))
    P.reset_launches()
    got = P.flash_attention(q, k, v)
    assert FA.last_route == route and P.launches()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, torch.arange(96, device=cuda),
                                   torch.arange(96, device=cuda))
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())


@pytest.mark.cuda
def test_cuda_serve_launches_the_model_kernels(cuda):
    """The reduced models served on the card: one kernel per block on
    prefill, none per decode token."""
    from repro_torch.launch import serve

    for arch, kernel in (("olmo-1b", "flash_attention"), ("rwkv6-1.6b", "wkv6")):
        P.reset_launches()
        out = serve.run(arch, batch=2, prompt_len=64, new_tokens=3, quiet=True)
        assert torch.isfinite(out.logits).all()
        counts = P.launches()
        assert counts[kernel] == 2 and sum(counts.values()) == 2
