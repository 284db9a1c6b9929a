"""Federated training of every arch on the port, against the reference, at
the reduced configs on the CPU: one GPDMM round of each of the ten archs
(``tests/test_archs.py``'s ``test_smoke_train_round``, held to the
reference's round), MoE under ``vmap(grad)`` through both dispatches, the
dispatch gather's fixed-order backward, the RG-LRU recurrence's autograd
Function (``kernels.ops.LruScan``: its backward ``lru_scan_bwd`` and its
vmap rule) and the launcher on the MoE archs.

Tolerances:
  * one round's server parameters, f32, from the same parameters
    (``convert.model_params``) and batch: 1e-5 of each leaf's largest
    entry (the two sides' products and sums round alike up to order; the
    round's K = 2 steps at eta 0.05 carry that over), rwkv6-1.6b 5e-4 (its
    chunked recurrence's exps of cumulative log decays round differently
    in XLA and torch, 2e-4 in its gradient, tests/test_torch_train.py);
  * ``vmap(grad)`` against the per-client ``grad`` on the port: rtol 1e-5
    (the vmapped products batch the clients' rows; the integers of the
    dispatch are held exactly);
  * ``LruScan``'s backward: bitwise autograd of the plain recurrence
    (``ref.lru_ref``), whose backward multiplies and adds in the same
    rounded two-operand steps; against ``jax.grad`` of the reference's
    chunked associative scan, 1e-5 of each gradient's largest entry (the
    scan's products and sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import FederatedConfig as RefFederatedConfig
from repro.core import make as ref_make
from repro.kernels import ops as RO
from repro.models import build as ref_build
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import make
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import run as train_run
from repro_torch.models import build, moe as M

ARCH_NAMES = sorted(ARCHS)
ROUND_RTOL = {"rwkv6-1.6b": 5e-4}
ROUND_RTOL_DEFAULT = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs six workers on a
    few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, key, B=2, S=24):
    """tests/test_archs.py's batch: tokens (B, [K,] S) as their own
    targets, and a vision arch's patches."""
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks > 1 else (B, S)
    toks = jax.random.randint(key, shape, 0, cfg.vocab_size)
    b = {"tokens": toks, "targets": toks}
    if cfg.frontend == "vision":
        b["patches"] = jax.random.normal(jax.random.fold_in(key, 9),
                                         (B, cfg.n_prefix_tokens, cfg.frontend_dim))
    return b


def _torch_tree(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_round_matches_reference(name):
    """One GPDMM round (K = 2, eta 0.05, m = 2) of the reduced config in
    f32 through ``fed.round`` over ``vmap(grad(loss))``, from the
    reference's parameters and two clients' batches: the new server
    parameters against the reference's jitted round; the invariant (25)
    and every new state leaf finite, as ``test_smoke_train_round`` checks
    the reference."""
    key = jax.random.key(0)
    rc = dataclasses.replace(REF_ARCHS[name].reduced(), dtype="float32")
    pc = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    rm, pm = ref_build(rc), build(pc)
    rp = rm.init(key)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), _batch(rc, jax.random.fold_in(key, 1)),
                         _batch(rc, jax.random.fold_in(key, 2)))
    rfed = ref_make(RefFederatedConfig(algorithm="gpdmm", inner_steps=2, eta=0.05))

    def ref_grad(p, b):
        return jax.grad(lambda q: rm.loss(q, b)[0])(p)

    rstate, rmet = jax.jit(lambda s, b: rfed.round(s, ref_grad, b))(rfed.init(rp, 2), batch)

    fed = make(FederatedConfig(algorithm="gpdmm", inner_steps=2, eta=0.05))

    def grad(p, b):
        return torch.func.grad(lambda q: pm.loss(q, b)[0])(p)

    state, met = fed.round(fed.init(convert.model_params(rp, "cpu"), 2), grad,
                           _torch_tree(batch))
    assert float(met["lam_sum_norm"]) < 1e-2, name
    for leaf in T.leaves(state):
        if leaf.is_floating_point():
            assert bool(torch.isfinite(leaf.float()).all()), name
    rtol = ROUND_RTOL.get(name, ROUND_RTOL_DEFAULT)
    want, got = jax.tree.leaves(rfed.server_params(rstate)), T.leaves(fed.server_params(state))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a, np.float32)
        scale = max(1e-12, float(np.abs(a).max()))
        np.testing.assert_allclose(b.float().numpy() / scale, a / scale, atol=rtol, err_msg=name)
    np.testing.assert_allclose(float(met["client_drift"]), float(rmet["client_drift"]),
                               rtol=max(rtol, 1e-5))


# ---------------------------------------------------------------------------
# MoE under vmap(grad)
# ---------------------------------------------------------------------------

def _slots_onehot(e, E, cap, counts=None):
    """The reference's slot rule in numpy: the running one-hot count."""
    onehot = np.eye(E, dtype=np.int64)[e]
    pos = ((np.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    if counts is not None:
        pos = pos + counts[e]
    return np.where(pos < cap, pos, cap), onehot.sum(0)


@pytest.mark.parametrize("cap", [3, 7, 40])
def test_dispatch_integers_under_vmap(cap):
    """``_slots``, ``_count`` and ``_table`` give the reference's integers
    on each client's row, vmapped over clients or not (no in-place write
    into a tensor made outside the vmap), with and without carried
    counts, drops included."""
    rng = np.random.default_rng(cap)
    E, n, m = 5, 30, 3
    e = torch.from_numpy(rng.integers(0, E, (m, n)))
    counts = torch.from_numpy(rng.integers(0, 3, (m, E)))
    got_s, got_c = torch.func.vmap(lambda a, c: M._slots(a, E, cap, c))(e, counts)
    got_t = torch.func.vmap(lambda a, s: M._table(E, cap, a, s, torch.arange(n), n))(e, got_s)
    for i in range(m):
        want_s, want_c = _slots_onehot(e[i].numpy(), E, cap, counts[i].numpy())
        np.testing.assert_array_equal(got_s[i].numpy(), want_s)
        np.testing.assert_array_equal(got_c[i].numpy(), want_c)
        np.testing.assert_array_equal(M._slots(e[i], E, cap, counts[i])[0].numpy(), want_s)
        table = np.full((E, cap + 1), n)
        table[e[i].numpy(), want_s] = np.arange(n)
        np.testing.assert_array_equal(got_t[i].numpy(), table[:, :cap])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_slot"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
def test_moe_vmap_grad_equals_per_client_grad(arch, fused):
    """``vmap(grad(loss))`` over two clients through each dispatch (the
    fused one and the per-slot loop, at the training capacity) equals each
    client's own ``grad``, and its loss and ``moe_aux`` each
    client's: the vmapped integers route as the unbatched ones."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              moe_fused_dispatch=fused)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16), generator=g)
    batch = {"tokens": toks, "targets": toks}

    def grad(b):
        return torch.func.grad(lambda p: model.loss(p, b)[0])(params)

    got = torch.func.vmap(grad)(batch)
    aux = torch.func.vmap(lambda b: model.loss(params, b)[1]["moe_aux"])(batch)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        want = grad(b)
        for x, y in zip(T.leaves(got), T.leaves(want)):
            torch.testing.assert_close(x[i], y, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aux[i], model.loss(params, b)[1]["moe_aux"], rtol=1e-6,
                                   atol=0)


def test_dispatch_gather_backward_sums_in_expert_order():
    """``_DispatchGather``'s backward is a token's row gradients added in
    ascending expert order, dropped rows left out: in bf16 (where the
    order shows) it equals that sum written out, and in f32 autograd of
    the plain gather within rounding; the sentinel row gets nothing."""
    rng = np.random.default_rng(0)
    T_, D, E, cap, k = 6, 8, 4, 3, 2
    topi = torch.from_numpy(np.stack([rng.choice(E, k, replace=False) for _ in range(T_)]))
    slot, _ = M._slots(topi.reshape(-1), E, cap)
    fidx = M._table(E, cap, topi.reshape(-1), slot, torch.arange(T_ * k), T_ * k)
    tok = torch.where(fidx < T_ * k, fidx // k, T_)
    e_sorted, order = torch.sort(topi, dim=-1, stable=True)
    slot_sorted = torch.gather(slot.reshape(T_, k), 1, order)
    kept = slot_sorted < cap
    assert not bool(kept.all()), "the case drops no token"
    rows = e_sorted * cap + torch.clamp_max(slot_sorted, cap - 1)
    for dt in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(rng.standard_normal((T_, D)).astype(np.float32)).to(dt)
        gy = torch.from_numpy(rng.standard_normal((E, cap, D)).astype(np.float32)).to(dt)
        x = xt.clone().requires_grad_(True)
        y = M._DispatchGather.apply(x, tok, rows, kept)
        assert torch.equal(y, torch.cat([xt, xt.new_zeros(1, D)])[tok])
        (got,) = torch.autograd.grad(y, x, gy)
        want = torch.zeros(T_, D, dtype=dt)
        flat = gy.reshape(E * cap, D)
        for t in range(T_):
            for j in range(k):
                if kept[t, j]:
                    want[t] = want[t] + flat[rows[t, j]]
        assert torch.equal(got, want)
        if dt == torch.float32:
            x2 = xt.clone().requires_grad_(True)
            plain = torch.cat([x2, x2.new_zeros(1, D)])[tok]
            (g2,) = torch.autograd.grad(plain, x2, gy)
            torch.testing.assert_close(got, g2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
def test_launcher_trains_moe_archs(arch):
    """``launch.train.run`` on the CPU runs the MoE archs (the fused
    dispatch for deepseek, the per-slot loop for maverick): finite rows,
    the invariant at its rounding scale; two runs from one seed agree."""
    kw = dict(reduced=True, steps=2, k=2, m=2, per_client_batch=2, seq_len=16, eta=0.05,
              log_every=1, device="cpu")
    a, b = train_run(arch, **kw), train_run(arch, **kw)
    assert [r["round"] for r in a] == [1, 2]
    for r in a:
        assert all(np.isfinite(v) for v in r.values())
        assert r["lam_sum_norm"] < 1e-3
    for x, y in zip(a, b):
        for key in x:
            np.testing.assert_allclose(x[key], y[key], rtol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the RG-LRU recurrence's Function
# ---------------------------------------------------------------------------

def _lru_inputs(seed, *lead, S=37, D=6):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.random((*lead, S, D)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((*lead, S, D)).astype(np.float32))
    return a, b


@pytest.mark.parametrize("S", [1, 16, 37])
def test_lru_scan_function_backward_is_autograd_of_plain(S):
    """``LruScan``'s backward (``lru_scan_bwd``'s plain version on the
    CPU) bitwise autograd of ``ref.lru_ref``, with gradients into both
    outputs and into y alone (h_last's gradient then zero)."""
    B, D = 2, 6
    a, b = _lru_inputs(S, B, S=S, D=D)
    rng = np.random.default_rng(100 + S)
    h0, dh = (torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)) for _ in range(2))
    dy = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    for with_h in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        y, h = ops.LruScan.apply(*ins, True)
        outs, grads = ((y, h), (dy, dh)) if with_h else ((y,), (dy,))
        got = torch.autograd.grad(outs, ins, grads)
        ins2 = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        y2, h2 = ref.lru_ref(*ins2)
        assert torch.equal(y, y2) and torch.equal(h, h2)
        want = torch.autograd.grad((y2, h2) if with_h else (y2,), ins2, grads)
        for x, w in zip(got, want):
            assert torch.equal(x, w)


def test_lru_scan_function_vmap_grad():
    """``vmap(grad)`` through ``LruScan`` (its vmap rule folding the
    clients into the batch, h0 unbatched: the rule expands it) equals
    ``vmap(grad)`` of the plain recurrence bitwise, and ``jax.grad`` of the
    reference's chunked associative scan (``ops.lru_scan``) at 1e-5."""
    m, B, S, D = 3, 2, 40, 5
    a, b = _lru_inputs(7, m, B, S=S, D=D)
    rng = np.random.default_rng(8)
    h0 = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    cy = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    ch = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

    def loss(fn):
        def f(a, b, h0):
            y, h = fn(a, b, h0)
            return (y * cy).sum() + (h * ch).sum()
        return f

    args = (0, 1, 2)
    got = torch.func.vmap(torch.func.grad(loss(lambda *t: ops.LruScan.apply(*t, True)),
                                          argnums=args), in_dims=(0, 0, None))(a, b, h0)
    want = torch.func.vmap(torch.func.grad(loss(ref.lru_ref), argnums=args),
                           in_dims=(0, 0, None))(a, b, h0)
    for x, w in zip(got, want):
        assert x.shape == w.shape and torch.equal(x, w)

    def ref_loss(a, b, h0):
        y, h = RO.lru_scan(a, b, h0, chunk=8)
        return (y * jnp.asarray(cy.numpy())).sum() + (h * jnp.asarray(ch.numpy())).sum()

    jg = jax.vmap(jax.grad(ref_loss, argnums=args), in_axes=(0, 0, None))(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jnp.asarray(h0.numpy()))
    for x, w in zip(got, jg):
        w = np.asarray(w)
        scale = max(1e-12, float(np.abs(w).max()))
        np.testing.assert_allclose(x.numpy() / scale, w / scale, atol=1e-5)


def test_lru_scan_function_without_keep_has_no_backward():
    """A transform without a gradient runs ``LruScan`` with ``keep`` off:
    the forward is the plain one, nothing is saved, and a backward raises."""
    a, b = _lru_inputs(3, 1)
    h0 = torch.zeros(1, 6)
    y, h = torch.func.vmap(lambda a, b: ops.LruScan.apply(a, b, h0, False))(a[None], b[None])
    y2, h2 = ref.lru_ref(a, b, h0)
    assert torch.equal(y[0], y2) and torch.equal(h[0], h2)
    x = a.clone().requires_grad_(True)
    y, _ = ops.LruScan.apply(x, b, h0, False)
    with pytest.raises(RuntimeError, match="without keep"):
        y.sum().backward()


def test_cpu_lru_scan_skips_the_function(monkeypatch):
    """On the CPU ``ops.lru_scan`` calls the plain version directly, so
    autograd differentiates the plain ops; no Function on the path."""
    def refuse(*a, **k):
        raise AssertionError("a Function on the CPU path")

    monkeypatch.setattr(ops.LruScan, "apply", refuse)
    a, b = _lru_inputs(4, 1)
    a.requires_grad_(True)
    y, _ = ops.lru_scan(a, b, torch.zeros(1, 6))
    y.sum().backward()
    assert a.grad is not None
