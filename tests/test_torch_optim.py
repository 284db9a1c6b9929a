"""The local optimizers and schedules (``repro_torch.optim``) against the
reference's (``src/repro/optim``) on the CPU, over a few steps of seeded
gradients, for f32 and bf16 parameter trees.

Both sides do the same ops in the same order: a Python coefficient weakly
typed against its tensor (bf16 leaves round it first), f32 moments, b1^t and
b2^t as f32 powers, a schedule's f32 rate promoting a bf16 gradient to f32.
So SGD's parameters, updates and momentum after every step, and Adam's step
and moments, are held bitwise.  Adam's update takes an f32 square root,
which XLA's CPU code does not always round as torch does (an ulp apart at
eps 1e-6): its updates and parameters are held to 1e-6 of each leaf's
largest entry in f32, and to one bf16 step (2^-7 of it) in bf16, where an
ulp of the f32 update can carry a bf16 rounding over.
``clip_by_global_norm``'s norm sums each leaf's squares in another
order (``jnp.sum`` against ``torch.sum``): rtol 1e-6, the clipped leaves
then within one rounding of that scale (rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
OPTIMIZERS = {
    "sgd": lambda M: M.sgd(0.1),
    "sgd_momentum": lambda M: M.sgd(0.1, momentum=0.9),
    "sgd_warmup": lambda M: M.sgd(M.linear_warmup(0.1, 3), momentum=0.5),
    "adam": lambda M: M.adam(1e-2),
    "adam_decay": lambda M: M.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.01),
    "adam_cosine": lambda M: M.adam(M.cosine(1e-2, 10, warmup_steps=2)),
    "adam_constant": lambda M: M.adam(M.constant(1e-3)),
}
STEPS = 5


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)],
            "c": {"d": rng.standard_normal((2, 2)).astype(np.float32)}}


def _both(tree, dt):
    tdt, jdt = DTYPES[dt]
    return (jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), tree),
            jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), tree))


def _equal(j, t, rtol=0.0):
    """The trees leaf by leaf: the same dtypes, and values bitwise or, with
    ``rtol``, within rtol of each leaf's largest entry."""
    jl, tl = jax.tree.leaves(j), jax.tree.leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), (a.dtype, b.dtype)
        a = np.asarray(a, np.float32)
        if rtol:
            scale = max(1e-30, float(np.abs(a).max()))
            np.testing.assert_allclose(b.float().numpy() / scale, a / scale, atol=rtol)
        else:
            np.testing.assert_array_equal(a, b.float().numpy())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, dt):
    """init, then STEPS of update and apply_updates: every update, the
    state (step, moments) and the parameters against the reference's
    (bitwise, but Adam's updates and parameters: see the module doc)."""
    rtol = 0.0 if name.startswith("sgd") else (1e-6 if dt == "f32" else 2.0 ** -7)
    rng = np.random.default_rng(0)
    jp, tp = _both(_tree(rng), dt)
    jo, to = OPTIMIZERS[name](R), OPTIMIZERS[name](P)
    js, ts = jo.init(jp), to.init(tp)
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    for _ in range(STEPS):
        jg, tg = _both(_tree(rng), dt)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        _equal(ju, tu, rtol)
        jp, tp = R.apply_updates(jp, ju), P.apply_updates(tp, tu)
        _equal(jp, tp, rtol)
        assert int(ts["step"]) == int(js["step"])
        for k in ("mom", "mu", "nu"):
            if js.get(k) is not None:
                _equal(js[k], ts[k])


@pytest.mark.parametrize("name", ["constant", "linear_warmup", "cosine", "cosine_warmup"])
def test_schedules_match_reference(name):
    """Each schedule's f32 rate at steps 0..12 (past warm-up and the end):
    bitwise the reference's, but for the cosine's own rounding (rtol 1e-6:
    XLA's and torch's f32 cos)."""
    make = {"constant": lambda M: M.constant(0.3),
            "linear_warmup": lambda M: M.linear_warmup(0.3, 4),
            "cosine": lambda M: M.cosine(0.3, 10),
            "cosine_warmup": lambda M: M.cosine(0.3, 10, 3, 0.2)}
    jf, tf = make[name](R), make[name](P)
    for step in range(13):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        if name.startswith("cosine"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(dt, max_norm):
    """The global norm of f32 squares and the clipped leaves (a clipping
    and a non-clipping bound); a bf16 leaf comes back f32, as the
    reference's strong f32 scale promotes it."""
    rng = np.random.default_rng(1)
    jg, tg = _both(_tree(rng), dt)
    jc, jn = R.clip_by_global_norm(jg, max_norm)
    tc, tn = P.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_state_follows_the_parameters_device():
    """The state's tensors lie on the parameters' device (meta here stands
    in for the card's), the step an int32 tensor there."""
    p = {"w": torch.empty(3, 2, device="meta"), "b": torch.empty(2, device="meta",
                                                                  dtype=torch.bfloat16)}
    for opt in (P.adam(1e-3), P.sgd(0.1, momentum=0.9)):
        s = opt.init(p)
        assert s["step"].device.type == "meta" and s["step"].dtype == torch.int32
        for k in ("mu", "nu", "mom"):
            if s.get(k) is not None:
                assert all(t.device.type == "meta" for t in jax.tree.leaves(s[k]))
    s = P.adam(1e-3).init(p)
    assert s["mu"]["b"].dtype == torch.float32
