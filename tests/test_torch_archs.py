"""The ten architectures in the port, on the CPU: ``tests/test_archs.py``'s
checks (forward shapes, decode against a full forward, the fused MoE
dispatch against the per-slot loop, parameter counts, the ring cache
wrapping around), and the pieces this slice ports held against the
reference: ``lru_scan`` and its plain version, kernel 16's plain version at
the MLA, recurrentgemma and stablelm head dims against the reference's
Pallas kernel in interpret mode, the naive attention oracle, MoE top-k
ties, the bf16 MoE decode's drift from its prefill against the
reference's own, the cache specs, the served logits for a seed, the
hot-swap watcher, and the guards that keep a gradient away from kernels
without a backward.

Inputs come from numpy with a seed (or the reference's key for its own
weights, carried across with ``convert.model_params``).  Tolerances,
relative to the largest magnitude of the reference value: f32 1e-5 (sums in
another order); the port's own decode against its forward 2e-2, as
``tests/test_archs.py`` holds the reference's (f32 reduced configs); the
fused dispatch against the loop atol = rtol = 1e-5, as there.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels import flash_attention as RFA
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.launch import serve as ref_serve
from repro.models import build as ref_build
from repro.models import moe as RM
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core import prng
from repro_torch.core import tree_util as T
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as P, ref
from repro_torch.launch import serve
from repro_torch.models import build, moe as M
from repro_torch.models.model import forward

ARCH_NAMES = sorted(ARCHS)
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs six workers on a
    few cores, where torch's thread pools would oversubscribe them (the
    port's eager ops, the keyed draws above all, slow down many times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _batch(cfg, n, seed=0):
    """Tokens (B, [K,] n) and, for a vision frontend, patches, from numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, n) if cfg.n_codebooks > 1 else (B, n)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).long()}
    if cfg.frontend == "vision":
        b["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    return b


def _init(cfg, seed=0):
    return build(cfg).init(torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_shapes(name):
    cfg = get_arch(name).reduced()
    assert cfg.n_layers <= 4 and cfg.d_model <= 512 and cfg.n_experts <= 4
    with torch.no_grad():
        logits = build(cfg).apply(_init(cfg), _batch(cfg, S))
    s_total = S + (cfg.n_prefix_tokens if cfg.frontend == "vision" else 0)
    want = ((B, S, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks > 1
            else (B, s_total, cfg.vocab_size))
    assert tuple(logits.shape) == want and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_full_forward(name):
    """A decode step after a drop-free prefill of S - 1 tokens gives the
    last logits of a drop-free prefill of all S (and, without routed
    experts, of the train-mode forward) within 2e-2; the cache has the
    layout and the logical axes ``cache_shapes`` and ``cache_specs`` give."""
    cfg = get_arch(name).reduced()
    wo = 16 if cfg.sw_variant_window else None
    m = build(cfg, window_override=wo)
    params = _init(cfg)
    full_b = _batch(cfg, S)
    pre_b = dict(full_b, tokens=full_b["tokens"][..., :S - 1])
    last = full_b["tokens"][..., S - 1:]
    cap = cfg.n_prefix_tokens * (cfg.frontend == "vision") + S + 2
    with torch.no_grad():
        want, _ = m.prefill(params, full_b, cap, exact_moe=True)
        _, cache = m.prefill(params, pre_b, cap, exact_moe=True)
        pos = int(cache["pos"])
        got, new_cache = m.decode(params, cache, last)
        assert _rel(got.numpy(), want.numpy()) < 2e-2
        assert int(new_cache["pos"]) == pos + 1
        if "moe" not in cfg.block_pattern:
            full, _, _ = forward(cfg, params, full_b, mode="train", window_override=wo)
            assert _rel(got.numpy(), full[:, -1].numpy()) < 2e-2
    shapes = m.cache_shapes(B, cap)
    assert T.paths(shapes) == T.paths(new_cache)
    for w, g in zip(T.leaves(shapes), T.leaves(new_cache)):
        assert w.shape == g.shape and w.dtype == g.dtype
    specs = m.cache_specs()
    for w, axes in zip(T.leaves(shapes["layers"]), jax.tree.leaves(
            specs["layers"], is_leaf=lambda t: isinstance(t, tuple))):
        assert len(axes) == w.ndim


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_reference(name):
    """``cache_specs``: the reference's logical axes, leaf for leaf."""
    rcfg, pcfg = REF_ARCHS[name].reduced(), get_arch(name).reduced()
    wo = 16 if pcfg.sw_variant_window else None
    assert build(pcfg, window_override=wo).cache_specs() == \
        ref_build(rcfg, window_override=wo).cache_specs()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
def test_moe_fused_dispatch_matches_loop(name):
    """The fused dispatch agrees with the per-slot loop at full capacity
    (identical routing, one combine), and runs under capacity pressure."""
    cfg = get_arch(name).reduced()
    params = M.moe_init(M.L.as_keys(torch.Generator().manual_seed(0)), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    out_loop, aux_loop = M.moe_apply(cfg, params, x, full_capacity=True, fused=False)
    out_fused, aux_fused = M.moe_apply(cfg, params, x, full_capacity=True, fused=True)
    np.testing.assert_allclose(out_fused.numpy(), out_loop.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux_fused), float(aux_loop), rtol=1e-6)
    out_c, _ = M.moe_apply(cfg, params, x, full_capacity=False, fused=True)
    assert bool(torch.isfinite(out_c).all())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("full_capacity", [False, True])
def test_moe_matches_reference_under_router_ties(fused, full_capacity):
    """A router whose columns repeat in pairs, so that every token's gates
    tie exactly in pairs: the port picks the reference's experts (ties
    toward the lower index, ``jax.lax.top_k``'s order) and gives its output
    and aux loss, drops at capacity included (T = 32 tokens, k = 2 of 4
    experts: capacity 20)."""
    rcfg = dataclasses.replace(REF_ARCHS["deepseek-v2-lite-16b"].reduced(), top_k=2)
    pcfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(), top_k=2)
    rp, _ = RM.moe_init(jax.random.key(3), rcfg, jnp.float32)
    rp = dict(rp, router=jnp.repeat(rp["router"][:, ::2], 2, axis=1))  # columns 2i, 2i + 1 equal
    pp = convert.model_params(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
    want, want_aux = RM.moe_apply(rcfg, rp, jnp.asarray(x), full_capacity=full_capacity,
                                  fused=fused)
    got, got_aux = M.moe_apply(pcfg, pp, torch.from_numpy(x), full_capacity=full_capacity,
                               fused=fused)
    assert _rel(got.numpy(), want) < 1e-5
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    gates = np.array(jax.nn.softmax(jnp.asarray(x.reshape(-1, rcfg.d_model)) @ rp["router"]))
    _, want_idx = jax.lax.top_k(jnp.asarray(gates), 2)
    _, got_idx = M.top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert (gates[:, 0::2] == gates[:, 1::2]).all()  # the ties are exact


def _ref_routed(fn):
    """``fn(*args)`` jitted, with the reference's ``jax.lax.top_k`` replaced
    while it traces (its layers unrolled, one call a MoE block): given
    ``routes``, one (T, k) array a call, it takes those experts, their own
    gates as the values; without, it returns the choices it made beside
    ``fn``'s result."""
    plain = jax.lax.top_k

    def traced(*args, routes=None):
        made, given = [], iter(routes or ())

        def top_k(gates, k):
            if routes is None:
                vals, idx = plain(gates, k)
                made.append(idx)
                return vals, idx
            idx = next(given)
            return jnp.take_along_axis(gates, idx, -1), idx
        jax.lax.top_k = top_k
        try:
            return fn(*args), made
        finally:
            jax.lax.top_k = plain
    return jax.jit(traced)


def _port_routed(monkeypatch, routes):
    """The port's ``top_k`` taking ``routes(call)``'s experts, its gates as
    the values."""
    calls = itertools.count()

    def top_k(gates, k):
        idx = routes(next(calls))
        return gates.gather(-1, idx), idx
    monkeypatch.setattr(M, "top_k", top_k)


@pytest.mark.parametrize("layers", [4, 27])
def test_moe_bf16_decode_drift_is_the_references(monkeypatch, layers):
    """deepseek-v2-lite-16b in bf16 at a reduced width and at 4 layers and
    its full 27: the last of 4 decode steps after a 32-token drop-free
    prefill, against a drop-free prefill of all 36 tokens, every MoE block
    routed on both sides as the reference's extended prefill routed the
    token (so no near-tied router row flips an expert).  In bf16 the two
    paths round the hidden states at other points and the difference grows
    with depth; the reference's own decode drifts from its prefill as the
    port's does: over 4 seeds of weights and tokens, the port's mean drift
    is within 1.5x the reference's.  Readings printed (``-s``)."""
    Bq, S0, N = 2, 32, 4
    cfgs = [dataclasses.replace(c["deepseek-v2-lite-16b"].reduced(), n_layers=layers,
                                dtype="bfloat16", scan_layers=False)
            for c in (REF_ARCHS, ARCHS)]
    rm, pm = ref_build(cfgs[0]), build(cfgs[1])
    r_init = jax.jit(rm.init)
    r_pre = _ref_routed(lambda p, t: rm.prefill(p, {"tokens": t}, S0 + N, exact_moe=True)[0])
    r_prompt = _ref_routed(lambda p, t: rm.prefill(p, {"tokens": t}, S0 + N, exact_moe=True))
    r_dec = _ref_routed(rm.decode)
    drift = {"ref": [], "port": [], "port_vs_ref": []}
    for seed in range(4):
        rp = r_init(jax.random.key(seed))
        pp = convert.model_params(jax.tree.map(np.asarray, rp), "cpu")
        tok = np.random.default_rng(seed).integers(0, cfgs[0].vocab_size,
                                                   (Bq, S0 + N)).astype(np.int32)
        want, made = r_pre(rp, jnp.asarray(tok))
        routes = [np.array(r).reshape(Bq, S0 + N, -1) for r in made]
        n_moe = len(routes)

        def rows(call):  # the prompt's prefill, then one decode step a token
            step, r = divmod(call, n_moe)
            r = routes[r][:, :S0] if step == 0 else routes[r][:, S0 + step - 1]
            return np.ascontiguousarray(r).reshape(-1, r.shape[-1])
        (got, cache), _ = r_prompt(rp, jnp.asarray(tok[:, :S0]),
                                   routes=[jnp.asarray(rows(c)) for c in range(n_moe)])
        for i in range(N):
            (got, cache), _ = r_dec(rp, cache, jnp.asarray(tok[:, S0 + i:S0 + i + 1]), routes=[
                jnp.asarray(rows(c)) for c in range((i + 1) * n_moe, (i + 2) * n_moe)])
        pt = torch.from_numpy(tok).long()
        with torch.no_grad():
            _port_routed(monkeypatch, lambda call: torch.from_numpy(
                routes[call].reshape(-1, routes[call].shape[-1])).long())
            p_want, _ = pm.prefill(pp, {"tokens": pt}, S0 + N, exact_moe=True)
            _port_routed(monkeypatch, lambda call: torch.from_numpy(rows(call)).long())
            p_got, p_cache = pm.prefill(pp, {"tokens": pt[:, :S0]}, S0 + N, exact_moe=True)
            for i in range(N):
                p_got, p_cache = pm.decode(pp, p_cache, pt[:, S0 + i:S0 + i + 1])
        want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
        drift["ref"].append(_rel(got, want))
        drift["port"].append(_rel(p_got.float().numpy(), p_want.float().numpy()))
        drift["port_vs_ref"].append(_rel(p_got.float().numpy(), got))
    print(f"\ndeepseek reduced width, {layers} layers, bf16, routes forced: decode vs prefill "
          f"rel error, seeds 0-3: reference {drift['ref']}, port {drift['port']}; "
          f"port's decode vs the reference's {drift['port_vs_ref']}")
    assert np.mean(drift["port"]) <= 1.5 * np.mean(drift["ref"])


def test_moe_capacity_is_the_references():
    for T_, k, E, full in ((4096, 6, 64, False), (32, 2, 4, False), (7, 1, 128, False),
                           (4224, 6, 64, True)):
        cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b"), top_k=k, n_experts=E)
        want = T_ if full else max(1, int((k * T_ / E) * RM.CAPACITY_FACTOR))
        assert M.capacity(cfg, T_, full) == want


def test_param_counts_match_published():
    """The reference's published counts on the port's configs, and each
    reduced init's leaf sizes summed equal to the reference's."""
    expect = {"llama3-8b": 8.0e9, "yi-34b": 34.4e9, "olmo-1b": 1.18e9,
              "deepseek-v2-lite-16b": 15.7e9, "musicgen-large": 3.3e9, "stablelm-12b": 12.1e9}
    for name, n in expect.items():
        assert abs(ARCHS[name].param_count() - n) / n < 0.06, name
    l4 = ARCHS["llama4-maverick-400b-a17b"]
    assert 3.5e11 < l4.param_count() < 4.5e11
    assert 1.0e10 < l4.active_param_count() < 2.0e10
    for name in ARCH_NAMES:
        want = jax.eval_shape(ref_build(REF_ARCHS[name].reduced()).init, jax.random.key(0))
        got = _init(get_arch(name).reduced())
        assert sum(t.numel() for t in T.leaves(got)) == sum(
            int(np.prod(w.shape)) for w in jax.tree.leaves(want)), name


def test_ring_cache_wraparound():
    """Sliding-window decode stays with the full forward after the ring
    wraps (pos > W): recurrentgemma's local blocks with W = 8, 12 tokens
    decoded past an 8-token prefill."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(), window=8)
    m = build(cfg)
    params = _init(cfg)
    toks = _batch(cfg, 20)["tokens"][:1]
    with torch.no_grad():
        _, cache = m.prefill(params, {"tokens": toks[:, :8]}, 22)
        for t in range(8, 20):
            lg, cache = m.decode(params, cache, toks[:, t:t + 1])
        full, _, _ = forward(cfg, params, {"tokens": toks}, mode="train")
    assert _rel(lg.numpy(), full[:, -1].numpy()) < 2e-2


@pytest.mark.parametrize("S,chunk", [(24, 8), (512, 512), (1024, 512), (64, 16), (1, 1)])
def test_lru_scan_matches_reference(S, chunk):
    """``ops.lru_scan`` (the plain sequential recurrence on the CPU) against
    the reference's chunked associative scan at chunk edges and its
    sequential ``lru_ref``, a in (0, 1) as the RG-LRU's decays, h0 != 0."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 40)).astype(np.float32)
    b = rng.standard_normal((2, S, 40)).astype(np.float32)
    h0 = rng.standard_normal((2, 40)).astype(np.float32)
    y, h = P.lru_scan(*(torch.from_numpy(t) for t in (a, b, h0)))
    ry, rh = RO.lru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=chunk)
    sy, sh = RR.lru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    for got, want in ((y, ry), (h, rh), (y, sy), (h, sh)):
        assert _rel(got.numpy(), want) < 1e-5
    y2, h2 = ref.lru_ref(*(torch.from_numpy(t) for t in (a, b, h0)))
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("case", [
    (1, 64, 4, 4, 192, 128, None),  # deepseek's MLA: hd 192, vd 128
    (1, 64, 4, 1, 256, 256, 24),  # recurrentgemma: one kv head, hd 256, a window
    (1, 64, 4, 2, 160, 160, None),  # stablelm: hd 160
])
def test_flash_attention_ref_at_new_head_dims_matches_pallas(case):
    """Kernel 16's plain version at the head dims this slice serves against
    the reference's Pallas kernel, interpreted on the CPU, and both
    oracles (the naive ``attention_ref``) against the reference's."""
    Bq, Sq, H, Hkv, hd, vd, window = case
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, Hkv, vd)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    want = RFA.flash_attention_pallas(*(jnp.asarray(t) for t in (q, k, v)), causal=True,
                                      window=window, interpret=True)
    tq, tk, tv, tp = (torch.from_numpy(t) for t in (q, k, v, pos))
    got = P.flash_attention(tq, tk, tv, causal=True, window=window)
    assert tuple(got.shape) == (Bq, Sq, H, vd)
    assert _rel(got.numpy(), want) < 1e-5
    naive = ref.attention_ref(tq, tk, tv, tp, tp, causal=True, window=window)
    ref_naive = RR.attention_ref(*(jnp.asarray(t) for t in (q, k, v, pos, pos)), causal=True,
                                 window=window)
    assert _rel(naive.numpy(), ref_naive) < 1e-5 and _rel(naive.numpy(), want) < 1e-5


def test_attention_ref_empty_slots_and_fully_masked_rows():
    """The naive oracle's -1 slots and rows with no valid key (0), as the
    reference's."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 3, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 5, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 5, 1, 4)).astype(np.float32)
    q_pos = np.array([0, 3, 4], np.int32)
    k_pos = np.array([-1, 2, 3, -1, 4], np.int32)
    for window in (None, 1):
        want = RR.attention_ref(*(jnp.asarray(t) for t in (q, k, v, q_pos, k_pos)),
                                window=window)
        got = ref.attention_ref(*(torch.from_numpy(t) for t in (q, k, v, q_pos, k_pos)),
                                window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not np.asarray(want)[0, 0].any()  # no valid key for query 0


def test_served_logits_match_the_reference_pipeline():
    """``serve.run`` on reduced llava-next (f32): its weights, prompts,
    patches and greedy tokens are the reference's for the same seed (the
    reference's ``serve.run`` generates the same tokens), and its last
    logits match the reference's prefill and decode on them within 1e-5."""
    arch, seed = "llava-next-mistral-7b", 3
    got = serve.run(arch, batch=2, prompt_len=12, new_tokens=3, seed=seed, device="cpu",
                    quiet=True)
    want_tokens = np.asarray(ref_serve.run(arch, batch=2, prompt_len=12, new_tokens=3,
                                           seed=seed))
    np.testing.assert_array_equal(got.tokens.numpy(), want_tokens)
    rcfg = REF_ARCHS[arch].reduced()
    rm = ref_build(rcfg)
    key = jax.random.key(seed)
    rp = rm.init(key)
    b = {"tokens": jax.random.randint(key, (2, 12), 0, rcfg.vocab_size),
         "patches": jax.random.normal(jax.random.fold_in(key, 1),
                                      (2, rcfg.n_prefix_tokens, rcfg.frontend_dim))}
    np.testing.assert_array_equal(got.prompts.numpy(), np.asarray(b["tokens"]))
    np.testing.assert_allclose(got.batch["patches"].numpy(), np.asarray(b["patches"]),
                               atol=2e-5, rtol=1e-5)  # erfinv's few f32 roundings
    for want, leaf in zip(jax.tree.leaves(rp), T.leaves(got.params)):
        assert _rel(convert.to_numpy(leaf), want) < 1e-4
    logits, cache = jax.jit(lambda p, bb: rm.prefill(p, bb, 15 + rcfg.n_prefix_tokens))(rp, b)
    dec = jax.jit(rm.decode)
    for i in range(3):
        logits, cache = dec(rp, cache, jnp.asarray(want_tokens)[:, i:i + 1])
    assert _rel(got.logits.numpy(), logits) < 1e-5


def test_served_batch_is_the_references_for_vision_and_codebooks():
    """The prompts of a codebook arch and the patches of a vision arch:
    ``prng``'s draws of the reference's shapes from the same key."""
    key = jax.random.key(4)
    for arch in ("musicgen-large", "llava-next-mistral-7b"):
        cfg = get_arch(arch).reduced()
        b = serve.prompt_batch(cfg, prng.key(4), 2, 10, "cpu")
        shape = (2, cfg.n_codebooks, 10) if cfg.n_codebooks > 1 else (2, 10)
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(
            jax.random.randint(key, shape, 0, cfg.vocab_size)))
        if cfg.frontend == "vision":
            want = jax.random.normal(jax.random.fold_in(key, 1),
                                     (2, cfg.n_prefix_tokens, cfg.frontend_dim))
            np.testing.assert_allclose(b["patches"].numpy(), np.asarray(want), atol=2e-5,
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# train-while-serve: tests/test_staleness.py's hot-swap checks in the port
# ---------------------------------------------------------------------------

def test_checkpoint_steps_listing(tmp_path):
    assert ckpt.steps(tmp_path / "nope") == []
    for s in (3, 1, 7):
        ckpt.save(tmp_path, s, {"x": torch.arange(2.0)})
    assert ckpt.steps(tmp_path) == [1, 3, 7]
    assert ckpt.latest_step(tmp_path) == 7


def test_load_with_retry_recovers_transient(tmp_path, monkeypatch):
    ckpt.save(tmp_path, 5, {"x": torch.arange(3.0)})
    calls = {"n": 0}
    real_load = ckpt.load

    def flaky(path, step=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return real_load(path, step)

    monkeypatch.setattr(serve.ckpt, "load", flaky)
    out = serve.load_with_retry(str(tmp_path), 5, retries=3, backoff=0.001)
    assert calls["n"] == 3 and int(out["x"][2]) == 2
    # a persistent failure propagates once the schedule is spent
    calls["n"] = -10 ** 9
    with pytest.raises(OSError):
        serve.load_with_retry(str(tmp_path), 5, retries=2, backoff=0.001)


def test_hot_swap_watcher_rejects_truncation_keeps_last_good(tmp_path):
    ckpt.save(tmp_path, 2, {"server": {"w": torch.arange(3.0)}, "round": 2})
    w = serve.HotSwapWatcher(str(tmp_path), retries=2, backoff=0.001)
    assert int(w.poll()["round"]) == 2 and w.step == 2
    assert w.poll() is None  # nothing newer

    # a truncated file at the newest step: rejected loudly, last good kept
    (tmp_path / "step_00000009.msgpack").write_bytes(b"\x00" * 17)
    assert w.poll() is None
    assert w.failures == 1 and 9 in w.bad and w.step == 2
    assert w.poll() is None  # the bad step is remembered, not retried
    assert w.failures == 1

    # a good newer step behind the bad one still swaps in
    ckpt.save(tmp_path, 6, {"server": {"w": torch.arange(3.0)}, "round": 6})
    got = w.poll()
    assert got is not None and w.step == 6 and int(got["round"]) == 6
    assert w.swaps == 2


def test_run_watch_serves_the_newest_checkpoint(tmp_path):
    """``run_watch`` serves the trainer's parameters (a reduced model's
    tree, as ``launch/train.py`` saves it under "server") and swaps to a
    newer step between query batches."""
    cfg = get_arch("olmo-1b").reduced()
    params = build(cfg).init(prng.key(0), "cpu")
    ckpt.save(tmp_path, 1, {"server": params, "round": 1})
    served = []

    def stop():
        if len(served) == 1:
            ckpt.save(tmp_path, 4, {"server": params, "round": 4})
        return len(served) >= 2

    history, watcher = serve.run_watch("olmo-1b", ckpt_dir=str(tmp_path), batch=1,
                                       prompt_len=6, new_tokens=2, poll_interval=0.0,
                                       duration=30.0, stop_when=stop, history=served,
                                       device="cpu")
    assert [row["step"] for row in history] == [1, 4]
    assert watcher.swaps == 2 and all(row["tokens"] == 2 for row in history)


# ---------------------------------------------------------------------------
# no gradient reaches a kernel without a backward
# ---------------------------------------------------------------------------

def test_flash_attention_backward_shapes():
    """Kernel 16b takes every head dim kernel 16 takes, hd, vd <= 256 (MLA's
    192 / 128, recurrentgemma's 256, stablelm's 160, vd != hd); its wgmma
    route bf16 at hd = vd <= 128, a multiple of 16, its warp tensor-core
    route bf16 at other multiples of 16, the rest the CUDA cores;
    ``check_backward`` refuses only hd or vd above 256."""
    for hd, vd in ((128, 128), (64, 64), (192, 128), (256, 256), (160, 160), (64, 128),
                   (256, 64), (24, 24)):
        assert FA.backward_takes(hd, vd)
        FA.check_backward(hd, vd)
    for hd, vd in ((288, 128), (128, 320), (512, 512)):
        assert not FA.backward_takes(hd, vd)
        with pytest.raises(NotImplementedError, match="hd, vd <= 256"):
            FA.check_backward(hd, vd)
    bf, f32 = torch.bfloat16, torch.float32
    assert FA.bwd_route(bf, 128, 128) == FA.bwd_route(bf, 64, 64) == "wgmma"
    for hd, vd in ((192, 128), (256, 256), (160, 160), (64, 128), (256, 64)):
        assert FA.bwd_route(bf, hd, vd) == "mma"
    for dt, hd, vd in ((bf, 24, 24), (bf, 200, 136), (f32, 128, 128), (f32, 192, 128)):
        assert FA.bwd_route(dt, hd, vd) == "cuda_cores"
    # one kv head at the training round's (8, 128): 32 blocks of 32 keys
    # (16 of 64 on the warp tensor cores), so its 16 query heads split
    # across 8 blocks (16); enough blocks or one query head a kv head, no
    # split
    assert FA.dkdv_splits(8, 128, 1, 16, 132) == 8
    assert FA.dkdv_splits(8, 128, 1, 16, 132, key_tile=64) == 16
    assert FA.dkdv_splits(8, 128, 16, 1, 132) == FA.dkdv_splits(8, 128, 8, 4, 132) == 1
    for B, Sk, Hkv, G in ((4, 1024, 1, 16), (1, 77, 1, 7), (2, 40, 3, 5)):
        n = FA.dkdv_splits(B, Sk, Hkv, G, 132)
        per = -(-G // n)
        assert 1 <= n <= G and (n - 1) * per < G  # no empty split


def test_gradients_off_the_cpu_are_refused_before_any_launch(monkeypatch):
    """Off the CPU (meta tensors stand in for the card's here), a gradient
    reaching kernel 16 at MLA's (192, 128), recurrentgemma's (256, 256) or
    stablelm's (160, 160) head dims, or ``lru_scan``, goes through its
    autograd Function (``FlashAttention``, ``LruScan``); one at a head dim
    above 256 raises ``NotImplementedError`` before any Function or
    launch.  On the CPU the plain versions differentiate as before."""
    seen = []

    def record(name):
        def apply(*args):
            seen.append((name, tuple(args[0].shape)))
            raise _Reached
        return apply

    class _Reached(Exception):
        pass

    monkeypatch.setattr(P.FlashAttention, "apply", record("flash"))
    monkeypatch.setattr(P.LruScan, "apply", record("lru"))
    meta = {"device": "meta", "requires_grad": True}
    for H, Hkv, hd, vd in ((2, 2, 192, 128), (2, 1, 256, 256), (4, 2, 160, 160)):
        q, k = torch.empty(1, 8, H, hd, **meta), torch.empty(1, 8, Hkv, hd, **meta)
        v = torch.empty(1, 8, Hkv, vd, **meta)
        with pytest.raises(_Reached):
            P.flash_attention(q, k, v, window=4 if Hkv == 1 else None)
    a, b, h0 = torch.empty(1, 8, 4, **meta), torch.empty(1, 8, 4, **meta), torch.empty(1, 4,
                                                                                      **meta)
    with pytest.raises(_Reached):
        P.lru_scan(a, b, h0)
    assert seen == [("flash", (1, 8, 2, 192)), ("flash", (1, 8, 2, 256)),
                    ("flash", (1, 8, 4, 160)), ("lru", (1, 8, 4))]
    q = torch.empty(1, 8, 2, 320, **meta)
    with pytest.raises(NotImplementedError, match="hd, vd <= 256"):
        P.flash_attention(q, q, torch.empty(1, 8, 2, 128, **meta))
    assert len(seen) == 4
    a, b, h0 = (torch.rand(1, 5, 3, requires_grad=True), torch.rand(1, 5, 3),
                torch.rand(1, 3))
    y, _ = P.lru_scan(a, b, h0)
    y.sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())
