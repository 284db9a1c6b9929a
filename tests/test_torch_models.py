"""The model slice of the port (``repro_torch.configs``, ``models``,
``launch.serve``) against the reference, on the CPU.

The reference's parameters (``Model.init``) are carried across with
``convert.model_params``; the prompts, llava's patches and the
teacher-forced decode tokens come from numpy with a seed.  For olmo-1b,
rwkv6-1.6b, deepseek-v2-lite-16b (MLA, MoE, a dense lead layer),
llama4-maverick (a dense, moe unit), recurrentgemma-9b (RG-LRU and local
attention), llava-next (the vision prefix) and musicgen (4 codebooks),
``.reduced()`` (two or three layers, d_model 256), in f32 and in bf16, the
tests compare prefill's last-token logits and every cache entry, then 4
decode steps fed the same tokens on both sides (so that no argmax tie can
diverge), with the reference under ``ops.set_default_impl("xla")`` and
``"pallas_interpret"``; also a sliding window, a ``local`` block and
llama3-8b's grouped heads.  Its prefill and decode are jitted, as
``launch/serve.py`` runs them.

Tolerances, relative to the largest magnitude of the reference's value:
f32 1e-5 (matrix products, the softmax and the chunked recurrence sum in
another order; measured about 2e-6); bf16 4e-2 (about ten bf16 ulps: XLA
fuses a jitted bf16 computation and rounds its intermediates at other
points than eager PyTorch, and the differences pass two layers and the
head; measured up to 1.5e-2).  The port's own decode against its full
forward: 2e-2, as ``tests/test_archs.py`` holds the reference's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.kernels import ops as R
from repro.models import build as ref_build
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs import base as port_base
from repro_torch.core import tree_util as T
from repro_torch.kernels import ops as P
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.models.model import forward

B, S, STEPS = 2, 24, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs six workers on a
    few cores, where torch's thread pools would oversubscribe them (the
    port's eager ops, the keyed draws above all, slow down many times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TOL = {"float32": 1e-5, "bfloat16": 4e-2}


@pytest.fixture(params=["xla", "pallas_interpret"])
def impl(request):
    """The reference's kernel branch; its global default is restored in any
    case."""
    prev = R._DEFAULT_IMPL
    try:
        R.set_default_impl(request.param)
        yield request.param
    finally:
        R.set_default_impl(prev)


def _cfgs(name, dtype, pattern=None):
    rc, pc = REF_ARCHS[name].reduced(), get_arch(name).reduced()
    kw = dict(dtype=dtype)
    if pattern is not None:
        kw |= dict(block_pattern=pattern, window=16)
    return dataclasses.replace(rc, **kw), dataclasses.replace(pc, **kw)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _tokens(cfg, n, seed=0):
    """(B, n) token ids, or (B, K, n) for K codebooks."""
    shape = (B, cfg.n_codebooks, n) if cfg.n_codebooks > 1 else (B, n)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _batches(cfg, tok):
    """The reference's and the port's prompt batch: the tokens, and for a
    vision frontend patches (B, P, frontend_dim) from numpy with a seed."""
    rb, pb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok).long()}
    if cfg.frontend == "vision":
        patches = np.random.default_rng(1).standard_normal(
            (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
        rb["patches"], pb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return rb, pb


NEW_ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b", "recurrentgemma-9b",
             "llava-next-mistral-7b", "musicgen-large")
CASES = [("olmo-1b", "float32", None, None), ("olmo-1b", "bfloat16", None, None),
         ("rwkv6-1.6b", "float32", None, None), ("rwkv6-1.6b", "bfloat16", None, None),
         ("olmo-1b", "float32", 16, None), ("olmo-1b", "float32", None, ("dense", "local")),
         ("llama3-8b", "float32", None, None)] + [
    (name, dtype, None, None) for name in NEW_ARCHS for dtype in ("float32", "bfloat16")]
CASE_IDS = ["olmo-f32", "olmo-bf16", "rwkv-f32", "rwkv-bf16", "olmo-window16", "olmo-local",
            "llama3-gqa-f32"] + [f"{name.split('-')[0]}-{'f32' if dt == 'float32' else 'bf16'}"
                                 for name in NEW_ARCHS for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,dtype,wo,pattern", CASES, ids=CASE_IDS)
def test_prefill_cache_and_decode_match_reference(impl, name, dtype, wo, pattern):
    rcfg, pcfg = _cfgs(name, dtype, pattern)
    rm, pm = ref_build(rcfg, window_override=wo), build(pcfg, window_override=wo)
    rp = rm.init(jax.random.key(0))
    pp = convert.model_params(jax.tree.map(np.asarray, rp), "cpu")
    tok = _tokens(rcfg, S + STEPS)
    cap = S + STEPS + 2 + rcfg.n_prefix_tokens
    rb, pb = _batches(rcfg, tok[..., :S])
    rl, rc = jax.jit(lambda p, b: rm.prefill(p, b, cap))(rp, rb)
    with torch.no_grad():
        pl, pc = pm.prefill(pp, pb, cap)
    tol = TOL[dtype]
    assert _rel(pl.numpy(), rl) < tol
    assert jax.tree.structure(rc) == jax.tree.structure(convert.to_numpy(pc))
    for path, want, got in zip(T.paths(pc), jax.tree.leaves(rc), T.leaves(pc)):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        if got.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
        else:
            assert _rel(convert.to_numpy(got), want) < tol, path
    dec = jax.jit(rm.decode)
    for i in range(STEPS):
        nt = tok[..., S + i:S + i + 1]
        rl, rc = dec(rp, rc, jnp.asarray(nt))
        with torch.no_grad():
            pl, pc = pm.decode(pp, pc, torch.from_numpy(nt).long())
        assert _rel(pl.numpy(), rl) < tol, f"decode step {i}"
        assert int(pc["pos"]) == int(rc["pos"])


@pytest.mark.parametrize("name,wo", [("olmo-1b", None), ("olmo-1b", 16), ("rwkv6-1.6b", None)])
def test_decode_matches_full_forward_inside_the_port(name, wo):
    """``tests/test_archs.py::test_decode_matches_full_forward`` in the
    port: a decode step after a prefill of S - 1 tokens gives the logits of
    a prefill of all S, and of the train-mode forward, within 2e-2; the
    cache has the layout ``cache_shapes`` gives."""
    cfg = get_arch(name).reduced()
    m = build(cfg, window_override=wo)
    params = m.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg, S)).long()
    with torch.no_grad():
        ref, _ = m.prefill(params, {"tokens": tok}, S + 2)
        _, cache = m.prefill(params, {"tokens": tok[:, :S - 1]}, S + 2)
        pos = int(cache["pos"])
        lg, new_cache = m.decode(params, cache, tok[:, S - 1:])
        full, _, _ = forward(cfg, params, {"tokens": tok}, mode="train", window_override=wo)
    assert _rel(lg.numpy(), ref.numpy()) < 2e-2
    assert _rel(lg.numpy(), full[:, -1].numpy()) < 2e-2
    assert int(new_cache["pos"]) == pos + 1
    shapes = m.cache_shapes(B, S + 2)
    assert T.paths(shapes) == T.paths(cache)
    for want, got in zip(T.leaves(shapes), T.leaves(cache)):
        assert want.shape == got.shape and want.dtype == got.dtype


def test_model_params_carry_bf16_bits_and_structure():
    """The reference's nested bf16 parameter tree (lists, stacked units,
    an empty dict) comes across bit for bit, keys, lists and empties kept."""
    rcfg, _ = _cfgs("olmo-1b", "bfloat16")
    rp = ref_build(rcfg).init(jax.random.key(1))
    pp = convert.model_params(rp, "cpu")
    assert pp["final_norm"] == {} and pp["stack"]["units"]["b0"]["ln1"] == {}
    assert jax.tree.structure(convert.to_numpy(pp)) == jax.tree.structure(rp)
    for want, got in zip(jax.tree.leaves(rp), T.leaves(pp)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_port_init_matches_reference_layout():
    """The port's random init has the reference's tree, shapes and dtypes
    (not its numbers: a torch.Generator draws them)."""
    for name in ("olmo-1b", "rwkv6-1.6b"):
        rcfg, pcfg = _cfgs(name, "bfloat16")
        want = jax.eval_shape(ref_build(rcfg).init, jax.random.key(0))
        got = build(pcfg).init(torch.Generator().manual_seed(0))
        assert jax.tree.structure(convert.to_numpy(got)) == jax.tree.structure(want)
        for w, g in zip(jax.tree.leaves(want), T.leaves(got)):
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "musicgen-large",
                                  "llava-next-mistral-7b"])
def test_serve_runs_on_the_cpu(arch):
    """``serve.run`` on the reduced configs: tokens (batch, [K,] new_tokens)
    in the vocabulary, finite last logits, no kernel launched on the CPU."""
    P.reset_launches()
    out = serve.run(arch, batch=2, prompt_len=70, new_tokens=3, device="cpu", quiet=True)
    cfg = get_arch(arch).reduced()
    lead = (2, cfg.n_codebooks) if cfg.n_codebooks > 1 else (2,)
    assert tuple(out.tokens.shape) == lead + (3,) and tuple(out.prompts.shape) == lead + (70,)
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < cfg.vocab_size
    assert tuple(out.logits.shape) == lead + (cfg.vocab_size,)
    assert torch.isfinite(out.logits).all()
    assert out.prefill_ms > 0 and out.decode_ms_per_token > 0
    assert P.launches() == {k.name: 0 for k in P.KERNELS}


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs, as chip_smoke.py drives it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run("olmo-1b", batch=1, prompt_len=8, new_tokens=1)


@pytest.mark.parametrize("name", sorted(n for n in REF_ARCHS
                                        if n not in ("olmo-1b", "rwkv6-1.6b")))
def test_every_arch_builds_with_the_reference_tree(name):
    """Every other arch builds, and its init (``.reduced()``, bf16, a
    generator's draw) has the reference's tree: paths, shapes and dtypes
    (RG-LRU's ``lam`` f32 in a bf16 model); its cache too."""
    rcfg, pcfg = _cfgs(name, "bfloat16")
    want = jax.eval_shape(ref_build(rcfg).init, jax.random.key(0))
    model = build(pcfg)
    assert model.cfg is pcfg
    got = model.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(convert.to_numpy(got)) == jax.tree.structure(want)
    for path, w, g in zip(T.paths(got), jax.tree.leaves(want), T.leaves(got)):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    ref_cache = ref_build(rcfg).cache_shapes(B, 40)
    port_cache = model.cache_shapes(B, 40)
    for w, g in zip(jax.tree.leaves(ref_cache), T.leaves(port_cache)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)


def test_config_copies_match_reference():
    """``SHAPES``, the ten architectures (and their reduced variants) value
    for value, and ``param_count`` for all ten; the dataclasses' fields are
    pinned in tests/test_torch_port.py."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, rc in REF_ARCHS.items():
        pc = ARCHS[name]
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc), name
        assert dataclasses.asdict(pc.reduced()) == dataclasses.asdict(rc.reduced()), name
        assert pc.param_count() == rc.param_count(), name
        assert pc.active_param_count() == rc.active_param_count(), name
        assert (pc.resolved_head_dim, pc.pattern_len) == (rc.resolved_head_dim, rc.pattern_len)
    assert abs(ARCHS["olmo-1b"].param_count() - 1.18e9) / 1.18e9 < 0.06
    with pytest.raises(AssertionError):
        port_base.validate(dataclasses.replace(ARCHS["olmo-1b"], n_kv_heads=3))
