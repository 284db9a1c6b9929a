"""The port's flat client arena against the reference's (``repro.core.arena``):
the same slice table, and pack/unpack bitwise equal for f32 and bf16 on a
multi-leaf dict tree with odd (non-multiple-of-128) leaf sizes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import arena as RA
from repro_torch.core import arena as PA
from repro_torch import convert

SHAPES = {"w": (3, 50), "b": (7,), "s": (), "c": (130,)}


def _trees(dtype, m=None):
    rng = np.random.default_rng(0 if m is None else m)
    lead = () if m is None else (m,)
    arrs = {k: rng.standard_normal(lead + s).astype(np.float32) for k, s in SHAPES.items()}
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return ({k: jnp.asarray(a).astype(jd) for k, a in arrs.items()},
            {k: torch.from_numpy(a.copy()).to(td) for k, a in arrs.items()})


def _bits(x):
    """Raw bits of a jax array or a torch tensor, for bitwise comparison."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slice_table_matches_reference(dtype):
    jt, tt = _trees(dtype)
    rs, ps = RA.ArenaSpec.from_tree(jt), PA.ArenaSpec.from_tree(tt)
    assert ps.width == rs.width and ps.n_rows == rs.n_rows
    assert ps.leaf_rows() == rs.leaf_rows()
    for a, b in zip(rs.leaves, ps.leaves):  # sorted key order, as jax.tree
        assert (a.path, a.shape, a.offset, a.size, a.padded) == (
            b.path, b.shape, b.offset, b.size, b.padded)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_unpack_bitwise(dtype):
    jt, tt = _trees(dtype)
    rs, ps = RA.ArenaSpec.from_tree(jt), PA.ArenaSpec.from_tree(tt)
    row_r, row_p = rs.pack(jt), ps.pack(tt)
    assert row_p.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_array_equal(_bits(row_p), _bits(row_r))
    back = ps.unpack(row_p)
    assert sorted(back) == sorted(tt)
    for k in tt:
        assert back[k].dtype == tt[k].dtype and back[k].shape == tt[k].shape
        np.testing.assert_array_equal(_bits(back[k]), _bits(rs.unpack(row_r)[k]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_unpack_stacked_bitwise(dtype):
    m = 5
    jt, tt = _trees(dtype, m)
    rs = RA.ArenaSpec.from_tree(jt, stacked=True)
    ps = PA.ArenaSpec.from_tree(tt, stacked=True)
    buf_r, buf_p = rs.pack_stacked(jt), ps.pack_stacked(tt)
    assert tuple(buf_p.shape) == (m, ps.width) and buf_p.is_contiguous()
    np.testing.assert_array_equal(_bits(buf_p), _bits(buf_r))
    back_p, back_r = ps.unpack_stacked(buf_p), rs.unpack_stacked(buf_r)
    for k in tt:
        np.testing.assert_array_equal(_bits(back_p[k]), _bits(back_r[k]))
        np.testing.assert_array_equal(_bits(back_p[k]), _bits(tt[k]))


def test_single_tensor_tree_and_zero_padding():
    x = torch.arange(1.0, 501.0)
    spec = PA.ArenaSpec.from_tree(x)
    assert spec.width == 512 and spec.keys is None
    row = spec.pack(x)
    assert torch.all(row[500:] == 0) and torch.equal(spec.unpack(row), x)
    z = PA.zeros(spec, 3, device="cpu")
    assert z.shape == (3, 512) and z.dtype == torch.float32 and not z.any()


def test_mixed_dtype_tree_promotes_like_reference():
    jt, tt = _trees("f32")
    jt["b"], tt["b"] = jt["b"].astype(jnp.bfloat16), tt["b"].to(torch.bfloat16)
    rs, ps = RA.ArenaSpec.from_tree(jt), PA.ArenaSpec.from_tree(tt)
    assert rs.dtype == jnp.float32 and ps.dtype == torch.float32
    np.testing.assert_array_equal(_bits(ps.pack(tt)), _bits(rs.pack(jt)))


def test_convert_carries_bf16_bits():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(jnp.bfloat16)
    t = convert.tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), _bits(a))
    assert jax.numpy.result_type(a) == jnp.bfloat16


def test_nested_tree_slice_table_and_rows_match_reference():
    """A nested tree (a dict inside a dict, a list of leaves, an empty dict,
    a None): the same slice table, key paths and stacked arena rows as the
    reference's, and unpack rebuilds the structure."""
    rng = np.random.default_rng(3)
    m = 3
    tree = {"enc": {"w": rng.standard_normal((m, 3, 5)), "b": rng.standard_normal((m, 4))},
            "lst": [rng.standard_normal((m, 130)), None], "empty": {},
            "top": rng.standard_normal((m, 7))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jt, tt = jax.tree.map(jnp.asarray, tree), convert.params(tree, "cpu")
    rs = RA.ArenaSpec.from_tree(jt, stacked=True)
    ps = PA.ArenaSpec.from_tree(tt, stacked=True)
    assert ps.width == rs.width and ps.leaf_rows() == rs.leaf_rows()
    for a, b in zip(rs.leaves, ps.leaves):
        assert (a.path, a.shape, a.offset, a.size, a.padded) == (
            b.path, b.shape, b.offset, b.size, b.padded)
    buf = ps.pack_stacked(tt)
    np.testing.assert_array_equal(_bits(buf), _bits(rs.pack_stacked(jt)))
    back = convert.to_numpy(ps.unpack_stacked(buf))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, w)
