"""The port's participation draw (``repro_torch.core.prng``) against
``jax.random``: threefry2x32 keys, ``fold_in``, ``split``, 32-bit random
bits and ``permutation``, and the masks and cohorts built on them
(``tree_util.participation_mask``, ``cohort_indices``).  All integer
results, so every comparison is exact."""
import numpy as np
import jax
import pytest
import torch

from repro.core import tree_util as ref_T
from repro_torch.core import prng
from repro_torch.core import tree_util as T

SEEDS = [0, 17, 2 ** 31 - 1]
SIZES = [1, 2, 10, 500, 2000]  # 2000 > 1625 needs two sort rounds
ROUNDS = [0, 1, 37]
FRACS = [0.07, 0.25, 0.5, 1.0]


def _keys(seed, r):
    """The round key on both sides, the port's folded from an int32 round
    counter tensor as the rounds fold ``state["round"]``."""
    return (jax.random.fold_in(jax.random.key(seed), r),
            prng.fold_in(prng.key(seed), torch.tensor(r, dtype=torch.int32)))


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_mask_and_cohort_match_jax(seed, m):
    for r in ROUNDS:
        jk, pk = _keys(seed, r)
        perm = prng.permutation(pk, m)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jax.random.permutation(jk, m)))
        assert perm.dtype == torch.int64
        for frac in FRACS:
            mask = T.participation_mask(pk, m, frac)
            np.testing.assert_array_equal(mask.numpy(),
                                          np.asarray(ref_T.participation_mask(jk, m, frac)))
            idx, cmask = T.cohort_indices(pk, m, frac)
            ridx, rmask = ref_T.cohort_indices(jk, m, frac)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
            np.testing.assert_array_equal(cmask.numpy(), np.asarray(rmask))
            assert idx.shape == (T.cohort_count(m, frac),)


@pytest.mark.parametrize("seed", SEEDS + [123456789])
def test_key_words_fold_in_split_and_bits_match_jax(seed):
    jk = jax.random.key(seed)
    assert prng.key(seed) == tuple(int(w) for w in np.asarray(jax.random.key_data(jk)))
    for data in (0, 5, 2 ** 31 - 1):
        jf = jax.random.fold_in(jk, data)
        for pf in (prng.fold_in(prng.key(seed), data),
                   prng.fold_in(prng.key(seed), torch.tensor(data, dtype=torch.int32))):
            assert tuple(int(w) for w in pf) == tuple(
                int(w) for w in np.asarray(jax.random.key_data(jf)))
        ja, jb = jax.random.split(jf)
        pa, pb = prng.split(prng.fold_in(prng.key(seed), data))
        for jkey, pkey in ((ja, pa), (jb, pb)):
            assert tuple(int(w) for w in pkey) == tuple(
                int(w) for w in np.asarray(jax.random.key_data(jkey)))
        bits = np.asarray(jax.random.bits(jb, (257,), np.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(pb, 257).numpy(), bits)


def test_threefry_known_answer():
    """Random123's known-answer vectors of threefry2x32 (20 rounds): key
    and counter all ones, and all zeros."""
    m = 0xFFFFFFFF
    assert prng.threefry2x32(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)
    assert prng.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


def test_shuffle_rounds():
    assert [prng.shuffle_rounds(n) for n in (0, 1, 2, 1625, 1626, 10 ** 6, 3 * 10 ** 6)] == [
        0, 0, 1, 1, 2, 2, 3]


def test_draw_stays_on_the_device_of_the_round_counter():
    """Every tensor of the draw lives where the counter does (here the CPU,
    on the card the card): nothing is copied from the host per round."""
    meta = torch.tensor(3, dtype=torch.int32, device="meta")
    k = prng.fold_in(prng.key(17), meta)
    assert all(w.device.type == "meta" for w in k)
    assert prng.permutation(k, 10).device.type == "meta"
