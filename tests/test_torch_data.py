"""The data pipeline of the port (``repro_torch.data``) against the
reference's (tests/test_data_ckpt.py's data half).

The partitions are bitwise: ``by_class`` picks each class's first samples
in order, ``iid`` and ``dirichlet`` draw through ``core.prng`` (jax's
threefry, bit for bit), so the same arrays and key give the reference's
split exactly.  The generators of ``synthetic.py`` take a ``core.prng``
key and follow the reference's split / fold_in tree: the token streams are
the reference's bit for bit (the weighted choice is a search in
``cumsum(p)``, summed in XLA's order), the images within a few f32
roundings (``prng.normal``'s erfinv, then a (n, 32) x (32, 784) product
in another order: 5e-5 of the largest |x|); their contracts are pinned
too (shapes, one class per client, heterogeneous topics, the cohort stream
equal to the gathered full stream)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree_util as ref_T
from repro.data import partition as ref_partition
from repro.data import synthetic as ref_synthetic
from repro_torch.core import prng
from repro_torch.data import partition, synthetic


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs six workers on a
    few cores, where torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    ds = ref_synthetic.gaussian_mixture_images(jax.random.key(0), 50, 10)
    return ds, tuple(torch.from_numpy(np.array(a)) for a in (ds.x_train, ds.y_train))


def test_by_class_equals_reference(images):
    ds, (x, y) = images
    rxs, rys = ref_partition.by_class(ds.x_train, ds.y_train, ds.n_classes)
    xs, ys = partition.by_class(x, y, ds.n_classes)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(rys))


def test_by_class_truncates_to_the_smallest_class():
    y = torch.tensor([0, 1, 1, 2, 0, 2, 2, 1, 0, 0])
    x = torch.arange(10, dtype=torch.float32)[:, None]
    xs, ys = partition.by_class(x, y, 3)
    rxs, rys = ref_partition.by_class(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 3)
    assert xs.shape == (3, 3, 1)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(rys))


@pytest.mark.parametrize("seed,n,m", [(1, 100, 4), (2, 97, 3), (5, 2000, 7)])
def test_iid_equals_reference(seed, n, m):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n) % 10
    rxs, rys = ref_partition.iid(jax.random.key(seed), jnp.asarray(x), jnp.asarray(y), m=m)
    xs, ys = partition.iid(prng.key(seed), torch.from_numpy(x), torch.from_numpy(y), m=m)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(rys))
    assert xs.shape == (m, n // m, 3)
    assert len(np.unique(xs[..., 0].reshape(-1).numpy())) == (n // m) * m  # no duplicate


@pytest.mark.parametrize("m,alpha", [(2, 0.1), (3, 0.3), (5, 1.7), (8, 5.0)])
def test_dirichlet_equals_reference_and_covers_all(m, alpha):
    key = int(alpha * 100) + m
    y = np.random.default_rng(0).integers(0, 5, 200)
    want = ref_partition.dirichlet(jax.random.key(key), None, jnp.asarray(y), m=m,
                                   n_classes=5, alpha=alpha)
    got = partition.dirichlet(prng.key(key), None, torch.from_numpy(y), m=m, n_classes=5,
                              alpha=alpha)
    assert len(got) == len(want) == m
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(200))


def test_minibatch_schedule_equals_reference():
    for args in ((1000, 32, 50), (40, 32, 7), (10, 32, 3)):
        s = partition.minibatch_schedule(*args)
        np.testing.assert_array_equal(s, ref_partition.minibatch_schedule(*args))
        np.testing.assert_array_equal(s, partition.minibatch_schedule(*args))
    assert (partition.minibatch_schedule(1000, 32, 50) + 32 <= 1000).all()


def test_gaussian_mixture_images_shapes_and_split():
    ds = synthetic.gaussian_mixture_images(prng.key(0), 50, 10, device="cpu")
    assert ds.x_train.shape == (500, 784) and ds.y_train.shape == (500,)
    assert ds.x_val.shape == (100, 784) and ds.y_val.dtype == torch.int32
    xs, ys = partition.by_class(ds.x_train, ds.y_train, ds.n_classes)
    assert xs.shape[0] == 10
    for c in range(10):
        assert bool((ys[c] == c).all())
    # seeded: the same key gives the same data
    again = synthetic.gaussian_mixture_images(prng.key(0), 50, 10, device="cpu")
    assert torch.equal(again.x_train, ds.x_train) and torch.equal(again.x_val, ds.x_val)


@pytest.mark.parametrize("args", [(0, 50, 10, 1.2), (0, 600, 120, 0.12)],
                         ids=["default_sep", "table1"])
def test_gaussian_mixture_images_match_reference(args):
    """The reference's images from the same key (Table I's draw included,
    ``benchmarks/tab1_softmax.py:54``), within a few f32 roundings."""
    seed, n_tr, n_val, sep = args
    want = ref_synthetic.gaussian_mixture_images(jax.random.key(seed), n_tr, n_val, sep=sep)
    got = synthetic.gaussian_mixture_images(prng.key(seed), n_tr, n_val, sep=sep, device="cpu")
    for a, b in ((want.x_train, got.x_train), (want.x_val, got.x_val)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy() / np.abs(a).max(), a / np.abs(a).max(), atol=5e-5)
    np.testing.assert_array_equal(got.y_train.numpy(), np.asarray(want.y_train))
    np.testing.assert_array_equal(got.y_val.numpy(), np.asarray(want.y_val))


@pytest.mark.parametrize("n", [1, 16, 17, 255, 256, 4097, 50304])
def test_xla_cumsum_is_jnp_cumsum_bitwise(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    np.testing.assert_array_equal(synthetic.xla_cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("vocab,start", [(512, 0), (50304, 3)])
def test_lm_batches_are_the_reference_tokens(vocab, start):
    """Every token of the reference's stream, bit for bit (olmo-1b's vocab
    and a reduced one)."""
    kw = dict(per_client_batch=2, seq_len=64, vocab=vocab, start=start)
    want = list(ref_synthetic.lm_batches(jax.random.key(1), 2, 3, **kw))
    got = list(synthetic.lm_batches(prng.key(1), 2, 3, device="cpu", **kw))
    for a, b in zip(want, got):
        for name in ("tokens", "targets"):
            assert b[name].dtype == torch.int32
            np.testing.assert_array_equal(b[name].numpy(), np.asarray(a[name]))


def test_cohort_lm_batches_are_the_reference_tokens():
    kw = dict(per_client_batch=2, seq_len=16, vocab=128, participation=0.5, fed_seed=17)
    want = list(ref_synthetic.cohort_lm_batches(jax.random.key(9), 3, 8, **kw))
    got = list(synthetic.cohort_lm_batches(prng.key(9), 3, 8, device="cpu", **kw))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(a["tokens"]))


def test_topic_permutation_equals_reference():
    for topic in (0, 3, 7):
        want = jax.random.permutation(jax.random.fold_in(jax.random.key(1234), topic), 128)
        np.testing.assert_array_equal(synthetic.topic_permutation(topic, 128).numpy(),
                                      np.asarray(want))


def test_lm_batches_heterogeneous():
    batch = next(synthetic.lm_batches(prng.key(0), 1, m=3, per_client_batch=2, seq_len=32,
                                      vocab=128, device="cpu"))
    assert batch["tokens"].shape == (3, 2, 32) and batch["targets"].shape == (3, 2, 32)
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["tokens"][..., 1:], batch["targets"][..., :-1])
    # different clients draw from different topic permutations
    h0 = np.bincount(batch["tokens"][0].numpy().ravel(), minlength=128)
    h1 = np.bincount(batch["tokens"][1].numpy().ravel(), minlength=128)
    assert not np.array_equal(h0, h1)


def test_lm_batches_resume_from_start():
    """``start`` offsets the round: a resumed stream (the same key) sees
    the uninterrupted stream's batches from that round."""
    kw = dict(m=3, per_client_batch=2, seq_len=16, vocab=64, device="cpu")
    full = list(synthetic.lm_batches(prng.key(4), 4, **kw))
    rest = list(synthetic.lm_batches(prng.key(4), 2, start=2, **kw))
    for a, b in zip(full[2:], rest):
        assert torch.equal(a["tokens"], b["tokens"])


def test_cohort_stream_equals_gathered_full_stream():
    """Round r's cohort rows are the reference's cohort ids (the round
    engine's draw), each row the full stream's row of that client."""
    m, p, seed = 8, 0.5, 17
    kw = dict(per_client_batch=2, seq_len=16, vocab=64, device="cpu")
    full = list(synthetic.lm_batches(prng.key(9), 3, m, **kw))
    coh = list(synthetic.cohort_lm_batches(prng.key(9), 3, m, participation=p, fed_seed=seed,
                                           **kw))
    for r, (f, c) in enumerate(zip(full, coh)):
        idx, _ = ref_T.cohort_indices(jax.random.fold_in(jax.random.key(seed), r), m, p)
        idx = np.array(idx)
        assert c["tokens"].shape == (len(idx), 2, 16)
        assert torch.equal(c["tokens"], f["tokens"][torch.from_numpy(idx)])
        assert torch.equal(c["targets"], f["targets"][torch.from_numpy(idx)])
