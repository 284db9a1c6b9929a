"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``src/repro/checkpoint``): the private msgpack codec against
the ``msgpack`` package, files cross-loaded in both directions (bitwise the
same bytes for the same tree), bf16 through its 16-bit words, the chunked
streaming of large arrays, loud rejection of corrupt and truncated files,
keep-last-N, and the population store's save and resume
(tests/test_data_ckpt.py:60-90 and tests/test_popstore.py:194-248
mirrored).  Every comparison is exact: a checkpoint moves bytes."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.checkpoint import msgpack_ckpt as ref_msgpack_ckpt
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import _msgpack, msgpack_ckpt
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import popstore, prng, quadratic

CODEC_OBJECTS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63,
    0.0, -0.0, 1.5, 1e300, float("inf"), "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
    "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000, [], [1] * 15, [1] * 16,
    list(range(70000)), {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"n": [1, {"x": b"z", "t": [None, True]}], "f": -2.5},
]


@pytest.mark.parametrize("obj", CODEC_OBJECTS, ids=lambda o: f"{type(o).__name__}{str(o)[:12]}")
def test_codec_matches_msgpack(obj):
    """``packb`` writes msgpack's bytes (use_bin_type=True); the unpacker
    reads msgpack's bytes back to the same object."""
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


def test_codec_reads_float32_and_streams():
    """A float32 (which other writers emit) decodes; objects stream one at
    a time, ``OutOfData`` at a clean end, an error inside an object."""
    msgpack = pytest.importorskip("msgpack")
    data = msgpack.packb(1.5, use_single_float=True) + _msgpack.packb([1, "a"])
    unp = _msgpack.Unpacker(io.BytesIO(data))
    assert unp.unpack() == 1.5 and unp.unpack() == [1, "a"]
    with pytest.raises(_msgpack.OutOfData):
        unp.unpack()
    with pytest.raises(ValueError, match="inside an object"):
        _msgpack.Unpacker(io.BytesIO(_msgpack.packb(b"x" * 40)[:-3])).unpack()
    with pytest.raises(TypeError):
        _msgpack.packb({1j})


def _ref_tree():
    return {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": {"c": jnp.ones((4,), jnp.bfloat16) * 1.5, "d": [jnp.int32(3), jnp.zeros((2, 2))]},
        "e": (jnp.asarray(2.5),),
        "f": np.linspace(0, 1, 5),  # f64 host state
        "meta": 7, "s": "text", "n": None,
    }


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_data_ckpt.py's round trip on the port: containers, bf16,
    scalars; arrays load as tensors, f64 as writable numpy."""
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones(4, dtype=torch.bfloat16), "d": [torch.tensor(3, dtype=torch.int32),
                                                               torch.zeros(2, 2)]},
        "e": (torch.tensor(2.5),),
        "meta": 7,
    }
    ckpt.save(tmp_path, 3, tree)
    assert ckpt.latest_step(tmp_path) == 3
    back = ckpt.load(tmp_path)
    assert back["meta"] == 7
    assert isinstance(back["e"], tuple) and isinstance(back["b"]["d"], list)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["d"][0].dtype == torch.int32 and int(back["b"]["d"][0]) == 3


def test_checkpoint_multiple_steps(tmp_path):
    for s in [1, 5, 3]:
        ckpt.save(tmp_path, s, {"x": torch.tensor(float(s))})
    assert ckpt.latest_step(tmp_path) == 5
    assert float(ckpt.load(tmp_path, 3)["x"]) == 3.0


@pytest.mark.parametrize("chunk", [None, 64], ids=["inline", "chunked"])
def test_reference_file_loads_in_the_port_and_back(tmp_path, monkeypatch, chunk):
    """A file the reference wrote loads in the port (bf16 as torch.bfloat16,
    f64 as numpy), and the port writes it back byte for byte; the
    reference loads the port's file to the same values."""
    if chunk is not None:
        monkeypatch.setattr(ref_msgpack_ckpt, "CHUNK_BYTES", chunk)
        monkeypatch.setattr(msgpack_ckpt, "CHUNK_BYTES", chunk)
    tree = _ref_tree()
    ref_ckpt.save(tmp_path / "ref", 1, tree)
    back = ckpt.load(tmp_path / "ref", 1)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["c"].float(), torch.full((4,), 1.5))
    assert isinstance(back["f"], np.ndarray) and back["f"].flags.writeable
    assert back["meta"] == 7 and back["s"] == "text" and back["n"] is None
    ckpt.save(tmp_path / "port", 1, back)
    a = (tmp_path / "ref" / "step_00000001.msgpack").read_bytes()
    b = (tmp_path / "port" / "step_00000001.msgpack").read_bytes()
    assert a == b
    again = ref_ckpt.load(tmp_path / "port", 1)
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_file_loads_in_the_reference(tmp_path):
    """The other direction: the port's tensors (bf16 included) and numpy
    arrays load in the reference with their dtypes and values."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "x": torch.randn(7, generator=g), "i": torch.arange(4, dtype=torch.int64),
            "flag": torch.tensor([True, False]), "sum": np.arange(3, dtype=np.float64),
            "t": (1, 2.0, [3])}
    ckpt.save(tmp_path, 2, tree)
    back = ref_ckpt.load(tmp_path, 2)
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32), tree["w"].float().numpy())
    np.testing.assert_array_equal(np.asarray(back["x"]), tree["x"].numpy())
    np.testing.assert_array_equal(np.asarray(back["i"]), tree["i"].numpy())
    np.testing.assert_array_equal(np.asarray(back["flag"]), tree["flag"].numpy())
    assert back["sum"].dtype == np.float64 and back["t"] == (1, 2.0, [3])


def test_chunked_streaming_roundtrip(tmp_path, monkeypatch):
    """Arrays past CHUNK_BYTES stream in chunks (a bf16 one too) and come
    back as host numpy (bf16: a CPU tensor); small ones stay inline."""
    monkeypatch.setattr(msgpack_ckpt, "CHUNK_BYTES", 100)
    big = torch.arange(1000, dtype=torch.float32).reshape(10, 100)
    tree = {"big": big, "bf": big.to(torch.bfloat16), "small": torch.ones(3)}
    ckpt.save(tmp_path, 1, tree)
    back = ckpt.load(tmp_path, 1)
    assert isinstance(back["big"], np.ndarray) and back["big"].flags.writeable
    np.testing.assert_array_equal(back["big"], big.numpy())
    assert back["bf"].dtype == torch.bfloat16 and torch.equal(back["bf"], tree["bf"])
    assert torch.is_tensor(back["small"])


def test_corrupt_and_truncated_files_are_rejected(tmp_path, monkeypatch):
    """A truncated file, trailing bytes and a short chunk stream fail
    loudly, naming the file."""
    monkeypatch.setattr(msgpack_ckpt, "CHUNK_BYTES", 64)
    ckpt.save(tmp_path, 1, {"x": torch.arange(100, dtype=torch.float32)})
    fp = tmp_path / "step_00000001.msgpack"
    data = fp.read_bytes()
    fp.write_bytes(data[:-10])
    with pytest.raises(ValueError, match="truncated or corrupt"):
        ckpt.load(tmp_path, 1)
    fp.write_bytes(data + b"\x01")
    with pytest.raises(ValueError, match="trailing"):
        ckpt.load(tmp_path, 1)
    fp.write_bytes(b"\xc1garbage")
    with pytest.raises(ValueError, match="step_00000001"):
        ckpt.load(tmp_path, 1)
    with pytest.raises(FileNotFoundError):
        ckpt.load(tmp_path / "none")


def test_keep_last_n_and_stray_files(tmp_path):
    """``keep`` prunes all but the newest N by step number; stray
    step_*.msgpack names are skipped with a warning."""
    (tmp_path / "step_tmp.msgpack").write_bytes(b"")
    for s in (1, 2, 10, 3):
        with pytest.warns(RuntimeWarning, match="non-checkpoint"):
            ckpt.save(tmp_path, s, {"s": s}, keep=2)
    with pytest.warns(RuntimeWarning):
        assert ckpt.steps(tmp_path) == [3, 10]
    assert (tmp_path / "step_tmp.msgpack").exists()
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# the population store's save and resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prob():
    return quadratic.generate_from_key(prng.key(0), m=8, n=60, d=24, device="cpu")


def _cfg(prob, algo="gpdmm", **kw):
    return FederatedConfig(algorithm=algo, inner_steps=3, eta=0.3 / prob.L, use_arena=True,
                           participation=0.5, cohort=True, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_popstore_checkpoint_streams_and_resumes(prob, tmp_path, monkeypatch, dtype):
    """tests/test_popstore.py's chunked save -> load -> continue, equal to
    the uninterrupted run bitwise: a tiny CHUNK_BYTES streams the store's
    (m, width) buffers, which load as writable host numpy (a bf16 store as
    a CPU bf16 tensor), the f64 running sums without a downcast."""
    monkeypatch.setattr(msgpack_ckpt, "CHUNK_BYTES", 1024)
    cfg = _cfg(prob)
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d, dtype=dtype), prob.m)
    for _ in range(2):
        s, _ = runner.round(s, prob.batch())
    ckpt.save(tmp_path, 2, s)
    back = ckpt.load(tmp_path, 2)
    for name, buf in back["pop"].items():
        if dtype == torch.bfloat16:
            assert buf.dtype == torch.bfloat16 and torch.equal(buf, s["pop"][name])
        else:
            assert isinstance(buf, np.ndarray) and buf.flags.writeable
            np.testing.assert_array_equal(buf, s["pop"][name])
    assert back["pop_sum"].dtype == np.float64
    np.testing.assert_array_equal(back["pop_sum"], s["pop_sum"])

    r2 = popstore.Runner(cfg, prob.oracle(), device="cpu")
    for _ in range(3):
        s, _ = runner.round(s, prob.batch())
        back, _ = r2.round(back, prob.batch())
    for name in popstore.POP_BUFFERS["gpdmm"]:
        a, b = s["pop"][name], back["pop"][name]
        assert (torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(a, b)), name
    assert torch.equal(s["x_s"], back["x_s"])


def test_popstore_stale_slots_survive_the_checkpoint(prob, tmp_path, monkeypatch):
    """A faulted store (dropout and corruption with screening) saved
    mid-run and resumed replays the uninterrupted run's rounds and fault
    counters bitwise."""
    from repro_torch.configs.base import FaultConfig

    monkeypatch.setattr(msgpack_ckpt, "CHUNK_BYTES", 512)
    cfg = _cfg(prob, faults=FaultConfig(dropout=0.2, corrupt=0.1, seed=5), screen=True)
    runner = popstore.Runner(cfg, prob.oracle(), device="cpu")
    s = runner.init(torch.zeros(prob.d), prob.m)
    s, _ = runner.round(s, prob.batch())
    ckpt.save(tmp_path, 1, s)
    back = ckpt.load(tmp_path, 1)
    r2 = popstore.Runner(cfg, prob.oracle(), device="cpu")
    for _ in range(3):
        s, ma = runner.round(s, prob.batch())
        back, mb = r2.round(back, prob.batch())
        for k in ma:
            assert float(ma[k]) == float(mb[k]) or (ma[k] != ma[k] and mb[k] != mb[k]), k
    for name in popstore.POP_BUFFERS["gpdmm"]:
        np.testing.assert_array_equal(s["pop"][name], back["pop"][name])


def test_checkpoint_roundtrip_at_10k_rows(tmp_path):
    """The real streaming threshold (16 MiB) and a 10^4-row store: each
    (10^4, 512) f32 buffer is 20 MB and streams unpatched."""
    cfg = FederatedConfig(algorithm="gpdmm", inner_steps=2, eta=0.1, use_arena=True,
                          participation=64 / 10_000, cohort=True, arena_min_width=512)

    def grad(p, b):
        return {k: v * 0.1 for k, v in p.items()}

    runner = popstore.Runner(cfg, grad, device="cpu")
    s = runner.init({"w": torch.full((512,), 0.5)}, 10_000)
    batch = {"dummy": torch.zeros(10_000, 1)}
    s, _ = runner.round(s, batch)
    assert s["pop"]["u_hat"].nbytes > msgpack_ckpt.CHUNK_BYTES
    ckpt.save(tmp_path, 1, s)
    back = ckpt.load(tmp_path, 1)
    for name in popstore.POP_BUFFERS["gpdmm"]:
        assert isinstance(back["pop"][name], np.ndarray)
        np.testing.assert_array_equal(back["pop"][name], s["pop"][name])
    assert back["pop_sum"].dtype == np.float64
    s, _ = runner.round(s, batch)
    back, _ = popstore.Runner(cfg, grad, device="cpu").round(back, batch)
    np.testing.assert_array_equal(s["pop"]["u_hat"], back["pop"]["u_hat"])
