"""The port's host runtime (``lotus_tpu_torch.native``) against
``lotus_tpu.native`` on seeded numpy inputs.

Both libraries compile the same C++, so labels, merged scores and ids and
array files must be equal bit for bit (tolerance 0).  The plain versions
(the reference's Python fallbacks) are held on the inputs where the
reference's own fallback agrees with its C++: union-find components (not
labels: the fallback has no union by rank), merges of distinct scores with
``-1`` only at the ends of lists.
"""

from pathlib import Path

import numpy as np
import pytest

from lotus_tpu import native as ref
from lotus_tpu_torch import native
from lotus_tpu_torch.ops._kernels import BUILD_DIR


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    # Without its C++ the reference answers through its fallback, which
    # these bit-for-bit cases do not describe.
    assert ref.available(), "lotus_tpu.native did not build its library"


def components(labels: np.ndarray) -> set[frozenset]:
    groups: dict[int, set] = {}
    for node, label in enumerate(labels.tolist()):
        groups.setdefault(label, set()).add(node)
    return {frozenset(g) for g in groups.values()}


def random_graph(seed: int, n: int, e: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n, size=(e, 2)).astype(np.int64)


@pytest.mark.parametrize("seed,n,e", [(0, 50, 30), (1, 1000, 800), (2, 1000, 5000), (3, 20_000, 15_000),
                                      (4, 7, 0)])
def test_union_find_labels_equal_reference(seed, n, e):
    edges = random_graph(seed, n, e)
    labels = native.union_find(edges, n)
    np.testing.assert_array_equal(labels, ref.union_find(edges, n))
    assert components(labels) == components(native.union_find_reference(edges, n))


def test_union_find_long_chain():
    n = 100_000
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).astype(np.int64)
    labels = native.union_find(edges, n)
    np.testing.assert_array_equal(labels, ref.union_find(edges, n))
    assert len(set(labels.tolist())) == 1
    # Reversed and shuffled, the chain is still one component.
    shuffled = edges[np.random.default_rng(5).permutation(n - 1)][:, ::-1]
    np.testing.assert_array_equal(native.union_find(shuffled, n), ref.union_find(shuffled, n))


def test_union_find_refuses_ids_past_the_nodes():
    for bad in ([[0, 3]], [[-1, 0]]):
        with pytest.raises(ValueError, match="edge ids"):
            native.union_find(np.array(bad), 3)


def test_union_find_reference_components():
    # 0-1-2 form one component, 3-4 another, 5 isolated.
    edges = np.array([[0, 1], [1, 2], [3, 4]], dtype=np.int64)
    for fn in (native.union_find, native.union_find_reference):
        assert components(fn(edges, 6)) == {frozenset({0, 1, 2}), frozenset({3, 4}), frozenset({5})}


def pools(seed: int, b: int, n_lists: int, list_len: int, *, ties: bool, interior: bool, tails: bool):
    """(B, n_lists, list_len) descending lists of scores and ids: with
    ``ties``, scores drawn from a few values; with ``tails``, each list's
    last entries -1; with ``interior``, some -1 ids inside lists."""
    rng = np.random.default_rng(seed)
    shape = (b, n_lists, list_len)
    raw = rng.integers(0, 4, size=shape) if ties else rng.standard_normal(shape)
    scores = -np.sort(-raw.astype(np.float32), axis=-1)
    ids = rng.integers(0, 10_000, size=(b, n_lists, list_len)).astype(np.int64)
    if tails:
        cut = rng.integers(0, list_len + 1, size=(b, n_lists))
        ids[np.arange(list_len)[None, None, :] >= cut[..., None]] = -1
    if interior:
        ids[rng.random((b, n_lists, list_len)) < 0.15] = -1
    return scores, ids


CASES = {
    "distinct": dict(ties=False, interior=False, tails=False),
    "tails": dict(ties=False, interior=False, tails=True),
    "ties": dict(ties=True, interior=False, tails=False),
    "ties_tails": dict(ties=True, interior=False, tails=True),
    "interior": dict(ties=False, interior=True, tails=False),
    "ties_interior_tails": dict(ties=True, interior=True, tails=True),
}


@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("case", sorted(CASES))
def test_topk_merge_batch_bitwise(case, k):
    """k 37 runs past a pool of 3 lists x 12 (36 candidates)."""
    scores, ids = pools(sorted(CASES).index(case), 64, 3, 12, **CASES[case])
    got_s, got_i = native.topk_merge_batch(scores, ids, k)
    want_s, want_i = ref.topk_merge_batch(scores, ids, k)
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
    np.testing.assert_array_equal(got_i, want_i)
    for q in (0, 17, 63):
        s, i = native.topk_merge(scores[q], ids[q], k)
        rs, ri = ref.topk_merge(scores[q], ids[q], k)
        np.testing.assert_array_equal(s.view(np.int32), rs.view(np.int32))
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(s, got_s[q])
        np.testing.assert_array_equal(i, got_i[q])


@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("case", ["distinct", "tails"])
def test_topk_merge_plain_version(case, k):
    """Distinct scores with -1 only at list ends: the plain version gives the
    library's answer exactly."""
    scores, ids = pools(7 + k, 64, 3, 12, **CASES[case])
    got = native.topk_merge_batch(scores, ids, k)
    plain = native.topk_merge_batch_reference(scores, ids, k)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_topk_merge_quirks_of_the_plain_version():
    """The reference's C++ ends a list at its first -1 and orders ties as
    its heap pops them; its Python fallback skips the -1 and sorts stably.
    The port's library follows the C++."""
    scores = np.array([[9.0, 8.0, 5.0], [7.0, 6.0, 1.0]], dtype=np.float32)
    ids = np.array([[10, -1, 12], [20, 21, 22]], dtype=np.int64)
    lib_s, lib_i = native.topk_merge(scores, ids, 4)
    assert lib_i.tolist() == [10, 20, 21, 22] == ref.topk_merge(scores, ids, 4)[1].tolist()
    assert native.topk_merge_reference(scores, ids, 4)[1].tolist() == [10, 20, 21, 12]

    tied = np.ones((3, 2), dtype=np.float32)
    tied_ids = np.arange(6, dtype=np.int64).reshape(3, 2)
    lib_order = native.topk_merge(tied, tied_ids, 6)[1].tolist()
    assert lib_order == ref.topk_merge(tied, tied_ids, 6)[1].tolist()
    assert native.topk_merge_reference(tied, tied_ids, 6)[1].tolist() == [0, 1, 2, 3, 4, 5]
    assert sorted(lib_order) == [0, 1, 2, 3, 4, 5]


def test_topk_merge_missing_pads():
    scores = np.array([[9.0, 0.0], [8.0, 7.0]], dtype=np.float32)
    ids = np.array([[10, -1], [20, 21]], dtype=np.int64)
    s, i = native.topk_merge(scores, ids, 5)
    assert i.tolist() == [10, 20, 21, -1, -1]
    np.testing.assert_array_equal(s[3:], np.float32(native.MISSING_SCORE))
    with pytest.raises(ValueError, match="matching"):
        native.topk_merge_batch(scores, ids, 2)
    with pytest.raises(ValueError, match="matching"):
        native.topk_merge(scores, ids[:, :1], 2)


ARRAYS = {
    "f32": np.random.default_rng(0).standard_normal((37, 5)).astype(np.float32),
    "i8": np.random.default_rng(1).integers(-127, 128, size=(3, 64)).astype(np.int8),
    "i64": np.arange(1000, dtype=np.int64),
    "empty": np.zeros((0, 4), dtype=np.float32),
}
WRITERS = {"port": native.write_array, "reference": ref.write_array, "plain": native.write_array_reference}
READERS = {"port": native.read_array, "reference": ref.read_array, "plain": native.read_array_reference}


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port"), ("port", "port"),
                                           ("plain", "port"), ("port", "plain")])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_array_files_cross_read(tmp_path, writer, reader, name):
    arr = ARRAYS[name]
    path = str(tmp_path / "arr.ltpu")
    WRITERS[writer](path, arr)
    ref.write_array(str(tmp_path / "ref.ltpu"), arr)
    assert Path(path).read_bytes() == (tmp_path / "ref.ltpu").read_bytes()
    back = READERS[reader](path, arr.dtype, arr.shape)
    np.testing.assert_array_equal(back, arr)
    assert back.dtype == arr.dtype


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_array_files_detect_corruption(tmp_path, writer):
    arr = np.arange(100, dtype=np.float32)
    path = str(tmp_path / "arr.ltpu")
    WRITERS[writer](path, arr)
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    for read in (native.read_array, ref.read_array, native.read_array_reference):
        with pytest.raises(OSError, match="checksum|corrupt"):
            read(path, np.float32, (100,))
    WRITERS[writer](path, arr)
    with pytest.raises(OSError, match="size mismatch"):
        native.read_array(path, np.float32, (101,))
    with pytest.raises(OSError):
        native.read_array(str(tmp_path / "missing.ltpu"), np.float32, (1,))


def test_library_is_built_into_the_build_directory():
    assert native.available()
    path = native.build()
    assert path.parent == BUILD_DIR and path.name.startswith("liblotus_native_") and path.exists()
    assert path == native.build()  # the digest names it: a second call rebuilds nothing
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" { int lotus_union_find( }\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.union_find(np.zeros((0, 2), np.int64), 3)
    assert "broken.cpp" in str(err.value)  # the compiler's output comes with it
    assert not native.available()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.topk_merge(np.zeros((1, 1), np.float32), np.zeros((1, 1), np.int64), 1)
