"""The port's data layer against the JAX package's: MAT v5 files in both
directions (both readers of each package, compressed and not), the vecs
files and their malformed-file errors, the SIFT-shaped generator, the
digits set and the MNIST loader on a ``.mat``."""

import numpy as np
import pytest

from mpi_knn_tpu.data import digits as ref_digits
from mpi_knn_tpu.data import matfile as ref_mat
from mpi_knn_tpu.data import mnist as ref_mnist
from mpi_knn_tpu.data import synthetic as ref_synth
from mpi_knn_tpu.data import vecs as ref_vecs
from mpi_knn_tpu_torch.data import digits, matfile, mnist, synthetic, vecs

DTYPES = [np.float64, np.float32, np.int32, np.uint8, np.int16, np.int64]


def _array(dtype, shape=(7, 5)):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(shape) * 50).astype(dtype)


def _readers(module):
    return {"native": module.read_mat_native, "numpy": module.read_mat_numpy}


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: np.dtype(t).name)
def test_port_writer_to_both_packages_readers(tmp_path, compress, dtype):
    X = _array(dtype)
    path = tmp_path / "a.mat"
    matfile.write_mat(path, {"train_X": X, "v": np.arange(4, dtype=dtype)},
                      compress=compress)
    for pkg in (ref_mat, matfile):
        for name, read in _readers(pkg).items():
            got = read(path)
            assert got["train_X"].dtype == np.float64, name
            np.testing.assert_array_equal(got["train_X"], X.astype(np.float64))
            np.testing.assert_array_equal(got["v"], np.arange(4.0)[:, None])


@pytest.mark.parametrize("compress", [True, False])
def test_port_writer_bytes_equal_the_reference_writer(tmp_path, compress):
    """Byte for byte after the 116-byte header text."""
    arrays = {"train_X": _array(np.float64), "train_labels": np.arange(7) + 1,
              "s": _array(np.float32, (3, 9))}
    matfile.write_mat(tmp_path / "p.mat", arrays, compress=compress)
    ref_mat.write_mat(tmp_path / "r.mat", arrays, compress=compress)
    got, want = ((tmp_path / n).read_bytes() for n in ("p.mat", "r.mat"))
    assert got[116:] == want[116:] and len(got) == len(want)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_reference_writer_to_port_readers(tmp_path, compress, reader):
    X = _array(np.float32, (11, 3))
    path = tmp_path / "r.mat"
    ref_mat.write_mat(path, {"train_X": X, "queries": X[:2]},
                      compress=compress)
    got = _readers(matfile)[reader](path)
    want = ref_mat.read_mat(path)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("limit", [None, 4])
@pytest.mark.parametrize("compress", [True, False])
def test_load_corpus_mat_labels_and_limit(tmp_path, limit, compress):
    X = _array(np.float64, (9, 6))
    labels = np.array([1, 2, 3, 10, 1, 4, 5, 6, 7], dtype=np.float64)
    path = tmp_path / "c.mat"
    matfile.write_mat(path, {"train_X": X, "train_labels": labels},
                      compress=compress)
    gx, gy = matfile.load_corpus_mat(path, limit=limit)
    wx, wy = ref_mat.load_corpus_mat(path, limit=limit)
    assert gx.dtype == np.float32 and gy.dtype == np.int32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gy, (labels - 1)[:limit].astype(np.int32))


def test_load_corpus_mat_without_labels_or_train_x(tmp_path):
    path = tmp_path / "x.mat"
    matfile.write_mat(path, {"train_X": _array(np.float32)})
    X, y = matfile.load_corpus_mat(path)
    assert y is None and X.shape == (7, 5)
    matfile.write_mat(path, {"other": _array(np.float32)})
    for pkg in (ref_mat, matfile):
        with pytest.raises(ValueError, match="no train_X"):
            pkg.load_corpus_mat(path)
    with pytest.raises(FileNotFoundError):
        matfile.read_mat(tmp_path / "absent.mat")


def test_reader_name_says_which_reader_runs(tmp_path):
    path = tmp_path / "a.mat"
    matfile.write_mat(path, {"train_X": _array(np.float32)})
    name = matfile.reader_name()
    assert name == ("native" if matfile.load_native_lib() else "numpy")
    assert matfile.read_mat(path).keys() == {"train_X"}


def test_bad_mat_files_are_refused(tmp_path):
    short = tmp_path / "short.mat"
    short.write_bytes(b"MATLAB 5.0")
    for pkg in (ref_mat, matfile):
        with pytest.raises(ValueError, match="too short"):
            pkg.read_mat_numpy(short)
    with pytest.raises(ValueError, match="only 1-D/2-D"):
        matfile.write_mat(tmp_path / "b.mat", {"x": np.zeros((2, 2, 2))})
    with pytest.raises(ValueError, match="unsupported dtype"):
        matfile.write_mat(tmp_path / "b.mat", {"x": np.zeros(3, np.complex64)})


# ---------------------------------------------------------------- vecs

VECS = {".fvecs": np.float32, ".bvecs": np.uint8, ".ivecs": np.int32}


@pytest.mark.parametrize("suffix", list(VECS))
@pytest.mark.parametrize("reader", ["native", "numpy"])
@pytest.mark.parametrize("limit", [None, 3, 0])
def test_vecs_round_trip_against_the_reference(tmp_path, suffix, reader,
                                               limit):
    rng = np.random.default_rng(1)
    X = (rng.random((10, 12)) * 200).astype(VECS[suffix])
    path = tmp_path / f"x{suffix}"
    vecs.write_vecs(path, X)
    read = {"native": vecs.read_vecs_native,
            "numpy": vecs.read_vecs_numpy}[reader]
    got = read(path, limit=limit)
    want = ref_vecs.read_vecs(path, limit=limit)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if limit != 0:
        np.testing.assert_array_equal(got, X[:limit].astype(got.dtype))


def _malformed(tmp_path, case):
    path = tmp_path / "bad.fvecs"
    X = np.ones((4, 3), np.float32)
    vecs.write_vecs(path, X)
    raw = bytearray(path.read_bytes())
    if case == "truncated":
        raw = raw[:-5]
    elif case == "inconsistent":
        raw[2 * 16: 2 * 16 + 4] = np.int32(5).tobytes()
    elif case == "implausible":
        raw[:4] = np.int32(-2).tobytes()
    elif case == "short_head":
        raw = raw[:2]
    path.write_bytes(bytes(raw))
    return path


@pytest.mark.parametrize("case,message", [
    ("truncated", "truncat"), ("inconsistent", "inconsistent dimension"),
    ("implausible", "implausible dimension"),
    ("short_head", "truncated dimension"),
])
def test_malformed_vecs_are_refused_as_the_reference_refuses(tmp_path, case,
                                                             message):
    path = _malformed(tmp_path, case)
    for read in (vecs.read_vecs_native, ref_vecs.read_vecs_native):
        with pytest.raises(ValueError):
            read(path)
    for read in (vecs.read_vecs_numpy, ref_vecs.read_vecs_numpy):
        with pytest.raises(ValueError, match=message):
            read(path)


def test_vecs_suffix_is_checked(tmp_path):
    for read in (vecs.read_vecs, ref_vecs.read_vecs):
        with pytest.raises(ValueError, match="not a .fvecs"):
            read(tmp_path / "x.txt")


# ---------------------------------------------------------------- corpora


@pytest.mark.parametrize("m,chunk,seed", [(1000, 300, 0), (257, 100_000, 3)])
def test_make_sift_like_is_bitwise_the_reference(m, chunk, seed):
    got = synthetic.make_sift_like(m=m, d=128, seed=seed, chunk=chunk)
    want = ref_synth.make_sift_like(m=m, d=128, seed=seed, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == (m, 128)
    assert np.array_equal(got, want)


def test_digits_equal_the_reference():
    gx, gy = digits.load_digits()
    wx, wy = ref_digits.load_digits()
    assert gx.shape == (1797, 64) and gx.dtype == np.float32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("m", [20, 7])
def test_load_mnist_reads_the_mat_layout(tmp_path, m):
    X = _array(np.uint8, (20, 784)).astype(np.float64)
    labels = (np.arange(20) % 10 + 1).astype(np.float64)
    path = tmp_path / "mnist_train.mat"
    matfile.write_mat(path, {"train_X": X, "train_labels": labels})
    gx, gy, src = mnist.load_mnist(str(path), m=m)
    wx, wy, wsrc = ref_mnist.load_mnist(str(path), m=m)
    assert src == wsrc == "mat"
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    assert gx.shape == (m, 784) and gy.max() == min(m, 10) - 1


def test_load_mnist_mat_needs_labels(tmp_path):
    path = tmp_path / "nolabels.mat"
    matfile.write_mat(path, {"train_X": _array(np.float32)})
    with pytest.raises(ValueError, match="train_labels"):
        mnist.load_mnist(str(path))
