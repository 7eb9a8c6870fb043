"""The port's native PQ library (million_tpu_torch/native.py, its own copy of
the C++ source built into million_tpu_torch/csrc/build/) against
million_tpu.native: the same source at the same seed, so codebooks and codes
must be bit-equal. Rows are continuous random data, so no cluster goes empty
(the library's donor order for empty clusters depends on which thread
trains which subspace). Skipped where no g++ is found."""

import shutil

import numpy as np
import pytest

from million_tpu import native as jn
from million_tpu_torch import native as tn

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def test_port_keeps_a_verbatim_copy_of_the_source():
    root = tn.SRC.parents[2]
    assert tn.SRC.read_bytes() == (root / "native" / "pqlib.cpp").read_bytes()
    assert tn.library_path().parent == root / "million_tpu_torch" / "csrc" / "build"


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("n,d,M,nbits", [(1500, 32, 16, 4), (1200, 16, 4, 6), (2000, 64, 8, 7)])
def test_train_and_encode_bit_equal(rng, layout, n, d, M, nbits):
    x = rng.standard_normal((n, d)).astype(np.float32)
    got = tn.train_pq_native(x, M, nbits, iters=6, seed=5, layout=layout)
    want = jn.train_pq_native(x, M, nbits, iters=6, seed=5, layout=layout)
    assert got.shape == (M, 2**nbits, d // M)
    np.testing.assert_array_equal(got, want)
    xq = rng.standard_normal((3, 50, d)).astype(np.float32)
    codes = tn.encode_native(xq, got, layout)
    assert codes.shape == (3, 50, M) and codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, jn.encode_native(xq, want, layout))


def test_native_available_and_rejects_bad_args(rng):
    assert tn.native_available()
    with pytest.raises(ValueError):
        tn.train_pq_native(rng.standard_normal((10, 32)).astype(np.float32), M=16, nbits=8)


def test_no_compiler_raises(monkeypatch, tmp_path):
    """Without g++ the port raises; it neither falls back nor writes under native/."""
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn.shutil, "which", lambda name: None)
    assert not tn.native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tn.encode_native(np.zeros((4, 8), np.float32), np.zeros((4, 4, 2), np.float32))
    assert not (tmp_path / "build").exists()
