"""The port's native host library (`binius_tpu_torch/native/`) against its
plain Python versions and the JAX package's, which runs its own C: tower
scalar ops at every level, B128 batch products, barycentric weights and
Lagrange evaluations, the shift indicator's carry DP, and Grøstl-256's
permutations, compression, streaming, batch digests and 2-to-1
compression. Field arithmetic and hashing are exact: every case is equal.
The library builds from an empty build directory, and a failing compiler
raises."""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from binius_tpu.fields import scalar as jscalar
from binius_tpu.hash import groestl as jgroestl
from binius_tpu.math import univariate as juni
from binius_tpu.protocols import ring_switch as jring_switch
from binius_tpu.protocols import shift_ind as jshift
from binius_tpu_torch import native
from binius_tpu_torch.convert import ints_to_pairs
from binius_tpu_torch.fields import scalar, tower
from binius_tpu_torch.hash import groestl
from binius_tpu_torch.math import univariate
from binius_tpu_torch.protocols import shift_ind

torch.set_num_threads(1)  # the suite's test processes share the cores


def _elems(level: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64)
    vals = [int(w[0]) | int(w[1]) << 32 | int(w[2]) << 64 | int(w[3]) << 96 for w in words]
    return [v & ((1 << (1 << level)) - 1) for v in vals]


@pytest.fixture
def c_everywhere(monkeypatch):
    """Every scalar op through C, whatever the operand's size."""
    for name in ("PY_MUL_BELOW", "PY_INVERT_BELOW"):
        monkeypatch.setattr(scalar, name, 0)


def _c_square(level: int, a: int) -> int:
    """The C square (`tower_square`), which `scalar.square` leaves to Python."""
    out = (ctypes.c_uint64 * 2)()
    native.get_lib().tower_square(scalar._level_of(a), a & ((1 << 64) - 1), a >> 64, out)
    return out[0] | out[1] << 64


@pytest.mark.parametrize("level", range(8))
def test_scalar_ops_match_plain_and_reference(level, c_everywhere):
    xs = [0, 1, (1 << (1 << level)) - 1] + _elems(level, 40, level)
    ys = [1, 0, 1] + _elems(level, 40, 100 + level)
    for a, b in zip(xs, ys):
        assert scalar.mul(level, a, b) == scalar.mul_py(level, a, b) == jscalar.mul(level, a, b)
        assert _c_square(level, a) == scalar.square(level, a) == jscalar.square(level, a)
        if a:
            assert (scalar.invert(level, a) == scalar.invert_py(level, a)
                    == jscalar.invert(level, a))
        for e in (0, 1, b, (1 << 64) - 1, (1 << 64) + b, 3 << 70):
            assert (scalar.pow(level, a, e) == scalar.pow_py(level, a, e)
                    == jscalar.pow(level, a, e))
    with pytest.raises(ZeroDivisionError):
        scalar.invert(level, 0)


def test_scalar_dispatch_bounds_match_plain():
    """With the bounds as shipped: operands on both sides of each bound."""
    for level in (3, 4, 5, 6, 7):
        for a, b in zip(_elems(level, 30, 7 + level), _elems(level, 30, 70 + level)):
            assert scalar.mul(7, a, b) == scalar.mul_py(7, a, b)
            if a:
                assert scalar.invert(level, a) == scalar.invert_py(level, a)
            assert scalar.pow(7, a, b) == scalar.pow_py(7, a, b)
    with pytest.raises(ZeroDivisionError):
        scalar.invert(7, 0)


@pytest.mark.parametrize("k", [1, 7, 300])
def test_mul_batch_matches_plain_and_reference(k):
    a = ints_to_pairs(_elems(7, k, k))
    b = ints_to_pairs(_elems(7, k, k + 1))
    got = scalar.mul_pairs(7, a, b)
    assert np.array_equal(got, scalar.mul_pairs_py(7, a, b))
    assert np.array_equal(got, jring_switch._mul_pairs(a, b))
    a5, b5 = (ints_to_pairs(_elems(5, k, s)) for s in (k + 2, k + 3))
    assert np.array_equal(scalar.mul_pairs(5, a5, b5), scalar.mul_pairs_py(5, a5, b5))
    with pytest.raises(ValueError):
        scalar.mul_pairs(5, a, b)


def _limbs_to_ints(arr: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in np.asarray(arr)]


@pytest.mark.parametrize("n", [2, 3, 64])
def test_lagrange_matches_plain_and_reference(n):
    points = univariate.EvaluationDomain.from_subspace(7, n).points
    weights = univariate.barycentric_weights(points)
    assert weights == univariate._barycentric_weights_py(points)
    assert list(weights) == _limbs_to_ints(juni._barycentric_weights_np(points))
    for z in (_elems(7, 1, n)[0], points[n // 2], points[0]):
        got = univariate.lagrange_evals_np(points, z)
        assert got == tower.to_ints(7, univariate.lagrange_evals_device(points, z, "cpu"))
        assert got == _limbs_to_ints(juni.lagrange_evals_np(points, z))
    assert univariate.lagrange_evals_np(points, points[n - 1]) == [int(i == n - 1)
                                                                   for i in range(n)]


@pytest.mark.parametrize("b", [1, 3, 6])
def test_shift_indicator_dp_matches_plain_and_reference(b):
    rng = np.random.default_rng(b)
    variants = [shift_ind.LOGICAL_LEFT, shift_ind.LOGICAL_RIGHT, shift_ind.CIRCULAR_LEFT] * 2
    offs = [int(rng.integers(1, 1 << b)) for _ in variants]
    xs = [_elems(7, b, 10 * b + i) for i in range(len(variants))]
    ys = [_elems(7, b, 20 * b + i) for i in range(len(variants))]
    got = shift_ind.evaluate_scalar_batch(variants, [b] * len(variants), offs, xs, ys)
    assert got == [shift_ind.evaluate_scalar(v, b, o, x, y)
                   for v, o, x, y in zip(variants, offs, xs, ys)]
    assert got == jshift.evaluate_scalar_batch(variants, [b] * len(variants), offs, xs, ys)


def _cols(seed: int) -> list[int]:
    return [int(v) for v in np.random.default_rng(seed).integers(0, 1 << 64, 8, dtype=np.uint64)]


@pytest.mark.parametrize("is_q", [False, True])
def test_permute_and_compress_match_plain_and_reference(is_q):
    for seed in range(4):
        cols, m = _cols(seed), _cols(seed + 50)
        assert (groestl._permute_cols(cols, is_q) == groestl._py_permute_cols(cols, is_q)
                == jgroestl._permute_cols(cols, is_q))
        assert (groestl._compress_cols(cols, m) == groestl._py_compress_cols(cols, m)
                == jgroestl._compress_cols(cols, m))
        assert (groestl.compress_seq_native(cols, bytes(64) * 3)
                == jgroestl.compress_seq_native(cols, bytes(64) * 3))


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 1000])
def test_groestl256_streamed_matches_one_shot(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    want = groestl.groestl256(data)
    assert want == groestl._py_groestl256(data) == jgroestl.groestl256(data)
    h = groestl.Groestl256()
    for i, j in zip([0, 1, 9, 70, 200], [1, 9, 70, 200, length]):
        h.update(data[i:j])
    assert h.finalize() == want
    assert groestl.Groestl256().update(data).finalize() == want


def test_groestl256_copy_forks():
    data = np.random.default_rng(3).integers(0, 256, 300, dtype=np.uint8).tobytes()
    h = groestl.Groestl256().update(data[:100])
    fork = h.copy()
    h.update(data[100:])
    fork.update(data[100:150])
    assert h.finalize() == groestl.groestl256(data)
    assert fork.finalize() == groestl.groestl256(data[:150])
    jh = jgroestl.Groestl256().update(data[:100])
    assert jh.copy().update(data[100:150]).finalize() == groestl.groestl256(data[:150])
    assert (h._h, h._n_bytes) == (jgroestl.Groestl256().update(data)._h, 300)


@pytest.mark.parametrize("width", [16, 56, 256])
def test_digest_rows_match_plain_and_reference(width):
    blobs = np.random.default_rng(width).integers(0, 256, (5, width), dtype=np.uint8)
    got = groestl.hash_leaves_np(blobs)
    assert np.array_equal(got, groestl.digest_rows_native(blobs))
    assert np.array_equal(got, groestl.leaf_hash_t(torch.from_numpy(blobs)).numpy())
    assert np.array_equal(got, jgroestl.digest_rows_native(blobs))
    assert got[2].tobytes() == groestl._py_groestl256(blobs[2].tobytes())


@pytest.mark.parametrize("n", [1, 8, 300])
def test_compress_pairs_match_plain_and_reference(n):
    pairs = np.random.default_rng(n).integers(0, 256, (n, 64), dtype=np.uint8)
    got = groestl.compress_pairs(pairs)
    assert got.shape == (n, 32)
    assert np.array_equal(got, groestl.compress_pairs_t(torch.from_numpy(pairs)).numpy())
    assert np.array_equal(got, jgroestl.compress_pairs(pairs))
    assert np.array_equal(groestl.compress_pairs(pairs[0]), got[0])


def _copy_package(tmp_path):
    """The native package alone in a fresh directory: its build directory
    is empty."""
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.dirname(native.__file__), pkg / "native",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return pkg


_LOAD = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import native
    lib = native.get_lib()
    out = (__import__("ctypes").c_uint64 * 2)()
    lib.tower_mul(7, 3, 5, 7, 11, out)
    print(native.build(), out[0], out[1])
""")


def test_builds_from_empty_build_dir(tmp_path):
    pkg = _copy_package(tmp_path)
    out = subprocess.run([sys.executable, "-c", _LOAD, str(pkg)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    so, lo, hi = out.stdout.split()
    assert os.path.dirname(so) == str(pkg / "build") and os.path.exists(so)
    want = scalar.mul_py(7, 3 | 5 << 64, 7 | 11 << 64)
    assert int(lo) | int(hi) << 64 == want


def test_failing_compiler_raises(tmp_path):
    pkg = _copy_package(tmp_path)
    stub = tmp_path / "cc_stub"
    stub.write_text("#!/bin/sh\necho 'stub compiler: no' >&2\nexit 3\n")
    stub.chmod(0o755)
    for cc, said in ((str(stub), "stub compiler: no"), (str(tmp_path / "no_cc"),
                                                         "cannot run the C compiler")):
        out = subprocess.run([sys.executable, "-c", _LOAD, str(pkg)], capture_output=True,
                             text=True, timeout=120, env={**os.environ, "CC": cc})
        assert out.returncode != 0
        assert "RuntimeError" in out.stderr and said in out.stderr, out.stderr
    assert not list((pkg / "build").glob("*.so"))
