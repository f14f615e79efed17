"""The port's small helpers that no proof path calls, against the JAX
package's: the bitsliced square, B128 coordinates, the batched claim sum,
shifted columns on the host, one claim's shift-indicator multilinear, the
static exponentiation witness under its earlier name and the codeword's
host copy. Every comparison is exact."""

import numpy as np
import pytest
import torch

from binius_tpu.fields import scalar as jscalar
from binius_tpu.protocols import ring_switch as jring_switch
from binius_tpu.protocols import shift_ind as jshift_ind
from binius_tpu.protocols.sumcheck import common as jcommon
from binius_tpu_torch.fields import bitslice, tower
from binius_tpu_torch.math import mle
from binius_tpu_torch.protocols import fri, gkr_exp, ring_switch, shift_ind
from binius_tpu_torch.protocols.sumcheck import common

torch.set_num_threads(1)  # the suite's test processes share the cores


def _ints(rng, bits: int, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


@pytest.mark.parametrize("level", [5, 7])
def test_bitsliced_square(level):
    vals = _ints(np.random.default_rng(level), 1 << level, 64)
    x = tower.from_ints(level, vals, "cpu")
    got = bitslice.square(level, x)
    assert tower.to_ints(level, got) == [jscalar.square(level, v) for v in vals]
    assert torch.equal(bitslice.square_planes(level, bitslice.to_bitsliced(level, x)),
                       bitslice.to_bitsliced(level, got))


def test_coords_and_batched_sum():
    rng = np.random.default_rng(1)
    e = _ints(rng, 128, 1)[0]
    for level in (0, 3, 5):
        cs = [ring_switch.coord(level, e, j) for j in range(128 >> level)]
        assert cs == [jring_switch.coord(level, e, j) for j in range(128 >> level)]
        assert ring_switch.from_coords(level, cs) == jring_switch.from_coords(level, cs) == e
    sums, coeffs = _ints(rng, 128, 5), _ints(rng, 128, 5)
    assert common.batch_weighted_sum(sums, coeffs) == jcommon.batch_weighted_sum(sums, coeffs)


@pytest.mark.parametrize("variant", [shift_ind.CIRCULAR_LEFT, shift_ind.LOGICAL_LEFT,
                                     shift_ind.LOGICAL_RIGHT])
def test_shift_helpers(variant):
    rng = np.random.default_rng(2)
    vals = _ints(rng, 32, 32)
    assert shift_ind.apply_shift_ints(variant, 3, 3, vals) == \
        jshift_ind.apply_shift_ints(variant, 3, 3, vals)
    x = _ints(rng, 128, 3)
    got = shift_ind.partial_mle(variant, 3, 3, x, "cpu")
    assert torch.equal(got, shift_ind.partial_mle_batch([variant], 3, [3], [x], "cpu")[0])
    # its evaluation at y is shift_ind(x, y)
    ys = _ints(rng, 128, 3)
    eq = tower.to_ints(7, mle.eq_ind_partial_eval(7, tower.from_ints(7, ys, "cpu")))
    acc = 0
    for v, w in zip(tower.to_ints(7, got), eq):
        acc ^= jscalar.mul(7, v, w)
    assert acc == jshift_ind.evaluate_scalar(variant, 3, 3, x, ys)


def test_static_exp_witness_and_codeword_copy():
    bits = [torch.tensor([1, 0, 1, 1], dtype=torch.int32), torch.tensor([0, 1, 1, 0])]
    a = gkr_exp.StaticExpWitness.compute(2, 0x1234, bits)
    b = gkr_exp.ExpWitness.static(2, 0x1234, bits)
    assert torch.equal(a.layers, b.layers) and a.level == b.level == gkr_exp.LEVEL
    cw = tower.from_ints(7, [1, (1 << 127) | 5], "cpu")
    host = fri.codeword_to_numpy(cw)
    assert host.dtype == np.uint32 and host.tolist() == [[1, 0, 0, 0], [5, 0, 0, 1 << 31]]
