"""The least time of the commit's NTT on an H100: operations and bytes counted
from the transform's plan, against published peaks frozen here.

The commit encodes the packed witness with one forward additive NTT over B32
twiddles on B128 data: K2 lays the codeword out as 128 bit planes and back
(two launches), K4 runs the stages whose butterflies span more than a K3
tile (runs of up to 7 per launch), K3 the trailing stages inside the tile.
The counts follow the program's plan rule (`bitsliced_ntt._make_plan`) and
its gate networks; the arithmetic is `chip_smoke.py`'s (`mul_gates`,
`ntt_ops`, `TRANSPOSE_GATES_PER_WORD`, `bound_ms`), copied so that the
yardstick stays as it is.

The transform's least time (`transform_bound_s`) is the larger of its
operations (the gates of both layouts and of every stage) at the logic
peak, and of one read of its input and one write of its output at the
memory peak: the planes each kernel passes through memory in between are
the current split's, not the transform's. `kernel_work` gives each kernel's
own operations and bytes, those passes included, as `chip_smoke.bound_ms`
counts them.

Peaks: NVIDIA's data sheet for the H100 SXM (3.35 TB/s of HBM3), and two-input
gates at 132 SMs x 1,980 MHz x 64 32-bit logic results per clock per SM x 2
gates per LOP3. They are not read from the card.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_MHZ = 1980.0
LOGIC_PER_CLOCK_PER_SM = 64
GATES_PER_LOP3 = 2
GATES_PER_S = SMS * SM_MHZ * 1e6 * LOGIC_PER_CLOCK_PER_SM * GATES_PER_LOP3

TRANSPOSE_GATES_PER_WORD = 15   # one 32 x 32 bit transpose: 5 rounds of 3
TILE_WORDS = 1024               # K3's tile
CROSS_STAGES = 7                # K4: stages per launch
DATA_LEVEL, TWIDDLE_LEVEL = 7, 5


def mul_gates(level: int) -> int:
    """Two-input gates of the bitsliced Karatsuba product at a tower level."""
    if level == 0:
        return 1
    h = 1 << (level - 1)
    return 3 * mul_gates(level - 1) + 6 * h - 1


@dataclasses.dataclass(frozen=True)
class Plan:
    n_words: int
    stage_d_elems: tuple   # butterfly distance of each stage, in execution order
    n_local: int           # the trailing stages K3 runs

    @staticmethod
    def forward(log_x: int, log_y: int, skip_rounds: int) -> "Plan":
        """The forward transform of shape (log_x, log_y, 0): 2^log_x
        interleaved columns of 2^log_y elements, the first `skip_rounds`
        rounds skipped (the repeated message of a rate-1/2^skip code)."""
        n_words = 1 << (log_x + log_y - 5)
        d = tuple(1 << (i + log_x) for i in range(log_y - skip_rounds - 1, -1, -1))
        tile = min(TILE_WORDS, n_words)
        n_local = 0
        for de in reversed(d):
            if (de >> 5) > tile // 2:
                break
            n_local += 1
        return Plan(n_words, d, n_local)

    def cross_runs(self) -> list[int]:
        n_cross = len(self.stage_d_elems) - self.n_local
        return [min(CROSS_STAGES, n_cross - f) for f in range(0, n_cross, CROSS_STAGES)]


def ntt_ops(plan: Plan, d_elems) -> int:
    """Gates of the given butterfly stages (`chip_smoke.ntt_ops`)."""
    groups, p = 1 << (DATA_LEVEL - TWIDDLE_LEVEL), 1 << TWIDDLE_LEVEL
    ops = 0
    for d in d_elems:
        per = mul_gates(TWIDDLE_LEVEL) + 3 * p + (2 * p * 8 if d < 32 else 2 * p)
        ops += plan.n_words // 2 * groups * per
    return ops


def bound_s(n_bytes: int, n_ops: int) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / GATES_PER_S)


def kernel_work(plan: Plan) -> dict:
    """Bytes and gates of K2 (both launches), K3 and K4 (all runs) for one
    transform, each kernel on its own: its input read once and its output
    written once, the stages' twiddle rows read once."""
    planes_words = (1 << DATA_LEVEL) * plan.n_words
    n_elems_words = planes_words            # 4 words per B128 element
    d = plan.stage_d_elems
    n_cross = len(d) - plan.n_local
    runs = plan.cross_runs()
    return {
        "k2": (2 * 2 * n_elems_words * 4, 2 * n_elems_words * TRANSPOSE_GATES_PER_WORD),
        "k3": (2 * planes_words * 4 + plan.n_local * plan.n_words * 4,
               ntt_ops(plan, d[n_cross:])),
        "k4": (2 * len(runs) * planes_words * 4 + n_cross * plan.n_words * 4,
               ntt_ops(plan, d[:n_cross])),
    }


def transform_bound_s(plan: Plan) -> float:
    """Least seconds of one transform: all of its gates, against its input
    read once and its output written once."""
    n_bytes = 2 * (1 << DATA_LEVEL) * plan.n_words * 4
    return bound_s(n_bytes, sum(ops for _, ops in kernel_work(plan).values()))
