"""A Binius proof verifier in plain Python and NumPy: the benchmark's reference.

It checks a proof of a constraint system made of committed, shifted,
linear-combination, repeating and transparent oracles and zero constraints
(no channels, no exponents): the systems of the benchmark's configurations.
It follows the upstream protocol (IrreducibleOSS/binius, FRI-Binius, DP24):

  transcript   Fiat-Shamir over Grøstl-256 (`crates/core/src/transcript`);
  zerocheck    the univariate skip over a B8 subspace domain, then the
               eq-indicator sumcheck, then the univariatizing reduction;
  evalcheck    linear combinations send their inner evaluations, shifted
               oracles reduce through a sumcheck against the shift
               indicator, repeating oracles truncate the point;
  ring switch  the tensor-algebra partial evaluations and row batching;
  PIOP         the front-loaded sumcheck interleaved with FRI folding, the
               terminate codeword, the Merkle layers and the queries.

`verify` raises `Rejected` unless the proof holds, and returns the claims on
the committed oracles that the evalcheck reached: (oracle id, point,
value). The proof binds these values to the commitment, so comparing them
with the statement's own columns (`binding.py`) ties the proof to the
statement. Nothing here is imported from the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import field as F
from . import groestl

SCALAR_BYTES = 16


class Rejected(ValueError):
    """The proof does not verify."""


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise Rejected(what)


# ---------------------------------------------------------------------------
# The system: oracles and zero constraints
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Oracle:
    kind: str            # committed | shifted | linear_combination | repeating | transparent
    n_vars: int
    level: int
    inner: tuple = ()
    shift: tuple = ()    # (offset, block bits, "logical_left" | "circular_left")
    lc: tuple = ()       # (offset, coefficients)
    values: tuple = ()   # transparent: its 2^n_vars values


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    n_vars: int
    oracle_ids: tuple
    exprs: tuple         # expressions over the set's oracles (see `Expr`)


@dataclasses.dataclass(frozen=True)
class System:
    digest: bytes
    oracles: tuple
    constraint_sets: tuple


class Builder:
    """Collects a system's oracles in order; each call returns the id."""

    def __init__(self):
        self.oracles: list[Oracle] = []

    def _add(self, o: Oracle) -> int:
        self.oracles.append(o)
        return len(self.oracles) - 1

    def committed(self, n_vars: int) -> int:
        """A committed B1 column."""
        return self._add(Oracle("committed", n_vars, 0))

    def shifted(self, inner: int, offset: int, block_bits: int, variant: str) -> int:
        o = self.oracles[inner]
        return self._add(Oracle("shifted", o.n_vars, o.level, (inner,),
                                shift=(offset, block_bits, variant)))

    def linear_combination(self, inner: list[int], coeffs: list[int], offset: int = 0) -> int:
        return self._add(Oracle("linear_combination", self.oracles[inner[0]].n_vars, 7,
                                tuple(inner), lc=(offset, tuple(coeffs))))

    def transparent(self, values: list[int], level: int) -> int:
        return self._add(Oracle("transparent", (len(values) - 1).bit_length(), level,
                                values=tuple(values)))

    def repeating(self, inner: int, log_count: int) -> int:
        o = self.oracles[inner]
        return self._add(Oracle("repeating", o.n_vars + log_count, o.level, (inner,)))


def constraint_set(n_vars: int, constraints: list[tuple]) -> ConstraintSet:
    """[(columns, Expr over them)] -> one set over the sorted distinct
    columns, each expression's variables renumbered to positions there."""
    ids = sorted({c for cols, _ in constraints for c in cols})
    pos = {c: i for i, c in enumerate(ids)}

    def renumber(n, cols):
        if n[0] == "var":
            return ("var", pos[cols[n[1]]])
        if n[0] == "const":
            return n
        return (n[0], renumber(n[1], cols), renumber(n[2], cols))

    return ConstraintSet(n_vars, tuple(ids),
                         tuple(Expr(renumber(e.node, cols)) for cols, e in constraints))


class Expr:
    """A polynomial expression: ("var", i) | ("const", c) | ("add", a, b) |
    ("mul", a, b)."""

    def __init__(self, node):
        self.node = node

    @staticmethod
    def var(i: int) -> "Expr":
        return Expr(("var", i))

    @staticmethod
    def const(c: int) -> "Expr":
        return Expr(("const", c))

    def __add__(self, other: "Expr") -> "Expr":
        return Expr(("add", self.node, other.node))

    def __mul__(self, other: "Expr") -> "Expr":
        return Expr(("mul", self.node, other.node))

    def degree(self) -> int:
        def go(n):
            if n[0] == "var":
                return 1
            if n[0] == "const":
                return 0
            a, b = go(n[1]), go(n[2])
            return max(a, b) if n[0] == "add" else a + b
        return go(self.node)

    def evaluate(self, vals: list[int]) -> int:
        def go(n):
            if n[0] == "var":
                return vals[n[1]]
            if n[0] == "const":
                return n[1]
            a, b = go(n[1]), go(n[2])
            return a ^ b if n[0] == "add" else F.mul(a, b)
        return go(self.node)


# ---------------------------------------------------------------------------
# Transcript
# ---------------------------------------------------------------------------

class _Challenger:
    """The upstream HasherChallenger: sampler and observer modes over one
    running hasher."""

    def __init__(self):
        d = groestl.digest(b"")
        self._hasher = groestl.Hasher().update(d)
        self._observing = False
        self._buffer = d
        self._index = 0

    def observe(self, data: bytes) -> None:
        if not self._observing:
            self._hasher.update(self._index.to_bytes(8, "little"))
            self._observing = True
        self._hasher.update(data)

    def sample(self, n: int) -> bytes:
        if self._observing:
            self._observing = False
            self._index = 32
        out = b""
        while n:
            if self._index == 32:
                self._buffer = self._hasher.copy().finalize()
                self._hasher = groestl.Hasher().update(self._buffer)
                self._index = 0
            take = min(32 - self._index, n)
            out += self._buffer[self._index:self._index + take]
            self._index += take
            n -= take
        return out


class Transcript:
    """The verifier's side: messages are read and observed, decommitments
    read only. Obtaining a message reader moves the challenger to its
    observer mode even when nothing is read, as upstream."""

    def __init__(self, proof: bytes):
        self.proof = proof
        self.pos = 0
        self.ch = _Challenger()

    def observe(self, data: bytes = b"") -> None:
        self.ch.observe(data)

    def message(self) -> "Transcript._Reader":
        self.ch.observe(b"")
        return Transcript._Reader(self, True)

    def decommitment(self) -> "Transcript._Reader":
        return Transcript._Reader(self, False)

    def sample(self) -> int:
        return int.from_bytes(self.ch.sample(SCALAR_BYTES), "little")

    def samples(self, n: int) -> list[int]:
        return [self.sample() for _ in range(n)]

    def sample_bits(self, bits: int) -> int:
        raw = int.from_bytes(self.ch.sample(4), "little")
        return raw & ((1 << min(bits, 32)) - 1)

    def finish(self) -> None:
        _require(self.pos == len(self.proof), f"{len(self.proof) - self.pos} proof bytes left")

    class _Reader:
        def __init__(self, t: "Transcript", observed: bool):
            self.t, self.observed = t, observed

        def bytes(self, n: int) -> bytes:
            t = self.t
            _require(t.pos + n <= len(t.proof), "proof too short")
            data = t.proof[t.pos:t.pos + n]
            t.pos += n
            if self.observed:
                t.ch.observe(data)
            return data

        def scalars(self, n: int) -> list[int]:
            raw = self.bytes(SCALAR_BYTES * n)
            return [int.from_bytes(raw[SCALAR_BYTES * i:SCALAR_BYTES * (i + 1)], "little")
                    for i in range(n)]


# ---------------------------------------------------------------------------
# Sumcheck verifiers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SumClaim:
    """sum over the n_vars-cube of sum_j coeff^(j+1) * comps[j](multilinears)
    = sums, one composite per entry."""
    n_vars: int
    n_multilinears: int
    comps: list          # [(Expr, claimed sum)]

    def degree(self) -> int:
        return max((e.degree() for e, _ in self.comps), default=0)


def _recover(coeffs: list[int], s: int) -> list[int]:
    """The round polynomial from its proof: the top coefficient is
    s - r(0) - r(1) + a_d = s + a_1 + ... + a_{d-1} in characteristic 2."""
    top = s
    for c in coeffs[1:]:
        top ^= c
    return [*coeffs, top]


def _horner(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = F.mul(acc, x) ^ c
    return acc


def _weighted(coeff: int, values: list[int]) -> int:
    """sum_j coeff^(j+1) * values[j]."""
    acc = 0
    for v in reversed(values):
        acc = F.mul(acc, coeff) ^ v
    return F.mul(coeff, acc)


def batch_sumcheck(claims: list[SumClaim], t: Transcript) -> tuple[list, list]:
    """Batched sumcheck, claims descending by n_vars; a claim joins when the
    remaining rounds equal its n_vars, with a sampled coefficient. Returns
    (challenges, per-claim multilinear evaluations)."""
    n_rounds = claims[0].n_vars if claims else 0
    coeffs, challenges = [], []
    s = 0
    nxt = 0
    deg = 0
    for rnd in range(n_rounds):
        while nxt < len(claims) and claims[nxt].n_vars == n_rounds - rnd:
            phi = t.sample()
            coeffs.append(phi)
            for _, cs in claims[nxt].comps:
                s ^= F.mul(phi, cs)
            deg = max(deg, claims[nxt].degree())
            nxt += 1
        full = _recover(t.message().scalars(deg), s)
        r = t.sample()
        challenges.append(r)
        s = _horner(full, r)
    _require(nxt == len(claims), "sumcheck claim over no variables")
    expected = 0
    evals = []
    for claim, phi in zip(claims, coeffs):
        ev = t.message().scalars(claim.n_multilinears)
        evals.append(ev)
        for e, _ in claim.comps:
            expected ^= F.mul(phi, e.evaluate(ev))
    _require(expected == s, "sumcheck: final evaluation")
    return challenges, evals


class FrontLoaded:
    """The front-loaded batch: claims ascending by n_vars, all starting at
    round 0, each finished (its evaluations read and folded into the sum)
    at the round equal to its n_vars. A claim with an eq point has the eq
    indicator as its multilinear 0, which the verifier evaluates itself."""

    def __init__(self, claims: list[SumClaim], t: Transcript, coeffs=None, presum=None,
                 eq_points=None):
        self.claims = list(claims)
        self.coeffs = list(coeffs) if coeffs is not None else t.samples(len(claims))
        if presum is None:
            presum = 0
            for c, k in zip(self.claims, self.coeffs):
                presum ^= _weighted(k, [cs for _, cs in c.comps])
        self.sum = presum
        self.eq_points = list(eq_points) if eq_points is not None else [None] * len(claims)
        self.round = 0
        self.challenges: list = []
        self.evals: list = []
        self._reader = None

    def _r(self, t):
        if self._reader is None:
            self._reader = t.message()
        return self._reader

    def finish_claims(self, t) -> None:
        reader = self._r(t)
        while self.claims and self.claims[0].n_vars == self.round:
            c, k, eq_pt = self.claims.pop(0), self.coeffs.pop(0), self.eq_points.pop(0)
            ev = reader.scalars(c.n_multilinears - (eq_pt is not None))
            if eq_pt is not None:
                ev = [F.eq_at(eq_pt, list(reversed(self.challenges[:c.n_vars]))), *ev]
            self.evals.append(ev)
            self.sum ^= _weighted(k, [e.evaluate(ev) for e, _ in c.comps])

    def round_proof(self, t) -> None:
        deg = max((c.degree() for c in self.claims), default=0)
        self._full = _recover(self._r(t).scalars(deg), self.sum)

    def next_round(self, r: int) -> None:
        self.challenges.append(r)
        self.sum = _horner(self._full, r)
        self.round += 1
        self._reader = None

    def run(self, t, n_rounds: int, after_round=None) -> None:
        for rnd in range(n_rounds):
            self.finish_claims(t)
            self.round_proof(t)
            self.next_round(t.sample())
            if after_round is not None:
                after_round(rnd)
        self.finish_claims(t)
        _require(not self.claims, "unfinished sumcheck claims")
        _require(self.sum == 0, "front-loaded sumcheck: final sum")


# ---------------------------------------------------------------------------
# Zerocheck with the univariate skip
# ---------------------------------------------------------------------------

DOMAIN_BITS = 8   # the skipped variables' domain is a subspace of B8


def _lagrange(n_points: int, z: int) -> list[int]:
    """L_i(z) over the points 0 .. n_points - 1 (the subspace of B8 with
    the standard basis), from prefix and suffix products."""
    w = []
    for i in range(n_points):
        den = 1
        for j in range(n_points):
            if j != i:
                den = F.mul(den, i ^ j)
        w.append(F.invert(den, 3))
    pre, suf = [1] * n_points, [1] * n_points
    for i in range(1, n_points):
        pre[i] = F.mul(pre[i - 1], z ^ (i - 1))
    for i in range(n_points - 2, -1, -1):
        suf[i] = F.mul(suf[i + 1], z ^ (i + 1))
    return [F.mul(w[i], F.mul(pre[i], suf[i])) for i in range(n_points)]


def zerocheck(sets: list[ConstraintSet], t: Transcript) -> list[tuple]:
    """Returns [(oracle id, point, value)] of every set's oracles."""
    sets = sorted(sets, key=lambda s: s.n_vars)
    degs = [max((e.degree() for e in s.exprs), default=0) for s in sets]
    k = min(DOMAIN_BITS - max(0, (d - 1).bit_length()) for d in degs)
    k = max(0, min(k, max(s.n_vars for s in sets)))
    _require(k > 0 and all(s.n_vars >= k for s in sets), "zerocheck shape outside the reference")
    max_n = sets[-1].n_vars
    r = t.samples(max_n - k)
    eq_pts = [r[len(r) - (s.n_vars - k):] if s.n_vars > k else [] for s in sets]
    domain = max(max(degs), 1) << k
    batch = t.samples(len(sets))
    round_evals = t.message().scalars(domain - (1 << k))
    u = t.sample()
    presum = 0
    for ev, lg in zip(round_evals, _lagrange(domain, u)[1 << k:]):
        presum ^= F.mul(ev, lg)

    eq = Expr.var(0)
    s2 = [SumClaim(s.n_vars - k, len(s.oracle_ids) + 1,
                   [(eq * _shift_vars(e, 1), 0) for e in s.exprs]) for s in sets]
    fl2 = FrontLoaded(s2, t, coeffs=batch, presum=presum, eq_points=eq_pts)
    fl2.run(t, max(c.n_vars for c in s2))

    sums = [v for ev in fl2.evals for v in ev[1:]]
    n = len(sums)
    red = SumClaim(k, n + 1, [(Expr.var(i) * Expr.var(n), v) for i, v in enumerate(sums)])
    fl3 = FrontLoaded([red], t)
    fl3.run(t, k)
    skipped = list(reversed(fl3.challenges))
    evals = fl3.evals[0]
    want = 0
    for c, e in zip(_lagrange(1 << k, u), F.eq_expand(skipped)):
        want ^= F.mul(c, e)
    _require(evals[-1] == want, "zerocheck: Lagrange multilinear")

    out, pos = [], 0
    for s in sets:
        pt = tuple(skipped + list(reversed(fl2.challenges[:s.n_vars - k])))
        for oid in s.oracle_ids:
            out.append((oid, pt, evals[pos]))
            pos += 1
    return out


def _shift_vars(e: Expr, by: int) -> Expr:
    def go(n):
        if n[0] == "var":
            return ("var", n[1] + by)
        if n[0] == "const":
            return n
        return (n[0], go(n[1]), go(n[2]))
    return Expr(go(e.node))


# ---------------------------------------------------------------------------
# Evalcheck
# ---------------------------------------------------------------------------

def _carry_indicator(b: int, o: int, x: list[int], y: list[int]) -> int:
    """The multilinear of [y = x + o] on b-bit indices (no wrap), at field
    points x, y: a carry automaton over the bits, low to high."""
    s = [1, 0]
    for k in range(b):
        ok = (o >> k) & 1
        nxt = [0, 0]
        for c in (0, 1):
            if not s[c]:
                continue
            for xb in (0, 1):
                yb = xb ^ ok ^ c
                carry = int(xb + ok + c >= 2)
                wx = x[k] if xb else x[k] ^ 1
                wy = y[k] if yb else y[k] ^ 1
                nxt[carry] ^= F.mul(s[c], F.mul(wx, wy))
        s = nxt
    return s[0]


def shift_indicator(variant: str, b: int, o: int, x: list[int], y: list[int]) -> int:
    """x: the shifted oracle's index point, y: the inner oracle's."""
    if variant == "logical_left":          # x = y + o
        return _carry_indicator(b, o, y, x)
    if variant == "circular_left":         # x = y + o mod 2^b
        return _carry_indicator(b, o, y, x) ^ _carry_indicator(b, (1 << b) - o, x, y)
    raise Rejected(f"shift variant {variant} outside the reference")


def evalcheck(system: System, claims: list[tuple], t: Transcript) -> list[tuple]:
    """Reduce claims on any oracle to claims on committed ones."""
    oracles = system.oracles
    seen: dict = {}
    committed = []
    queue = list(claims)
    while queue:
        shifts, nxt = [], []
        for oid, pt, val in queue:
            if (oid, pt) in seen:
                _require(seen[(oid, pt)] == val, "conflicting evaluation claims")
                continue
            seen[(oid, pt)] = val
            o = oracles[oid]
            if o.kind == "committed":
                committed.append((oid, pt, val))
            elif o.kind == "transparent":
                _require(F.mle_fold(list(o.values), list(pt)) == val, f"transparent {oid}")
            elif o.kind == "repeating":
                nxt.append((o.inner[0], pt[:oracles[o.inner[0]].n_vars], val))
            elif o.kind == "linear_combination":
                evs = t.message().scalars(len(o.inner))
                acc = o.lc[0]
                for e, c in zip(evs, o.lc[1]):
                    acc ^= F.mul(e, c)
                _require(acc == val, f"linear combination {oid}")
                nxt.extend((i, pt, e) for i, e in zip(o.inner, evs))
            elif o.kind == "shifted":
                shifts.append((oid, pt, val))
            else:
                raise Rejected(f"oracle kind {o.kind} outside the reference")
        if shifts:
            shifts.sort(key=lambda c: -oracles[c[0]].shift[1])
            sc = [SumClaim(oracles[oid].shift[1], 2, [(Expr.var(0) * Expr.var(1), val)])
                  for oid, _, val in shifts]
            challenges, evals = batch_sumcheck(sc, t)
            n_rounds = sc[0].n_vars
            for (oid, pt, _), c, (proj, ind) in zip(shifts, sc, evals):
                o = oracles[oid]
                offset, b, variant = o.shift
                z = challenges[n_rounds - c.n_vars:]
                _require(ind == shift_indicator(variant, b, offset, list(pt[:b]), z),
                         f"shift indicator of oracle {oid}")
                nxt.append((o.inner[0], tuple(z) + tuple(pt[b:]), proj))
        queue = nxt
    return committed


# ---------------------------------------------------------------------------
# Ring switch
# ---------------------------------------------------------------------------

def _transpose(level: int, elems: list[int]) -> list[int]:
    """Swap the factors of a tensor-algebra element: element j of the result
    holds coordinate j of every element (coordinates of width 2^level)."""
    w, k = 1 << level, len(elems)
    raw = np.frombuffer(b"".join(e.to_bytes(16, "little") for e in elems), dtype=np.uint8)
    bits = np.unpackbits(raw, bitorder="little").reshape(k, k, w)    # [element, coord, bit]
    out = np.packbits(bits.transpose(1, 0, 2).reshape(k, 128), axis=1, bitorder="little")
    return [int.from_bytes(row.tobytes(), "little") for row in out]


def _fold_vertical(level: int, elems: list[int], coeffs: list[int]) -> int:
    acc = 0
    for x, c in zip(_transpose(level, elems), coeffs):
        acc ^= F.mul(x, c)
    return acc


def _eq_ind_product(level: int, suffix: list[int], query: list[int]) -> list[int]:
    """prod_i (1 + z_i (x) 1 + 1 (x) q_i) in the tensor algebra."""
    acc = [1] + [0] * ((128 >> level) - 1)
    for z, q in zip(suffix, query):
        vert = [F.mul(e, z) for e in acc]
        hor = _transpose(level, [F.mul(e, q) for e in _transpose(level, acc)])
        acc = [a ^ v ^ h for a, v, h in zip(acc, vert, hor)]
    return acc


class _RingSwitchTransparents:
    """The ring-switch eq indicators, A_i(q) = fold_vertical((mix_i (x) 1) *
    prod_j (1 + z_j (x) 1 + 1 (x) q_j)), evaluated on demand; the claims of
    one (level, suffix) share the product, and mix -> A is F2-linear, so a
    large group takes the images of the 128 bits of mix once."""

    def __init__(self, claims, mixing, row_coeffs):
        self.claims, self.mixing, self.rc = claims, mixing, row_coeffs
        self.cache: dict = {}

    def value(self, i: int, query: list[int]) -> int:
        level, _, suffix, _ = self.claims[i]
        key = (level, suffix, tuple(query))
        group = self.cache.get(key)
        if group is None:
            prod = _eq_ind_product(level, list(suffix), list(query))
            n_members = sum(1 for c in self.claims if (c[0], c[2]) == (level, suffix))
            images = None
            if n_members > 8:
                images = [_fold_vertical(level, [F.mul(e, 1 << b) for e in prod], self.rc)
                          for b in range(128)]
            group = self.cache[key] = (prod, images)
        prod, images = group
        mix = self.mixing[i]
        if images is None:
            return _fold_vertical(level, [F.mul(e, mix) for e in prod], self.rc)
        out = 0
        for b in range(128):
            if (mix >> b) & 1:
                out ^= images[b]
        return out


def ring_switch(claims: list[tuple], t: Transcript):
    """claims: [(level, committed index, suffix, prefix, value)] in the
    PIOP's order. Returns ([(n_vars, committed index, value)], transparents)."""
    n = len(claims)
    m = (n - 1).bit_length() if n > 1 else 0
    mixing = F.eq_expand(t.samples(m))[:n]
    prefixes = list(dict.fromkeys(c[3] for c in claims))
    which = [prefixes.index(c[3]) for c in claims]
    expected = [0] * len(prefixes)
    for c, mix, p in zip(claims, mixing, which):
        expected[p] ^= F.mul(c[4], mix)
    reader = t.message()
    tensors = []
    for p, prefix in enumerate(prefixes):
        level = claims[which.index(p)][0]
        elems = reader.scalars(128 >> level)
        _require(F.mle_fold(elems, list(prefix)) == expected[p],
                 "ring switch: partial evaluations")
        tensors.append((level, elems))
    row_coeffs = F.eq_expand(t.samples(max(7 - c[0] for c in claims)))
    row_batched = t.message().scalars(n)
    mixed = [0] * len(prefixes)
    for rb, p in zip(row_batched, which):
        mixed[p] ^= rb
    for (level, elems), want in zip(tensors, mixed):
        _require(_fold_vertical(level, elems, row_coeffs) == want, "ring switch: row batching")
    trans = _RingSwitchTransparents([(c[0], c[1], c[2], c[3]) for c in claims], mixing,
                                    row_coeffs)
    return [(len(c[2]), c[1], rb) for c, rb in zip(claims, row_batched)], trans


# ---------------------------------------------------------------------------
# FRI and the PIOP
# ---------------------------------------------------------------------------

def n_test_queries(security_bits: int, log_dim: int, log_inv_rate: int) -> int:
    """Queries for `security_bits` against the proximity gap of the code
    (upstream `fri/common.rs`)."""
    field = 2.0 ** 128
    allowed = 2.0 ** -security_bits - 2 * log_dim / field - (1 << (log_dim + log_inv_rate)) / field
    _require(allowed > 0, "security level unattainable")
    return math.ceil(math.log(allowed, 0.5 * (1 + 2.0 ** -log_inv_rate)))


def optimal_arity(log_block: int, digest_size: int = 32, elem_size: int = 16) -> int:
    best = None
    for arity in range(1, log_block + 1):
        est = ((log_block // 2 * digest_size + (1 << arity) * elem_size)
               * (log_block - arity) // arity)
        if best is not None and est > best[1]:
            break
        best = (arity, est)
    return best[0] if best else 1


@dataclasses.dataclass(frozen=True)
class FRIParams:
    log_dim: int
    log_inv_rate: int
    log_batch: int
    arities: tuple
    n_queries: int

    @staticmethod
    def for_message(log_msg: int, security_bits: int, log_inv_rate: int) -> "FRIParams":
        arity = optimal_arity(log_msg + log_inv_rate)
        log_dim = max(log_msg - arity, 0)
        nq = n_test_queries(security_bits, log_dim, log_inv_rate)
        cap = (nq - 1).bit_length()
        n_arities = max(log_msg - max(cap - log_inv_rate, 0), 0) // arity
        return FRIParams(log_dim, log_inv_rate, min(log_msg, arity), (arity,) * n_arities, nq)

    @property
    def log_code(self) -> int:
        return self.log_dim + self.log_inv_rate

    @property
    def n_fold_rounds(self) -> int:
        return self.log_dim + self.log_batch

    @property
    def n_final(self) -> int:
        return self.n_fold_rounds - sum(self.arities)

    def layer_depths(self) -> list[int]:
        lg_q = (self.n_queries - 1).bit_length()
        out, log_cosets = [], self.log_code + self.log_batch
        for a in self.arities:
            log_cosets -= a
            out.append(max(min(lg_q, log_cosets), 0))
        return out


class Domain:
    """The additive NTT's domain over B32 with the standard basis: the
    normalized subspace polynomials W^_i at the basis elements above i."""

    def __init__(self, log_size: int):
        basis = [1 << i for i in range(log_size)]
        norm, rows = [1], [basis[1:]]
        for _ in range(1, log_size):
            prev_n, prev = norm[-1], rows[-1]
            norm.append(F.mul(prev[0], prev[0] ^ prev_n))
            rows.append([F.mul(e, e ^ prev_n) for e in prev[1:]])
        self.log_size = log_size
        self.rows = [[F.mul(e, F.invert(nc, 5)) for e in row] for nc, row in zip(norm, rows)]

    def twiddle(self, i: int, index: int) -> int:
        out, b = 0, 0
        while index:
            if index & 1:
                out ^= self.rows[i][b]
            index >>= 1
            b += 1
        return out


def _fold_chunk(dom: Domain, log_len: int, chunk: int, vals: list[int], rs: list[int]) -> int:
    """Fold one coset of 2^len(rs) values by the FRI challenges rs: each step
    undoes one butterfly stage (twiddle t: v' = v + u, u' = u + t v') and
    combines the pair as u' + r (u' + v')."""
    size = len(rs)
    for r in rs:
        tw_round = dom.log_size - log_len
        vals = [_fold_pair(dom.twiddle(tw_round, (chunk << (size - 1)) | i), vals[2 * i],
                           vals[2 * i + 1], r) for i in range(len(vals) // 2)]
        log_len -= 1
        size -= 1
    return vals[0]


def _fold_pair(tw: int, u: int, v: int, r: int) -> int:
    v2 = v ^ u
    u2 = u ^ F.mul(tw, v2)
    return u2 ^ F.mul(u2 ^ v2, r)


def _elems(raw: bytes) -> list[int]:
    return [int.from_bytes(raw[16 * i:16 * i + 16], "little") for i in range(len(raw) // 16)]


def _leaf_root(raw: bytes, log_coset: int) -> bytes:
    blobs = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 16 << log_coset)
    return groestl.merkle_root(groestl.digest_rows(blobs))


def fri_queries(p: FRIParams, commitment: bytes, round_roots: list[bytes],
                challenges: list[int], t: Transcript) -> int:
    """The FRI query phase; returns the value the codeword folds to."""
    dom = Domain(p.log_code)
    interleave = F.eq_expand(challenges[:p.log_batch])
    folds = challenges[p.log_batch:]
    advice = t.decommitment()
    n_term = 1 << (p.n_final + p.log_inv_rate)
    term_raw = advice.bytes(16 * n_term)
    last = round_roots[-1] if round_roots else commitment
    _require(_leaf_root(term_raw, p.n_final if p.arities else p.log_dim + p.log_batch) == last,
             "FRI: terminate codeword commitment")
    term = _elems(term_raw)
    if p.arities:
        nf = p.n_final
        rep = [_fold_chunk(dom, nf + p.log_inv_rate, i, term[i << nf:(i + 1) << nf],
                           folds[len(folds) - nf:]) for i in range(len(term) >> nf)]
    else:
        a = p.log_dim + p.log_batch
        rep = [_fold_chunk(dom, p.log_code, i, _collapse(term[i << a:(i + 1) << a], interleave,
                                                         p.log_batch), folds)
               for i in range(len(term) >> a)]
    _require(all(v == rep[0] for v in rep), "FRI: terminate codeword is no repetition")
    final = rep[0]

    layers = []
    for root, depth in zip([commitment, *round_roots], p.layer_depths()):
        layer = np.frombuffer(advice.bytes(32 << depth), dtype=np.uint8).reshape(-1, 32)
        _require(groestl.merkle_root(layer) == root, "FRI: Merkle layer")
        layers.append(layer)
    index_bits = p.log_code + p.log_batch - p.arities[0] if p.arities else 0
    indices = [t.sample_bits(index_bits) for _ in range(p.n_queries)]
    depths = p.layer_depths()
    queries = []
    for _ in indices:
        adv = t.decommitment()
        q, log_cosets = [], index_bits
        for i, a in enumerate(p.arities):
            if i:
                log_cosets -= a
            vals = adv.bytes(16 << a)
            q.append((vals, [adv.bytes(32) for _ in range(log_cosets - depths[i])]))
        queries.append(q)
    if not p.arities:
        return final
    idx = np.asarray(indices, dtype=np.int64)
    for i, a in enumerate(p.arities):
        if i:
            idx = idx >> a
        cur = groestl.digest_rows(np.stack([np.frombuffer(q[i][0], dtype=np.uint8)
                                            for q in queries]))
        n_branch = len(queries[0][i][1])
        for k in range(n_branch):
            sib = np.stack([np.frombuffer(q[i][1][k], dtype=np.uint8) for q in queries])
            left = (((idx >> k) & 1) == 0)[:, None]
            cur = groestl.compress_pairs(np.concatenate([np.where(left, cur, sib),
                                                         np.where(left, sib, cur)], axis=1))
        _require(bool((cur == layers[i][idx >> n_branch]).all()), f"FRI: opening of oracle {i}")
    for index, q in zip(indices, queries):
        c0 = p.arities[0] - p.log_batch
        value = _fold_chunk(dom, p.log_code, index,
                            _collapse(_elems(q[0][0]), interleave, p.log_batch), folds[:c0])
        done = c0
        for i, a in enumerate(p.arities[1:]):
            vals = _elems(q[i + 1][0])
            _require(value == vals[index % (1 << a)], f"FRI: fold at oracle {i + 1}")
            value = _fold_chunk(dom, p.log_code - done, index >> a, vals, folds[done:done + a])
            index >>= a
            done += a
        _require(value == term[index], "FRI: final fold")
    return final


def _collapse(vals: list[int], tensor: list[int], log_batch: int) -> list[int]:
    out = []
    for j in range(len(vals) >> log_batch):
        acc = 0
        for x in range(1 << log_batch):
            acc ^= F.mul(tensor[x], vals[(j << log_batch) | x])
        out.append(acc)
    return out


def _piecewise(point: list[int], n_by_vars: list[int], evals: list[int]) -> int:
    """The multilinear whose hypercube holds the pieces, largest first, each
    the piece's evaluation at the point's prefix (upstream
    `piecewise_multilinear.rs`)."""
    evals = list(evals)
    index, to_fold = len(evals), 0
    for i, r in enumerate(point):
        to_fold += n_by_vars[i] if i < len(n_by_vars) else 0
        start = index - to_fold
        seg = evals[start:index]
        folded = [seg[j] ^ F.mul(seg[j] ^ (seg[j + 1] if j + 1 < len(seg) else 0), r)
                  for j in range(0, len(seg), 2)]
        evals[start:start + len(folded)] = folded
        index -= to_fold // 2
        to_fold -= to_fold // 2
    return evals[0]


def piop(p: FRIParams, counts: list[int], commitment: bytes, claims: list[tuple],
         trans: _RingSwitchTransparents, t: Transcript) -> None:
    """claims: [(n_vars, committed index, sum)] from the ring switch, in
    order; counts[k]: committed multilinears of k packed variables."""
    total_vars = max((sum(c << k for k, c in enumerate(counts)) - 1).bit_length(), 0)
    ranges, off = [], 0
    for c in counts:
        ranges.append((off, off + c))
        off += c
    t_ranges = [[0, 0] for _ in counts]
    cur = 0
    for i, (nv, _, _) in enumerate(claims):
        _require(nv >= cur, "PIOP claims out of order")
        if nv > cur:
            cur = nv
            t_ranges[cur] = [i, i]
        t_ranges[cur][1] = i + 1
    groups, sc = [], []
    for k in range(len(counts)):
        (c0, c1), (t0, t1) = ranges[k], t_ranges[k]
        if c1 == c0:
            continue
        comps = [(Expr.var(ci - c0) * Expr.var((c1 - c0) + ti - t0), s)
                 for ti, (nv, ci, s) in enumerate(claims) if nv == k]
        sc.append(SumClaim(k, (c1 - c0) + (t1 - t0), comps))
        groups.append((k, c0, c1, t0))
    fl = FrontLoaded(sc, t)
    commit_rounds = {sum(p.arities[:i + 1]) for i in range(len(p.arities))}
    roots = []

    def after(rnd):
        if rnd + 1 in commit_rounds:
            roots.append(t.message().bytes(32))

    fl.run(t, total_vars, after)
    final = fri_queries(p, commitment, roots, fl.challenges, t)
    rev = list(reversed(fl.challenges))
    committed = []
    for (k, c0, c1, t0), ev in zip(groups, fl.evals):
        committed.extend(ev[:c1 - c0])
        for i, claimed in enumerate(ev[c1 - c0:]):
            _require(trans.value(t0 + i, rev[len(rev) - k:]) == claimed,
                     f"ring-switch transparent {t0 + i}")
    _require(_piecewise(fl.challenges, list(counts) + [0] * (total_vars + 1 - len(counts)),
                        list(reversed(committed))) == final,
             "PIOP: FRI's final value against the sumcheck's evaluations")


# ---------------------------------------------------------------------------
# The whole proof
# ---------------------------------------------------------------------------

def commit_layout(system: System) -> tuple[list[int], list[int], list[int]]:
    """(committed ids in the PIOP's order, their packed n_vars, counts per
    packed n_vars): ascending by packed size, then by id."""
    keyed = sorted((max(0, o.n_vars + o.level - 7), oid)
                   for oid, o in enumerate(system.oracles) if o.kind == "committed")
    counts = [0] * (max((k for k, _ in keyed), default=0) + 1)
    for k, _ in keyed:
        counts[k] += 1
    return [oid for _, oid in keyed], [k for k, _ in keyed], counts


def fri_params(system: System, security_bits: int, log_inv_rate: int) -> FRIParams:
    _, _, counts = commit_layout(system)
    total = sum(c << k for k, c in enumerate(counts))
    return FRIParams.for_message(max((total - 1).bit_length(), 0), security_bits, log_inv_rate)


def verify(system: System, proof: bytes, security_bits: int, log_inv_rate: int) -> list[tuple]:
    """Raises `Rejected` unless `proof` proves `system` at the given security
    and rate; returns the committed oracles' claims [(id, point, value)]."""
    t = Transcript(proof)
    t.observe(system.digest)
    t.observe()   # the boundaries: none
    order, packed, counts = commit_layout(system)
    p = fri_params(system, security_bits, log_inv_rate)
    commitment = t.message().bytes(32)
    committed = evalcheck(system, zerocheck(list(system.constraint_sets), t), t)

    keyed = []
    pos = {oid: i for i, oid in enumerate(order)}
    for oid, pt, val in committed:
        o = system.oracles[oid]
        kappa = 7 - o.level
        pt = tuple(pt) + (0,) * max(0, kappa - len(pt))
        keyed.append((packed[pos[oid]], pos[oid], (o.level, pos[oid], pt[kappa:], pt[:kappa], val)))
    keyed.sort(key=lambda x: (x[0], x[1]))
    rs_claims, trans = ring_switch([k[2] for k in keyed], t)
    piop(p, counts, commitment, rs_claims, trans, t)
    t.finish()
    return committed
