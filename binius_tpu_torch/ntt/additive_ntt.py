"""Additive (LCH14) NTT over binary tower fields.

Counterpart of `binius_tpu/ntt/additive_ntt.py`: `NTTDomain` (twiddles as
normalized subspace polynomial evaluations, built on the host from
Python-int tower arithmetic) and `AdditiveNTT`. A transform takes one of
two paths by one rule (`bitsliced_ntt.supported`): the bitsliced path on
bit planes (K2, K3 and K4 on the card) where its kernels fit the shape,
twiddles at B32 or below, data at B32 or above and a power-of-two batch of
at least 2^15 elements (the JAX package's dispatch threshold), and the
packed stage loop otherwise, on either device: subfield-scalar butterflies
over the (Z, Y, X) view with the twiddles kept at their own level, plain
PyTorch as the JAX package's `_transform_jit` is plain XLA. A row-sharded
operand (`parallel.mesh.RowShard`) takes `sharded_ntt.transform_sharded`.
`forward_scalar` and `inverse_scalar` are the host oracles.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import resolve
from ..fields import scalar, tower
from ..math.binary_subspace import BinarySubspace


def _subspace_map(e: int, c: int, level: int) -> int:
    """W_{i+1} value from W_i value: e * (e + c)."""
    return scalar.mul(level, e, e ^ c)


@dataclasses.dataclass(frozen=True)
class NTTDomain:
    """Twiddle data for an NTT over a binary subspace: `s_evals[i][j]` is the
    normalized subspace polynomial W-hat_i(beta_{i+1+j}), `norm_consts[i]`
    is W_i(beta_i) (unnormalized)."""

    level: int
    subspace: BinarySubspace
    s_evals: tuple
    norm_consts: tuple

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def create(level: int, log_domain_size: int, basis: tuple | None = None) -> "NTTDomain":
        sub = (BinarySubspace.with_dim(level, log_domain_size) if basis is None
               else BinarySubspace(level, basis))
        b = sub.basis
        assert b[0] == 1, "domain must include 1 as first basis element"
        norm_consts = [1]
        s_evals = [list(b[1:])]
        for _ in range(1, sub.dim):
            prev_n = norm_consts[-1]
            prev = s_evals[-1]
            norm_consts.append(_subspace_map(prev[0], prev_n, level))
            s_evals.append([_subspace_map(e, prev_n, level) for e in prev[1:]])
        out = []
        for nc, row in zip(norm_consts, s_evals):
            inv = scalar.invert(level, nc)
            out.append(tuple(scalar.mul(level, e, inv) for e in row))
        return NTTDomain(level, sub, tuple(out), tuple(norm_consts))

    @property
    def log_domain_size(self) -> int:
        return self.subspace.dim

    def twiddle(self, round_i: int, index: int) -> int:
        """W-hat_{round_i} at the sum of beta_{round_i+1+b} over bits b of index."""
        row = self.s_evals[round_i]
        out = 0
        b = 0
        while index:
            if index & 1:
                out ^= row[b]
            index >>= 1
            b += 1
        return out

    def stage_twiddles_np(self, round_i: int, n_bits: int, high_bits: int = 0) -> np.ndarray:
        """t[j] = twiddle(round_i, (high_bits << n_bits) | j), j < 2^n_bits, as
        uint64 for level <= 6, else (., 4) uint32."""
        row = self.s_evals[round_i]
        base = self.twiddle(round_i, high_bits << n_bits)
        idx = np.arange(1 << n_bits)
        if self.level <= 6:
            out = np.full(1 << n_bits, np.uint64(base), dtype=np.uint64)
            for b in range(n_bits):
                out[((idx >> b) & 1).astype(bool)] ^= np.uint64(row[b])
            return out
        out = np.zeros((1 << n_bits, 4), dtype=np.uint32)
        for limb in range(4):
            acc = np.full(1 << n_bits, (base >> (32 * limb)) & 0xFFFFFFFF, dtype=np.uint32)
            for b in range(n_bits):
                acc[((idx >> b) & 1).astype(bool)] ^= np.uint32((row[b] >> (32 * limb)) & 0xFFFFFFFF)
            out[:, limb] = acc
        return out


_STAGE_TW: dict = {}


@dataclasses.dataclass(frozen=True)
class AdditiveNTT:
    """Batched additive NTT over `domain` for data at tower level `data_level`
    (twiddles embed into the data field, e.g. B32 twiddles on B128 data)."""

    domain: NTTDomain

    @property
    def level(self) -> int:
        return self.domain.level

    def _transform(self, data: torch.Tensor, data_level: int, shape: tuple,
                   coset: int, coset_bits: int, skip_rounds: int, inverse: bool,
                   device) -> torch.Tensor:
        from ..parallel import mesh as mesh_mod
        from . import bitsliced_ntt
        if isinstance(data, mesh_mod.RowShard):
            # a row-sharded operand: the explicit cross-rank transform, or
            # (where it does not apply) the whole transform on every rank
            from . import sharded_ntt
            mesh = data.mesh
            if sharded_ntt.suitable(self, data, shape, mesh):
                return sharded_ntt.transform_sharded(self, data, data_level, shape, coset,
                                                     coset_bits, skip_rounds, inverse, mesh)
            full = self._transform(mesh_mod.pull_local(data), data_level, shape, coset,
                                   coset_bits, skip_rounds, inverse, mesh.device)
            return mesh_mod.put_axis_sharded(mesh, full, 0, min_elems=1)
        data = data.to(resolve(device))
        n = tower.batch_shape(data_level, data)
        if len(n) == 1 and n[0] == 1 << sum(shape) and bitsliced_ntt.supported(
                self.level, data_level, n[0]):
            return bitsliced_ntt.transform(
                self.domain, data, data_level, shape, coset=coset,
                coset_bits=coset_bits, skip_rounds=skip_rounds, inverse=inverse)
        return self._stage_loop(data, data_level, shape, coset, coset_bits,
                                skip_rounds, inverse)

    def _stage_twiddles(self, log_y: int, coset: int, coset_bits: int, i: int,
                        device) -> torch.Tensor:
        """Stage i's twiddles at the domain's level, cached per device."""
        key = (self.domain, log_y, coset, coset_bits, i, str(device))
        if key not in _STAGE_TW:
            base = self.domain.log_domain_size - (log_y + coset_bits)
            assert base >= 0, "domain too small"
            tw = self.domain.stage_twiddles_np(base + i, log_y - 1 - i, high_bits=coset)
            if self.level <= 5:
                tw = tw.astype(np.uint32)
            _STAGE_TW[key] = tower.from_numpy(self.level, tw, device)
        return _STAGE_TW[key]

    def _stage_loop(self, data: torch.Tensor, data_level: int, shape: tuple,
                    coset: int, coset_bits: int, skip_rounds: int,
                    inverse: bool) -> torch.Tensor:
        """Butterfly stages over the (Z, Y, X) view of `data`: every batch
        shape whose element count is a multiple of 2^(log_x + log_y) (Z is
        the rest, of any size); the result has the shape of `data`."""
        log_x, log_y, _ = shape
        tl, dl = self.level, data_level
        X, Y = 1 << log_x, 1 << log_y
        Z = math.prod(tower.batch_shape(dl, data)) // (X * Y)
        stages = (range(0, log_y - skip_rounds) if inverse
                  else range(log_y - skip_rounds - 1, -1, -1))
        d = data
        for i in stages:
            blocks, inner = 1 << (log_y - 1 - i), 1 << i
            view = d.reshape(tower.elem_shape(dl, (Z, blocks, 2, inner, X)))
            u, v = view[:, :, 0], view[:, :, 1]
            tw = self._stage_twiddles(log_y, coset, coset_bits, i, data.device)
            t = tw[None, :, None, None]   # the twiddles stay at their own level
            if inverse:
                v = v ^ u
                u = u ^ tower.scale_subfield(tl, dl, t, v)
            else:
                u = u ^ tower.scale_subfield(tl, dl, t, v)
                v = v ^ u
            d = torch.stack([u, v], dim=2)
        return d.reshape(data.shape)

    def forward(self, data: torch.Tensor, data_level: int, shape: tuple[int, int, int],
                coset: int = 0, coset_bits: int = 0, skip_rounds: int = 0,
                device=None) -> torch.Tensor:
        """Forward transform (novel-basis coeffs -> evaluations), not in place.
        `data`: flat batch of 2^(log_x+log_y+log_z) elements, X fastest."""
        return self._transform(data, data_level, shape, coset, coset_bits,
                               skip_rounds, False, device)

    def inverse(self, data: torch.Tensor, data_level: int, shape: tuple[int, int, int],
                coset: int = 0, coset_bits: int = 0, skip_rounds: int = 0,
                device=None) -> torch.Tensor:
        """Inverse transform (evaluations -> novel-basis coeffs)."""
        return self._transform(data, data_level, shape, coset, coset_bits,
                               skip_rounds, True, device)

    # ---- host oracles -----------------------------------------------------

    def forward_scalar(self, values: list[int], data_level: int, log_y: int,
                       coset: int = 0, coset_bits: int = 0, skip_rounds: int = 0) -> list[int]:
        """Naive host forward transform on Python ints (single column)."""
        data = list(values)
        base = self.domain.log_domain_size - (log_y + coset_bits)
        for i in range(log_y - skip_rounds - 1, -1, -1):
            for j in range(1 << (log_y - 1 - i)):
                t = self.domain.twiddle(base + i, (coset << (log_y - 1 - i)) | j)
                for k in range(1 << i):
                    i0 = (j << (i + 1)) | k
                    i1 = i0 | (1 << i)
                    u = data[i0] ^ scalar.mul(data_level, t, data[i1])
                    data[i0], data[i1] = u, data[i1] ^ u
        return data

    def inverse_scalar(self, values: list[int], data_level: int, log_y: int,
                       coset: int = 0, coset_bits: int = 0, skip_rounds: int = 0) -> list[int]:
        data = list(values)
        base = self.domain.log_domain_size - (log_y + coset_bits)
        for i in range(0, log_y - skip_rounds):
            for j in range(1 << (log_y - 1 - i)):
                t = self.domain.twiddle(base + i, (coset << (log_y - 1 - i)) | j)
                for k in range(1 << i):
                    i0 = (j << (i + 1)) | k
                    i1 = i0 | (1 << i)
                    v = data[i1] ^ data[i0]
                    data[i0], data[i1] = data[i0] ^ scalar.mul(data_level, t, v), v
        return data
