"""FRI over interleaved Reed-Solomon codewords: parameters and the commit.

Counterpart of the commit part of `binius_tpu/protocols/fri.py`:
`FRIParams` (code, arity schedule, query count), `rs_encode` (repeat the
message 2^log_inv_rate times, forward additive NTT with skip_rounds =
log_inv_rate), `leaf_blobs`, `commit_codeword` (host tree) and `fri_commit`
(encode and Merkle-commit on the device). The fold rounds, queries and
verifier are not ported yet. Data in B128 (level 7), twiddles in
FEncode = B32 (level 5).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve
from ..merkle.tree import MerkleTree, commit_codeword_device, hash_leaves
from ..ntt.additive_ntt import AdditiveNTT, NTTDomain

LEVEL = 7       # codeword field (B128)
ENC_LEVEL = 5   # FEncode (B32), the twiddle field


def calculate_n_test_queries(security_bits: int, log_dim: int, log_inv_rate: int) -> int:
    """`fri/common.rs:199-224` semantics."""
    field_size = 2.0 ** 128
    sumcheck_err = (2 * log_dim) / field_size
    folding_err = (1 << (log_dim + log_inv_rate)) / field_size
    per_query_err = 0.5 * (1 + 2.0 ** (-log_inv_rate))
    allowed = 2.0 ** (-security_bits) - sumcheck_err - folding_err
    if allowed <= 0:
        raise ValueError("security level unattainable")
    return math.ceil(math.log(allowed, per_query_err))


def estimate_optimal_arity(log_block_length: int, digest_size: int, field_size: int) -> int:
    """`fri/common.rs:224-250` proof-size heuristic."""
    best = None
    for arity in range(1, log_block_length + 1):
        est = ((log_block_length // 2 * digest_size + (1 << arity) * field_size)
               * (log_block_length - arity) // arity)
        if best is not None and est > best[1]:
            break
        best = (arity, est)
    return best[0] if best else 1


@dataclasses.dataclass(frozen=True)
class FRIParams:
    log_dim: int
    log_inv_rate: int
    log_batch_size: int
    fold_arities: tuple
    n_test_queries: int

    @staticmethod
    def choose_with_constant_fold_arity(log_msg_len: int, security_bits: int,
                                        log_inv_rate: int, arity: int) -> "FRIParams":
        assert arity > 0
        log_dim = max(log_msg_len - arity, 0)
        log_batch_size = min(log_msg_len, arity)
        n_q = calculate_n_test_queries(security_bits, log_dim, log_inv_rate)
        cap_height = (n_q - 1).bit_length()  # log2_ceil
        n_arities = max(log_msg_len - max(cap_height - log_inv_rate, 0), 0) // arity
        return FRIParams(log_dim, log_inv_rate, log_batch_size, (arity,) * n_arities, n_q)

    @property
    def log_code_len(self) -> int:
        """RS code block log-length (without interleaving)."""
        return self.log_dim + self.log_inv_rate

    @property
    def log_len(self) -> int:
        """Log-length of the initial interleaved oracle."""
        return self.log_code_len + self.log_batch_size

    @property
    def n_fold_rounds(self) -> int:
        return self.log_dim + self.log_batch_size

    @property
    def n_oracles(self) -> int:
        return len(self.fold_arities)

    @property
    def log_coset(self) -> int:
        """Elements per Merkle leaf of the committed codeword (log)."""
        return self.fold_arities[0] if self.fold_arities else self.log_dim + self.log_batch_size

    def ntt_domain(self) -> NTTDomain:
        return NTTDomain.create(ENC_LEVEL, self.log_code_len)


def rs_encode(params: FRIParams, message: torch.Tensor, device=None) -> torch.Tensor:
    """Encode the interleaved message (2^(log_dim+log_batch) B128 elements)
    into the interleaved codeword (2^log_len elements)."""
    message = message.to(resolve(device))
    rep = torch.cat([message] * (1 << params.log_inv_rate), dim=0)
    return AdditiveNTT(params.ntt_domain()).forward(
        rep, LEVEL, (params.log_batch_size, params.log_code_len, 0),
        skip_rounds=params.log_inv_rate, device=message.device)


def leaf_blobs(cw_np: np.ndarray, log_coset: int) -> np.ndarray:
    """Group consecutive 2^log_coset elements into canonical-byte leaf rows."""
    n = cw_np.shape[0] >> log_coset
    b = cw_np.astype("<u4").reshape(n, (1 << log_coset) * 16 // 4).view(np.uint8)
    return np.ascontiguousarray(b)


def commit_codeword(cw_np: np.ndarray, log_coset: int) -> MerkleTree:
    """Host commit of a (N, 4) uint32 codeword."""
    return MerkleTree.build(hash_leaves(leaf_blobs(cw_np, log_coset)))


def fri_commit(params: FRIParams, message: torch.Tensor, device=None):
    """Encode and commit the interleaved message on the device.
    Returns (codeword, DeviceMerkleTree)."""
    cw = rs_encode(params, message, device)
    return cw, commit_codeword_device(cw, params.log_coset, cw.device)
