"""FRI over interleaved Reed-Solomon codewords (DP24, FRI-Binius).

Counterpart of `binius_tpu/protocols/fri.py`:

  * `FRIParams`: code, arity schedule, query count;
  * `rs_encode`: repeat the message 2^log_inv_rate times, forward additive
    NTT with skip_rounds = log_inv_rate; `fri_commit` encodes and
    Merkle-commits on the device;
  * `fold_interleaved`: collapse the interleaved batch with the eq tensor,
    then per challenge peel one inverse-NTT stage fused with a random linear
    fold (B128 products through `tower.mul`, B32 twiddles through
    `tower.scale_subfield`);
  * `FRIFolder`: the prover's round loop (fold and commit each oracle on the
    device at arity boundaries), then the terminate codeword, the optimal
    Merkle layers and the coset query openings;
  * `FRIVerifier`: the host verifier (terminate codeword, layers, per-query
    Merkle openings and fold consistency), with the scalar fold oracles.

Data in B128 (level 7), twiddles in FEncode = B32 (level 5).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve
from ..fields import scalar, tower
from ..hash.groestl import compress_pairs
from ..math import mle
from ..merkle.tree import MerkleTree, commit_codeword_device, hash_leaves
from ..ntt.additive_ntt import AdditiveNTT, NTTDomain
from ..parallel import mesh as mesh_mod
from ..utils import tracing

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

    @property
    def index_bits(self) -> int:
        bits = self.log_len - self.fold_arities[0] if self.fold_arities else 0
        # sample_bits clamps at 32 (transcript/mod.rs:473)
        assert bits <= 32, f"FRI query index needs {bits} bits (> 32)"
        return bits

    @property
    def n_final_challenges(self) -> int:
        return self.n_fold_rounds - sum(self.fold_arities)

    def ntt_domain(self) -> NTTDomain:
        return NTTDomain.create(ENC_LEVEL, self.log_code_len)

    def optimal_layer_depth(self, log_n_cosets: int) -> int:
        """min(log2_ceil(n_queries), tree_depth) (`merkle_tree/scheme.rs:48`)."""
        lg_q = (self.n_test_queries - 1).bit_length() if self.n_test_queries > 0 else 0
        return max(min(lg_q, log_n_cosets), 0)

    def vcs_optimal_layers_depths(self) -> list[int]:
        out = []
        log_n_cosets = self.log_len
        for arity in self.fold_arities:
            log_n_cosets -= arity
            out.append(self.optimal_layer_depth(log_n_cosets))
        return out


def rs_encode(params: FRIParams, message: torch.Tensor, device=None, mesh=None):
    """Encode the interleaved message (2^(log_dim+log_batch) B128 elements)
    into the interleaved codeword (2^log_len elements). `mesh`: each rank
    encodes its block of the codeword (`ntt.sharded_ntt`) and gets it as a
    `parallel.mesh.RowShard`."""
    message = message.to(mesh.device if mesh is not None else resolve(device))
    rep = torch.cat([message] * (1 << params.log_inv_rate), dim=0)
    if mesh is not None:
        rep = mesh_mod.put_axis_sharded(mesh, rep, 0, min_elems=1)
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


def fri_commit(params: FRIParams, message: torch.Tensor, device=None, mesh=None):
    """Encode and commit the interleaved message on the device.
    Returns (codeword, DeviceMerkleTree). `mesh`: each rank encodes and
    hashes its block; the codeword and the tree's layers are then gathered
    (the FRI folds and queries read them whole)."""
    cw = rs_encode(params, message, device, mesh)
    tree = commit_codeword_device(cw, params.log_coset, cw.device)
    return mesh_mod.pull_local(cw), tree


# ---------------------------------------------------------------------------
# Folding (device) and its scalar oracles (host)
# ---------------------------------------------------------------------------

_FOLD_TW: dict = {}


def _fold_twiddles(domain: NTTDomain, log_len: int, n_folds: int, device) -> list:
    """B32 twiddle vectors for peeling `n_folds` inverse-NTT stages from a
    codeword of log length `log_len`, cached per device."""
    key = (domain, log_len, n_folds, str(device))
    if key not in _FOLD_TW:
        tws = []
        for L in range(log_len, log_len - n_folds, -1):
            tw = domain.stage_twiddles_np(domain.log_domain_size - L, L - 1)
            tws.append(tower.from_numpy(ENC_LEVEL, tw.astype(np.uint32), device))
        _FOLD_TW[key] = tws
    return _FOLD_TW[key]


def fold_interleaved(domain: NTTDomain, codeword: torch.Tensor, challenges: list[int],
                     log_len: int, log_batch: int) -> torch.Tensor:
    """FRI fold on the codeword's device; challenges[:log_batch] collapse the
    interleaving, each later one folds one stage."""
    assert len(challenges) >= log_batch
    dev = codeword.device
    inter, folds = challenges[:log_batch], challenges[log_batch:]
    d = codeword
    if log_batch:
        tensor = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, inter, dev))
        d = tower.inner_product(LEVEL, d.reshape(1 << log_len, 1 << log_batch, 4), tensor,
                                axis=1)
    L = log_len
    for r, tw in zip(folds, _fold_twiddles(domain, log_len, len(folds), dev)):
        pairs = d.reshape(1 << (L - 1), 2, 4)
        u, v = pairs[:, 0], pairs[:, 1]
        v2 = v ^ u
        u2 = u ^ tower.scale_subfield(ENC_LEVEL, LEVEL, tw, v2)
        d = u2 ^ tower.mul(LEVEL, u2 ^ v2, tower.from_ints(LEVEL, [r], dev)[0])
        L -= 1
    return d


def fold_pair_scalar(domain: NTTDomain, log_len: int, index: int, u: int, v: int, r: int) -> int:
    t = domain.twiddle(domain.log_domain_size - log_len, index)
    v2 = v ^ u
    u2 = u ^ scalar.mul(LEVEL, t, v2)
    return u2 ^ scalar.mul(LEVEL, u2 ^ v2, r)


def fold_chunk_scalar(domain: NTTDomain, log_len: int, chunk_index: int,
                      values: list[int], challenges: list[int]) -> int:
    vals = list(values)
    size = len(challenges)
    for ch in challenges:
        vals = [fold_pair_scalar(domain, log_len, (chunk_index << (size - 1)) | i,
                                 vals[2 * i], vals[2 * i + 1], ch)
                for i in range(1 << (size - 1))]
        log_len -= 1
        size -= 1
    return vals[0]


def fold_interleaved_chunk_scalar(domain: NTTDomain, log_len: int, log_batch: int,
                                  chunk_index: int, values: list[int],
                                  tensor: list[int], challenges: list[int]) -> int:
    """Host mirror of `fold_interleaved_chunk` (`ntt/fri.rs:178+`)."""
    collapsed = []
    for j in range(len(values) >> log_batch):
        acc = 0
        for x in range(1 << log_batch):
            acc ^= scalar.mul(LEVEL, tensor[x], values[(j << log_batch) | x])
        collapsed.append(acc)
    return fold_chunk_scalar(domain, log_len, chunk_index, collapsed, challenges)


def eq_tensor_scalar_ordered(point: list[int]) -> list[int]:
    out = []
    for idx in range(1 << len(point)):
        acc = 1
        for i, p in enumerate(point):
            acc = scalar.mul(LEVEL, acc, p if (idx >> i) & 1 else p ^ 1)
        out.append(acc)
    return out


def np_elem_to_int(cw_np: np.ndarray, i: int) -> int:
    return int(sum(int(x) << (32 * k) for k, x in enumerate(cw_np[i])))


def codeword_to_numpy(codeword: torch.Tensor) -> np.ndarray:
    """(N, 4) int32 codeword -> (N, 4) uint32 host copy."""
    tracing.count("readbacks")
    return codeword.detach().cpu().contiguous().numpy().view(np.uint32)



# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

class FRIFolder:
    """The fold-phase prover (`FRIFolder`, `fri/prove.rs:219`). Codewords
    stay on their device; each fold oracle is committed there through
    `commit_codeword_device` (K5 and K6 on the card). Only the terminate
    codeword and the opened cosets cross to the host."""

    def __init__(self, params: FRIParams, codeword: torch.Tensor, codeword_tree):
        self.params = params
        self.domain = params.ntt_domain()
        self.codewords = [codeword]   # 0 = the interleaved codeword, 1.. = folds
        self.trees = [codeword_tree]
        self.unprocessed: list[int] = []
        self.curr_round = 0
        self.next_commit_round = params.fold_arities[0] if params.fold_arities else None

    @property
    def n_rounds(self) -> int:
        return self.params.n_fold_rounds

    def execute_fold_round(self, challenge: int):
        """Returns the new oracle's root (bytes) on commitment rounds, else None."""
        self.unprocessed.append(challenge)
        self.curr_round += 1
        if self.next_commit_round != self.curr_round:
            return None
        p = self.params
        n_committed = len(self.codewords) - 1
        if n_committed:
            prev = self.codewords[-1]
            folded = fold_interleaved(self.domain, prev, self.unprocessed,
                                      prev.shape[0].bit_length() - 1, 0)
        else:
            folded = fold_interleaved(self.domain, self.codewords[0], self.unprocessed,
                                      p.log_code_len, p.log_batch_size)
        self.unprocessed = []
        coset_log = (p.fold_arities[n_committed + 1]
                     if n_committed + 1 < len(p.fold_arities) else p.n_final_challenges)
        self.codewords.append(folded)
        tree = commit_codeword_device(folded, coset_log, folded.device)
        self.trees.append(tree)
        if n_committed + 1 < len(p.fold_arities):
            self.next_commit_round = self.curr_round + p.fold_arities[n_committed + 1]
        else:
            self.next_commit_round = None
        return tree.root

    def finish_proof(self, transcript) -> None:
        """Terminate codeword, optimal layers, query openings
        (`fri/prove.rs:483-508`)."""
        assert self.curr_round == self.n_rounds, "must execute all fold rounds"
        p = self.params
        advice = transcript.decommitment()
        advice.write_bytes(codeword_to_numpy(self.codewords[-1]).astype("<u4").tobytes())
        for tree, depth in zip(self.trees, p.vcs_optimal_layers_depths()):
            advice.write_bytes(tree.layer_np(tree.depth - depth).tobytes())
        # decommitment writes never touch the challenger, so sampling every
        # index first gives the reference's bytes and lets the openings of
        # each oracle gather in one device round trip
        indices = [transcript.sample_bits(p.index_bits) for _ in range(p.n_test_queries)]
        for blobs in self._query_openings(indices):
            adv = transcript.decommitment()
            for b in blobs:
                adv.write_bytes(b)

    def _query_openings(self, indices: list[int]) -> list[list[bytes]]:
        """Per query: for each oracle, its coset's bytes and the branch
        siblings up to the optimal layer, leaf-up."""
        p = self.params
        out: list[list[bytes]] = [[] for _ in indices]
        depths = p.vcs_optimal_layers_depths()
        idx = list(indices)
        for oracle, arity in enumerate(p.fold_arities):
            if oracle > 0:
                # the index shifts by the current oracle's arity before its
                # opening (`fri/prove.rs:581-597`)
                idx = [i >> arity for i in idx]
            cw = self.codewords[oracle]
            sel = torch.tensor(idx, dtype=torch.long, device=cw.device)
            rows = codeword_to_numpy(cw.reshape(cw.shape[0] >> arity, -1)[sel])
            tree = self.trees[oracle]
            branches = tree.branches_many(idx, tree.depth - depths[oracle])
            for q in range(len(indices)):
                out[q].append(rows[q].astype("<u4").tobytes())
                out[q].extend(branches[q])
        return out


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------

class FRIVerifier:
    def __init__(self, params: FRIParams, codeword_commitment: bytes,
                 round_commitments: list[bytes], challenges: list[int]):
        assert len(round_commitments) == params.n_oracles
        assert len(challenges) == params.n_fold_rounds
        self.params = params
        self.domain = params.ntt_domain()
        self.codeword_commitment = codeword_commitment
        self.round_commitments = round_commitments
        self.interleave_tensor = eq_tensor_scalar_ordered(challenges[:params.log_batch_size])
        self.fold_challenges = challenges[params.log_batch_size:]

    def verify(self, transcript) -> int:
        """The query phase; returns the final folded value."""
        p = self.params
        advice = transcript.decommitment()
        n_term = 1 << (p.n_final_challenges + p.log_inv_rate)
        terminate_np = np.frombuffer(advice.read_bytes(n_term * 16), dtype="<u4").reshape(n_term, 4)
        final_value = self.verify_last_oracle(terminate_np)
        depths = p.vcs_optimal_layers_depths()
        layers = [np.frombuffer(advice.read_bytes((1 << d) * 32), dtype=np.uint8)
                  .reshape(1 << d, 32) for d in depths]
        for com, layer in zip([self.codeword_commitment, *self.round_commitments], layers):
            self._verify_layer(com, layer)
        # every index first (decommitment reads never touch the challenger),
        # then all queries' Merkle checks batched per oracle and level
        indices = [transcript.sample_bits(p.index_bits) for _ in range(p.n_test_queries)]
        queries = [self._read_query(transcript.decommitment()) for _ in indices]
        if p.fold_arities:
            self._check_openings_batch(indices, queries, layers)
            for index, q in zip(indices, queries):
                self._check_folds(index, q, terminate_np)
        return final_value

    def _read_query(self, advice) -> list:
        """One query's advice: per oracle, (values (2^arity, 4) uint32, branch
        siblings) in the prover's write order."""
        p = self.params
        out = []
        depths = p.vcs_optimal_layers_depths()
        log_n_cosets = p.index_bits
        for i, arity in enumerate(p.fold_arities):
            if i > 0:
                log_n_cosets -= arity
            vals = np.frombuffer(advice.read_bytes((1 << arity) * 16), dtype="<u4")
            vals = vals.reshape(1 << arity, 4)
            out.append((vals, [advice.read_bytes(32) for _ in range(log_n_cosets - depths[i])]))
        return out

    def _check_openings_batch(self, indices: list[int], queries: list, layers: list) -> None:
        """Each oracle's openings for all queries: the leaf digests in one
        batched hash, one batched compression per branch level, one compare
        against the cached layer."""
        idx = np.asarray(indices)
        for i, arity in enumerate(self.params.fold_arities):
            if i > 0:
                idx = idx >> arity
            cur = hash_leaves(np.ascontiguousarray(
                np.stack([q[i][0].view(np.uint8).reshape(-1) for q in queries])))
            n_branch = len(queries[0][i][1])
            for k in range(n_branch):
                sibs = np.stack([np.frombuffer(q[i][1][k], dtype=np.uint8) for q in queries])
                left_is_cur = ((idx >> k) & 1)[:, None] == 0
                pairs = np.concatenate([np.where(left_is_cur, cur, sibs),
                                        np.where(left_is_cur, sibs, cur)], axis=1)
                cur = compress_pairs(np.ascontiguousarray(pairs))
            ok = (cur == layers[i][idx >> n_branch]).all(axis=1)
            if not ok.all():
                raise ValueError(f"Merkle coset opening failed (oracle {i}, query "
                                 f"{int(np.nonzero(~ok)[0][0])})")

    def _check_folds(self, index: int, query: list, terminate_np: np.ndarray) -> None:
        """One query's fold-consistency walk."""
        p = self.params
        vals0 = query[0][0]
        log_coset0 = p.fold_arities[0] - p.log_batch_size
        next_value = fold_interleaved_chunk_scalar(
            self.domain, p.log_code_len, p.log_batch_size, index,
            [np_elem_to_int(vals0, i) for i in range(vals0.shape[0])],
            self.interleave_tensor, self.fold_challenges[:log_coset0])
        fold_round = log_coset0
        for i, arity in enumerate(p.fold_arities[1:]):
            coset_index = index >> arity
            vals_np = query[i + 1][0]
            values = [np_elem_to_int(vals_np, j) for j in range(vals_np.shape[0])]
            if next_value != values[index % (1 << arity)]:
                raise ValueError(f"incorrect fold at query round {i}")
            next_value = fold_chunk_scalar(
                self.domain, p.log_code_len - fold_round, coset_index, values,
                self.fold_challenges[fold_round:fold_round + arity])
            index = coset_index
            fold_round += arity
        if next_value != np_elem_to_int(terminate_np, index):
            raise ValueError("incorrect final fold")

    def verify_last_oracle(self, terminate_np: np.ndarray) -> int:
        p = self.params
        last_com = (self.round_commitments[-1] if self.round_commitments
                    else self.codeword_commitment)
        n_final = p.n_final_challenges
        tree = commit_codeword(terminate_np,
                               n_final if p.n_oracles else p.log_dim + p.log_batch_size)
        if tree.root != last_com:
            raise ValueError("terminate codeword does not match commitment")
        term = [np_elem_to_int(terminate_np, i) for i in range(terminate_np.shape[0])]
        if p.n_oracles:
            final_challenges = self.fold_challenges[len(self.fold_challenges) - n_final:]
            rep = [fold_chunk_scalar(self.domain, n_final + p.log_inv_rate, i,
                                     term[i << n_final:(i + 1) << n_final], final_challenges)
                   for i in range(len(term) >> n_final)]
        else:
            arity = p.log_dim + p.log_batch_size
            rep = [fold_interleaved_chunk_scalar(
                self.domain, p.log_code_len, p.log_batch_size, i,
                term[i << arity:(i + 1) << arity], self.interleave_tensor, self.fold_challenges)
                for i in range(len(term) >> arity)]
        if any(v != rep[0] for v in rep[1:]):
            raise ValueError("terminate codeword is not a repetition codeword")
        return rep[0]

    @staticmethod
    def _verify_layer(commitment: bytes, layer: np.ndarray) -> None:
        cur = layer
        while cur.shape[0] > 1:
            cur = compress_pairs(cur.reshape(-1, 64))
        if cur[0].tobytes() != commitment:
            raise ValueError("layer does not match commitment")
