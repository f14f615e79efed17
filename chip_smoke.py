#!/usr/bin/env python3
"""Drive binius_tpu_torch's commit and its opening on one NVIDIA H100 and
check them.

    python3 chip_smoke.py [--seed 0] [--log-rows 22]

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds the kernels from binius_tpu_torch/csrc (nvcc, sm_90a) and times it.
3. One phase per kernel (K1-K6) at the shapes of the main path: the
   kernel's output against its plain PyTorch version on the same inputs
   (bit-equal: every operation is exact over GF(2)), the kernel's and the
   plain version's median time with CUDA events, and the kernel's bound.
   K1 runs at levels 5, 6 and 7 on the opening's largest batch, 2^22
   elements.
4. The commit: the u32_add witness at 2^log_rows rows from --seed,
   committed with `piop.commit` on the card, its launches counted; its root
   against the same commit composed from the plain versions; at 2^16 rows
   the root against a golden root computed by the JAX package; the warm
   commit time and its split.
5. The opening (the main path): one evaluation claim per committed column
   at a point drawn after the witness, proven by commit, `ring_switch.prove`
   and `piop.prove`, with every launch counter set to 0 just before and read
   just after; the port's verifiers accept the proof and reject it with one
   byte flipped; the warm time (median of 3) and its split.
6. Bytes: at 2^16 rows the opening's sha256 against a golden digest
   computed by the JAX package, and the same opening composed from the
   plain versions (on the CPU) against the kernel path, byte for byte.
7. One JSON line for the kernels, then, as the last line,
   {"ok": true, "device": {...}}.

Every failure raises: no phase is caught. Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# The JAX package's `piop.commit` root for u32_add_columns(16, seed=0),
# computed on the CPU with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_root.py --log-rows 16 --seed 0
GOLDEN_LOG_ROWS, GOLDEN_SEED = 16, 0
GOLDEN_ROOT_16 = "5ba7dfef9aaac4e68954742aec76cae848d679dbe787f5a4957283dfacf08804"
# The JAX package's opening of the same commitment (u32_add_instance(16, 0):
# root, ring_switch.prove, piop.prove), computed on the CPU with binius_tpu
# (jax 0.9.0) by
#   python scripts/port_golden_open.py --log-rows 16 --seed 0
GOLDEN_OPEN_16 = "21afac7159130124a328928ff19e3590bcc3e50fc0cc6119002f22b17a6a0591"

# Card peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W): HBM at
# 3.35 TB/s; 32-bit integer and logic operations at no more than the
# float32 issue rate outside the tensor cores, 67 TFLOP/s / 2 per FMA.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2

SECURITY_BITS = 100
LOG_INV_RATE = 1


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int, setup=None, inner: int = 1) -> float:
    """Median over `reps` runs of fn(setup()) between CUDA events (ms); a
    run of `inner` back-to-back calls, divided by `inner`, keeps the host's
    launch overhead out of a short kernel's time."""
    times = []
    for _ in range(reps):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(arg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over the words (int32 tensors or lists of them)."""
    pairs = list(zip(a, b)) if isinstance(a, (list, tuple)) else [(a, b)]
    err = 0
    for x, y in pairs:
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        err = max(err, int((x.long() - y.long()).abs().max().item()) if x.numel() else 0)
    return err


def mul_gates(level: int) -> int:
    """2-input gates of the bitsliced Karatsuba network `_mul_bs(level)`."""
    if level == 0:
        return 1
    h = 1 << (level - 1)
    return 3 * mul_gates(level - 1) + 6 * h - 1


def ntt_ops(plan, stages) -> int:
    """Gate count of the butterfly stages: per (pair or intra-word word) and
    group, the B32 network, 32 mask expansions of 3 ops, and the XORs."""
    groups = 1 << (plan.dl - 5)
    ops = 0
    for st in stages:
        if st.d_elems < 32:
            ops += plan.n_words * groups * (mul_gates(5) + 96 + 32 * 8)
        else:
            ops += plan.n_words // 2 * groups * (mul_gates(5) + 96 + 64)
    return ops


# one Grøstl round on 8 column words: 8 constant XOR64 (16 ops), 64 table
# lookups (byte extract + address + load, 4 ops) and 56 XOR64 (112 ops)
GROESTL_ROUND_OPS = 16 + 64 * 4 + 112


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def instance(log_rows: int, seed: int, device) -> dict:
    """The slice's inputs: the committed u32_add columns, and one claim per
    column at the point drawn after the witness, its value the column's
    evaluation there."""
    from binius_tpu_torch.convert import from_reference
    from binius_tpu_torch.fields import scalar, tower
    from binius_tpu_torch.m3.gadgets.arith import u32_add_instance
    from binius_tpu_torch.math import mle
    from binius_tpu_torch.protocols import piop, ring_switch

    cols, point = u32_add_instance(log_rows, seed)
    words = [from_reference(c, device) for c in cols]
    packed = [piop.pack_multilinear(tower.P1, w, log_rows + 5) for w in words]
    meta = piop.CommitMeta((0,) * packed[0][1] + (len(packed),))
    # bind the high variables with the suffix's eq expansion, then the 7 low
    # ones (bit positions in a packed element) on the host
    eq = mle.eq_ind_partial_eval(7, tower.from_ints(7, point[7:], device))
    _, t = mle.batched_evaluate_partial_high(tower.P1, torch.stack(words), log_rows + 5, eq, 7)
    claims = []
    for i, row in enumerate(t):
        cur = tower.to_ints(7, row)
        for z in point[:7]:
            cur = [cur[2 * j] ^ scalar.mul(7, cur[2 * j] ^ cur[2 * j + 1], z)
                   for j in range(len(cur) // 2)]
        claims.append(ring_switch.RingSwitchEvalClaim(i, 0, tuple(point), cur[0]))
    return dict(params=piop.make_commit_params(meta, SECURITY_BITS, LOG_INV_RATE), meta=meta,
                packed=packed, witnesses=[(tower.P1, w) for w in words], claims=claims,
                device=device)


def open_commitment(inst: dict) -> bytes:
    """Commit, then open: the proof's first message is the root."""
    from binius_tpu_torch.protocols import piop, ring_switch
    from binius_tpu_torch.transcript.transcript import ProverTranscript

    pt = ProverTranscript()
    cw, tree, _ = piop.commit(inst["params"], inst["meta"], inst["packed"], inst["device"])
    pt.message().write_bytes(tree.root)
    red = ring_switch.prove(inst["claims"], inst["witnesses"], pt, inst["device"])
    piop.prove(inst["params"], inst["meta"], cw, tree, inst["packed"], red.transparent_mles,
               red.sumcheck_claims, pt, inst["device"])
    return pt.finalize()


def verify_opening(inst: dict, proof: bytes) -> None:
    from binius_tpu_torch.protocols import piop, ring_switch
    from binius_tpu_torch.transcript.transcript import VerifierTranscript

    vt = VerifierTranscript(proof)
    com = vt.message().read_bytes(32)
    red = ring_switch.verify(inst["claims"], vt, inst["device"])
    piop.verify(inst["params"], inst["meta"], com, red.transparent_mles, red.sumcheck_claims, vt)
    vt.finalize()


class Phases:
    """Seconds of each phase of the script, printed as each one ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        t = time.perf_counter()
        log(f"[phase] {name}: {t - self.t:.1f} s")
        self.t = t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-rows", type=int, default=22)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.fields import bitslice, bitslice_cuda
    from binius_tpu_torch.hash import groestl_cuda
    from binius_tpu_torch.merkle.tree import MerkleTree, _MIN_DEVICE_ROWS
    from binius_tpu_torch.ntt import bitsliced_ntt as bn
    from binius_tpu_torch.protocols import fri, piop, ring_switch
    from binius_tpu_torch.transcript.transcript import ProverTranscript

    phases = Phases()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so)}")
    for line in (cuda_lib.BUILD / "ptxas.log").read_text().splitlines() if (
            cuda_lib.BUILD / "ptxas.log").exists() else []:
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
            log("  ptxas:", line.strip())
    phases.done("card and build")

    inst = instance(args.log_rows, args.seed, dev)
    params, meta, packed = inst["params"], inst["meta"], inst["packed"]
    message = piop.merge_multilins(packed, meta.total_vars)
    rep = torch.cat([message] * (1 << params.log_inv_rate))
    shape = (params.log_batch_size, params.log_code_len, 0)
    plan, tw_np = bn._make_plan(params.ntt_domain(), fri.LEVEL, shape, 0, 0,
                                params.log_inv_rate, False)
    tw = bn._dev_tw(plan, tw_np, dev)
    n_stages = len(plan.stages)
    first = n_stages - plan.n_local
    cross = [plan.stages[si] for si in range(first)]
    local = plan.stages[first:]
    log(f"slice: {args.log_rows} rows, {params}, message {tuple(message.shape)}, "
        f"W {plan.n_words} words, {len(cross)} pair stages + {len(local)} fused "
        f"(tile {plan.tile})")
    torch.cuda.synchronize()

    rows = []

    def report(name, source, replaces, k_out, p_out, k_fn, p_fn, n_bytes, n_ops,
               setup=None, label="", row=True, inner=1):
        err = max_abs_err(k_out, p_out)
        if err:
            raise AssertionError(f"{name}: kernel and plain version differ (max |err| {err})")
        ms = cuda_ms(k_fn, args.reps, setup, inner)
        plain = cuda_ms(p_fn, args.reps, setup)
        b, by = bound_ms(n_bytes, n_ops)
        if row:
            rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                             launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b, bound_by=by, library_ms=None))
        log(f"{name}{' ' + label if label else ''}: bit-equal to plain; {ms:.4f} ms "
            f"(plain {plain:.3f} ms, bound {b:.4f} ms by {by})")

    # 3. kernel phases at the main path's shapes
    # K1: the network at the opening's largest batch, 2^22 elements (the
    # transparents' eq scaling and the sumcheck's first rounds); the row is
    # level 7 (B128), where most of the opening's products are
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k1_words = 1 << 17
    for level in (5, 6, 7):
        a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << level, k1_words), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(2))
        report("k1_tower_mul", "binius_tpu_torch/csrc/tower_mul.cu",
               "binius_tpu/fields/bitslice_pallas.py:37",
               bitslice_cuda.mul_planes(level, a, b), bitslice.mul_planes(level, a, b),
               lambda _: bitslice_cuda.mul_planes(level, a, b),
               lambda _: bitslice.mul_planes(level, a, b),
               n_bytes=3 * a.numel() * 4, n_ops=mul_gates(level) * k1_words,
               label=f"level {level}", row=level == 7, inner=20)
        del a, b
    phases.done("K1")

    # K2: to_bitsliced and from_bitsliced around the NTT (2 launches)
    planes_k = bitslice_cuda.to_bitsliced(7, rep)
    back_k = bitslice_cuda.from_bitsliced(7, planes_k)
    planes_p = bitslice.to_bitsliced(7, rep)
    back_p = bitslice.from_bitsliced(7, planes_p)
    if not torch.equal(back_k, rep):
        raise AssertionError("K2: from_bitsliced(to_bitsliced(x)) != x")
    report("k2_transpose32", "binius_tpu_torch/csrc/transpose32.cu",
           "binius_tpu/fields/bitslice_pallas.py:57",
           [planes_k, back_k], [planes_p, back_p],
           lambda _: bitslice_cuda.from_bitsliced(7, bitslice_cuda.to_bitsliced(7, rep)),
           lambda _: bitslice.from_bitsliced(7, bitslice.to_bitsliced(7, rep)),
           n_bytes=2 * 2 * rep.numel() * 4, n_ops=2 * rep.numel() * 15)

    # K4: the pair stages, one launch each
    def pairs_k(x):
        for si, st in enumerate(cross):
            bn.ntt_pair(plan, st, x, tw[si])
        return x

    def pairs_p(x):
        for si, st in enumerate(cross):
            x = bn._stage_plain(plan, st, x, tw[si])
        return x

    after_pairs = pairs_k(planes_k.clone())
    report("k4_ntt_pair", "binius_tpu_torch/csrc/ntt.cu",
           "binius_tpu/ntt/bitsliced_ntt.py:295",
           after_pairs, pairs_p(planes_k), pairs_k, pairs_p,
           n_bytes=len(cross) * (2 * planes_k.numel() * 4 + plan.n_words * 4),
           n_ops=ntt_ops(plan, cross), setup=planes_k.clone)

    # K3: the fused trailing stages, one launch
    def local_k(x):
        return bn.ntt_local(plan, first, x, tw[first:])

    def local_p(x):
        for k, st in enumerate(local):
            x = bn._stage_plain(plan, st, x, tw[first + k])
        return x

    planes_out = local_k(after_pairs.clone())
    report("k3_ntt_local", "binius_tpu_torch/csrc/ntt.cu",
           "binius_tpu/ntt/bitsliced_ntt.py:258",
           planes_out, local_p(after_pairs), local_k, local_p,
           n_bytes=2 * planes_k.numel() * 4 + len(local) * plan.n_words * 4,
           n_ops=ntt_ops(plan, local), setup=after_pairs.clone)

    # K5: leaf hashes of the codeword, one launch
    cw = bitslice_cuda.from_bitsliced(7, planes_out)
    log_coset = params.log_coset
    n_leaves = cw.shape[0] >> log_coset
    blob_len = cw.numel() * 4 // n_leaves
    n_blocks = (blob_len + 8) // 64 + 1
    leaves_k = groestl_cuda.leaf_hash_kernel(cw, log_coset, blob_len)
    report("k5_groestl_leaf", "binius_tpu_torch/csrc/groestl.cu",
           "binius_tpu/hash/groestl_pallas.py:179",
           leaves_k, groestl_cuda.leaf_hash_plain(cw, log_coset, blob_len),
           lambda _: groestl_cuda.leaf_hash_kernel(cw, log_coset, blob_len),
           lambda _: groestl_cuda.leaf_hash_plain(cw, log_coset, blob_len),
           n_bytes=cw.numel() * 4 + n_leaves * 32,
           n_ops=n_leaves * (2 * n_blocks + 1) * 10 * GROESTL_ROUND_OPS)

    # K6: the device levels down to _MIN_DEVICE_ROWS rows, one launch each
    n_dev = (n_leaves.bit_length() - 1) - (_MIN_DEVICE_ROWS.bit_length() - 1)

    def levels(fn):
        out = [leaves_k]
        for _ in range(n_dev):
            out.append(fn(out[-1]))
        return out[1:]

    n_pairs = sum(n_leaves >> (k + 1) for k in range(n_dev))
    report("k6_groestl_pairs", "binius_tpu_torch/csrc/groestl.cu",
           "binius_tpu/hash/groestl_pallas.py:200",
           levels(groestl_cuda.pairs_kernel), levels(groestl_cuda.pairs_plain),
           lambda _: levels(groestl_cuda.pairs_kernel),
           lambda _: levels(groestl_cuda.pairs_plain),
           n_bytes=n_pairs * 96, n_ops=n_pairs * 10 * GROESTL_ROUND_OPS)

    phases.done("K2-K6")

    # 4. the commit through the entry point, counted
    piop.commit(params, meta, packed)  # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    cw_main, tree, msg_main = piop.commit(params, meta, packed)
    torch.cuda.synchronize()
    counts = dict(cuda_lib.launches)
    log(f"launches on the commit: {counts}")
    missing = [k for k, v in counts.items() if v == 0 and k != "k1_tower_mul"]
    if missing:
        raise AssertionError(f"kernels not launched on the commit: {missing}")

    # (a) the same commit composed from the plain versions, on the card
    p = bitslice.to_bitsliced(7, torch.cat([msg_main] * (1 << params.log_inv_rate)))
    for si, st in enumerate(plan.stages):
        p = bn._stage_plain(plan, st, p, tw[si])
    cw_plain = bitslice.from_bitsliced(7, p)
    if not torch.equal(cw_plain, cw_main):
        raise AssertionError("slice: kernel codeword != plain codeword")
    dig = groestl_cuda.leaf_hash_plain(cw_plain, log_coset, blob_len)
    for _ in range(n_dev):
        dig = groestl_cuda.pairs_plain(dig)
    root_plain = MerkleTree.build(dig.cpu().numpy().view(np.uint8).reshape(-1, 32)).root
    if root_plain != tree.root:
        raise AssertionError(f"slice: kernel root {tree.root.hex()} != plain {root_plain.hex()}")
    log(f"root 2^{args.log_rows} rows, seed {args.seed}: {tree.root.hex()} (= plain path)")

    # (b) the golden root from the JAX package
    g_inst = instance(GOLDEN_LOG_ROWS, GOLDEN_SEED, dev)
    g_root = piop.commit(g_inst["params"], g_inst["meta"], g_inst["packed"])[1].root.hex()
    if g_root != GOLDEN_ROOT_16:
        raise AssertionError(f"golden: root {g_root} != {GOLDEN_ROOT_16}")
    log(f"root 2^{GOLDEN_LOG_ROWS} rows, seed {GOLDEN_SEED}: {g_root} (= JAX golden)")

    # warm commit time and its split (median of 3)
    splits = {k: [] for k in ("total", "merge", "encode", "leaf_hash", "pair_levels", "host_top")}
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        m = piop.merge_multilins(packed, meta.total_vars)
        ev[1].record()
        c = fri.rs_encode(params, m)
        ev[2].record()
        outs = [groestl_cuda.leaf_hash_kernel(c, log_coset, blob_len)]
        ev[3].record()
        for _ in range(n_dev):
            outs.append(groestl_cuda.pairs_kernel(outs[-1]))
        ev[4].record()
        top_rows = outs[-1].cpu().numpy()  # waits for the device
        t_dev = time.perf_counter()
        MerkleTree.build(top_rows.view(np.uint8).reshape(-1, 32))
        t_end = time.perf_counter()
        for k, (a, b) in zip(("merge", "encode", "leaf_hash", "pair_levels"),
                             zip(ev, ev[1:])):
            splits[k].append(a.elapsed_time(b))
        splits["host_top"].append((t_end - t_dev) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piop.commit(params, meta, packed)
        torch.cuda.synchronize()
        splits["total"].append((time.perf_counter() - t0) * 1e3)
    split = {k: statistics.median(v) for k, v in splits.items()}
    log("commit 2^%d rows, warm, median of 3 (ms): %s" % (
        args.log_rows, ", ".join(f"{k} {v:.3f}" for k, v in split.items())))
    phases.done("commit")

    # 5. the opening, the main path: commit, ring switch, PIOP; counted
    open_commitment(inst)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    proof = open_commitment(inst)
    torch.cuda.synchronize()
    counts = dict(cuda_lib.launches)
    log(f"launches on the opening (its commit included): {counts}")
    log(f"opening: {len(proof)} proof bytes, sha256 {hashlib.sha256(proof).hexdigest()}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    verify_opening(inst, proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        verify_opening(inst, bytes(bad))
    except (ValueError, EOFError) as e:
        log(f"opening verifies; with byte {len(bad) // 2} flipped it is rejected ({e})")
    else:
        raise AssertionError("a proof with a flipped byte was accepted")

    # warm opening time and its split (median of 3)
    names = ("total", "commit", "ring_switch", "rounds", "queries", "verify")
    splits = {k: [] for k in names}
    for _ in range(3):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        pt = ProverTranscript()
        cw, tree, _ = piop.commit(params, meta, packed)
        pt.message().write_bytes(tree.root)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        red = ring_switch.prove(inst["claims"], inst["witnesses"], pt)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        folder = piop.prove_rounds(params, meta, cw, tree, packed, red.transparent_mles,
                                   red.sumcheck_claims, pt)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        folder.finish_proof(pt)
        again = pt.finalize()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        verify_opening(inst, again)
        t.append(time.perf_counter())
        if again != proof:
            raise AssertionError("opening: proof bytes differ between runs")
        for k, a, b in zip(names[1:], t, t[1:]):
            splits[k].append((b - a) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        open_commitment(inst)
        torch.cuda.synchronize()
        splits["total"].append((time.perf_counter() - t0) * 1e3)
    split = {k: statistics.median(v) for k, v in splits.items()}
    log("opening 2^%d rows (commit + ring switch + sumcheck and fold rounds + queries; "
        "verify apart), warm, median of 3 (ms): %s" % (
            args.log_rows, ", ".join(f"{k} {v:.3f}" for k, v in split.items())))
    phases.done("opening")

    # 6. bytes: the JAX package's digest at 2^16 rows, and the same opening
    # composed from the plain versions on the CPU (at the golden's depth it
    # runs two FRI oracles, as the main path runs three, in a few seconds)
    g_proof = open_commitment(g_inst)
    g_digest = hashlib.sha256(g_proof).hexdigest()
    if g_digest != GOLDEN_OPEN_16:
        raise AssertionError(f"golden: opening sha256 {g_digest} != {GOLDEN_OPEN_16}")
    log(f"opening 2^{GOLDEN_LOG_ROWS} rows, seed {GOLDEN_SEED}: {len(g_proof)} bytes, sha256 "
        f"{g_digest} (= JAX golden)")
    p_proof = open_commitment(instance(GOLDEN_LOG_ROWS, GOLDEN_SEED, torch.device("cpu")))
    if p_proof != g_proof:
        raise AssertionError("plain-path opening differs from the kernel path")
    log(f"opening 2^{GOLDEN_LOG_ROWS} rows through the plain versions on the CPU: "
        f"the kernel path's bytes")
    phases.done("golden and plain openings")

    # 7. results
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
