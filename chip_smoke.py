#!/usr/bin/env python3
"""Drive binius_tpu_torch's proofs of the reference grid's circuits
(u32_add, b32_mul, Keccak-f, Grøstl-P, u32 multiplication through the
GKR exponentiation phase, u32 bitwise ops), of Keccak-f with chi through
a lookup channel (the grand-product phase), of SHA-256 compressions, of
Merkle-tree inclusion paths (packed and selected columns), of the M3
gadgets u32 subtraction, schoolbook u32 multiplication, the barrel
shifter and u32 division, and the u32_add commit and opening on their
own, on one NVIDIA H100, and check them, with the constraint systems'
wire formats and the prover's trace; then a Vision Mark-32 Merkle tree over
the opening's codeword and the AES and POLYVAL bases on the card; then
proofs across two ranks of a mesh, byte-equal to one device's.

    python3 chip_smoke.py [--seed 0] [--log-rows 22]

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds the kernels from binius_tpu_torch/csrc (nvcc, sm_90a) and times it.
   The ptxas report (registers, spills; no function of K1 and K2 and no
   kernel of K3-K6 may spill, K3 and K4 in either direction at each of the
   six twiddle levels), the SASS instruction
   counts of K1, K3, K5 and K6, and the card figures the bounds use.
2b. The native host library (`binius_tpu_torch/native`, `native_phase`):
   built with the system C compiler on the card's host (the compiler, the
   library and the host CPU printed), then each C entry bit-equal to its
   plain Python version at a card-size proof's sizes, with both times:
   the transcript's absorb over NATIVE_BLOCKS blocks, `Groestl256`
   streamed and forked, the one-shot digest, P, Q and the compression;
   `compress_pairs` over NATIVE_PAIRS pairs and `digest_batch` over
   NATIVE_ROWS (2^11 rows of 256 bytes, 2 of 16 KiB) against the torch
   permutation on the CPU; the ring switch's B128 `tower_mul_batch` of
   NATIVE_PRODUCTS; scalar mul, square, invert and pow at levels 0-7 (us
   per op; `invert(0)` raises); the barycentric weights and Lagrange
   evaluations over the zerocheck's domains (NATIVE_DOMAINS: d * 2^k points,
   z off and on a point, and the 2^k cube) against the torch scans on the
   CPU; the evalcheck verifier's shift-indicator waves (NATIVE_SHIFT_WAVES)
   against each claim's scalar DP in Python ints.
3. One phase per kernel (K1-K6) at the shapes of the main path: the
   kernel's output against its plain PyTorch version on the same inputs
   (bit-equal: every operation is exact over GF(2)), the kernel's and the
   plain version's median time with CUDA events, and the kernel's bound.
   K1 (`bitslice_cuda.mul`, packed in and out, one launch) runs at levels
   5, 6 and 7 on 2^22 elements: full x full, a scalar on either side, and
   a ragged 2^22 - 7 elements; B128 also at a sixteenth of the size from
   which it takes its persistent kernel, the same four cases. K4 (cross
   stages fused in runs) forward at the commit's plan and at a plan of two
   runs, inverse at a plan of five cross stages. K3 at the commit's plan,
   at a plan whose tile is below 1024 words, and inverse at 2^15 words.
   K5 (both of its kernels) at the opening's four leaf shapes, at a ragged
   leaf count and at blobs of 16 and 56 bytes. K6 at the opening's four
   tree shapes (2^19, 2^15, 2^11 and 2 leaves), every layer to the root,
   with its tail from several level sizes, the wrapper's among them.
4. The commit: the u32_add witness at 2^log_rows rows from --seed,
   committed with `piop.commit` on the card, its launches counted (K4 one
   per run of cross stages, K5 one, K6 as `tree_launches` says); its
   codeword and every tree layer against the same commit composed from the
   plain versions; at 2^16 rows the root against a golden root computed by
   the JAX package; the warm commit time and its split.
5. The opening: one evaluation claim per committed column
   at a point drawn after the witness, proven by commit, `ring_switch.prove`
   and `piop.prove`, with every launch counter set to 0 just before and read
   just after, and no Grøstl Merkle hashing on the host (a counter around
   `groestl.compress_pairs_t` and the native library's pair and row
   batches); the port's verifiers accept the proof and
   reject it with one byte flipped; the warm time (median of 3) and its
   split.
   (The commit and the opening are the earlier slices' main paths, each
   driven on its own with its own counts.)
5b. The Vision Mark-32 tree, the reference's other Merkle scheme: the
   opening run once more, recording its commit's codeword and its FRI query
   indices; the codeword's leaves (`fri.leaf_blobs` at the commit's
   log_coset: 2^19 leaves of 256 bytes at 2^22 rows) hashed by
   `vision.digest_many` and the tree built by `MerkleTree.build(...,
   vision_scheme())`: the first build, one build counted (K1 alone, one
   launch per MDS layer per batch: 16 x (5 + 2 x 19)) with its peak device
   memory, and the warm time (median of 3: the counted build and two more)
   split into leaves and levels, with permutations per second; the same
   tree through K1's plain version `bitslice.mul` on the card (in batches
   of `PLAIN_VISION_STATES` rows), every layer byte-equal; 64 sampled
   leaves and 64 sampled pairs at three levels against the host sponge
   (`vision.digest`, `permute_scalar`); every query's branch hashed up to
   the root, one batch per level, and `verify_branch` and
   `verify_branch_to_layer` (to FRI's optimal layer) accepting two of them
   and rejecting a flipped byte; at 2^16 rows the root, on K1 and on the
   plain path, against the JAX package's (`GOLDEN_VISION_ROOT_16`).
5c. The AES and POLYVAL bases on 2^22 random B128 elements:
   `aes.convert_device` to AES and back (the identity; `canonical_to_aes`
   on 256 samples), `tower.apply_bitmatrix` with the canonical -> POLYVAL
   matrix (`canonical_to_polyval` on 256 samples), and phi(a * b) with a * b
   from K1 (one launch) against `polyval_mul(phi(a), phi(b))` on 256
   samples; each step's time on its first run.
6. The NTT's small shapes (fault C1): forward and inverse transforms of 16,
   32, 64 and 128 B128 elements (B32 twiddles, a coset of a larger domain)
   and a B8 transform of the zerocheck's shape (k = 7 stages over 5 rows)
   take the packed stage loop on the card, no K2-K4 launch, and equal it
   on the CPU; the smallest batch the bitsliced gate admits (2^15
   elements) takes K2/K3/K4 and equals the stage loop on the card. Stage
   1 of the zerocheck routes as the JAX package does (fault C7): a chunk
   with B32 or wider data (b32_mul's B32, u32_mul_gkr's and div_uu32's
   B128) whose rows, padded to a power of two, hold at least 2^15 elements
   is one flat batch through K2 and K3 at B8 twiddles; B8 and B16 data
   (u32_add, keccak, sha256 and the other proofs) and smaller batches keep
   the stage loop.
6b. K3 and K4 at every twiddle level (fault C5; `level_checks`): at each
   (data level, twiddle level) of `LEVEL_PAIRS` (B8 and B16 twiddles on
   B8 to B128 data, and B1 to B4 twiddles on B32), forward and inverse at
   the shapes of `LEVEL_SHAPES` (intra-word stages, cross runs, a coset,
   skipped rounds, blocks below a word), K3 launched once where the plan
   has local stages and K4 once per cross run (at least once per pair),
   each transform bit-equal to the stages' plain version on the card;
   `AdditiveNTT` over a B8 domain on 2^20 B32 elements, shape (12, 8, 0),
   the call that raised before, equal to the stage loop, and K4 and K3
   timed at its plan with their bounds. Then the zerocheck's stage-1
   shapes (fault C7, `STAGE1_SHAPES`): (0, 7, log_z) at (5, 3) and (7, 3)
   as b32_mul, u32_mul_gkr and div_uu32 give them at 2^20, and (0, 3, 12)
   on B128 (k < 5: blocks below a word), the inverse on coset 0 and the
   forward on each other coset, each bit-equal to the plain stages with
   its K3 launch asserted; K3 timed at b32_mul's and div_uu32's shapes
   with its bound and x bound.
7. The proofs (the main path), each through `constraint_system.prove.prove`
   on the card with its inputs drawn from --seed
   (`binius_tpu_torch.circuits.instance`): the u32_add constraint system
   of 2^log_rows rows, then the reference grid's other circuits at their
   grid sizes: b32_mul (2^20 B32 products), keccak (2^13 Keccak-f[1600]
   permutations), groestl (2^14 Grøstl P permutations), u32_mul_gkr (2^20
   u32 products, `MulUU32`), bitwise_ops (2^22 rows of u32 AND, XOR
   and OR) and keccak_lookups (2^13 Keccak-f permutations with chi through
   the bit-AND lookup channel: 600 pulls of 2^19 values and 31 flushes of
   the 4-row table, proven through the grand-product phase; its table
   sizes are the proof's first message), then the examples outside the
   grid at `circuits.CARD_SIZE`: sha256 (2^14 SHA-256 compressions,
   1,344 committed B1 columns of 2^19 bits) and merkle_tree (2^12 opened
   leaves of a 2^20-leaf Grøstl-256 tree, whose levels K6 builds on the card, the paths'
   compressions checked in three nodes tables, through packed, projected
   and shifted columns, with its boundaries and table sizes), u32_sub
   (2^22 rows, `U32Sub`), u32_mul (2^20 schoolbook products, `U32Mul`:
   128 committed B1 columns of 2^25 bits),
   barrel_shifter (2^20 rows, each of the three shift kinds by its own
   amounts) and div_uu32 (2^20 divisions, `DivUU32`: a `MulUU32` through
   the exponentiation phase, 64-bit ripple adder and subtracter over bit
   columns, a non-zero claim). For each: the system's BTPUCS03 bytes
   (`constraint_system.serialization`) and canonical form read back to
   the same bytes, digest and symbolic system; the
   system's size and the commit's NTT plan; the first run's time with its
   phase split; one run with every launch counter set to 0 just before
   and read just after (K1, K2, K3, K5 and K6 each launched; K2 twice
   and K3 once per bitsliced transform, K4 once per run of a plan's cross
   stages: the commit's, and stage 1's where it routes, which b32_mul,
   u32_mul_gkr and div_uu32 must do at the shapes of `STAGE1_SHAPES`, and
   no other proof; no host Grøstl compression), its
   length, sha256 (against `CARD_PROOFS` where pinned), peak device
   memory and bytes per phase
   (`last_phase_sizes`, summing to its length but for the table sizes'
   message); for a system with exponents (u32_mul_gkr, div_uu32), every
   exponent's layer witnesses at the proof's size computed through K1
   and through its plain version `bitslice.mul` on the card, bit-equal,
   K1 once per layer; for a system with flushes or non-zero claims
   (keccak_lookups, merkle_tree, div_uu32), the grand-product trees of
   its flush oracles at the proof's size through K1 (one launch per layer
   and size group) against the plain `bitslice.mul` on the card, layer by
   layer, bit-equal
   (`check_gpa_layers`); the port's `verify` accepts it
   and rejects it with one byte flipped; the warm prove time (median of 3:
   the counted run and two more) with its phase split (commit, exp, gpa, zerocheck, evalcheck, ring
   switch, PIOP), the bytes equal across the runs, and the verify time
   (median of 3: the accepting verify, and two against the system
   deserialized from its BTPUCS03 bytes); for the three proofs whose
   stage 1 routes, two more runs with stage 1 on the stage loop (before
   and after the warm runs): the same bytes, and both routes' stage-1 and
   zerocheck times. Every proof runs with stage 2's
   same-structure zerocheck claims grouped (`group_claims`, on for CUDA by
   default); each counted run prints its grouped provers and their claims
   and stage 2's wall ms. For keccak and merkle_tree the proof's zerocheck
   also runs alone in both regimes, one prover per claim and grouped
   (`stage2_regimes`: stage 2's wall ms, median of 3, its wall and device
   ms under torch.profiler, the grouped provers, K1 launches; the two
   transcripts equal).
7b. Other code rates and the command lines: u32_add at 2^log_rows rows
   with `log_inv_rate` 2 and 3 and sha256 2^14 with 2 through the same
   proof driver as section 7, with one warm run (the counted one; their
   goldens are section 8's); then each example command line of
   `binius_tpu_torch.examples` run in-process on the card at its JAX
   defaults, its output holding the device and every metric line the JAX
   example prints (`EXAMPLE_LINES`), and u32_add's as `python -m
   binius_tpu_torch.examples.u32_add` in a subprocess beside them.
8. Bytes: at 2^16 rows the opening's sha256 against a golden digest
   computed by the JAX package, and the same opening composed from the
   plain versions (on the CPU) against the kernel path, byte for byte; the
   golden 8-row u32_add proof (`tests/test_golden_transcript.py`'s
   instance) on the card with tracing on (`utils.tracing`,
   BINIUS_TRACE_FILE: its Chrome trace, written to chiprun_out/, holds a
   complete span per phase of the phase's time within 1 ms) against its
   pinned length, sha256 and bytes per phase (`GOLDEN_PHASE_SIZES_8`); the
   2^16-row
   proof against the JAX package's digest, and the same proof through the
   plain versions on the CPU against the kernel path's bytes; b32_mul at
   2^10, keccak at 2^1 and groestl at 2^3 (seed 0) on the card against the
   JAX package's length and sha256 (`GOLDEN_CIRCUITS`), and each through
   the plain versions on the CPU against the card's bytes; u32_mul_gkr at
   2^7, bitwise_ops at 2^5, keccak_lookups at 2^0, the channel systems
   (`circuits.channel_system`: a permutation channel, boundaries,
   selector flushes, a multiplicity lookup, a non-zero claim), sha256 at
   2^0 and merkle_tree at the example's instance (16 leaves, 3 opened: its
   LEFT nodes table is empty), u32_sub at 2^4, u32_mul, barrel_shifter and
   div_uu32 at 2^2 the same way, merkle_tree at 64 leaves with 8
   opened (every nodes table has rows, `GOLDEN_CARD`), and u32_add at 2^11
   rows with `log_inv_rate` 2 and 3 and sha256 at 2^0 with 2
   (`GOLDEN_RATES`), each proof verified (the proofs through the plain
   versions run in PLAIN_WORKERS worker processes beside the card's); the golden systems' BTPUCS03 bytes (8 and 2^16 rows, each of
   `GOLDEN_CIRCUITS`) against the sha256 of the JAX package's
   (`GOLDEN_SERIALIZE`); keccak at 2^1 also with `group_claims` False and
   True, both the JAX package's bytes.
8b. The mesh (`mesh_phase`): MESH_WORLD ranks started by
   `parallel.distributed.run_ranks` (two on cuda:0 over gloo, the
   collectives staged through host buffers, or one card each over NCCL
   where there are as many cards; printed), each proving with
   `prove(..., mesh=)`: u32_add at 2^16 rows (the JAX package's digest),
   at 2^log_rows rows (the bytes of section 7's one-device proof; its
   first and warm time, per-rank peak device memory and a run counted per
   rank, every kernel launched on each rank) and the lookups-and-
   exponentiation instance (`m3.instances.grouped_lookup_exp_instance`,
   the JAX package's digest, proven here on one device too, a grouped
   prover of two claims on every rank); each proof accepted by `verify`
   and rejected with one byte flipped; and `ntt.sharded_ntt` forward and
   inverse on 2^MESH_NTT_LOG B32 elements, every rank's block equal to the
   one-device transform's, with the launches per rank.
9. One JSON line for the kernels (launches: the thirteen proofs' counted
   runs, the three proofs at other rates, the Vision tree's counted build
   and each mesh rank's counted u32_add run together, and per proof),
   then, as the last line,
   {"ok": true, "device": {...}}.

Every failure raises: no phase is caught. Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import ctypes
import hashlib
import importlib
import io
import json
import multiprocessing
import os
import random
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

# The JAX package's `piop.commit` root for u32_add_columns(16, seed=0),
# computed on the CPU with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_root.py --log-rows 16 --seed 0
GOLDEN_LOG_ROWS, GOLDEN_SEED = 16, 0
GOLDEN_ROOT_16 = "5ba7dfef9aaac4e68954742aec76cae848d679dbe787f5a4957283dfacf08804"
# The JAX package's Vision Mark-32 root over the same codeword's leaves
# (`fri.leaf_blobs` at the commit's log_coset: 2^13 leaves of 256 bytes;
# `vision.digest_many`, then `MerkleTree.build(..., vision_scheme())`),
# computed on the CPU with binius_tpu (jax 0.9.0; 146.1 s) by
#   python scripts/port_golden_root.py --log-rows 16 --seed 0 --scheme vision
GOLDEN_VISION_ROOT_16 = "3ee397d94bbe4c9205e49e783285db2a129b59ace06ad558520524a02c32bdee"
# The JAX package's opening of the same commitment (u32_add_instance(16, 0):
# root, ring_switch.prove, piop.prove), computed on the CPU with binius_tpu
# (jax 0.9.0) by
#   python scripts/port_golden_open.py --log-rows 16 --seed 0
GOLDEN_OPEN_16 = "21afac7159130124a328928ff19e3590bcc3e50fc0cc6119002f22b17a6a0591"
# The JAX package's u32_add proof of u32_add_rows(16, seed=0) (its M3 front
# end, `constraint_system.prove.prove`, log_inv_rate 1), computed on the CPU
# with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_proof.py --log-rows 16 --seed 0
GOLDEN_PROOF_16 = (202416, "645a741da769b72893f0a66f657e3f7c11e5f91e7ce4200e6f993ab5eab091cc")
# The golden 8-row instance of tests/test_golden_transcript.py (rows drawn
# by random.Random(42)), pinned in tests/fixtures/proof_self_golden.json.
GOLDEN_PROOF_8 = (7328, "ff771c0972ec4044dac2aeb7f02b0f602d872968a4aaf9d5b3770608a7c2e079")
# The JAX package's proofs of the other circuits of the reference grid at
# small sizes, seed 0 (`binius_tpu_torch.circuits.instance(circuit, size,
# 0)`; log_inv_rate 1): circuit -> (size, proof bytes, sha256), computed on
# the CPU with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_proof.py --circuit <circuit>
GOLDEN_CIRCUITS = {
    "b32_mul": (10, 35792, "7f2b964a9d4a8326edf4fe5d1900b2a243b019269e9170c6baa5135e0e290847"),
    "keccak": (1, 229536, "c6bd0d572e02e3d17609fe1b96f60a57656c27380acd805aef036e46e6da7185"),
    "groestl": (3, 122928, "339e2b793472a0d5a544aa4761267e9bba3b6fc431f77e0e359c5cfc28bbf40a"),
    "u32_mul_gkr": (7, 119056,
                    "037d26fe0103d4a1b7bd69b62f08a63ead6aab24b0cdda6d91c89718424ab7bf"),
    "bitwise_ops": (5, 7056, "b940a3424843ed12f7903164e954209c7bc6d870fcb7e37fb5da7a5d083257fa"),
    "keccak_lookups": (0, 376904,
                       "680bf3cfbef773ae2e8940ff0a868f6dc90e8c6737f4c73c42fef8b9d745de16"),
    # the channel systems (`circuits.channel_system`), proven with their
    # boundaries
    "perm_channel": (3, 752, "2435e62d80fc9ae6663b91f96bdbda617f2844b50776a0478708b8e2fa3a0f87"),
    "boundary": (2, 320, "dbba8fd3315d1723e4cfdecc7df64540b1c2b5f3d5c682df58640dfe3922a063"),
    "selector_flush": (3, 1152,
                       "af2f72581a1a880c709a5f7ba17eb205bfa201810e1b85aafc5a021ef0f120c2"),
    "lookup_flush": (3, 1744, "8f54d62cb6c324a97fcc497a478de0c87438ecb264f6036c897a6385daee1de3"),
    "nonzero": (3, 496, "f71e94aacb76ad26ddb9f4b2bc4c5ea29754da7098c402bb4cf332199d7b2429"),
    # the examples outside the grid: sha256 at 2^0 compressions, merkle_tree
    # at examples/merkle_tree.py's instance (16 leaves, 3 opened: its LEFT
    # table is empty)
    "sha256": (0, 294288, "3503f8885847d388cb69a0e2b33308ecdd665845a20da0b5c5a155114b428d0b"),
    "merkle_tree": (4, 409792,
                    "cdf69c556ed8401569641ea73d04aa9fe4dff199032d6e53b2e8b9b8f2aee6fe"),
    # the gadget circuits outside the grid (`circuits.instance`)
    "u32_sub": (4, 7664, "d9f5019fcc63a8b384c3e90cdb2b922af6b3e86a33316390cb5d82e31d88eccb"),
    "u32_mul": (2, 30000, "91bc4cb428486dcc9551ba645f0b4680238b2abd15bc29d362f9ef2bdeee4efe"),
    "barrel_shifter": (2, 12896,
                       "55b52fc2995f670b54425058652ee8e01fa7e130284f06aedbe999536a962797"),
    "div_uu32": (2, 139472, "6da950f89bf961cd73369cdb4001dad611c8dc93056e2046a6edd5d300c41b33"),
}
# The golden 8-row proof's bytes per phase (`constraint_system.prove.
# last_phase_sizes`), and the sha256 of the JAX package's
# `constraint_system.serialization.serialize` of each golden system (the
# sizes of GOLDEN_CIRCUITS, GOLDEN_PROOF_16 and GOLDEN_PROOF_8), computed on
# the CPU with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_proof.py --circuit golden_8
#   python scripts/port_golden_proof.py --systems-only --circuit <circuit>
GOLDEN_PHASE_SIZES_8 = {"commit": 32, "exp": 0, "gpa": 0, "zerocheck": 2496, "evalcheck": 192,
                        "ring_switch": 4176, "piop": 432}
GOLDEN_SERIALIZE = {
    "golden_8": "defacd9c77b272e5971129f1054181e81ce8c71dae84bdb1de7bc252141ddb3c",
    "u32_add": "26de30ea157956732636fac11ac42a6d326c3ce93e0f8b7fe9097aa5ab681922",
    "b32_mul": "c2f3858ee140ed2b4163b07492cc3d1462f56f2ee92101820117c589b757de3b",
    "keccak": "d64411b0ff97c2e219dd3dc0e4c20fce6e9b40e3a1e16c5c8df5c3a171e4f3ce",
    "groestl": "e88591e0725e17cbabf8d9300f0f8225b9cabc583d348e79f07b8fb75118bc36",
    "u32_mul_gkr": "65172ca4c8dd6a6e0feb68ffe06e7a578a2f70bf88c8f16b7dec9d4cf94fccd7",
    "bitwise_ops": "1f43c9d5c4eb5f6cfdaa607cef3bf509461a85dcaf70c4a2016458074ad0e03d",
    "keccak_lookups": "0894b1a8edef51793874c1c33110c2095ae501bd099e8ad4660d7e1b90dce434",
    "perm_channel": "7dd6df9adf51fb7164f3f16344d5a934f4c59c4e0f02294c9c44112a920ad4a9",
    "boundary": "e99cfeeb5fb1e91ea7f08ac41a8595a19d13c03ae4602c34b89e994a1bd55aba",
    "selector_flush": "9672aa2d03a1ba38ac3029fb2984c7eee2673b19bac74668c27a63080a17c65a",
    "lookup_flush": "3886f661f93233820e816f02c0427b3eaa0165fda5b6a11d4c4f3ab8fc09982a",
    "nonzero": "d0a2d022b9ffed999be0cd61dc9c8a5c591cc9cc99419aad5d3497c9811f6f77",
    "sha256": "ee2bde52e107e3dc84ca5189353050380dbb1bf616d0aa86e76533640959582c",
    "merkle_tree": "95b5af62139d22ec3a284254d1d86144a361b22c4e9da8009c7279b27d165823",
    "u32_sub": "79d930ae90c25f2534e10ee607053fd469bee55cb162e8a6a2451d684bcf669d",
    "u32_mul": "4f26f9157c82ae8810e363dc13b20fde08c98feefba5ed8ba021940f80a31a2c",
    "barrel_shifter": "ce77b1ad8dcd4dcf94d228ed187a00d275950575299e2a3d44fe76ee9033f1bf",
    "div_uu32": "51f5e78c5ad196491213d1e6d7c3f785bfb8349cb08244cac185176ecd1427e2",
}
# proven on the card and through the plain versions by this script, not by
# the CPU tests: merkle_tree at 64 leaves with 8 opened (random.seed(0);
# `scripts/port_golden_proof.py --circuit merkle_tree --size 6`)
GOLDEN_CARD = {
    "merkle_tree": (6, 413184, "09284e3c15eab83ae1cbace6d397729197e1cb9f1a006804a8e66fdc9225e02d"),
}
# the native phase's sizes (`native_phase`): the transcript's blocks, the
# host Merkle batches (2-to-1 pairs; leaf rows of 256 bytes and of 16 KiB),
# the ring switch's B128 products, scalar ops per level, and the
# univariate-skip zerocheck's domains (d * 2^k points, and the 2^k cube)
NATIVE_BLOCKS = 1 << 14
NATIVE_PAIRS = 1 << 12
NATIVE_ROWS = ((1 << 11, 256), (2, 1 << 14))
NATIVE_PRODUCTS = 1 << 12
NATIVE_SCALAR_OPS = 2000
NATIVE_DOMAINS = ((2, 7), (3, 6), (5, 5), (9, 4))
NATIVE_SHIFT_WAVES = ((32, 5), (128, 6))
# The JAX package's proof of `m3.instances.grouped_lookup_exp_instance(17)`
# (lookups, an exponentiation and two u32_add tables of one structure;
# log_inv_rate 1), (bytes, sha256), computed on the CPU with binius_tpu
# (jax 0.9.0) by
#   python scripts/port_golden_proof.py --circuit grouped_lookup_exp --seed 17
GOLDEN_GROUPED_LOOKUP_EXP = (120816,
                             "e0872180579ef3a25c67755a0a59b9a17a2c0ca23115a13787cefc7d776dbeec")
# The JAX package's proofs at code rates 1/4 and 1/8 (`log_inv_rate` 2 and
# 3), seed 0: (circuit, size, log_inv_rate) -> (proof bytes, sha256),
# computed on the CPU with binius_tpu (jax 0.9.0) by
#   python scripts/port_golden_proof.py --circuit u32_add --size 11 --log-inv-rate 2 3
#   python scripts/port_golden_proof.py --circuit sha256 --size 0 --log-inv-rate 2
#   python scripts/port_golden_proof.py --circuit u32_add --size 6 --log-inv-rate 2 3
# (5.5 to 9.2 minutes each); this script holds the first two lines' on the
# card and through the plain versions on the CPU, the CPU tests the last's
# (tests/test_torch_rates.py)
GOLDEN_RATES_CPU = {
    ("u32_add", 6, 2): (11408, "3a2ad2e3d89c75998c3d0bd587d4340c9652408b21224f6cecf3155d661d74d7"),
    ("u32_add", 6, 3): (15504, "2729cd49d2622639440714dd0c40183d5c45f8e60a4dc040b8c4083b9c82c633"),
}
GOLDEN_RATES = {
    ("u32_add", 11, 2): (66752, "6403bcea3ae3f29557fdab444fa41ce3966dc48097103c8415d37d40850ec0b7"),
    ("u32_add", 11, 3): (70816, "b63b5bd46ed40682501a12320ef7fc914d93ae127e39a536034d30d3667e81ef"),
    ("sha256", 0, 2): (279312, "44c43239b0e825b0aff7e52c301f07fe3bcd66978b9fed27212d1ccb10379038"),
}
# the card-size proofs at those rates: u32_add at --log-rows, sha256 at its
# `circuits.CARD_SIZE`
RATE_PROOFS = (("u32_add", 2), ("u32_add", 3), ("sha256", 2))
# the card-size proofs' length and sha256 at seed 0, as section 7 proved
# them with every stage-1 NTT on the stage loop (NVIDIA H100 80GB HBM3, the
# tree of commit 7448a47): the routed stage 1 keeps these bytes
CARD_PROOFS = {
    ("u32_add", 22): (413072, "9045159bcd0b3bb39315c100a2076d9e4e73a62d3ac25195bb295e620141a1e0"),
    ("b32_mul", 20): (337456, "14f6ad14c4e2c08997f14235fbacbeb398202095862c53e751194bc54465196e"),
    ("keccak", 13): (602208, "ab3913d536f8cb1672911dad8097d2e77c6c1bdfeb71c331ef87974a6139a4c0"),
    ("groestl", 14): (424848, "189e5027ab1911e823a28f128ce815e633e93c4cda5d8274378f91a530562bfc"),
    ("u32_mul_gkr", 20): (541056,
                          "152a15bff6d5b6859db620e4313d52b0161ef1e5dbbf2ae8cf95aa032edd3f87"),
    ("bitwise_ops", 22): (475232,
                          "7ff22f846b9c00e9e335538ee0e68a45adb7075446cdece51554da81633afb55"),
    ("keccak_lookups", 13): (1008792,
                             "13b067d2bc4b57b22b242d12d5d3bf9edba355261683d5f4bd37b768ca5d0a51"),
    ("sha256", 14): (691696, "986313c33f905e42df79ab0de318fc597d96566d16d4324944b6a90be040661e"),
    ("merkle_tree", 20): (696544,
                          "869e721b40df5ba6fc4d5a1c87a729958fbc1ed55a4d0d5c91f0b3bcb1fe154d"),
    ("u32_sub", 22): (413072, "9bf1483b2c3af1bcb3cafafa7c903cfe091ff89abccd4ce51ebe2aaf2236238e"),
    ("u32_mul", 20): (570192, "77ff57224f12877f65c113638a96d7452e2042405091fdd49349375b3e303633"),
    ("barrel_shifter", 20): (482176,
                             "c55ea32e165020e3d731b0c2d96c645595eb5c23c66ca3fe7dbee7eb2cbcc558"),
    ("div_uu32", 20): (650448, "c0f823966be3a4c8449f5117fade9dc779fb1ad6124859710af5d4dee823d0bb"),
    ("u32_add rate 2", 22): (310800,
                             "8522c73a51aa5a0d8aaf68854622b72abafa6f9e01f77c5b1e367dc6dd055cd5"),
    ("u32_add rate 3", 22): (281104,
                             "e615be67c6579dbed9897e6379e3f46125a9de5bee568605b8b67c31a3563acd"),
    ("sha256 rate 2", 14): (548080,
                            "6e627821ca390d61840ee87e654a4262d4dc7b355ddff7757908474d9839b49e"),
}
# the example command lines (`binius_tpu_torch.examples`) and the metric
# lines each prints after its first, in the JAX example's order
EXAMPLE_LINES = {
    "u32_add": ("trace-gen-time", "prove-time", "prove.", "proof-size", "verify-time"),
    "b32_mul": ("trace-gen-time", "prove-time", "prove.", "proof-size", "verify-time"),
    "bitwise_ops": ("trace-gen-time", "prove-time", "proof-size", "verify-time"),
    "u32_mul_gkr": ("trace-gen-time", "prove-time", "prove.", "proof-size", "verify-time"),
    "sha256": ("trace-gen-time", "validate-time", "prove-time", "prove.", "proof-size",
               "verify-time"),
    "groestl": ("trace-gen-time", "validate-time", "prove-time", "prove.", "proof-size",
                "verify-time"),
    "keccak": ("trace-gen-time", "validate-time", "prove-time", "proof-size", "verify-time"),
    "keccak_lookups": ("trace-gen-time", "validate-time", "prove-time", "proof-size",
                       "verify-time"),
    "merkle_tree": ("trace-gen-time", "validate-time", "prove-time", "proof-size",
                    "verify-time"),
}
# fault C5's phase: K3 and K4 at each (data level, twiddle level) pair, each
# at the shapes of LEVEL_SHAPES[tl]: (log_x, log_y, log_z), coset bits (the
# coset index the same), skip_rounds. One shape has intra-word stages and a
# coset (K3 alone at B8 twiddles, whose domain holds 2^8 points), one has
# cross stages (K4, and K3 for the rest); at B16 one shape has both. B4's
# first has blocks smaller than a word on a coset (fault C6's shape)
LEVEL_PAIRS = ((3, 3), (4, 3), (5, 3), (7, 3), (4, 4), (5, 4), (7, 4), (5, 2), (5, 1), (5, 0))
LEVEL_SHAPES = {
    0: (((4, 1, 12), 0, 0), ((16, 1, 0), 0, 0)),
    1: (((14, 2, 0), 0, 0),),
    2: (((0, 3, 14), 1, 1), ((13, 4, 0), 0, 1)),
    3: (((2, 7, 8), 1, 1), ((10, 7, 0), 1, 1), ((9, 8, 0), 0, 0)),
    4: (((1, 16, 0), 0, 1), ((1, 15, 1), 1, 0)),
}
# fault C7's phase: the zerocheck's stage-1 transforms, (data level, shape,
# dom_log, n_cosets) over B8 twiddles: the inverse on coset 0 and the
# forward on cosets 1..n_cosets-1 of a 2^dom_log domain, coset_bits =
# dom_log - k. The circuits' entries are their proofs' own at 2^20 (degree
# 2, k = 7): b32_mul's 3 B32 multilinears padded to 4 rows, one chunk of
# 2^13 suffixes; u32_mul_gkr's 6 B1 and B64 ones (B128 data) padded to 8,
# one chunk; div_uu32's 421 padded to 512, 32 chunks of 256 suffixes. The
# last is a degree-3 claim at k = 3 on B128, blocks below a word (fault
# C6's region), which no proof reaches
STAGE1_SHAPES = {
    "b32_mul": (5, (0, 7, 15), 8, 2),
    "u32_mul_gkr": (7, (0, 7, 16), 8, 2),
    "div_uu32": (7, (0, 7, 17), 8, 2),
    "k = 3": (7, (0, 3, 12), 5, 3),
}
# section 8's proofs through the plain versions on the CPU: worker
# processes and the torch threads of each (the card's host has 8 cores)
PLAIN_WORKERS, PLAIN_THREADS = 3, 2
# the mesh phase: ranks (two on one card over gloo, or one per card over
# NCCL where the machine has as many cards) and the sharded NTT's size (B32)
MESH_WORLD = 2
MESH_NTT_LOG = 22

# Card rates for the bounds. HBM: 3.35 TB/s (NVIDIA H100 SXM data sheet, at
# 700 W). Logic: the CUDA C++ Programming Guide's throughput of 32-bit
# bitwise AND/OR/XOR on compute capability 9.0, 64 results per clock per SM,
# at the SM count and the maximum SM clock read from the card; one LOP3
# instruction replaces at most two two-input gates, so the least instruction
# count of a gate network is its gates / 2 (`card_rates`).
HBM_BYTES_PER_S = 3.35e12
LOGIC_PER_CLOCK_PER_SM = 64
GATES_PER_LOP3 = 2

SECURITY_BITS = 100
LOG_INV_RATE = 1
# where the traced proof's Chrome trace goes (in the checkout)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


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
    """Gate count of the butterfly stages: a level-dl transform over
    level-tl twiddles is 2^(dl - tl) level-tl transforms on plane groups of
    P = 2^tl planes; per network and group, the level-tl network, P mask
    expansions of 3 ops, and the XORs. A word-aligned stage runs one
    network per word pair; an intra-word stage scales only the v half of
    each word, so two words' v halves make one network."""
    groups, P = 1 << (plan.dl - plan.tl), 1 << plan.tl
    ops = 0
    for st in stages:
        if st.d_elems < 32:
            ops += plan.n_words // 2 * groups * (mul_gates(plan.tl) + 3 * P + 2 * P * 8)
        else:
            ops += plan.n_words // 2 * groups * (mul_gates(plan.tl) + 3 * P + 2 * P)
    return ops


# one Grøstl round on 8 column words: 8 constant XOR64 (16 ops), 64 table
# lookups (byte extract + address + load, 4 ops) and 56 XOR64 (112 ops)
GROESTL_ROUND_OPS = 16 + 64 * 4 + 112


# two-input gates per word of one 32x32 bit transpose (5 rounds of 3)
TRANSPOSE_GATES_PER_WORD = 15


def card_rates() -> dict:
    """The inputs of the operation bound, read from the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    return dict(sms=sms, max_sm_mhz=mhz, logic_per_clock_per_sm=LOGIC_PER_CLOCK_PER_SM,
                gates_per_lop3=GATES_PER_LOP3,
                gates_per_s=sms * mhz * 1e6 * LOGIC_PER_CLOCK_PER_SM * GATES_PER_LOP3)


def bound_ms(n_bytes: int, n_ops: int, gates_per_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / gates_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_spills(log_text: str) -> dict:
    """Spill bytes (stores + loads) per (source file, function) in the
    ptxas report."""
    spills, src, fn = {}, None, None
    for line in log_text.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and src and fn:
            spills[(src, fn)] = int(m.group(1)) + int(m.group(2))
    return spills


def sass_counts(tool: str, lib_path, pattern: str) -> dict:
    """Static SASS counts per kernel whose name matches the regex `pattern`,
    from `cuobjdump -sass` of the built library: instructions, LOP3s,
    shared-memory loads and stores, shuffles."""
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            if cur:
                counts[cur] = dict(instructions=0, lop3=0, lds_sts=0, shfl=0)
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            c = counts[cur]
            c["instructions"] += 1
            c["lop3"] += "LOP3" in line
            c["lds_sts"] += bool(re.search(r"\b(LDS|STS)", line))
            c["shfl"] += "SHFL" in line
    return counts


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


def golden_system(device):
    """The golden 8-row instance, built as tests/test_golden_transcript.py
    builds it."""
    from binius_tpu_torch.m3.gadgets import arith
    rng = random.Random(42)
    xs = [rng.getrandbits(32) for _ in range(8)]
    ys = [rng.getrandbits(32) for _ in range(8)]
    return arith.u32_add_system(3, xs, ys, device)


def check_digest(what: str, proof: bytes, want: tuple) -> None:
    got = (len(proof), hashlib.sha256(proof).hexdigest())
    if got != want:
        raise AssertionError(f"{what}: {got[0]} bytes, sha256 {got[1]} != {want}")
    log(f"{what}: {got[0]} bytes, sha256 {got[1]} (= golden)")


def check_serialized(name: str, core) -> None:
    """The sha256 of the system's BTPUCS03 bytes against the JAX
    package's (`GOLDEN_SERIALIZE`)."""
    from binius_tpu_torch.constraint_system import serialization

    got = hashlib.sha256(serialization.serialize(core)).hexdigest()
    if got != GOLDEN_SERIALIZE[name]:
        raise AssertionError(f"{name}: serialization sha256 {got} != {GOLDEN_SERIALIZE[name]}")
    log(f"{name} system: serialization sha256 {got} (= JAX golden)")


def check_wire_formats(what: str, core):
    """The system's BTPUCS03 bytes (`serialization.serialize`) read back by
    `deserialize` to the same bytes and digest, its canonical symbolic form
    read back by `canonical.deserialize` to itself; returns the
    deserialized system."""
    from binius_tpu_torch.constraint_system import canonical, serialization

    t0 = time.perf_counter()
    raw = serialization.serialize(core)
    back = serialization.deserialize(raw)
    if serialization.serialize(back) != raw or back.digest() != core.digest():
        raise AssertionError(f"{what}: the deserialized system differs")
    note = "no symbolic form"
    if core.symbolic is not None:
        craw = canonical.serialize(core.symbolic)
        if canonical.deserialize(craw) != core.symbolic:
            raise AssertionError(f"{what}: the canonical reader differs")
        note = f"canonical {len(craw)} bytes read back"
    log(f"{what}: BTPUCS03 {len(raw)} bytes (sha256 {hashlib.sha256(raw).hexdigest()}) read "
        f"back, same bytes and digest; {note} ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    return back


def level_checks(dev, gen) -> int:
    """Fault C5's checks: K3 and K4 (`bitsliced_ntt.transform_planes`) at
    each of LEVEL_PAIRS on random planes from `gen`, at LEVEL_SHAPES,
    forward and inverse, each launch count asserted (K3 once where the plan
    has local stages, K4 once per cross run; K4 at least once per pair) and
    each result bit-equal to the stages' plain version on the card; then
    fault C7's: each of STAGE1_SHAPES on its cosets the same way. Returns
    the number of transforms checked."""
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.fields import bitslice_cuda, tower
    from binius_tpu_torch.ntt import additive_ntt
    from binius_tpu_torch.ntt import bitsliced_ntt as bn

    def plain_planes(p_, tw_, x):
        for si, st in enumerate(p_.stages):
            x = bn._stage_plain(p_, st, x, tw_[si])
        return x

    n_level_cases = 0
    for dl, tl in LEVEL_PAIRS:
        k4_runs = 0
        for shape, coset_bits, skip in LEVEL_SHAPES[tl]:
            dom_l = additive_ntt.NTTDomain.create(tl, shape[1] + coset_bits)
            n_l = 1 << sum(shape)
            lo, hi = (0, 1 << (1 << dl)) if dl < 5 else (-2 ** 31, 2 ** 31 - 1)
            x = torch.randint(lo, hi, tower.elem_shape(dl, (n_l,)), dtype=torch.int32,
                              device=dev, generator=gen)
            planes_l = bitslice_cuda.to_bitsliced(dl, x)
            for inverse in (False, True):
                p_l, tw_np_l = bn._make_plan(dom_l, dl, shape, coset_bits, coset_bits, skip,
                                             inverse)
                tw_l = bn._dev_tw(p_l, tw_np_l, dev)
                runs_l = bn._cross_runs(p_l)
                cuda_lib.reset_launches()
                got = bn.transform_planes(dom_l, planes_l, dl, shape, coset_bits, coset_bits,
                                          skip, inverse)
                torch.cuda.synchronize()
                want = {**dict.fromkeys(cuda_lib.KERNELS, 0), "k3_ntt_local": int(p_l.n_local > 0),
                        "k4_ntt_cross": len(runs_l)}
                if dict(cuda_lib.launches) != want:
                    raise AssertionError(f"C5 dl {dl} tl {tl} {shape}: launches "
                                         f"{cuda_lib.launches}, want {want}")
                if not torch.equal(got, plain_planes(p_l, tw_l, planes_l.clone())):
                    raise AssertionError(f"C5 dl {dl} tl {tl} {shape} inverse {inverse}: "
                                         f"kernels != plain version")
                k4_runs += len(runs_l)
                n_level_cases += 1
                log(f"C5: dl {dl}, tl {tl}, shape {shape}, coset {coset_bits}/{coset_bits}, skip "
                    f"{skip}, {'inverse' if inverse else 'forward'}: {len(p_l.stages)} stages, "
                    f"{p_l.n_local} in K3, cross runs {runs_l}; bit-equal to the plain version")
        if not k4_runs:
            raise AssertionError(f"C5 dl {dl} tl {tl}: K4 never launched")
    # the zerocheck's stage-1 transforms (fault C7), through the same check
    for name, (dl, shape, dom_log, n_cosets) in STAGE1_SHAPES.items():
        coset_bits = dom_log - shape[1]
        dom_l = additive_ntt.NTTDomain.create(3, dom_log)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, tower.elem_shape(dl, (1 << sum(shape),)),
                          dtype=torch.int32, device=dev, generator=gen)
        planes_l = bitslice_cuda.to_bitsliced(dl, x)
        for coset in range(n_cosets):
            p_l, tw_np_l = bn._make_plan(dom_l, dl, shape, coset, coset_bits, 0, coset == 0)
            tw_l = bn._dev_tw(p_l, tw_np_l, dev)
            runs_l = bn._cross_runs(p_l)
            cuda_lib.reset_launches()
            got = bn.transform_planes(dom_l, planes_l, dl, shape, coset, coset_bits, 0,
                                      coset == 0)
            torch.cuda.synchronize()
            want = {**dict.fromkeys(cuda_lib.KERNELS, 0), "k3_ntt_local": 1,
                    "k4_ntt_cross": len(runs_l)}
            if dict(cuda_lib.launches) != want:
                raise AssertionError(f"C7 {name} {shape} coset {coset}: launches "
                                     f"{cuda_lib.launches}, want {want}")
            if not torch.equal(got, plain_planes(p_l, tw_l, planes_l.clone())):
                raise AssertionError(f"C7 {name} dl {dl} {shape} coset {coset}: kernels != "
                                     f"plain version")
            n_level_cases += 1
            log(f"C7: stage 1 of {name}, dl {dl}, tl 3, shape {shape}, coset {coset}/"
                f"{coset_bits} {'inverse' if coset == 0 else 'forward'}: {len(p_l.stages)} "
                f"stages, {p_l.n_local} in K3, cross runs {runs_l}; bit-equal to the plain "
                f"version")
        del x, planes_l, got
    return n_level_cases


def plain_proof(circuit: str, size: int, seed: int, rate: int) -> tuple[bytes, float]:
    """A worker process's job: the proof of `circuits.instance(circuit,
    size, seed)` at code rate 2^-rate through the plain versions on the CPU,
    and its seconds."""
    from binius_tpu_torch import circuits
    from binius_tpu_torch.constraint_system import prove as csp

    torch.set_num_threads(PLAIN_THREADS)
    t0 = time.perf_counter()
    core, witness, stmt = circuits.instance(circuit, size, seed, "cpu")
    proof = csp.prove(core, witness, log_inv_rate=rate, device="cpu", **stmt)
    return proof, time.perf_counter() - t0


def check_example(name: str, out: str, metrics: tuple, device_name: str,
                  n_phases: int) -> None:
    """An example command line's output: the device named on the first
    line, then the metric lines in the JAX example's order, each once but
    `prove.<phase>`, once per phase of the `n_phases`."""
    lines = out.splitlines()
    if not lines or not lines[0].startswith(f"{name}: proving ") or \
            not lines[0].endswith(f" on {device_name}"):
        raise AssertionError(f"command line {name}: first line {lines[:1]}")
    heads = [re.match(r"\s*([a-z][\w-]*\.?)", ln).group(1) for ln in lines[1:]]
    if [h for i, h in enumerate(heads) if h not in heads[:i]] != list(metrics):
        raise AssertionError(f"command line {name}: lines {heads}, want {metrics}")
    want = len(metrics) + (n_phases - 1 if "prove." in metrics else 0)
    if len(heads) != want:
        raise AssertionError(f"command line {name}: {len(heads)} lines {heads}, want {want}")


def check_trace(path: str, times: dict) -> None:
    """The Chrome trace at `path` holds a complete span "prove.<phase>" for
    each phase of `times` (`last_phase_times`), its durations summing to the
    phase's time within 1 ms."""
    events = json.load(open(path))["traceEvents"]
    for k, v in times.items():
        if k == "total":
            continue
        spans = [e for e in events if e["ph"] == "X" and e["name"] == f"prove.{k}"]
        got = sum(e["dur"] for e in spans) / 1e3
        if not spans or abs(got - v * 1e3) > 1.0:
            raise AssertionError(f"trace: {len(spans)} spans prove.{k} of {got:.3f} ms for a "
                                 f"phase of {v * 1e3:.3f} ms")
    log(f"trace {os.path.relpath(path)}: {len(events)} events, a span per phase within 1 ms "
        f"of its time")


# the Vision trees' plain rebuild runs its permutations in batches of at
# most this many states: the plain network's stacked temporaries take about
# 90 KB per state
PLAIN_VISION_STATES = 1 << 16


def vision_tree(blobs, scheme, chunk=None) -> list:
    """The layers of the Vision tree over `blobs` ((N, L) uint8), leaves
    first: `digest_many`, then `MerkleTree.build` (one `compress_pairs` batch
    per level); with `chunk`, each batch in pieces of at most `chunk` rows."""
    from binius_tpu_torch.merkle.tree import HashScheme, MerkleTree

    if chunk:
        def pieces(fn):
            return lambda x: np.concatenate([fn(x[i:i + chunk]) for i in range(0, len(x), chunk)])
        scheme = HashScheme(scheme.name, pieces(scheme.hash_leaves), pieces(scheme.compress_pairs))
    return MerkleTree.build(scheme.hash_leaves(blobs), scheme).layers


def install_grouped_spy() -> list:
    """From now on, every `GroupedRegularSumcheckProver` built appends its
    claim count to the returned list (the caller clears it)."""
    from binius_tpu_torch.protocols.sumcheck import prove as sc_prove

    built = []
    cls = sc_prove.GroupedRegularSumcheckProver

    class Counted(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self.n_claims)

    sc_prove.GroupedRegularSumcheckProver = Counted
    return built


def stage2_regimes(circuit: str, core, witness, grouped: list) -> None:
    """A proof's zerocheck alone (`univariate_zerocheck.batch_prove` on its
    witness, a fresh transcript) with stage 2's claims proven one at a time
    and grouped: per regime one warm-up run, one counted run (K1 launches,
    the grouped provers and their claims) and two more (stage 2's wall ms,
    the median of the three), then one under torch.profiler (the
    "zerocheck.stage2" range's wall ms and its device kernels' ms); the two
    regimes' transcripts must be equal."""
    from torch.autograd import DeviceType

    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.constraint_system import prove as csp
    from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
    from binius_tpu_torch.transcript.transcript import ProverTranscript

    sets, claims = csp._zerocheck_claims(core, ascending=True)
    k = csp._zerocheck_skip(core)
    mls = [[witness[oid] for oid in st.oracle_ids] for st in sets]
    tapes = {}
    for group in (False, True):
        def run():
            pt = ProverTranscript()
            uzc.batch_prove(claims, mls, pt, k, group_claims=group)
            torch.cuda.synchronize()
            return pt.finalize()

        run()
        grouped.clear()
        cuda_lib.reset_launches()
        tapes[group] = run()
        k1, groups = cuda_lib.launches["k1_tower_mul"], list(grouped)
        walls = [uzc.last_stage_times["stage2"]]
        for _ in range(2):
            run()
            walls.append(uzc.last_stage_times["stage2"])
        wall = statistics.median(walls) * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
        evs = prof.events()
        rng = next(e for e in evs if e.device_type == DeviceType.CPU
                   and e.name == "zerocheck.stage2")
        lo, hi = rng.time_range.start, rng.time_range.end
        busy = sum(e.time_range.elapsed_us() for e in evs
                   if e.device_type == DeviceType.CUDA and lo <= e.time_range.start < hi
                   and not e.name.startswith(("prove.", "zerocheck."))) / 1e3
        log(f"{circuit} stage 2 {'grouped' if group else 'one prover per claim'}: "
            f"{len(claims)} claims, {len(groups)} grouped provers holding {sum(groups)} claims "
            f"{groups}; zerocheck K1 launches {k1}; stage 2 wall {wall:.3f} ms (median of 3); "
            f"under the profiler wall {(hi - lo) / 1e3:.3f} ms, device {busy:.3f} ms")
    if tapes[False] != tapes[True]:
        raise AssertionError(f"{circuit}: grouped and per-claim zerocheck transcripts differ")
    log(f"{circuit}: the zerocheck's transcript is the same in both regimes "
        f"({len(tapes[True])} bytes)")


def mesh_rank(log_rows: int, seed: int) -> dict:
    """One rank of the mesh phase (`parallel.distributed.run_ranks`), all on
    the mesh (`prove(..., mesh=)`): u32_add at 2^16 rows (the golden
    instance), u32_add at 2^log_rows rows from `seed` (a first run, then a
    run counted, every launch counter set to 0 just before and read just
    after, with its peak device memory), the lookups-and-exponentiation
    instance with every column sharded that divides (its grouped provers'
    claims recorded), and `sharded_ntt.transform_sharded` of 2^MESH_NTT_LOG
    B32 elements from `seed`, forward and inverse on a coset (this rank's
    block's sha256 and the launches). Returns the digests, rank 0's proof
    bytes, the times (ms), the peaks and the launches."""
    from binius_tpu_torch import circuits, cuda_lib
    from binius_tpu_torch.constraint_system import prove as csp
    from binius_tpu_torch.m3 import instances
    from binius_tpu_torch.ntt.additive_ntt import AdditiveNTT, NTTDomain
    from binius_tpu_torch.parallel import mesh as mesh_mod

    grouped = install_grouped_spy()
    mesh = mesh_mod.make_mesh()
    dev = mesh.device
    cuda_lib.lib()
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "staged": mesh.staged}

    def digest(p: bytes) -> dict:
        return {"bytes": len(p), "sha": hashlib.sha256(p).hexdigest(),
                "proof": p if mesh.rank == 0 else None}

    core, wit, _ = circuits.instance("u32_add", GOLDEN_LOG_ROWS, GOLDEN_SEED, dev)
    out["u32_add_16"] = digest(csp.prove(core, wit, mesh=mesh))
    core, wit, _ = circuits.instance("u32_add", log_rows, seed, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csp.prove(core, wit, mesh=mesh)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = csp.prove(core, wit, mesh=mesh)
    torch.cuda.synchronize()
    out["u32_add"] = {**digest(p), "first_ms": first, "warm_ms": (time.perf_counter() - t0) * 1e3,
                      "phases_ms": {k: v * 1e3 for k, v in csp.last_phase_times.items()},
                      "launches": dict(cuda_lib.launches),
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del core, wit
    core, wit = instances.grouped_lookup_exp_instance(17, device=dev)
    grouped.clear()
    out["grouped_lookup_exp"] = {**digest(csp.prove(core, wit, mesh=mesh, group_claims=True,
                                                    min_shard_elems=1)),
                                 "grouped": list(grouped)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << MESH_NTT_LOG,), dtype=torch.int32,
                         device=dev, generator=gen)
    ntt = AdditiveNTT(NTTDomain.create(5, MESH_NTT_LOG + 1))
    for inverse in (False, True):
        cuda_lib.reset_launches()
        fn = ntt.inverse if inverse else ntt.forward
        got = fn(mesh_mod.put_row_sharded(mesh, 5, data), 5, (0, MESH_NTT_LOG, 0), coset=1,
                 coset_bits=1)
        torch.cuda.synchronize()
        out["ntt_inverse" if inverse else "ntt_forward"] = {
            "sha": hashlib.sha256(got.local.cpu().numpy().tobytes()).hexdigest(),
            "launches": dict(cuda_lib.launches)}
    return out


def mesh_phase(log_rows: int, seed: int, dev, proven: dict) -> dict:
    """The mesh at MESH_WORLD ranks (`mesh_rank` on each): every proof's
    bytes equal on the ranks and to the one-device proof (u32_add 2^16 the
    JAX package's digest; u32_add 2^log_rows the earlier phase's proof,
    `proven`; the lookups-and-exponentiation instance proven here on one
    device and the JAX package's digest), at least one grouped prover of
    two claims or more on it, each proof accepted by `verify` and rejected
    with one byte flipped; the sharded NTT's blocks equal the one-device
    transform's. Returns each rank's launches on its counted u32_add run."""
    from binius_tpu_torch import circuits, cuda_lib
    from binius_tpu_torch.constraint_system import prove as csp
    from binius_tpu_torch.m3 import instances
    from binius_tpu_torch.ntt.additive_ntt import AdditiveNTT, NTTDomain
    from binius_tpu_torch.parallel import distributed

    world = MESH_WORLD
    how = (f"{world} cards, one per rank, over NCCL" if torch.cuda.device_count() >= world
           else f"{world} ranks on cuda:0 over gloo, the collectives staged through host "
                f"buffers (data only: every computation stays on the card)")
    t0 = time.perf_counter()
    ranks = distributed.run_ranks(mesh_rank, world, (log_rows, seed), timeout=900)
    log(f"mesh: {how}; ranks {[(r['rank'], r['device'], r['backend']) for r in ranks]}; "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start-up")

    def check(what: str, key: str, want: tuple, core, stmt: dict) -> None:
        got = [(r[key]["bytes"], r[key]["sha"]) for r in ranks]
        if any(g != tuple(want) for g in got):
            raise AssertionError(f"mesh {what}: ranks' proofs {got} != one-device {want}")
        proof = ranks[0][key]["proof"]
        csp.verify(core, proof, **stmt)
        bad = bytearray(proof)
        bad[len(bad) // 3] ^= 1
        try:
            csp.verify(core, bytes(bad), **stmt)
        except (ValueError, EOFError):
            pass
        else:
            raise AssertionError(f"mesh {what}: a proof with a flipped byte was accepted")
        log(f"mesh {what}: {world} ranks, {want[0]} bytes, sha256 {want[1]} (= one device); "
            f"verifies, rejected with byte {len(bad) // 3} flipped")

    core16, _, _ = circuits.instance("u32_add", GOLDEN_LOG_ROWS, GOLDEN_SEED, dev)
    check(f"u32_add 2^{GOLDEN_LOG_ROWS}", "u32_add_16", GOLDEN_PROOF_16, core16, {})
    core_m, stmt_m, n_m, sha_m = proven["u32_add"]
    check(f"u32_add 2^{log_rows}", "u32_add", (n_m, sha_m), core_m, stmt_m)
    for r in ranks:
        u = r["u32_add"]
        log(f"mesh u32_add 2^{log_rows} rank {r['rank']}: first {u['first_ms']:.1f} ms, warm "
            f"{u['warm_ms']:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in u['phases_ms'].items())}"
            f"), peak device memory {u['peak_gib']:.2f} GiB, launches {u['launches']}")
    missing = [k for k in cuda_lib.KERNELS if any(r["u32_add"]["launches"][k] == 0
                                                 for r in ranks)]
    if missing:
        raise AssertionError(f"mesh u32_add 2^{log_rows}: kernels not launched on a rank: "
                             f"{missing}")
    core_g, wit_g = instances.grouped_lookup_exp_instance(17, device=dev)
    one = csp.prove(core_g, wit_g)
    if (len(one), hashlib.sha256(one).hexdigest()) != GOLDEN_GROUPED_LOOKUP_EXP:
        raise AssertionError("grouped_lookup_exp one-device proof != the JAX package's digest")
    check("grouped_lookup_exp", "grouped_lookup_exp", GOLDEN_GROUPED_LOOKUP_EXP, core_g, {})
    groups = [r["grouped_lookup_exp"]["grouped"] for r in ranks]
    if not all(any(n >= 2 for n in g) for g in groups):
        raise AssertionError(f"mesh grouped_lookup_exp: no grouped prover of 2 claims {groups}")
    log(f"mesh grouped_lookup_exp: grouped provers' claims per rank {groups}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << MESH_NTT_LOG,), dtype=torch.int32,
                         device=dev, generator=gen)
    ntt = AdditiveNTT(NTTDomain.create(5, MESH_NTT_LOG + 1))
    for key, fn in (("ntt_forward", ntt.forward), ("ntt_inverse", ntt.inverse)):
        want = fn(data, 5, (0, MESH_NTT_LOG, 0), coset=1, coset_bits=1,
                  device=dev).reshape(world, -1)
        for r in ranks:
            if r[key]["sha"] != hashlib.sha256(want[r["rank"]].cpu().numpy().tobytes()).hexdigest():
                raise AssertionError(f"mesh {key}: rank {r['rank']}'s block != one device")
        log(f"mesh sharded NTT, 2^{MESH_NTT_LOG} B32, coset 1, {key.split('_')[1]}: every "
            f"rank's block = the one-device transform; launches per rank "
            f"{[r[key]['launches'] for r in ranks]}")
    return {f"mesh u32_add 2^{log_rows} rank {r['rank']}": r["u32_add"]["launches"]
            for r in ranks}


def cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo, else lscpu), else its
    vendor, family and model numbers."""
    with open("/proc/cpuinfo") as f:
        info = dict(line.split(":", 1) for line in f if ":" in line)
    info = {k.strip().lower(): v.strip() for k, v in info.items()}
    if info.get("model name"):
        return info["model name"]
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except OSError:
        lscpu = ""
    for line in lscpu.splitlines():
        if line.lower().startswith("model name:"):
            return line.split(":", 1)[1].strip()
    return " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
                    if k in info) or "unknown"


def native_phase(seed: int) -> None:
    """The native host library (`binius_tpu_torch/native`): built on the
    card's host, the compiler and the library printed, then every C entry
    held bit-equal to its plain Python version at the sizes a card-size
    proof gives it, with both times on the host clock (C: median of 3 after
    one call; plain: one run)."""
    from binius_tpu_torch import native
    from binius_tpu_torch.convert import ints_to_pairs, pairs_to_ints
    from binius_tpu_torch.fields import scalar, tower
    from binius_tpu_torch.hash import groestl
    from binius_tpu_torch.math import univariate
    from binius_tpu_torch.protocols import shift_ind
    from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc

    cc = native.compiler()
    version = subprocess.run([cc, "--version"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    so = native.build()
    native.get_lib()
    log(f"native: {cc} ({(version.splitlines() or ['?'])[0]}) -> {os.path.relpath(so)} in "
        f"{time.perf_counter() - t0:.2f} s; host CPU {cpu_model()}, {os.cpu_count()} cores")
    rng = np.random.default_rng(seed)

    def timed(fn) -> tuple:
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def held(name: str, c_fn, plain_fn) -> None:
        """C against plain: equal results, and both times."""
        got = c_fn()
        c_ms = statistics.median(timed(c_fn)[1] for _ in range(3))
        want, p_ms = timed(plain_fn)
        if not (np.array_equal(got, want) if isinstance(got, np.ndarray) else got == want):
            raise AssertionError(f"native {name}: C and plain version differ")
        log(f"native {name}: bit-equal to plain; C {c_ms:.3f} ms, plain {p_ms:.1f} ms "
            f"({p_ms / max(c_ms, 1e-6):.0f}x)")

    # Grøstl: the transcript's absorb, its streaming class, the one-shot
    # digest, P, Q and the compression on column states
    blocks = rng.integers(0, 256, 64 * NATIVE_BLOCKS, dtype=np.uint8).tobytes()
    iv = groestl._bytes_to_cols(groestl.IV_256.tobytes())

    def seq_plain():
        h = iv
        for i in range(NATIVE_BLOCKS):
            h = groestl._py_compress_cols(h, groestl._bytes_to_cols(blocks[64 * i:64 * i + 64]))
        return h

    held(f"compress_seq ({NATIVE_BLOCKS} blocks)",
         lambda: groestl.compress_seq_native(iv, blocks), seq_plain)
    data = blocks[:4133]

    def streamed():
        h = groestl.Groestl256()
        for i in range(0, len(data), 77):
            h.update(data[i:i + 77])
        fork = h.copy().update(b"fork")
        return h.finalize(), fork.finalize()

    held("Groestl256 update / copy / finalize (4133 bytes in 77-byte writes, a fork)",
         streamed, lambda: (groestl._py_groestl256(data), groestl._py_groestl256(data + b"fork")))
    held("groestl256 digest (4133 bytes)", lambda: groestl.groestl256(data),
         lambda: groestl._py_groestl256(data))
    states = [[int(v) for v in rng.integers(0, 1 << 64, 8, dtype=np.uint64)] for _ in range(256)]
    for is_q in (False, True):
        held(f"permute {'Q' if is_q else 'P'} (256 states)",
             lambda: [groestl._permute_cols(c, is_q) for c in states],
             lambda: [groestl._py_permute_cols(c, is_q) for c in states])
    held("compress (256 states)",
         lambda: [groestl._compress_cols(c, m) for c, m in zip(states, states[::-1])],
         lambda: [groestl._py_compress_cols(c, m) for c, m in zip(states, states[::-1])])
    # host Merkle hashing: 2-to-1 pairs and leaf rows, against the torch
    # permutation on the CPU (K5's and K6's plain version)
    pairs = rng.integers(0, 256, (NATIVE_PAIRS, 64), dtype=np.uint8)
    held(f"compress_pairs ({NATIVE_PAIRS} pairs)", lambda: groestl.compress_pairs(pairs),
         lambda: groestl.compress_pairs_t(torch.from_numpy(pairs)).numpy())
    for n, width in NATIVE_ROWS:
        blobs = rng.integers(0, 256, (n, width), dtype=np.uint8)
        held(f"digest_batch ({n} rows of {width} bytes)",
             lambda: groestl.digest_rows_native(blobs),
             lambda: groestl.leaf_hash_t(torch.from_numpy(blobs)).numpy())
    # the ring switch's B128 batch products
    a, b = (ints_to_pairs([int(x) | int(y) << 64 for x, y in
                           rng.integers(0, 1 << 64, (NATIVE_PRODUCTS, 2), dtype=np.uint64)])
            for _ in range(2))
    held(f"tower_mul_batch (B128, {NATIVE_PRODUCTS})", lambda: scalar.mul_pairs(7, a, b),
         lambda: scalar.mul_pairs_py(7, a, b))
    # scalar ops at every level, every call through C (the dispatch bounds
    # set to 0), per op in us; 0, 1 and an exponent of 2^64 and more among them
    bounds = {k: getattr(scalar, k) for k in ("PY_MUL_BELOW", "PY_INVERT_BELOW")}
    n_ops = NATIVE_SCALAR_OPS
    out = (ctypes.c_uint64 * 2)()

    def c_square(level: int, a: int) -> int:
        """The C square, which `scalar.square` leaves to Python."""
        native.get_lib().tower_square(scalar._level_of(a), a & ((1 << 64) - 1), a >> 64, out)
        return out[0] | out[1] << 64

    scalar.mul_py(7, 3 << 100, 5 << 90)       # the plain tables, built once
    scalar.square_py(7, 3 << 100)
    try:
        for k in bounds:
            setattr(scalar, k, 0)
        for level in range(8):
            mask = (1 << (1 << level)) - 1
            xs = [0, 1] + [(int(x) | int(y) << 64) & mask for x, y in
                           rng.integers(0, 1 << 64, (n_ops - 2, 2), dtype=np.uint64)]
            ys = xs[::-1]
            es = [int(e) for e in rng.integers(0, 1 << 63, n_ops // 10)] + [1 << 64, 3 << 70]
            units = [x or 1 for x in xs]
            ops = (("mul", lambda f: [f(level, x, y) for x, y in zip(xs, ys)],
                    scalar.mul, scalar.mul_py, n_ops),
                   ("square", lambda f: [f(level, x) for x in xs], c_square,
                    scalar.square_py, n_ops),
                   ("invert", lambda f: [f(level, x) for x in units], scalar.invert,
                    scalar.invert_py, n_ops),
                   ("pow", lambda f: [f(level, x, e) for x, e in zip(units, es)], scalar.pow,
                    scalar.pow_py, len(es)))
            line = []
            for name, run, c_fn, p_fn, count in ops:
                got = run(c_fn)
                c_ms = statistics.median(timed(lambda: run(c_fn))[1] for _ in range(3))
                want, p_ms = timed(lambda: run(p_fn))
                if got != want:
                    raise AssertionError(f"native {name} at level {level}: C != plain")
                line.append(f"{name} {c_ms * 1e3 / count:.2f} / {p_ms * 1e3 / count:.2f}")
            try:
                scalar.invert(level, 0)
            except ZeroDivisionError:
                pass
            else:
                raise AssertionError(f"native invert(0) at level {level} did not raise")
            log(f"native scalar level {level}: bit-equal to plain; us per op, C / plain: "
                + ", ".join(line))
    finally:
        for k, v in bounds.items():
            setattr(scalar, k, v)
    log("native scalar dispatch: Python below " + ", ".join(
        f"{k.removeprefix('PY_').removesuffix('_BELOW').lower()} 2^{v.bit_length() - 1}"
        for k, v in bounds.items()) + ", square always, pow from 2^64 on")
    # the univariate-skip zerocheck's domains: barycentric weights (the C
    # entry uncached) and Lagrange evaluations at z off and on a domain point,
    # over the d * 2^k points and over the 2^k cube (the torch scans warmed
    # up first)
    univariate.lagrange_evals_device(uzc._domain_points(4), 3, "cpu")
    for d, k in NATIVE_DOMAINS:
        points = uzc._domain_points(d << k)
        held(f"barycentric weights ({d << k} points)",
             lambda: tuple(pairs_to_ints(univariate._domain_pairs.__wrapped__(points)[1])),
             lambda: univariate._barycentric_weights_py(points))
        z = int(rng.integers(1 << 62)) << 66 | 5
        for what, pts, zz in (("", points, z), (", z on a point", points, points[7]),
                              (", the cube", points[:1 << k], z)):
            held(f"lagrange evals ({len(pts)} points{what})",
                 lambda: univariate.lagrange_evals_np(pts, zz),
                 lambda: tower.to_ints(7, univariate.lagrange_evals_device(pts, zz, "cpu")))
    # the evalcheck verifier's shift-indicator waves: the carry DP over C
    # batches against the scalar DP of each claim in Python ints (every
    # scalar bound above any element)
    def in_python(fn):
        def run():
            saved = {k: getattr(scalar, k) for k in bounds}
            try:
                for k in bounds:
                    setattr(scalar, k, 1 << 129)
                return fn()
            finally:
                for k, v in saved.items():
                    setattr(scalar, k, v)
        return run

    for n, b in NATIVE_SHIFT_WAVES:
        variants = [(shift_ind.LOGICAL_LEFT, shift_ind.LOGICAL_RIGHT,
                     shift_ind.CIRCULAR_LEFT)[i % 3] for i in range(n)]
        offs = [int(o) for o in rng.integers(1, 1 << b, n)]
        xs, ys = ([[int(x) | int(y) << 64 for x, y in
                    rng.integers(0, 1 << 64, (b, 2), dtype=np.uint64)] for _ in range(n)]
                  for _ in range(2))
        held(f"shift-indicator wave ({n} claims, {b} bits)",
             lambda: shift_ind.evaluate_scalar_batch(variants, [b] * n, offs, xs, ys),
             in_python(lambda: [shift_ind.evaluate_scalar(v, b, o, x, y)
                                for v, o, x, y in zip(variants, offs, xs, ys)]))


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
    from binius_tpu_torch.fields import bitslice, bitslice_cuda, tower
    from binius_tpu_torch.hash import groestl, groestl_cuda
    from binius_tpu_torch.merkle.tree import DeviceMerkleTree
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
    ptxas = (cuda_lib.BUILD / "ptxas.log").read_text()
    for line in ptxas.splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
            log("  ptxas:", line.strip())
    spills = ptxas_spills(ptxas)
    per_src = {}
    for (src, _), v in spills.items():
        per_src[src] = per_src.get(src, 0) + v
    log(f"ptxas spill bytes (stores + loads) per source: {per_src}")
    # no K1 or K2 function and no kernel of K3-K6 (both directions of the
    # NTT's, at each of the six twiddle levels) may spill
    for what, n_fn in (("tower_mul.cu", 1), ("transpose32.cu", 1), ("ntt_local_kernel", 12),
                       ("ntt_cross_kernel", 12), ("leaf_kernel", 1), ("leaf_lanes_kernel", 1),
                       ("pairs_kernel", 1), ("tail_kernel", 1)):
        hits = {k: v for k, v in spills.items() if k[0] == what or what in k[1]}
        if len(hits) < n_fn or any(hits.values()):
            raise AssertionError(f"{what}: ptxas reports spills or no report ({hits})")
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    for fn, c in sass_counts(cuobjdump, so, r"mul\w*_kernel|ntt_local_kernel|leaf\w*_kernel|"
                                            r"pairs_kernel|tail_kernel").items():
        log(f"  sass: {fn}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    rates = card_rates()
    log("bounds: HBM %.2f TB/s; logic %d SMs x %.0f MHz (max SM clock) x %d results/clock/SM x "
        "%d gates per LOP3 = %.2f T two-input gates/s" % (
            HBM_BYTES_PER_S / 1e12, rates["sms"], rates["max_sm_mhz"],
            rates["logic_per_clock_per_sm"], rates["gates_per_lop3"], rates["gates_per_s"] / 1e12))
    phases.done("card and build")

    # 2b. the native host library on the card's host
    native_phase(args.seed)
    phases.done("native host library")

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
        f"W {plan.n_words} words, {len(cross)} cross stages + {len(local)} fused "
        f"(tile {plan.tile})")
    torch.cuda.synchronize()

    rows = []

    def report(name, source, replaces, k_out, p_out, k_fn, p_fn, n_bytes, n_ops,
               setup=None, label="", row=True, inner=1):
        """`p_fn` is the plain version to time, or its time (ms) where an
        earlier report timed it on the same inputs. The plain version is
        timed for the kernels line's row only; every case is checked."""
        err = max_abs_err(k_out, p_out)
        if err:
            raise AssertionError(f"{name}: kernel and plain version differ (max |err| {err})")
        ms = cuda_ms(k_fn, args.reps, setup, inner)
        plain = p_fn if isinstance(p_fn, float) or p_fn is None else (
            cuda_ms(p_fn, args.reps, setup) if row else None)
        b, by = bound_ms(n_bytes, n_ops, rates["gates_per_s"])
        if row:
            rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                             launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b, bound_by=by, library_ms=None))
        plain_txt = f"plain {plain:.3f} ms, " if isinstance(plain, float) else ""
        log(f"{name}{' ' + label if label else ''}: bit-equal to plain; {ms:.4f} ms "
            f"({plain_txt}bound {b:.4f} ms by {by}{f', {ms / b:.2f}x bound' if b else ''})")

    # 3. kernel phases at the main path's shapes
    # K1: the packed product at 2^22 elements (the transparents' eq scaling
    # and the sumcheck's first rounds), as the opening calls it: both
    # operands full, or a scalar on either side (extrapolate_line, the FRI
    # fold, eq expansion), and one ragged batch. B128 runs two kernels by
    # batch size (`bitslice_cuda.B128_PERSISTENT_FROM`): 2^22 elements take
    # the persistent one, and the same cases at a sixteenth of that size
    # take the one-tile-per-block one, as the opening's later rounds do.
    # The row is level 7 (B128) full x full at 2^22, where most of the
    # opening's product time is. Bound: the bytes of the full operands and
    # the result, and the network's gates plus 15 per word of each
    # transposed operand and of the result.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n1 = 1 << 22
    n_tile = bitslice_cuda.B128_PERSISTENT_FROM >> 4
    for level, n_full in ((5, n1), (6, n1), (7, n1), (7, n_tile)):
        limbs = tower.n_limbs(level)
        a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, tower.elem_shape(level, (n_full,)),
                              dtype=torch.int32, device=dev, generator=gen) for _ in range(2))
        cases = (("full x full", a, b), ("scalar x full", a[5], b), ("full x scalar", a, b[9]),
                 ("ragged full x full", a[:n_full - 7], b[7:]))
        for label, x, y in cases:
            n = max(tower.batch_shape(level, x) + tower.batch_shape(level, y))
            full = sum(len(tower.batch_shape(level, t)) == 1 for t in (x, y))
            cuda_lib.reset_launches()
            got = bitslice_cuda.mul(level, x, y)
            torch.cuda.synchronize()
            if dict(cuda_lib.launches) != {**dict.fromkeys(cuda_lib.KERNELS, 0), "k1_tower_mul": 1}:
                raise AssertionError(f"K1 level {level} {label}: launches {cuda_lib.launches}")
            report("k1_tower_mul", "binius_tpu_torch/csrc/tower_mul.cu",
                   "binius_tpu/fields/bitslice_pallas.py:37",
                   got, bitslice.mul(level, x, y),
                   lambda _: bitslice_cuda.mul(level, x, y), lambda _: bitslice.mul(level, x, y),
                   n_bytes=((full + 1) * n + 2 - full) * limbs * 4,
                   n_ops=-(-n // 32) * mul_gates(level)
                   + (full + 1) * n * limbs * TRANSPOSE_GATES_PER_WORD,
                   label=f"level {level} 2^{n_full.bit_length() - 1} {label}",
                   row=level == 7 and n_full == n1 and label == "full x full", inner=20)
        del a, b, got
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
           n_bytes=2 * 2 * rep.numel() * 4, n_ops=2 * rep.numel() * TRANSPOSE_GATES_PER_WORD)

    # K4: the cross stages, fused in runs of up to bn._CROSS_STAGES, one
    # launch per run. Bound: the planes read and written once, and the
    # run's twiddle rows read once.
    def cross_k(p_, tw_, x):
        for f, n in bn._cross_runs(p_):
            x = bn.ntt_cross(p_, f, n, x, tw_[f:f + n])
        return x

    def cross_p(p_, tw_, pl):
        for f, n in bn._cross_runs(p_):
            for si in range(f, f + n):
                pl = bn._stage_plain(p_, p_.stages[si], pl, tw_[si])
        return pl

    def check_cross(p_, tw_, pl, label):
        runs = bn._cross_runs(p_)
        cuda_lib.reset_launches()
        got = cross_k(p_, tw_, pl.clone())
        torch.cuda.synchronize()
        if dict(cuda_lib.launches) != {**dict.fromkeys(cuda_lib.KERNELS, 0),
                                       "k4_ntt_cross": len(runs)}:
            raise AssertionError(f"K4 {label}: launches {cuda_lib.launches}, runs {runs}")
        n_cross = sum(n for _, n in runs)
        return got, runs, n_cross

    after_cross, runs, n_cross = check_cross(plan, tw, planes_k, "commit")
    report("k4_ntt_cross", "binius_tpu_torch/csrc/ntt.cu",
           "binius_tpu/ntt/bitsliced_ntt.py:295",
           after_cross, cross_p(plan, tw, planes_k),
           lambda x: cross_k(plan, tw, x), lambda x: cross_p(plan, tw, x),
           n_bytes=2 * planes_k.numel() * 4 + n_cross * plan.n_words * 4,
           n_ops=ntt_ops(plan, cross), setup=planes_k.clone,
           label=f"forward, commit plan, {n_cross} stages in runs {runs}")
    # the same planes forward at the commit's shape without the skipped
    # round (8 cross stages: two runs), and inverse at 2^20 elements (five)
    dom = params.ntt_domain()
    inv_shape = (params.log_batch_size, params.log_code_len - 3, 0)
    for label, (shape_k, skip_k, inv_k) in (("forward, two runs", (shape, 0, False)),
                                            ("inverse", (inv_shape, 0, True))):
        p_k, tw_np_k = bn._make_plan(dom, fri.LEVEL, shape_k, 0, 0, skip_k, inv_k)
        tw_k = bn._dev_tw(p_k, tw_np_k, dev)
        pl = planes_k if p_k.n_words == plan.n_words else planes_k[:, :p_k.n_words].contiguous()
        got, runs_k, n_k = check_cross(p_k, tw_k, pl, label)
        cross_stages = [p_k.stages[si] for f, n in runs_k for si in range(f, f + n)]
        report("k4_ntt_cross", "binius_tpu_torch/csrc/ntt.cu",
               "binius_tpu/ntt/bitsliced_ntt.py:295",
               got, cross_p(p_k, tw_k, pl),
               lambda x, p_k=p_k, tw_k=tw_k: cross_k(p_k, tw_k, x),
               lambda x, p_k=p_k, tw_k=tw_k: cross_p(p_k, tw_k, x),
               n_bytes=2 * len(runs_k) * pl.numel() * 4 + n_k * p_k.n_words * 4,
               n_ops=ntt_ops(p_k, cross_stages), setup=pl.clone, row=False,
               label=f"{label}, shape {shape_k}, W {p_k.n_words}, {n_k} stages in runs {runs_k}")
        del got, pl

    # K3: the fused trailing stages (leading, inverse), one launch. The
    # commit's plan (the row), a plan whose tile is below 1024 words (the
    # 2^13-element transform at the commit's batch: every stage local), and
    # inverse at the 2^15-word plan of K4's inverse check. Bound: the planes
    # read and written once, the stages' twiddle rows read once.
    def local_first(p_):
        return 0 if p_.inverse else len(p_.stages) - p_.n_local

    def local_k(p_, tw_, x):
        f = local_first(p_)
        return bn.ntt_local(p_, f, x, tw_[f:f + p_.n_local])

    def local_p(p_, tw_, x):
        f = local_first(p_)
        for si in range(f, f + p_.n_local):
            x = bn._stage_plain(p_, p_.stages[si], x, tw_[si])
        return x

    def check_local(p_, tw_, pl, label, row=False):
        cuda_lib.reset_launches()
        got = local_k(p_, tw_, pl.clone())
        torch.cuda.synchronize()
        if dict(cuda_lib.launches) != {**dict.fromkeys(cuda_lib.KERNELS, 0), "k3_ntt_local": 1}:
            raise AssertionError(f"K3 {label}: launches {cuda_lib.launches}")
        f = local_first(p_)
        report("k3_ntt_local", "binius_tpu_torch/csrc/ntt.cu",
               "binius_tpu/ntt/bitsliced_ntt.py:258", got, local_p(p_, tw_, pl),
               lambda x: local_k(p_, tw_, x), lambda x: local_p(p_, tw_, x),
               n_bytes=2 * pl.numel() * 4 + p_.n_local * p_.n_words * 4,
               n_ops=ntt_ops(p_, p_.stages[f:f + p_.n_local]), setup=pl.clone, row=row,
               label=f"{label}, W {p_.n_words}, tile {p_.tile}, {p_.n_local} stages")
        return got

    planes_out = check_local(plan, tw, after_cross, "forward, commit plan", row=True)
    for label, (shape_k, skip_k, inv_k) in (
            ("forward, small tile", ((params.log_batch_size, 9, 0), 1, False)),
            ("inverse", (inv_shape, 0, True))):
        p_k, tw_np_k = bn._make_plan(dom, fri.LEVEL, shape_k, 0, 0, skip_k, inv_k)
        check_local(p_k, bn._dev_tw(p_k, tw_np_k, dev),
                    planes_k[:, :p_k.n_words].contiguous(), label)

    # K5: leaf digests, one launch per tree. Both kernels (16 lanes per
    # leaf, one thread per leaf; the wrapper picks by leaf count,
    # groestl_cuda.LANES_BELOW) at the opening's four shapes: the commit's
    # 2^19 leaves of 256 B, the FRI oracles' 2^15 and 2^11 leaves of 256 B
    # and the last oracle's 2 leaves of 16 KiB; then a leaf count that is
    # no multiple of a lane group or block, and blobs of 16 and 56 bytes
    # (the padding of the latter takes a block of its own). Bound per
    # shape: the blobs read and the digests written once, and the rounds'
    # operations. Shapes below 2^12 leaves are timed over 20 back-to-back
    # launches, whose rate the host wrapper sets (device time per launch:
    # scripts/profile_opening.py).
    cw = bitslice_cuda.from_bitsliced(7, planes_out)
    log_coset = params.log_coset
    n_leaves = cw.shape[0] >> log_coset
    blob_len = cw.numel() * 4 // n_leaves

    def k5_shape(x, lc, label, row=False):
        n_l = x.shape[0] >> lc
        b_len = x.numel() * 4 // n_l
        n_blk = (b_len + 8) // 64 + 1
        want = groestl_cuda.leaf_hash_plain(x, lc, b_len)
        # both variants compute the one plain function on these inputs
        plain_t = cuda_ms(lambda _: groestl_cuda.leaf_hash_plain(x, lc, b_len),
                          args.reps) if row else None
        pick = groestl_cuda.LANES_BELOW
        for variant, below in (("16 lanes per leaf", 1 << 62), ("one thread per leaf", 0)):
            groestl_cuda.LANES_BELOW = below
            cuda_lib.reset_launches()
            got = groestl_cuda.leaf_hash_kernel(x, lc, b_len)
            torch.cuda.synchronize()
            if dict(cuda_lib.launches) != {**dict.fromkeys(cuda_lib.KERNELS, 0),
                                           "k5_groestl_leaf": 1}:
                raise AssertionError(f"K5 {label}: launches {cuda_lib.launches}")
            chosen = (n_l < pick) == (below > 0)
            report("k5_groestl_leaf", "binius_tpu_torch/csrc/groestl.cu",
                   "binius_tpu/hash/groestl_pallas.py:179", got, want,
                   lambda _: groestl_cuda.leaf_hash_kernel(x, lc, b_len), plain_t,
                   n_bytes=x.numel() * 4 + n_l * 32,
                   n_ops=n_l * (2 * n_blk + 1) * 10 * GROESTL_ROUND_OPS,
                   label=f"{label}: {n_l} leaves of {b_len} B, {variant}"
                         f"{' (the wrapper picks it)' if chosen else ''}",
                   row=row and chosen, inner=1 if n_l > 1 << 12 else 20)
        groestl_cuda.LANES_BELOW = pick
        return want

    def rand_words(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    leaves_k = k5_shape(cw, log_coset, "commit", row=True)
    for n_l, lc, label in ((1 << 15, 4, "FRI oracle 1"), (1 << 11, 4, "FRI oracle 2"),
                           (2, 10, "FRI oracle 3")):
        k5_shape(rand_words((n_l << lc, 4)), lc, label)
    k5_shape(rand_words((((1 << 11) + 3) << 4, 4)), 4, "ragged count")
    k5_shape(rand_words((1001, 4)), 0, "16-byte blobs")
    k5_shape(rand_words((999, 14)), 0, "56-byte blobs")

    # K6: every level of a tree to the root, one launch per wide level and
    # one for the tail (groestl_cuda.tree_launches), at the opening's four
    # tree shapes: the commit's leaf digests, then random digests for the
    # FRI oracles' 2^15, 2^11 and 2 leaves (one pair: the tail alone). Every
    # layer against `pairs_plain` level by level, with the tail starting
    # from every level size (TAIL_PAIRS a power of two; 0 is every level
    # its own launch), and the launches per tree asserted. Bound per tree: every
    # pair's 64 bytes read and 32 written once, and its 10 rounds. Trees
    # below 2^12 leaves are timed over 20 back-to-back builds.
    def k6_tree(leaf_dig, label, row=False):
        n_l = leaf_dig.shape[0]
        want = [leaf_dig]
        while want[-1].shape[0] > 1:
            want.append(groestl_cuda.pairs_plain(want[-1]))
        buf = torch.empty((2 * n_l - 1, 8), dtype=torch.int32, device=dev)
        buf[:n_l] = leaf_dig
        pick = groestl_cuda.TAIL_PAIRS
        picked = groestl_cuda.tree_launches(n_l)
        # every tail position computes the one plain tree of these leaves
        plain_t = cuda_ms(lambda _: groestl_cuda.tail_plain(leaf_dig),
                          args.reps) if row else None
        splits = {}  # distinct launch lists -> the least TAIL_PAIRS giving each
        for tail in (0,) + tuple(1 << k for k in range(19)):
            groestl_cuda.TAIL_PAIRS = tail
            splits.setdefault(tuple(groestl_cuda.tree_launches(n_l)), tail)
        for launches, tail in splits.items():
            groestl_cuda.TAIL_PAIRS = tail
            buf[n_l:] = 0
            cuda_lib.reset_launches()
            groestl_cuda.pair_levels(buf)
            torch.cuda.synchronize()
            n_launch = len(launches)
            if dict(cuda_lib.launches) != {**dict.fromkeys(cuda_lib.KERNELS, 0),
                                           "k6_groestl_pairs": n_launch}:
                raise AssertionError(f"K6 {label}: launches {cuda_lib.launches}, "
                                     f"want {n_launch}")
            report("k6_groestl_pairs", "binius_tpu_torch/csrc/groestl.cu",
                   "binius_tpu/hash/groestl_pallas.py:200",
                   groestl_cuda.split_layers(buf), want,
                   lambda _: groestl_cuda.pair_levels(buf), plain_t,
                   n_bytes=(n_l - 1) * 96, n_ops=(n_l - 1) * 10 * GROESTL_ROUND_OPS,
                   label=f"{label}: {n_l} leaves, tail from {tail} pairs, {n_launch} launches"
                         f"{' (the wrapper picks it)' if list(launches) == picked else ''}",
                   row=row and list(launches) == picked, inner=1 if n_l > 1 << 12 else 20)
        groestl_cuda.TAIL_PAIRS = pick

    k6_tree(leaves_k, "commit", row=True)
    for n_l, label in ((1 << 15, "FRI oracle 1"), (1 << 11, "FRI oracle 2"),
                       (2, "FRI oracle 3")):
        k6_tree(rand_words((n_l, 8)), label)

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
    k6_commit = len(groestl_cuda.tree_launches(n_leaves))
    if (counts["k4_ntt_cross"] != len(runs) or counts["k5_groestl_leaf"] != 1
            or counts["k6_groestl_pairs"] != k6_commit):
        raise AssertionError(f"commit: K4 {counts['k4_ntt_cross']} launches for {len(runs)} "
                             f"runs, K5 {counts['k5_groestl_leaf']} for one tree, K6 "
                             f"{counts['k6_groestl_pairs']} for {k6_commit}")

    # (a) the same commit composed from the plain versions, on the card
    def plain_codeword(params_, message):
        """The Reed-Solomon codeword of a commit's message through the plain
        versions of K2, K4 and K3 (every stage of the commit's NTT plan)."""
        plan_, tw_np_ = bn._make_plan(params_.ntt_domain(), fri.LEVEL,
                                      (params_.log_batch_size, params_.log_code_len, 0),
                                      0, 0, params_.log_inv_rate, False)
        tw_ = bn._dev_tw(plan_, tw_np_, dev)
        p_ = bitslice.to_bitsliced(7, torch.cat([message] * (1 << params_.log_inv_rate)))
        for si, st in enumerate(plan_.stages):
            p_ = bn._stage_plain(plan_, st, p_, tw_[si])
        return bitslice.from_bitsliced(7, p_)

    def plain_layers(cw_, log_coset_, blob_len_):
        """Every layer of a codeword's Merkle tree, leaves first, through the
        plain versions of K5 and K6: the layout of `tree_levels`' buffer."""
        dig_ = groestl_cuda.leaf_hash_plain(cw_, log_coset_, blob_len_)
        return torch.cat([dig_, groestl_cuda.tail_plain(dig_)])

    cw_plain = plain_codeword(params, msg_main)
    if not torch.equal(cw_plain, cw_main):
        raise AssertionError("slice: kernel codeword != plain codeword")
    layers_plain = plain_layers(cw_plain, log_coset, blob_len)
    if not torch.equal(torch.cat(tree.layers), layers_plain):
        raise AssertionError("slice: kernel tree layers != plain tree layers")
    root_plain = layers_plain[-1].cpu().numpy().tobytes()
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
    splits = {k: [] for k in ("total", "merge", "encode", "leaf_hash", "pair_levels", "top_copy")}
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        m = piop.merge_multilins(packed, meta.total_vars)
        ev[1].record()
        c = fri.rs_encode(params, m)
        ev[2].record()
        buf = torch.empty((2 * n_leaves - 1, 8), dtype=torch.int32, device=dev)
        groestl_cuda.leaf_hash_kernel(c, log_coset, blob_len, out=buf[:n_leaves])
        ev[3].record()
        groestl_cuda.pair_levels(buf)
        ev[4].record()
        torch.cuda.synchronize()
        t_dev = time.perf_counter()
        DeviceMerkleTree(buf)  # the top's one copy to the host
        t_end = time.perf_counter()
        for k, (a, b) in zip(("merge", "encode", "leaf_hash", "pair_levels"),
                             zip(ev, ev[1:])):
            splits[k].append(a.elapsed_time(b))
        splits["top_copy"].append((t_end - t_dev) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piop.commit(params, meta, packed)
        torch.cuda.synchronize()
        splits["total"].append((time.perf_counter() - t0) * 1e3)
    split = {k: statistics.median(v) for k, v in splits.items()}
    log("commit 2^%d rows, warm, median of 3 (ms): %s" % (
        args.log_rows, ", ".join(f"{k} {v:.3f}" for k, v in split.items())))
    phases.done("commit")

    # 5. the opening: commit, ring switch, PIOP; counted, with
    # the host's Merkle hashing (the torch compression and the native C
    # batches of pairs and leaf rows) and the trees' leaf counts recorded
    host_compressions = [0]
    compress_pairs_t, tree_levels = groestl.compress_pairs_t, groestl_cuda.tree_levels
    host_lib = groestl._native_lib()
    host_batches = {name: getattr(host_lib, name)
                    for name in ("groestl_compress_pairs", "groestl_digest_batch")}
    trees = []

    def counted(fn):
        def call(*a):
            host_compressions[0] += 1
            return fn(*a)
        return call

    def count_host_hashing(on: bool) -> None:
        groestl.compress_pairs_t = counted(compress_pairs_t) if on else compress_pairs_t
        for name, fn in host_batches.items():
            setattr(host_lib, name, counted(fn) if on else fn)

    def recorded_tree(cw_, log_coset_, blob_len_):
        trees.append(cw_.shape[0] >> log_coset_)
        return tree_levels(cw_, log_coset_, blob_len_)

    count_host_hashing(True)
    groestl_cuda.tree_levels = recorded_tree
    open_commitment(inst)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    host_compressions[0] = 0
    trees.clear()
    proof = open_commitment(inst)
    torch.cuda.synchronize()
    counts = dict(cuda_lib.launches)
    count_host_hashing(False)
    groestl_cuda.tree_levels = tree_levels
    log(f"launches on the opening (its commit included): {counts}")
    k6_opening = sum(len(groestl_cuda.tree_launches(n)) for n in trees)
    log(f"trees on the opening (leaves): {trees}; K6 launches {k6_opening}; host Grøstl "
        f"compressions {host_compressions[0]}")
    if host_compressions[0]:
        raise AssertionError(f"the prover compressed {host_compressions[0]} times on the host")
    if counts["k6_groestl_pairs"] != k6_opening or counts["k5_groestl_leaf"] != len(trees):
        raise AssertionError(f"K6 launched {counts['k6_groestl_pairs']} times for {k6_opening},"
                             f" K5 {counts['k5_groestl_leaf']} for {len(trees)} trees")
    log(f"opening: {len(proof)} proof bytes, sha256 {hashlib.sha256(proof).hexdigest()}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if counts["k2_transpose32"] != 2:  # the commit's NTT in and out; tower.mul never
        raise AssertionError(f"K2 launched {counts['k2_transpose32']} times, not 2")
    if counts["k4_ntt_cross"] != len(runs):  # the commit's NTT only
        raise AssertionError(f"K4 launched {counts['k4_ntt_cross']} times, not {len(runs)}")
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

    # 5b. a Vision Mark-32 tree over the opening's codeword: the reference's
    # other Merkle scheme (`merkle_tree/scheme.rs`), whose MDS layer is one
    # B32 product per permutation and layer through K1. The opening is run
    # once more to record its commit's codeword and its FRI query indices.
    from binius_tpu_torch.fields import aes, isomorphism
    from binius_tpu_torch.hash import vision
    from binius_tpu_torch.merkle.tree import (MerkleTree, verify_branch, verify_branch_to_layer,
                                              vision_scheme)

    scheme_v = vision_scheme()
    recorded = {}
    fri_commit_0, query_openings = fri.fri_commit, fri.FRIFolder._query_openings

    def recording_fri_commit(params_, message, device=None, mesh=None):
        cw_, tree_ = fri_commit_0(params_, message, device, mesh)
        recorded.setdefault("codeword", cw_)
        return cw_, tree_

    def recording_queries(self, indices):
        recorded["queries"] = list(indices)
        return query_openings(self, indices)

    fri.fri_commit, fri.FRIFolder._query_openings = recording_fri_commit, recording_queries
    try:
        if open_commitment(inst) != proof:
            raise AssertionError("opening: proof bytes differ between runs")
    finally:
        fri.fri_commit, fri.FRIFolder._query_openings = fri_commit_0, query_openings
    cw_v, queries = recorded["codeword"], recorded["queries"]
    blobs = fri.leaf_blobs(cw_v.cpu().numpy().view(np.uint32), params.log_coset)
    if blobs.shape != (n_leaves, blob_len) or len(queries) != params.n_test_queries:
        raise AssertionError(f"vision: leaves {blobs.shape}, {len(queries)} queries")
    n_blocks = blob_len // vision.RATE_AS_U8 + 1
    depth = n_leaves.bit_length() - 1
    k1_tree = 16 * (n_blocks + 2 * depth)   # one K1 launch per MDS layer per batch
    n_perms = n_leaves * n_blocks + (n_leaves - 1) * 2
    log(f"vision: the opening's codeword, {cw_v.shape[0]} B128 elements, log_coset "
        f"{params.log_coset}: {n_leaves} leaves of {blob_len} B ({n_blocks} permutations "
        f"each), {depth} levels; {len(queries)} FRI query indices")
    t0 = time.perf_counter()
    layers_v = vision_tree(blobs, scheme_v)
    torch.cuda.synchronize()
    t_first_v = time.perf_counter() - t0
    # (a) one build counted, then warm: median of 3 (the counted one and two more)
    splits_v = {"total": [], "leaves": [], "levels": []}
    for rep in range(3):
        if rep == 0:
            torch.cuda.reset_peak_memory_stats()
            cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves_v = scheme_v.hash_leaves(blobs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tree_v = MerkleTree.build(leaves_v, scheme_v)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if rep == 0:
            counts_v = dict(cuda_lib.launches)
            peak_v = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, v in (("total", t2 - t0), ("leaves", t1 - t0), ("levels", t2 - t1)):
            splits_v[k].append(v * 1e3)
        if any(not np.array_equal(a, b) for a, b in zip(tree_v.layers, layers_v)):
            raise AssertionError("vision: tree layers differ between builds")
    if counts_v != {**dict.fromkeys(cuda_lib.KERNELS, 0), "k1_tower_mul": k1_tree}:
        raise AssertionError(f"vision tree: launches {counts_v}, want K1 {k1_tree} alone")
    split_v = {k: statistics.median(v) for k, v in splits_v.items()}
    log(f"launches on the vision tree: {counts_v}")
    log("vision tree 2^%d leaves: first build %.1f ms; warm, median of 3 (ms): %s; peak device "
        "memory %.2f GiB; %d permutations, %.3g permutations/s warm" % (
            depth, t_first_v * 1e3, ", ".join(f"{k} {v:.3f}" for k, v in split_v.items()),
            peak_v, n_perms, n_perms / (split_v["total"] / 1e3)))
    # (b) the same tree with K1's plain version on the card, byte-equal in
    # every layer (in batches of PLAIN_VISION_STATES rows)
    k1_mul = bitslice_cuda.mul
    bitslice_cuda.mul = bitslice.mul
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        plain_v = vision_tree(blobs, scheme_v, chunk=PLAIN_VISION_STATES)
        torch.cuda.synchronize()
        t_plain_v = time.perf_counter() - t0
    finally:
        bitslice_cuda.mul = k1_mul
    if cuda_lib.launches["k1_tower_mul"]:
        raise AssertionError("vision: K1 launched on the plain path")
    for k, (a, b) in enumerate(zip(layers_v, plain_v)):
        if not np.array_equal(a, b):
            raise AssertionError(f"vision: layer {k}: K1 != plain bitslice.mul")
    log(f"vision tree through the plain bitslice.mul on the card ({t_plain_v:.1f} s): every "
        f"layer byte-equal to K1's; root {tree_v.root.hex()}")
    # (c) sampled leaves and pairs at three levels against `permute_scalar`
    # (the host sponge, `vision.digest`)
    rng_v = random.Random(args.seed)
    for i in rng_v.sample(range(n_leaves), 64):
        if vision.digest(blobs[i].tobytes()) != layers_v[0][i].tobytes():
            raise AssertionError(f"vision: leaf {i} != the host sponge")
    levels_v = (1, depth // 2, depth - 6)
    for k in levels_v:
        for j in rng_v.sample(range(len(layers_v[k])), 64):
            pair = layers_v[k - 1][2 * j].tobytes() + layers_v[k - 1][2 * j + 1].tobytes()
            if vision.digest(pair) != layers_v[k][j].tobytes():
                raise AssertionError(f"vision: level {k} node {j} != the host sponge")
    log(f"vision: 64 sampled leaves and 64 sampled pairs at levels {levels_v} = "
        f"vision.digest (permute_scalar)")
    # (d) the opening's query branches: all of them hashed up to the root
    # level by level (one batch per level), and `verify_branch` /
    # `verify_branch_to_layer` (to FRI's optimal layer) on a few, each
    # rejecting a flipped byte
    idx = np.array(queries)
    cur = layers_v[0][idx]
    for k in range(depth):
        sib = layers_v[k][(idx >> k) ^ 1]
        left = ((idx >> k) & 1)[:, None] == 0
        cur = scheme_v.compress_pairs(np.concatenate([np.where(left, cur, sib),
                                                      np.where(left, sib, cur)], axis=1))
    if any(row.tobytes() != tree_v.root for row in cur):
        raise AssertionError("vision: a query branch does not hash to the root")
    opt = params.vcs_optimal_layers_depths()[0]
    to_layer = depth - opt
    for q in queries[:2]:
        leaf = layers_v[0][q].tobytes()
        if not (verify_branch(tree_v.root, q, leaf, tree_v.branch(q), scheme_v)
                and verify_branch_to_layer(tree_v.layers[to_layer], q, leaf,
                                           tree_v.branch(q, to_layer), scheme_v)):
            raise AssertionError(f"vision: the branch of query {q} does not verify")
    q = queries[0]
    bad = bytearray(layers_v[0][q].tobytes())
    bad[7] ^= 1
    if (verify_branch(tree_v.root, q, bytes(bad), tree_v.branch(q), scheme_v)
            or verify_branch_to_layer(tree_v.layers[to_layer], q, bytes(bad),
                                      tree_v.branch(q, to_layer), scheme_v)):
        raise AssertionError("vision: a leaf with a flipped byte verified")
    log(f"vision: the {len(queries)} query branches hash to the root; verify_branch and "
        f"verify_branch_to_layer (layer {to_layer}, {2 ** opt} digests) accept queries "
        f"{queries[:2]} and reject a flipped byte")
    # (e) the JAX package's Vision root at 2^16 rows, kernel and plain paths
    g_cw = piop.commit(g_inst["params"], g_inst["meta"], g_inst["packed"])[0]
    g_blobs = fri.leaf_blobs(g_cw.cpu().numpy().view(np.uint32), g_inst["params"].log_coset)
    g_root_k = vision_tree(g_blobs, scheme_v)[-1][0].tobytes().hex()
    bitslice_cuda.mul = bitslice.mul
    try:
        g_root_p = vision_tree(g_blobs, scheme_v, chunk=PLAIN_VISION_STATES)[-1][0].tobytes().hex()
    finally:
        bitslice_cuda.mul = k1_mul
    if not g_root_k == g_root_p == GOLDEN_VISION_ROOT_16:
        raise AssertionError(f"vision golden: roots {g_root_k} (K1), {g_root_p} (plain) != "
                             f"{GOLDEN_VISION_ROOT_16}")
    log(f"vision root 2^{GOLDEN_LOG_ROWS} rows ({g_blobs.shape[0]} leaves), seed {GOLDEN_SEED}: "
        f"{g_root_k} on K1 and on the plain path (= JAX golden)")
    del recorded, cw_v, blobs, layers_v, plain_v, tree_v, leaves_v, cur
    phases.done("vision tree")

    # 5c. the AES and POLYVAL bases on 2^22 random B128 elements: the AES
    # conversion both ways, the POLYVAL basis change, and the isomorphism
    # carrying K1's products to POLYVAL products, each on 256 samples
    # against the host conversions
    n_f = 1 << 22
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_f, 4), dtype=torch.int32, device=dev,
                      generator=gen)
    sample = rng_v.sample(range(n_f >> 1), 256)
    sel = torch.tensor(sample, device=dev)
    xs = tower.to_ints(7, x[sel])
    times_f = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_aes = aes.convert_device(7, x, to_canonical=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = aes.convert_device(7, x_aes, to_canonical=True)
    torch.cuda.synchronize()
    times_f["aes"] = (time.perf_counter() - t0) * 1e3
    times_f["aes one way"] = (t1 - t0) * 1e3
    if not torch.equal(back, x):
        raise AssertionError("aes: canonical -> AES -> canonical is not the identity")
    if tower.to_ints(7, x_aes[sel]) != [aes.canonical_to_aes(7, v) for v in xs]:
        raise AssertionError("aes: convert_device != canonical_to_aes")
    phi = isomorphism.canonical_to_polyval_matrix()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_pv = tower.apply_bitmatrix(7, phi, x)
    torch.cuda.synchronize()
    times_f["polyval"] = (time.perf_counter() - t0) * 1e3
    if tower.to_ints(7, x_pv[sel]) != [isomorphism.canonical_to_polyval(v) for v in xs]:
        raise AssertionError("polyval: apply_bitmatrix != canonical_to_polyval")
    a_f, b_f = x[:n_f >> 1], x[n_f >> 1:]
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ab_pv = tower.apply_bitmatrix(7, phi, tower.mul(7, a_f, b_f))
    torch.cuda.synchronize()
    times_f["product and polyval"] = (time.perf_counter() - t0) * 1e3
    if cuda_lib.launches["k1_tower_mul"] != 1:
        raise AssertionError(f"polyval: K1 launched {cuda_lib.launches['k1_tower_mul']} times")
    pa = tower.to_ints(7, x_pv[sel])
    pb = tower.to_ints(7, x_pv[sel + (n_f >> 1)])
    if tower.to_ints(7, ab_pv[sel]) != [isomorphism.polyval_mul(u, v) for u, v in zip(pa, pb)]:
        raise AssertionError("polyval: phi(a * b) != phi(a) * phi(b)")
    log(f"aes and polyval, 2^{n_f.bit_length() - 1} B128 elements, 256 samples each: AES both "
        f"ways = identity and = canonical_to_aes; POLYVAL = canonical_to_polyval; phi(a * b) "
        f"(K1, one launch, 2^{n_f.bit_length() - 2} products) = polyval_mul(phi(a), phi(b)); ms "
        f"(first run): " + ", ".join(f"{k} {v:.3f}" for k, v in times_f.items()))
    del x, x_aes, back, x_pv, ab_pv, a_f, b_f
    phases.done("aes and polyval")

    # 6. the NTT's small shapes take the packed stage loop on the card (C1)
    from binius_tpu_torch.ntt import additive_ntt
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(args.seed)

    def stage_loop_check(tl, dl, x, log_y, label):
        ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(tl, log_y + 1))
        for inverse in (False, True):
            fn = ntt.inverse if inverse else ntt.forward
            cuda_lib.reset_launches()
            got = fn(x.to(dev), dl, (0, log_y, 0), 1, 1, device=dev)
            torch.cuda.synchronize()
            if any(cuda_lib.launches[k] for k in ("k2_transpose32", "k3_ntt_local",
                                                   "k4_ntt_cross")):
                raise AssertionError(f"C1 {label}: the bitsliced path ran ({cuda_lib.launches})")
            want = fn(x, dl, (0, log_y, 0), 1, 1, device=cpu)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"C1 {label} {'inverse' if inverse else 'forward'}: "
                                     f"card != CPU stage loop")
        log(f"C1: {label}, forward and inverse on coset 1: stage loop on the card = on the CPU")

    for n in (16, 32, 64, 128):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), dtype=torch.int32, generator=g)
        stage_loop_check(5, 7, x, n.bit_length() - 1, f"{n} B128 elements, B32 twiddles")
    x = torch.randint(0, 256, (5, 64 << 7), dtype=torch.int32, generator=g)
    stage_loop_check(3, 3, x, 7, "B8 data on B8 twiddles, k = 7, 5 rows x 64 suffixes")
    # the smallest batch the bitsliced gate admits: K3's whole tile
    n_min = bn.MIN_ELEMS
    if bn.supported(5, 7, n_min >> 1) or not bn.supported(5, 7, n_min):
        raise AssertionError("the bitsliced gate is not at 2^15 elements")
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(5, 13))
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_min, 4), dtype=torch.int32, generator=g).to(dev)
    cuda_lib.reset_launches()
    got = ntt.forward(x, 7, (2, 13, 0), skip_rounds=1, device=dev)
    torch.cuda.synchronize()
    if not all(cuda_lib.launches[k] for k in ("k2_transpose32", "k3_ntt_local")):
        raise AssertionError(f"C1: 2^15 elements did not take the bitsliced path "
                             f"({cuda_lib.launches})")
    if not torch.equal(got, ntt._stage_loop(x, 7, (2, 13, 0), 0, 0, 1, False)):
        raise AssertionError("C1: bitsliced transform at 2^15 elements != stage loop")
    log(f"C1: 2^15 B128 elements take the bitsliced path (launches {dict(cuda_lib.launches)}) "
        f"= the stage loop on the card")
    phases.done("C1 small transforms")

    # 6b. K3 and K4 at every twiddle level the Pallas kernels take (fault
    # C5: twiddles below B32, data below B32), each case bit-equal to the
    # plain version on the card with its launches asserted; the B8-domain
    # transform of 2^20 B32 elements that raised before against the stage
    # loop, and K3 and K4 timed at its plan
    n_level_cases = level_checks(dev, gen)
    ntt_b8 = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(3, 8))
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20,), dtype=torch.int32, device=dev,
                      generator=gen)
    cuda_lib.reset_launches()
    got = ntt_b8.forward(x, 5, (12, 8, 0), device=dev)
    torch.cuda.synchronize()
    counts_b8 = dict(cuda_lib.launches)
    if not torch.equal(got, ntt_b8._stage_loop(x, 5, (12, 8, 0), 0, 0, 0, False)):
        raise AssertionError("C5: the B8-domain transform of 2^20 B32 elements != stage loop")
    if not all(counts_b8[k] for k in ("k2_transpose32", "k3_ntt_local", "k4_ntt_cross")):
        raise AssertionError(f"C5: the B8-domain transform missed a kernel ({counts_b8})")
    log(f"C5: {n_level_cases} transforms at {len(LEVEL_PAIRS)} (dl, tl) pairs bit-equal; "
        f"AdditiveNTT over NTTDomain.create(3, 8) on 2^20 B32 elements, shape (12, 8, 0) "
        f"(launches {counts_b8}) = the stage loop on the card")
    p_b8, tw_np_b8 = bn._make_plan(ntt_b8.domain, 5, (12, 8, 0), 0, 0, 0, False)
    tw_b8 = bn._dev_tw(p_b8, tw_np_b8, dev)
    planes_b8 = bitslice_cuda.to_bitsliced(5, x)
    after_b8, runs_b8, n_b8 = check_cross(p_b8, tw_b8, planes_b8, "B8 twiddles")
    report("k4_ntt_cross", "binius_tpu_torch/csrc/ntt.cu", "binius_tpu/ntt/bitsliced_ntt.py:295",
           after_b8, cross_p(p_b8, tw_b8, planes_b8),
           lambda x_: cross_k(p_b8, tw_b8, x_), lambda x_: cross_p(p_b8, tw_b8, x_),
           n_bytes=2 * planes_b8.numel() * 4 + n_b8 * p_b8.n_words * 4,
           n_ops=ntt_ops(p_b8, [p_b8.stages[si] for f, n in runs_b8 for si in range(f, f + n)]),
           setup=planes_b8.clone, row=False,
           label=f"B8 twiddles on B32 data, shape (12, 8, 0), {n_b8} stages in runs {runs_b8}")
    check_local(p_b8, tw_b8, after_b8, "B8 twiddles on B32 data, shape (12, 8, 0)")
    del x, got, planes_b8, after_b8
    # K3 at b32_mul's and div_uu32's stage-1 shapes (fault C7), the inverse
    # and the forward: every stage of the plan is local, so one K3 launch is
    # the whole transform
    for name in ("b32_mul", "div_uu32"):
        dl, shape, dom_log, n_cosets = STAGE1_SHAPES[name]
        dom_s = additive_ntt.NTTDomain.create(3, dom_log)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, tower.elem_shape(dl, (1 << sum(shape),)),
                          dtype=torch.int32, device=dev, generator=gen)
        planes_s = bitslice_cuda.to_bitsliced(dl, x)
        for coset in (0, 1):
            p_s, tw_np_s = bn._make_plan(dom_s, dl, shape, coset, dom_log - shape[1], 0,
                                         coset == 0)
            check_local(p_s, bn._dev_tw(p_s, tw_np_s, dev), planes_s,
                        f"stage 1 of {name} 2^20, dl {dl}, B8 twiddles, shape {shape}, "
                        f"{'inverse, coset 0' if coset == 0 else 'forward, coset 1'}")
        del x, planes_s
    phases.done("C5 twiddle levels")

    # 7. the proofs, the main path: the u32_add constraint system, then the
    # reference grid's other circuits, each through `constraint_system.prove`
    # on the card at its grid size
    from binius_tpu_torch import circuits
    from binius_tpu_torch.constraint_system import prove as csp
    from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
    from binius_tpu_torch.utils import tracing

    grouped = install_grouped_spy()   # the grouped provers' claims, per proof
    # the bitsliced transforms of a counted run, (plan, shape) each
    transforms = []
    bn_transform = bn.transform

    def recording_transform(domain, data, data_level, shape, coset=0, coset_bits=0,
                            skip_rounds=0, inverse=False):
        transforms.append((bn._make_plan(domain, data_level, shape, coset, coset_bits,
                                         skip_rounds, inverse)[0], tuple(shape)))
        return bn_transform(domain, data, data_level, shape, coset, coset_bits, skip_rounds,
                            inverse)

    def commit_plan(core, rate):
        """(K4 launches the commit's NTT makes, the plan's description)."""
        layout = csp.CommitLayout.from_system(core)
        p_ = csp.make_fri_params(layout.commit_meta, rate)
        n = 1 << (p_.log_batch_size + p_.log_code_len)
        if not bn.supported(5, fri.LEVEL, n):
            return 0, f"2^{n.bit_length() - 1} elements, the stage loop"
        plan_, _ = bn._make_plan(p_.ntt_domain(), fri.LEVEL, (p_.log_batch_size,
                                                             p_.log_code_len, 0),
                                 0, 0, p_.log_inv_rate, False)
        cross_ = len(plan_.stages) - plan_.n_local
        k4 = len(bn._cross_runs(plan_)) if cross_ else 0
        return k4, (f"2^{n.bit_length() - 1} elements, {len(plan_.stages)} stages: {cross_} "
                    f"cross in {k4} runs + {plan_.n_local} fused (tile {plan_.tile})")

    def check_exp_layers(core, witness):
        """Every exponent's layer witnesses (`exp.make_exp_witnesses`) on
        the card through K1, and again with `bitslice_cuda.mul` replaced
        by its plain version `bitslice.mul`: bit-equal, K1 launched once
        per layer on the first and never on the second."""
        from binius_tpu_torch.constraint_system import exp as exp_mod

        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        kernel = exp_mod.make_exp_witnesses(core, dict(witness))
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        k1 = cuda_lib.launches["k1_tower_mul"]
        n_layers = sum(w.layers.shape[0] for w in kernel)
        if k1 != n_layers:
            raise AssertionError(f"exp layers: K1 launched {k1} times for {n_layers} layers")
        k1_mul = bitslice_cuda.mul
        bitslice_cuda.mul = bitslice.mul
        try:
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            plain = exp_mod.make_exp_witnesses(core, dict(witness))
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        finally:
            bitslice_cuda.mul = k1_mul
        if cuda_lib.launches["k1_tower_mul"]:
            raise AssertionError("exp layers: K1 launched on the plain path")
        for e, a, b in zip(exp_mod.reorder(core.exponents, core.oracles), kernel, plain):
            if not torch.equal(a.layers, b.layers):
                raise AssertionError(f"exp layers of oracle {e.exp_result_id}: K1 != plain")
        log(f"exp layers: {len(kernel)} exponents, {n_layers} layers of "
            f"{tuple(kernel[0].layers.shape[1:])} at level {kernel[0].level}, K1 ({k1} launches, "
            f"{t_kernel * 1e3:.1f} ms) = the plain bitslice.mul on the card "
            f"({t_plain * 1e3:.1f} ms)")

    def check_gpa_layers(core, witness):
        """The grand-product trees of the system's flush oracles (alpha and
        beta drawn from --seed) on the card through K1, one launch per
        layer and size group (`GrandProductWitness.compute` on each size
        group's stack, `witness.materialize_stack`), each layer against
        the plain `bitslice.mul` of the kernel's layer below it on the
        card, bit-equal (in chunks of 2^24 products)."""
        from binius_tpu_torch.constraint_system import witness as witness_mod
        from binius_tpu_torch.protocols import gkr_gpa

        rng_ab = random.Random(args.seed)
        work = csp._working_copy(core)
        inst = csp._gpa_instances(work, csp._make_flush_oracles(
            work, rng_ab.getrandbits(128), rng_ab.getrandbits(128)))
        groups = {}
        for oid, _, _ in inst:
            groups.setdefault(work.oracles[oid].n_vars, []).append(oid)
        k1_total, t_kernel, t_plain = 0, 0.0, 0.0
        for n, oids in groups.items():
            stack = witness_mod.materialize_stack(work.oracles, dict(witness), oids)
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            w = gkr_gpa.GrandProductWitness.compute(n, stack)
            torch.cuda.synchronize()
            t_kernel += time.perf_counter() - t0
            k1 = cuda_lib.launches["k1_tower_mul"]
            if k1 != n:
                raise AssertionError(f"gpa tree of {len(oids)} x 2^{n}: K1 launched {k1} "
                                     f"times for {n} layers")
            k1_total += k1
            t0 = time.perf_counter()
            for k in range(n, 0, -1):
                below = w.layers[k].reshape(-1, 2, 4)
                per = 1 << 24
                plain = torch.cat([bitslice.mul(7, below[i:i + per, 0], below[i:i + per, 1])
                                   for i in range(0, below.shape[0], per)])
                if not torch.equal(plain, w.layers[k - 1].reshape(-1, 4)):
                    raise AssertionError(f"gpa tree of {len(oids)} x 2^{n}, layer {k - 1}: "
                                         f"K1 != plain")
            torch.cuda.synchronize()
            t_plain += time.perf_counter() - t0
            del stack, w
        log(f"gpa trees: {len(inst)} instances in size groups "
            f"{ {f'2^{n}': len(o) for n, o in groups.items()} }, K1 ({k1_total} launches, "
            f"{t_kernel * 1e3:.1f} ms) = the plain bitslice.mul on the card, layer by layer "
            f"({t_plain * 1e3:.1f} ms)")

    def drive_proof(circuit, size, rate=LOG_INV_RATE, warm=2):
        """Prove `circuit` at 2^size on the card at code rate 2^-rate: the
        first run's time and split, with the commit's codeword and every
        Merkle tree it builds held against the plain versions of K2-K6 on
        the same inputs; one run counted (every launch counter set to 0 just
        before, read just after; no host Grøstl compression); its bytes,
        sha256 and peak memory and bytes per phase (summing to its length);
        verify accepting it and rejecting a flipped byte; the warm time
        (median of 1 + `warm`: the counted run and `warm` more) with its
        split, the bytes equal across runs, and the verify time: the median
        of the accepting verify and `warm` verifies against the system read
        back from its BTPUCS03 bytes (whose digest, bytes and canonical form
        read back the same; checked where `warm` > 0). Returns the counted
        run's launches."""
        t0 = time.perf_counter()
        core, witness, stmt = circuits.instance(circuit, size, args.seed, dev)
        torch.cuda.synchronize()
        t_inst = time.perf_counter() - t0
        k4_want, plan_txt = commit_plan(core, rate)
        wire_core = check_wire_formats(f"{circuit} 2^{size} system", core) if warm else None
        if rate != LOG_INV_RATE:
            circuit = f"{circuit} rate {rate}"
        log(f"proof: {circuit} 2^{size} (seed {args.seed}): {len(core.oracles)} oracles, "
            f"{len(core.oracles.committed_ids())} committed, "
            f"{sum(len(c.zero_constraints) for c in core.constraint_sets)} zero constraints, "
            f"{len(core.flushes)} flushes, {len(core.non_zero_claims)} non-zero claims, "
            f"zerocheck skip {csp._zerocheck_skip(core)}; instance and witness on the card "
            f"{t_inst * 1e3:.1f} ms; commit NTT: {plan_txt}")
        # the first run records the commit's message and codeword and every
        # tree built (the commit's and the FRI oracles'), for the plain check
        commits, built = [], []
        fri_commit = fri.fri_commit

        def recording_commit(params_, message, device=None, mesh=None):
            cw_, tree_ = fri_commit(params_, message, device, mesh)
            commits.append((params_, message, cw_))
            return cw_, tree_

        def recording_tree(cw_, log_coset_, blob_len_):
            buf_ = tree_levels(cw_, log_coset_, blob_len_)
            built.append((cw_, log_coset_, blob_len_, buf_))
            return buf_

        fri.fri_commit, groestl_cuda.tree_levels = recording_commit, recording_tree
        t0 = time.perf_counter()
        csp.prove(core, witness, log_inv_rate=rate, **stmt)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        fri.fri_commit, groestl_cuda.tree_levels = fri_commit, tree_levels
        log("proof %s, first run: %.1f ms (%s)" % (circuit, t_first * 1e3,
                                                    ", ".join(f"{k} {v * 1e3:.1f}" for k, v
                                                              in csp.last_phase_times.items())))
        # the kernels at this proof's own shapes against their plain versions
        # on the card: the commit's codeword (K2, K4 and K3 at its plan) and
        # every tree's layers (K5 and K6 at its leaf count)
        if len(commits) != 1:
            raise AssertionError(f"{circuit}: {len(commits)} commits on one proof")
        params_c, message_c, cw_c = commits[0]
        if not torch.equal(plain_codeword(params_c, message_c), cw_c):
            raise AssertionError(f"{circuit}: kernel codeword != plain codeword")
        for cw_, log_coset_, blob_len_, buf_ in built:
            if not torch.equal(plain_layers(cw_, log_coset_, blob_len_), buf_):
                raise AssertionError(f"{circuit}: tree of {cw_.shape[0] >> log_coset_} leaves: "
                                     f"kernel layers != plain layers")
        leaves = [cw_.shape[0] >> lc_ for cw_, lc_, _, _ in built]
        k6_want = sum(len(groestl_cuda.tree_launches(n)) for n in leaves)
        log(f"proof {circuit}: codeword of {cw_c.shape[0]} elements and the layers of its "
            f"{len(built)} trees (leaves {leaves}) = the plain versions on the card")
        commits.clear()
        built.clear()
        del params_c, message_c, cw_c
        host_compressions[0] = 0
        count_host_hashing(True)
        torch.cuda.reset_peak_memory_stats()
        grouped.clear()
        transforms.clear()
        bn.transform = recording_transform
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            proof = csp.prove(core, witness, log_inv_rate=rate, **stmt)
            torch.cuda.synchronize()
        finally:
            bn.transform = bn_transform
        log(f"proof {circuit} stage 2 (grouping on, the CUDA default): {len(grouped)} grouped "
            f"provers holding {sum(grouped)} claims {list(grouped)}; stage 2 wall "
            f"{uzc.last_stage_times.get('stage2', 0.0) * 1e3:.3f} ms")
        proven[circuit] = (core, stmt, len(proof), hashlib.sha256(proof).hexdigest())
        # the counted run is also the first warm sample
        names = ("total", "commit", "exp", "gpa", "zerocheck", "evalcheck", "ring_switch",
                 "piop", "verify")
        splits = {"total": [(time.perf_counter() - t0) * 1e3], "verify": [],
                  **{k: [csp.last_phase_times[k] * 1e3] for k in names[1:-1]}}
        counts = dict(cuda_lib.launches)
        stage1_ms = uzc.last_stage_times.get("stage1", 0.0) * 1e3
        count_host_hashing(False)
        log(f"launches on the {circuit} proof: {counts}; host Grøstl compressions "
            f"{host_compressions[0]}")
        need = [k for k in cuda_lib.KERNELS if k != "k4_ntt_cross"]
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise AssertionError(f"{circuit}: kernels not launched on the proof: {missing}")
        # the bitsliced transforms: the commit's (its plan's cross runs in
        # K4) and stage 1's (log_z > 0), K2 twice and K3 once each
        stage1 = [sh for _, sh in transforms if sh[2] > 0]
        if len(transforms) - len(stage1) != 1:
            raise AssertionError(f"{circuit}: {len(transforms) - len(stage1)} commit transforms")
        k4_stage1 = sum(len(bn._cross_runs(p_)) for p_, sh in transforms if sh[2] > 0)
        want_ntt = {"k2_transpose32": 2 * len(transforms),
                    "k3_ntt_local": sum(p_.n_local > 0 for p_, _ in transforms),
                    "k4_ntt_cross": k4_want + k4_stage1}
        if any(counts[k] != v for k, v in want_ntt.items()):
            raise AssertionError(f"{circuit}: NTT launches {counts}, want {want_ntt} (the "
                                 f"commit's plan has {k4_want} cross runs; stage 1's "
                                 f"transforms {stage1})")
        base = circuit.split()[0]
        if base in STAGE1_SHAPES:
            want_s1 = STAGE1_SHAPES[base][1]
            if (counts["k3_ntt_local"] <= 1 or counts["k2_transpose32"] <= 2
                    or (size == 20 and set(stage1) != {want_s1})):
                raise AssertionError(f"{circuit}: stage 1 did not take K2/K3 at {want_s1}: "
                                     f"transforms {stage1}, launches {counts}")
        elif stage1 or counts["k3_ntt_local"] != 1:
            raise AssertionError(f"{circuit}: B8 stage-1 data took the bitsliced route "
                                 f"({stage1}, launches {counts})")
        log(f"proof {circuit} stage 1: {len(stage1)} transforms through K2/K3 "
            f"{sorted(set(stage1))} ({k4_stage1} K4 runs)" if stage1 else
            f"proof {circuit} stage 1: the stage loop (B8 data)")
        if counts["k5_groestl_leaf"] != len(leaves) or counts["k6_groestl_pairs"] != k6_want:
            raise AssertionError(f"{circuit}: K5 launched {counts['k5_groestl_leaf']} times for "
                                 f"{len(leaves)} trees, K6 {counts['k6_groestl_pairs']} for "
                                 f"{k6_want}")
        if host_compressions[0]:
            raise AssertionError(f"the prover compressed {host_compressions[0]} times on the host")
        sha = hashlib.sha256(proof).hexdigest()
        pinned = CARD_PROOFS.get((circuit, size)) if args.seed == 0 else None
        if pinned and (len(proof), sha) != pinned:
            raise AssertionError(f"{circuit}: {len(proof)} bytes, sha256 {sha}; the stage "
                                 f"loop's proof has {pinned}")
        log(f"proof {circuit}: {len(proof)} bytes, sha256 {sha}"
            f"{' (= CARD_PROOFS)' if pinned else ''}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        # the bytes per phase, from the commit on (the table sizes' message
        # is in none)
        sizes_msg = 8 + 8 * len(stmt["table_sizes"]) if "table_sizes" in stmt else 0
        log(f"proof {circuit} bytes per phase: {csp.last_phase_sizes}")
        if sum(csp.last_phase_sizes.values()) + sizes_msg != len(proof):
            raise AssertionError(f"{circuit}: phase sizes sum to "
                                 f"{sum(csp.last_phase_sizes.values())} + {sizes_msg}, the "
                                 f"proof has {len(proof)} bytes")
        if core.exponents:
            check_exp_layers(core, witness)
        if core.flushes or core.non_zero_claims:
            check_gpa_layers(core, witness)
        t0 = time.perf_counter()
        csp.verify(core, proof, log_inv_rate=rate, **stmt)
        splits["verify"].append((time.perf_counter() - t0) * 1e3)
        log(f"proof {circuit} verifies ({splits['verify'][0]:.1f} ms)")
        bad = bytearray(proof)
        bad[len(bad) // 3] ^= 1
        try:
            csp.verify(core, bytes(bad), log_inv_rate=rate, **stmt)
        except (ValueError, EOFError) as e:
            log(f"proof {circuit} with byte {len(bad) // 3} flipped: rejected ({e})")
        else:
            raise AssertionError(f"{circuit}: a proof with a flipped byte was accepted")
        routes = {"routed": [(stage1_ms, splits["zerocheck"][0])],
                  "stage loop": []}

        def loop_run():
            """One proof with stage 1 on the stage loop: its bytes equal the
            counted run's; its stage-1 and zerocheck ms recorded."""
            gate = uzc.bitsliced_ntt
            uzc.bitsliced_ntt = types.SimpleNamespace(supported=lambda *a: False)
            try:
                torch.cuda.synchronize()
                again = csp.prove(core, witness, log_inv_rate=rate, **stmt)
                torch.cuda.synchronize()
            finally:
                uzc.bitsliced_ntt = gate
            if again != proof:
                raise AssertionError(f"{circuit}: stage 1 on the stage loop changed the bytes")
            routes["stage loop"].append((uzc.last_stage_times["stage1"] * 1e3,
                                         csp.last_phase_times["zerocheck"] * 1e3))

        compare = warm and stage1
        if compare:
            loop_run()
        for _ in range(warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = csp.prove(core, witness, log_inv_rate=rate, **stmt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if again != proof:
                raise AssertionError(f"{circuit}: proof bytes differ between runs")
            routes["routed"].append((uzc.last_stage_times["stage1"] * 1e3,
                                     csp.last_phase_times["zerocheck"] * 1e3))
            for k in names[1:-1]:
                splits[k].append(csp.last_phase_times[k] * 1e3)
            splits["total"].append((t1 - t0) * 1e3)
            # verify against the system read back from its wire bytes
            csp.verify(wire_core, again, log_inv_rate=rate, **stmt)
            splits["verify"].append((time.perf_counter() - t1) * 1e3)
        split = {k: statistics.median(splits[k]) for k in names}
        log("proof %s 2^%d, warm, median of %d: the counted run and %d more (ms; verify apart: "
            "the accepting verify against the system and %d against the deserialized "
            "system): %s" % (
                circuit, size, warm + 1, warm, warm,
                ", ".join(f"{k} {v:.3f}" for k, v in split.items())))
        if compare:
            loop_run()
            log(f"proof {circuit} 2^{size} stage 1, routed (K2/K3; the counted run and "
                f"{warm} more) against the stage loop (one run before them, one after; the "
                f"same bytes), ms, median: " + "; ".join(
                    f"{route} stage 1 {statistics.median(t[0] for t in ts):.3f}, zerocheck "
                    f"{statistics.median(t[1] for t in ts):.3f} (runs "
                    f"{[round(t[0], 1) for t in ts]})" for route, ts in routes.items()))
        if circuit in ("keccak", "merkle_tree"):
            stage2_regimes(f"{circuit} 2^{size}", core, witness, grouped)
        return counts

    proven = {}
    proof_launches = {"u32_add": drive_proof("u32_add", args.log_rows)}
    if any(v == 0 for v in proof_launches["u32_add"].values()):
        raise AssertionError(f"kernels not launched on the u32_add proof: "
                             f"{proof_launches['u32_add']}")
    phases.done("proof u32_add")
    for circuit in ("b32_mul", "keccak", "groestl", "u32_mul_gkr", "bitwise_ops",
                    "keccak_lookups", "sha256", "merkle_tree", "u32_sub", "u32_mul",
                    "barrel_shifter", "div_uu32"):
        size = circuits.GRID_SIZE.get(circuit) or circuits.CARD_SIZE[circuit]
        proof_launches[circuit] = drive_proof(circuit, size)
        phases.done(f"proof {circuit}")
    proof_launches["vision_tree"] = counts_v

    # 7b. other code rates and the command lines: the card-size proofs at
    # log_inv_rate 2 and 3 (the counted run the one warm run; their goldens
    # are section 8's), the nine example command lines on the card at their
    # JAX defaults in-process, and u32_add's again as `python -m`, run
    # beside them
    for circuit, rate in RATE_PROOFS:
        size = args.log_rows if circuit == "u32_add" else circuits.CARD_SIZE[circuit]
        proof_launches[f"{circuit} rate {rate}"] = drive_proof(circuit, size, rate, warm=0)
        phases.done(f"proof {circuit} rate {rate}")
    device_name = torch.cuda.get_device_name(0)
    sub = subprocess.Popen([sys.executable, "-m", "binius_tpu_torch.examples.u32_add"],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t_sub = time.perf_counter()
    for name, metrics in EXAMPLE_LINES.items():
        mod = importlib.import_module(f"binius_tpu_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main([])
        check_example(name, out.getvalue(), metrics, device_name, len(csp.last_phase_times))
        log(f"command line {name} (its defaults) in-process, {time.perf_counter() - t0:.1f} s: "
            + " | ".join(ln.strip() for ln in out.getvalue().splitlines()))
    try:
        sub_out, sub_err = sub.communicate(timeout=600)
    finally:
        sub.kill()
    if sub.returncode:
        raise AssertionError(f"python -m binius_tpu_torch.examples.u32_add: exit "
                             f"{sub.returncode}: {sub_err[-2000:]}")
    check_example("u32_add", sub_out, EXAMPLE_LINES["u32_add"], device_name,
                  len(csp.last_phase_times))
    log(f"command line python -m binius_tpu_torch.examples.u32_add (beside the others), "
        f"{time.perf_counter() - t_sub:.1f} s: "
        + " | ".join(ln.strip() for ln in sub_out.splitlines()))
    phases.done("command lines")

    # 8. bytes: the JAX package's digest at 2^16 rows, and the same opening
    # composed from the plain versions on the CPU (at the golden's depth it
    # runs two FRI oracles, as the main path runs three, in a few seconds).
    # The golden proofs through the plain versions on the CPU run in
    # PLAIN_WORKERS worker processes beside the card's proofs of this
    # section (no timed phase runs meanwhile)
    plain_jobs = [("u32_add", GOLDEN_LOG_ROWS, GOLDEN_SEED, 1)] + [
        (c, size, 0, 1) for c, (size, _, _) in [*GOLDEN_CIRCUITS.items(), *GOLDEN_CARD.items()]
    ] + [(c, size, 0, rate) for c, size, rate in GOLDEN_RATES]
    pool = concurrent.futures.ProcessPoolExecutor(
        PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    plain = {job: pool.submit(plain_proof, *job) for job in plain_jobs}

    def plain_bytes(job, want, what):
        """The worker's proof of `job` against the card's bytes `want`."""
        proof, secs = plain[job].result()
        if proof != want:
            raise AssertionError(f"{what}: plain-path proof differs from the kernel path")
        log(f"{what} through the plain versions on the CPU ({secs:.1f} s in a worker): the "
            f"kernel path's bytes")

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
    # the golden 8-row proof, with tracing on (its Chrome trace written to
    # chiprun_out/ and held against the phase times), and the proof at 2^16
    # rows: the JAX package's digest, the kernel path and the plain versions
    # on the CPU
    core8, wit8 = golden_system(dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    trace_path = os.path.join(OUT_DIR, "trace_golden_8.json")
    os.environ["BINIUS_TRACE_FILE"] = trace_path
    tr = importlib.reload(tracing)
    try:
        p8 = csp.prove(core8, wit8)
        tr.save(trace_path)
    finally:
        del os.environ["BINIUS_TRACE_FILE"]
        atexit.unregister(tr.save)
        importlib.reload(tracing)
    check_trace(trace_path, csp.last_phase_times)
    check_digest("golden 8-row proof on the card", p8, GOLDEN_PROOF_8)
    if csp.last_phase_sizes != GOLDEN_PHASE_SIZES_8:
        raise AssertionError(f"golden 8-row proof: bytes per phase {csp.last_phase_sizes} != "
                             f"{GOLDEN_PHASE_SIZES_8}")
    log(f"golden 8-row proof bytes per phase: {csp.last_phase_sizes} (= golden)")
    check_serialized("golden_8", core8)
    csp.verify(core8, p8)
    core16, wit16, _ = circuits.instance("u32_add", GOLDEN_LOG_ROWS, GOLDEN_SEED, dev)
    check_serialized("u32_add", core16)
    p16 = csp.prove(core16, wit16)
    check_digest(f"proof 2^{GOLDEN_LOG_ROWS} rows, seed {GOLDEN_SEED} on the card", p16,
                 GOLDEN_PROOF_16)
    card = {("u32_add", GOLDEN_LOG_ROWS, GOLDEN_SEED, 1): (p16, f"proof 2^{GOLDEN_LOG_ROWS} rows")}
    phases.done("golden proofs")
    # the other circuits at small sizes and at other code rates: the JAX
    # package's digests on the card, and the same proofs through the plain
    # versions on the CPU (the workers')
    for circuit, (size, n_bytes, sha) in [*GOLDEN_CIRCUITS.items(), *GOLDEN_CARD.items()]:
        core_c, wit_c, stmt_c = circuits.instance(circuit, size, 0, dev)
        if GOLDEN_CIRCUITS.get(circuit, (None,))[0] == size:
            check_serialized(circuit, core_c)
        grouped.clear()
        pc = csp.prove(core_c, wit_c, **stmt_c)
        check_digest(f"{circuit} proof 2^{size}, seed 0 on the card ({len(grouped)} grouped "
                     f"provers, claims {list(grouped)})", pc, (n_bytes, sha))
        csp.verify(core_c, pc, **stmt_c)
        if circuit == "keccak":
            check_digest(f"{circuit} proof 2^{size} with group_claims=False",
                         csp.prove(core_c, wit_c, group_claims=False, **stmt_c), (n_bytes, sha))
            check_digest(f"{circuit} proof 2^{size} with group_claims=True",
                         csp.prove(core_c, wit_c, group_claims=True, **stmt_c), (n_bytes, sha))
        card[(circuit, size, 0, 1)] = (pc, f"{circuit} proof 2^{size}")
    for (circuit, size, rate), want_r in GOLDEN_RATES.items():
        core_c, wit_c, stmt_c = circuits.instance(circuit, size, 0, dev)
        pc = csp.prove(core_c, wit_c, log_inv_rate=rate, **stmt_c)
        check_digest(f"{circuit} proof 2^{size}, seed 0, rate {rate} on the card", pc, want_r)
        csp.verify(core_c, pc, log_inv_rate=rate, **stmt_c)
        card[(circuit, size, 0, rate)] = (pc, f"{circuit} proof 2^{size} rate {rate}")
    for job in plain_jobs:
        plain_bytes(job, *card[job])
    pool.shutdown()
    phases.done("golden and plain circuit proofs")

    # 8b. the mesh: ranks spawned on the card, every proof's bytes those of
    # one device
    torch.cuda.empty_cache()
    proof_launches.update(mesh_phase(args.log_rows, args.seed, dev, proven))
    phases.done("mesh")
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in proof_launches.values())
        r["launches_by_proof"] = {c: v[r["name"]] for c, v in proof_launches.items()}

    # 9. results
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
