"""binius_tpu_torch: the PyTorch and CUDA port of binius_tpu for the H100.

So far the port covers the prover's commit phase (pack, Reed-Solomon encode
with the additive NTT, Grøstl-256 Merkle root: `protocols.piop.commit`) and
the opening of that commitment (ring switching and the PIOP's sumcheck
interleaved with FRI: `protocols.ring_switch.prove` / `verify`,
`protocols.piop.prove` / `verify`, over `transcript.transcript`).
Entry points run on CUDA unless the caller passes ``device="cpu"``, which
takes each kernel's plain PyTorch version.
"""
