"""binius_tpu_torch: the PyTorch and CUDA port of binius_tpu for the H100.

So far the port covers the prover's commit phase: pack, Reed-Solomon encode with the
additive NTT, and the Grøstl-256 Merkle root (`protocols.piop.commit`).
Entry points run on CUDA unless the caller passes ``device="cpu"``, which
takes each kernel's plain PyTorch version.
"""
