"""The example command lines of the JAX package (`examples/*.py`), one
module each, run on the card or, with `--cpu`, through the plain versions
on the CPU:

    python -m binius_tpu_torch.examples.<name> [flags] [--cpu]

for name in u32_add, b32_mul, bitwise_ops, u32_mul_gkr, sha256, groestl,
keccak, keccak_lookups and merkle_tree. Each takes its JAX example's flags
under the same names and defaults, builds the same instance through the
port's front end (`circuits`), and prints the same lines: first the device
(`torch.cuda.get_device_name()`, or `cpu`), then the upstream metrics
`trace-gen-time`, `validate-time` where the JAX example prints it,
`prove-time`, `prove.<phase>` where it prints them, `proof-size` and
`verify-time`. Each module's `main(argv=None)` runs it in-process;
importing a module runs nothing. `examples/bench_b128_mul.py`, which times
the TPU's MXU multiply, has no counterpart: the port has no MXU path.
"""
