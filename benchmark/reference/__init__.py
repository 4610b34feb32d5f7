"""The benchmark's plain reference: plain PyTorch that re-derives, from the
inputs the benchmark makes, what the port's training steps should produce.

Nothing here imports the port (``recommenders_addons_tpu_torch``) or the
JAX package. Where the reference needs the port's documented arithmetic
(the key hash, the per-key threefry rows), it keeps a frozen copy of it.
"""
