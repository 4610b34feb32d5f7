"""The port's kernel measurement tools, each named after its counterpart
in the repository's ``tools/`` (the JAX package's tools)."""
