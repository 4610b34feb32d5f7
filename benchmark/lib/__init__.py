"""The benchmark's harness: manifest, inputs, timing, tracing, checks."""
