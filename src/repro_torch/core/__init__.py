"""The MPK compiler passes (copied from the JAX package, which stays the
reference) and the port's decode-graph lowering."""
