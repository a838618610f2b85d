"""Plain PyTorch reference of the benchmark's models: the yardstick that
decides ``correct``.  It imports neither JAX nor either package of this
repository; it reads the weights the harness made from the seed, keyed by
the parameter names of the state dict both sides are given."""
