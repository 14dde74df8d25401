"""The benchmark harness of the PyTorch and CUDA prover: cells, the
closed-loop window, the device trace, roofline counts and the guard
against JAX."""
