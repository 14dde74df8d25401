"""Field, circle, FFT, hashing, Merkle, quotient and FRI operations."""
