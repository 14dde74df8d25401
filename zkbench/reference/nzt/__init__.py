"""A frozen copy of the measured prover's verifier.

Copied from ``nexus_zkvm_tpu_torch`` when the benchmark was written and
kept apart from it, so a later change to the prover cannot change what
its proofs are judged by: the Blake2s channel, the field and circle
arithmetic, the plain PyTorch circle FFT and Blake2s (for the
preprocessed commitment), Merkle, DEEP-quotient and FRI checks, the
AIR framework and every component of machine v1 and machine2 (their
constraints, preprocessed columns and parameters, without their trace
fills), and the assembler.  ``verifier.verify`` replays a proof;
``machine/driver.py`` and ``machine2/driver.py`` rebuild the components
from a public View and apply each machine's size rules.  It imports
nothing of the prover package.
"""
