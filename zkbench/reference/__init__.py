"""The plain reference: what the prover's outputs are judged against.

It imports nothing of the prover package, of JAX or of the JAX package.
``fib.py`` computes each job's expected public claim from its n;
``nzt/`` is a frozen copy of the prover's verifier (its transcript,
Merkle and FRI checks, the constraint evaluations of every component
of machine v1 and machine2, the assembler), which a later change to the
prover cannot reach; ``check.py`` judges a run's proofs with both.
"""
