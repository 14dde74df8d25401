"""End-to-end example on the PyTorch/CUDA port: prove the fib guest and
verify the proof.

Counterpart of `examples/prove_fib.py`: load the guest, prove it with
its input through the port's `sdk.LocalProver`, inspect the View,
verify, serialize.  It runs on the card, or on the CPU with ``--cpu``.

    python examples/prove_fib_torch.py [n] [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

from nexus_zkvm_tpu_torch.sdk import (  # noqa: E402
    Guest, LocalProver, encode_u32s, decode_u32s, proof_to_bytes,
)


def main(argv) -> int:
    n = next((int(a) for a in argv if a.isdigit()), 20)
    guest = Guest.from_asm(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "guests",
        "fib.s")).read())
    prover = LocalProver(guest, device="cpu" if "--cpu" in argv else "cuda")

    t0 = time.time()
    view, proof = prover.prove_with_input(public_input=encode_u32s(n))
    t_prove = time.time() - t0
    print(f"fib({n}) = {decode_u32s(view.public_output, 1)[0]}")
    print(f"exit code: {view.exit_code}")
    print(f"proved in {t_prove:.1f}s, "
          f"proof ~{len(proof_to_bytes(proof)) / 1024:.0f} KiB")

    t0 = time.time()
    ok = prover.verify(view, proof)
    print(f"verified: {ok} in {time.time() - t0:.1f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
