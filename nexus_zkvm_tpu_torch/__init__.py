"""nexus_zkvm_tpu_torch — the Circle-STARK prover core on PyTorch and CUDA.

The PyTorch/CUDA port of ``nexus_zkvm_tpu``'s prover core: M31/QM31
field arithmetic, circle FFT, Blake2s Merkle commitments, LogUp, DEEP
quotients, FRI and resident prove/verify.  The hot device programs are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` for
``sm_90a`` at first use; every kernel has a plain PyTorch version that
runs when the tensors it is given lie on the CPU.

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present; pass ``device="cpu"`` for the plain path.
"""

from .channel import Blake2sChannel
from .prover import PcsConfig, FriConfig, MemoryConfig, prove, verify, Proof

__all__ = ["Blake2sChannel", "PcsConfig", "FriConfig", "MemoryConfig",
           "prove", "verify", "Proof"]
