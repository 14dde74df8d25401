"""STARK prover/verifier: commitment scheme, composition, prove/verify."""

from .config import PcsConfig, FriConfig
from .stark import prove, verify, Proof
