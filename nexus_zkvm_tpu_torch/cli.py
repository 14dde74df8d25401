"""Command-line interface: scaffold, run, prove, verify guests.

Counterpart of the reference's `cargo-nexus` CLI
(`nexus-zkvm/cli/src/command/mod.rs:7-20`):

    python -m nexus_zkvm_tpu_torch.cli new my_guest      # scaffold a guest
    python -m nexus_zkvm_tpu_torch.cli run   guest.s --input 21
    python -m nexus_zkvm_tpu_torch.cli prove guest.s --input 21 -o proof.bin
    python -m nexus_zkvm_tpu_torch.cli verify proof.bin

``prove`` and ``verify`` run on the card; ``--cpu`` runs them on the
plain PyTorch path instead.  Without ``--cpu`` and without a CUDA device
they exit with code 2.  ``run`` only emulates and needs no card.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time
from contextlib import nullcontext

_TEMPLATE = """\
# New guest program. Reads one u32 from the public input, writes one
# u32 result to the public output. See examples/guests/ for more.
    lw   t0, 0x80(zero)      # public input pointer
    lw   a0, 4(t0)           # first input word
    # ... compute on a0 ...
    lw   t1, 0x84(zero)      # public output pointer
    sw   a0, 0(t1)
    addi a0, zero, 0         # exit code 0
    addi a7, zero, 0x201
    ecall
"""

# `new NAME` (no .s suffix) scaffolds a host project like the
# reference's `cargo nexus host` (`cli/src/command/host.rs:18-29`):
# a runtime-based guest plus a host driver script.
_GUEST_TEMPLATE = """\
# Guest program (runtime dialect: see nexus_zkvm_tpu_torch/vm/runtime.py).
# `main` is called by the runtime; its return value is the exit code.
# Helpers: rt_input_word, rt_output_word, rt_alloc, rt_log,
#          rt_read_private, rt_cycle_mark.
main:
    mv   s0, ra
    addi a0, zero, 0
    call rt_input_word       # a0 = first public input word
    add  a1, a0, a0          # ... compute ...
    addi a0, zero, 0
    call rt_output_word      # output[0] = result
    mv   ra, s0
    addi a0, zero, 0         # exit code
    ret
"""

_HOST_TEMPLATE = """\
#!/usr/bin/env python3
\"\"\"Host driver: trace, prove, and verify the guest.

    python host.py [N] [--cpu]      # --cpu: the plain PyTorch path
\"\"\"
import sys

from nexus_zkvm_tpu_torch.sdk import (Guest, LocalProver, encode_u32s,
                                      decode_output, verify)

args = [a for a in sys.argv[1:] if a != "--cpu"]
device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
guest = Guest.from_asm(open("guest.s").read())
prover = LocalProver(guest, device=device)

n = int(args[0]) if args else 21
view, proof = prover.prove_with_input(public_input=encode_u32s(n))
print("exit code:", view.exit_code)
print("output:", decode_output(view, 1))
print("verified:", verify(view, proof, device=device))
"""

# what a corrupt bundle can raise while it is parsed or checked
_MALFORMED = (ValueError, IndexError, KeyError, OverflowError, MemoryError,
              AssertionError, EOFError, struct.error)


def _load_guest(path: str):
    from .sdk import Guest
    if path.endswith(".s") or path.endswith(".asm"):
        with open(path) as f:
            return Guest.from_asm(f.read())
    return Guest.from_elf(path)


def _input_bytes(args) -> bytes:
    from .sdk import encode_u32s
    return encode_u32s(*args.input) if args.input else b""


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nexus-zkvm-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_new = sub.add_parser("new", help="scaffold a new guest program")
    p_new.add_argument("name")

    def common(p):
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (the plain PyTorch path)")
        p.add_argument("--progress", action="store_true",
                       help="live phase ticker on stderr")
        p.add_argument("--profile", action="store_true",
                       help="per-phase host profile on stderr")

    for cmd in ("run", "prove"):
        p = sub.add_parser(cmd)
        p.add_argument("guest", help=".s/.asm assembly or riscv32 ELF")
        p.add_argument("--input", type=lambda s: int(s, 0), nargs="*",
                       help="public input u32 words")
        p.add_argument("--private-input", type=lambda s: int(s, 0),
                       nargs="*", help="private input bytes")
        common(p)
        if cmd == "prove":
            p.add_argument("-o", "--output", default="proof.bin")

    # verify is standalone: the bundle carries the View (public claim),
    # so no guest re-execution is needed (ref `sdk/src/stwo/seq.rs:
    # 141-147` ships the View with the proof the same way)
    p_ver = sub.add_parser("verify")
    p_ver.add_argument("proof", help="proof bundle from `prove`")
    common(p_ver)
    return ap


def _new(ap, name: str) -> int:
    if name.endswith(".s"):          # single-file guest
        if os.path.exists(name):
            ap.error(f"{name} already exists")
        with open(name, "w") as f:
            f.write(_TEMPLATE)
        print(f"wrote {name}")
        return 0
    # project scaffold (ref `cargo nexus host`)
    if os.path.exists(name):
        ap.error(f"{name}/ already exists")
    os.makedirs(name)
    with open(os.path.join(name, "guest.s"), "w") as f:
        f.write(_GUEST_TEMPLATE)
    with open(os.path.join(name, "host.py"), "w") as f:
        f.write(_HOST_TEMPLATE)
    print(f"scaffolded {name}/ (guest.s + host.py); "
          f"run: cd {name} && python host.py 21")
    return 0


def _print_output(view) -> None:
    out = view.public_output.rstrip(b"\0")
    if out:
        print(f"output bytes: {out.hex()}")


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.cmd == "new":
        return _new(ap, args.name)

    from .sdk import (LocalProver, bundle_to_bytes, bundle_from_bytes,
                      verify as verify_fn)
    from .utils import enable_progress, profiled
    from .utils.device import resolve_device

    device = "cpu" if args.cpu else "cuda"
    if args.cmd != "run":
        try:
            resolve_device(device)
        except RuntimeError as e:
            print(f"error: {e} (or pass --cpu)", file=sys.stderr)
            return 2
    if args.progress:
        enable_progress()
    prof_ctx = profiled() if args.profile else nullcontext()

    if args.cmd == "verify":
        with open(args.proof, "rb") as f:
            blob = f.read()
        t0 = time.time()
        with prof_ctx as prof:
            try:
                view, proof = bundle_from_bytes(blob)
                ok = verify_fn(view, proof, device=device)
            except _MALFORMED as e:
                print(f"malformed bundle: {type(e).__name__}: {e}")
                print("verified: False")
                return 1
        if prof is not None:
            print(prof.report(), file=sys.stderr)
        print(f"exit code: {view.exit_code}")
        _print_output(view)
        print(f"verified: {ok} in {time.time() - t0:.1f}s")
        return 0 if ok else 1

    guest = _load_guest(args.guest)
    prover = LocalProver(guest, device=device)
    priv = bytes(args.private_input or [])

    if args.cmd == "run":
        view, trace = prover.trace(public_input=_input_bytes(args),
                                   private_input=priv)
        print(f"exit code: {view.exit_code}")
        print(f"steps: {trace.n_steps}")
        _print_output(view)
        if view.debug_logs:
            print("logs:", view.logs_text())
        return 0 if view.exit_code == 0 else 1

    t0 = time.time()
    with prof_ctx as prof:
        view, proof = prover.prove_with_input(
            public_input=_input_bytes(args), private_input=priv)
    if prof is not None:
        print(prof.report(), file=sys.stderr)
    blob = bundle_to_bytes(view, proof)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"exit code {view.exit_code}; proof bundle "
          f"{len(blob) / 1024:.0f} KiB -> {args.output} "
          f"in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
