"""``composition_s``'s reading in machine2's cell, which reports no
``steps_per_s`` end to end: there the same proofs move ``setup_s``,
whose warm-up proves two jobs a rung."""

from harness.spec import load_module

_base = load_module("metrics", "composition_s")
UNIT, LAYER, SOURCE, MOVES = _base.UNIT, _base.LAYER, _base.SOURCE, \
    "setup_s"
read = _base.read
