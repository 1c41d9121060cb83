"""The flight recorder and deterministic replay (grove_tpu/trace
counterpart): `recorder` journals every committed solve wave, `replay`
re-solves a journal's waves and diffs them against the recorded plans."""
