"""The flight recorder, deterministic replay and what-if (grove_tpu/trace
counterpart): `recorder` journals every committed solve wave, `replay`
re-solves a journal's waves and diffs them against the recorded plans,
`whatif` re-solves them against an edited fleet or config."""
