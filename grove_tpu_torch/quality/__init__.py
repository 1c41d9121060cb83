"""Placement-quality evaluation (grove_tpu/quality counterpart): the report,
the exact branch-and-bound reference packer and the seeded audit."""
