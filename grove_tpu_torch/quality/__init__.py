"""Placement-quality evaluation (grove_tpu/quality counterpart, the report only)."""
