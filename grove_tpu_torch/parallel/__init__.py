"""Solving one wave under several weight variants, and the node-sharded
layout of the single-variant solve (grove_tpu/parallel counterpart; the
portfolio mesh is not ported)."""
