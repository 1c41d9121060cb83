"""Solving one wave under several weight variants (grove_tpu/parallel
counterpart, without the device meshes)."""
