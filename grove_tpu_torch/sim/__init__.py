"""Synthetic clusters and backlogs (grove_tpu/sim/workloads.py counterpart)."""
