"""Hand-written CUDA kernels for Hopper (sm_90a), built from csrc/ at first
use and bound with ctypes; nothing here builds or loads at import."""
