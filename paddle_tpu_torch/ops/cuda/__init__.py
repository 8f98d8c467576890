"""Hand-written CUDA C++ kernels for Hopper (sm_90a), built from `csrc/`
at first use and bound with ctypes."""
