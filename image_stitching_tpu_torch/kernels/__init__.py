"""Hand-written CUDA kernels with their plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (built from `csrc/` at first use) or raises.
`<wrapper>.launches` counts kernel launches.
"""
