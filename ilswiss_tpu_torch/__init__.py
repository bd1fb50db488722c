"""PyTorch/CUDA port of ilswiss_tpu (counterpart: ilswiss_tpu/__init__.py).

The JAX package `ilswiss_tpu` stays the reference; this package mirrors
its module layout and names.  Plain tensor code is PyTorch, and each TPU
kernel of the ported path is a CUDA C++ kernel for Hopper under
`csrc/`, built at first use by `kernels/build.py`.

Entry points run on the GPU unless the caller passes `device="cpu"`
(`utils.device.resolve_device`).  On a CPU tensor a kernel wrapper runs
its plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.
"""
