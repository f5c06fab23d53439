"""redisson_tpu_torch: the sketch data plane of redisson_tpu on PyTorch and CUDA.

A second package beside ``redisson_tpu`` (the JAX reference).  It keeps the
reference's module layout, public names and persisted formats, and runs the
device programs as hand-written CUDA kernels (``csrc/``) on an NVIDIA GPU.
Every kernel has a plain PyTorch version beside it, which runs when the state
lives on the CPU.

This package imports neither JAX nor anything of ``redisson_tpu``.
"""
from redisson_tpu_torch.version import __version__  # noqa: F401


def create(config=None, device="cuda"):
    """Create an embedded-mode client whose state lives on ``device``.

    The default is the CUDA card; without one this raises rather than
    falling back.  Pass ``device="cpu"`` to run the plain PyTorch versions.
    """
    from redisson_tpu_torch.client.redisson import RedissonTpu

    return RedissonTpu.create(config, device)


__all__ = ["__version__", "create"]
