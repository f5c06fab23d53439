"""redisson_tpu_torch.server — the RESP-speaking sidecar fronting the Engine.

`TpuServer` is the asyncio server; `ServerThread` embeds one in-process for
hermetic tests.  State lives on the CUDA card unless ``device="cpu"``.
"""
from redisson_tpu_torch.server.server import ServerThread, TpuServer  # noqa: F401
