"""``python -m redisson_tpu_torch.server [--device cuda|cpu] [--port N]`` —
the server CLI."""
from redisson_tpu_torch.server.server import main

if __name__ == "__main__":
    raise SystemExit(main())
