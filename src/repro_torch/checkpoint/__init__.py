"""msgpack checkpointing of trees (the port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.msgpack_ckpt import latest_step, load, save, steps

__all__ = ["save", "load", "latest_step", "steps"]
