"""Model substrate (the port of ``src/repro/models``): layers, GQA attention,
RWKV-6 and the pattern stack, for serving."""
from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
