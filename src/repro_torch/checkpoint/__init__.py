"""Checkpoints in the JAX package's msgpack layout, readable by either
package."""
from repro_torch.checkpoint.io import (latest_step, load_pytree, restore,
                                       save, save_pytree)

__all__ = ["latest_step", "load_pytree", "restore", "save", "save_pytree"]
