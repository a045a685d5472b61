"""Plain float32 PyTorch references of what the benchmark's cells run.

Nothing here imports the port (`score_based_channels_torch`), the JAX
package or JAX. Each module follows the published description of its
model or protocol, and where it re-derives a draw that the port makes
from a seed (pilots, noise, batch rows), it makes the same draw from the
same seed with the same torch calls.
"""
