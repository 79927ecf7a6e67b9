from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.fragmentsizes import FragmentSizes

__all__ = ["Chunk", "ChunkList", "FragmentSizes"]
