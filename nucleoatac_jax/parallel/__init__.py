from nucleoatac_jax.parallel.mesh import (
    make_mesh,
    sharded_full_step,
    sharded_size_histogram,
)

__all__ = ["make_mesh", "sharded_full_step", "sharded_size_histogram"]
