from dynamont_jax.parallel.mesh import make_mesh
from dynamont_jax.parallel.train_step import make_sharded_train_step, pool_params

__all__ = ["make_mesh", "make_sharded_train_step", "pool_params"]
