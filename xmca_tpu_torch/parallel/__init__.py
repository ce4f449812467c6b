from xmca_tpu_torch.parallel.mesh import (make_mesh, distribute_array,
                                          sharded_solve)

__all__ = ['make_mesh', 'distribute_array', 'sharded_solve']
