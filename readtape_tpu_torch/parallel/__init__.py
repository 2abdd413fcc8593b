from .mesh import (get_decode_mesh, make_decode_mesh, set_decode_mesh,
                   sharded_decode_step)

__all__ = ["get_decode_mesh", "make_decode_mesh", "set_decode_mesh",
           "sharded_decode_step"]
