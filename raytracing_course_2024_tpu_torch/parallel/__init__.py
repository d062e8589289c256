from .shard import (Mesh, init_distributed, make_mesh, make_multihost_mesh,
                    render_frame_sharded)

__all__ = ["Mesh", "init_distributed", "make_mesh", "make_multihost_mesh",
           "render_frame_sharded"]
