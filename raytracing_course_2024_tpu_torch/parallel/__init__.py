from .shard import Mesh, make_mesh, render_frame_sharded

__all__ = ["Mesh", "make_mesh", "render_frame_sharded"]
