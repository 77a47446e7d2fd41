"""Launch helpers of the port: the shard mesh of the sharded embedding store
and its layouts."""
from repro_torch.launch.mesh import EmbedMesh, make_embed_mesh  # noqa: F401
from repro_torch.launch.sharding import EMBED_LAYOUTS, check_layout  # noqa: F401
