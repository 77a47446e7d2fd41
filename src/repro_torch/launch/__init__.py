"""Launch helpers of the port: the shard mesh of the sharded embedding store
and its layouts; the LM launch study (sharding plans, abstract steps, the
fake-mesh dry-run and its reports) in ``sharding``, ``steps``, ``dryrun``,
``collectives_report`` and ``inspect_hlo``."""
from repro_torch.launch.mesh import EmbedMesh, make_embed_mesh  # noqa: F401
from repro_torch.launch.sharding import EMBED_LAYOUTS, check_layout  # noqa: F401
