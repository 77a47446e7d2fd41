"""Serving runtime of the port: the device serving engine and the sharded
one."""
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig  # noqa: F401
from repro_torch.runtime.sharded_engine import ShardedServingEngine  # noqa: F401
