"""Serving runtime of the port: the host plane's scheduler, the device
serving engine, the sharded one and the redundancy plane."""
from repro_torch.runtime.serve_sched import ServeConfig, ServeScheduler  # noqa: F401
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig  # noqa: F401
from repro_torch.runtime.sharded_engine import ShardedServingEngine  # noqa: F401
