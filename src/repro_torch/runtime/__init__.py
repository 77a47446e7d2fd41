"""Runtime of the port: the host plane's scheduler, the device serving
engine, the sharded one, the redundancy plane, the fleet's control plane
(``control.py``) and cluster simulator (``cluster.py``), and the
fault-tolerant trainer (``trainer.py``)."""
from repro_torch.runtime.serve_sched import ServeConfig, ServeScheduler  # noqa: F401
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig  # noqa: F401
from repro_torch.runtime.sharded_engine import ShardedServingEngine  # noqa: F401
from repro_torch.runtime.cluster import (ClusterConfig, ClusterReport,  # noqa: F401
                                         ClusterSim, HostSpec,
                                         homogeneous_cluster)
from repro_torch.runtime.control import (AutoscalePolicy, AutoscaleResult,  # noqa: F401
                                         CapacityPlan, ControlledHost,
                                         DegradePolicy, FailoverPlan,
                                         HostControl, autoscale_assign,
                                         autoscale_run, autoscale_schedule,
                                         build_controls, plan_capacity,
                                         rewrite_assignment)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
