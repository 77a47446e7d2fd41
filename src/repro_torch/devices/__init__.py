"""Event-driven SCM device plane (queues, write interference, §4.1 tuning).

The sampled counterpart to the analytic latency model in ``core/io_sim``:
``DeviceSim`` simulates per-device submission/completion queues with sampled
per-wave service times, ``UpdateSpec``/``UpdateStream`` add the
endurance-bounded model-update write plane, and ``DeviceTuning`` exposes the
paper's §4.1 tuning API (outstanding-IO throttling, burst smoothing,
read-priority scheduling). Select it per store with
``SDMConfig(latency_mode="sampled")``. ``integrity.py`` is the media-error
plane the redundancy plane (``runtime/redundancy.py``) composes. Copies of
``repro.devices``.
"""
from repro_torch.devices.integrity import (IntegritySpec,  # noqa: F401
                                           IntegrityStats, MediaErrorModel,
                                           row_checksums, verify_rows)
from repro_torch.devices.sim import DeviceSim  # noqa: F401
from repro_torch.devices.tuning import DEFAULT_TUNING, DeviceTuning  # noqa: F401
from repro_torch.devices.writes import UpdateSpec, UpdateStream  # noqa: F401
