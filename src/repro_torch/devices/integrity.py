"""Media-error plane: wear-dependent UBER, checksums, ECC retry ladder.

SCM media is not just slow — it *lies*. Nand and 3DXP parts quote an
uncorrectable bit-error rate (UBER) that rises with program/erase wear and
with read disturb on hot rows, and controllers recover from it with an
escalating read-retry ladder (re-read at shifted reference voltages, each
step another media access). This module models that physics for the
simulated device planes:

* :class:`IntegritySpec` — the error model: base UBER expressed as a
  per-row corruption probability per read, scaled up by cumulative
  model-refresh writes (the ``UpdateStream`` wear coupling) and by
  per-row-group read-disturb counters; the ECC retry ladder (per-step
  latency multipliers of the device's base latency, sampled with the
  device's ``service_cv`` dispersion) and its per-step correction
  probability; and the checksum switch — with ``checksums=False`` corrupt
  rows go *undetected* and (on materialized stores) poison pooled outputs,
  which is how the test suite proves the injection is real rather than
  bookkeeping.
* :class:`MediaErrorModel` — one seeded instance per device plane: draws
  corruption counts binomially per submission element (consumed in
  submission order, so a fixed seed fully determines a run — the same
  contract as :class:`~repro_torch.devices.sim.DeviceSim`), walks corrupt rows
  through the retry ladder, and tracks the wear state (reads per disturb
  group, refresh-wave decay).
* :func:`row_checksums` / :func:`verify_rows` — the actual end-to-end
  checksum arithmetic used when payloads are materialized: computed at
  fill/refresh time, verified against the returned rows, and sensitive to
  any single bit flip.

A spec with ``uber=0`` consumes no RNG and never perturbs a latency — the
zero-error oracle (integrity plane attached == vanilla run, bit for bit)
holds by construction. The replication/hedging/rebuild side lives in
:mod:`repro_torch.runtime.redundancy`, which composes this model into the
IO-engine hook.

A copy of ``repro.devices.integrity`` (``tests/test_torch_devices.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from repro_torch.core.io_sim import DeviceModel

_MAGIC = 0x1B7E6            # integrity RNG salt (cf. 0xD54E device sim)


def _finite(name: str, v: float, lo: float = 0.0) -> None:
    if not (isinstance(v, (int, float)) and math.isfinite(v) and v >= lo):
        raise ValueError(f"{name} must be finite and >= {lo}, got {v!r}")


@dataclasses.dataclass(frozen=True)
class IntegritySpec:
    """Media-error model + detection policy for one device plane.

    ``uber`` is the base probability a returned row is corrupt, per read —
    the row-granular stand-in for the bit-level UBER at the device's row
    size. The effective rate for a submission is::

        p = uber * (1 + wear_scale * cumulative_update_GiB)
                 * (1 + disturb_scale * group_reads / 1e6)

    where cumulative update writes come from the sampled write plane's
    :class:`~repro_torch.devices.writes.UpdateStream` (wave count x chunk bytes)
    and ``group_reads`` is the read-disturb counter of the row group the
    submission lands on (groups mirror the residency rotation; a refresh
    wave rewrites rows in place and decays every group by
    ``disturb_refresh`` reads — the approximation is at row-group, not
    single-row, granularity).
    """
    uber: float = 0.0                   # base P(row corrupt) per read
    wear_scale: float = 0.0             # UBER growth per GiB of update writes
    disturb_scale: float = 0.0          # UBER growth per 1e6 group reads
    disturb_groups: int = 8             # read-disturb counter granularity
    disturb_refresh: float = 50_000.0   # reads forgiven per refresh wave
    # ECC read-retry ladder: step k re-reads at base_latency_us * ladder[k]
    # (sampled with the device's service_cv dispersion); each step corrects
    # with probability retry_success. An exhausted ladder falls back to a
    # replica read (runtime/redundancy.py) or an SM re-fetch.
    retry_ladder: Tuple[float, ...] = (1.0, 2.0, 4.0)
    retry_success: float = 0.75
    refetch_penalty: float = 20.0       # SM re-fetch, in base-latency units
    # detection: per-row checksums verified on every read result. False =
    # silent corruption (test/demo mode: proves the injection would reach
    # pooled outputs).
    checksums: bool = True

    def __post_init__(self):
        if not (isinstance(self.uber, (int, float))
                and 0.0 <= self.uber <= 1.0):
            raise ValueError(f"uber must be in [0, 1], got {self.uber!r}")
        _finite("wear_scale", self.wear_scale)
        _finite("disturb_scale", self.disturb_scale)
        _finite("disturb_refresh", self.disturb_refresh)
        if self.disturb_groups < 1:
            raise ValueError("disturb_groups must be >= 1")
        if not self.retry_ladder:
            raise ValueError("retry_ladder must have at least one step")
        for f in self.retry_ladder:
            _finite("retry_ladder step", f)
        if not (0.0 < self.retry_success <= 1.0):
            raise ValueError(
                f"retry_success must be in (0, 1], got {self.retry_success!r}")
        _finite("refetch_penalty", self.refetch_penalty)

    @property
    def active(self) -> bool:
        """True when the spec can ever mark a row corrupt."""
        return self.uber > 0.0


@dataclasses.dataclass
class IntegrityStats:
    """Counters for one device plane's integrity activity. The first four
    roll up through ``QueryStats`` -> ``HostReport`` -> ``ClusterReport``;
    the rest are plane-level diagnostics."""
    corrupt_reads: int = 0       # rows whose checksum failed on first read
    retry_steps: int = 0         # ECC ladder steps paid
    hedged_reads: int = 0        # duplicate reads issued against replicas
    repair_ios: int = 0          # extra IOs: retries + replica + re-fetch + hedges
    retry_recovered: int = 0     # rows the ladder corrected
    replica_reads: int = 0       # rows served/recovered from the replica
    refetch_reads: int = 0       # rows re-fetched from the SM source of truth
    hedge_wins: int = 0          # hedges that beat the primary
    undetected: int = 0          # checksums off: corrupt rows served silently
    rows_lost: int = 0           # rows on a lost device (device_loss events)
    rows_rebuilt: int = 0        # rows re-replicated by the rebuild stream


class MediaErrorModel:
    """Seeded wear/corruption/retry model for one device plane.

    Draws are consumed in submission order (binomial corruption counts,
    then per-corrupt-row ladder walks), so serial/thread/process cluster
    runs and streamed/materialized traces that issue the same submission
    sequence see identical errors — the parity contract every other seeded
    plane in this repo honors.
    """

    def __init__(self, spec: IntegritySpec, device: DeviceModel,
                 seed: int = 0):
        self.spec = spec
        self.device = device
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, _MAGIC]))
        self._sigma = math.sqrt(math.log(1.0 + device.service_cv ** 2))
        self._disturb = np.zeros(spec.disturb_groups, np.float64)
        self._rr = 0                     # group rotation (mirrors residency)
        self._wear_gib = 0.0             # cumulative update writes observed
        self._waves_seen = 0

    # -- wear state ----------------------------------------------------------

    def observe_update(self, waves: int, chunk_bytes: int) -> None:
        """Couple to the write plane: ``waves`` is the update stream's
        cumulative wave count. New waves add wear and refresh (decay) the
        read-disturb counters — a rewrite clears disturb on what it
        rewrote."""
        new = waves - self._waves_seen
        if new <= 0:
            return
        self._waves_seen = waves
        self._wear_gib += new * chunk_bytes / 2.0**30
        if self.spec.disturb_refresh > 0.0:
            np.maximum(self._disturb - new * self.spec.disturb_refresh
                       / len(self._disturb), 0.0, out=self._disturb)

    def note_reads(self, num_ios: int) -> int:
        """Account ``num_ios`` reads against the current disturb group
        (rotating, like the device sim's residency pointer); returns the
        group index the submission landed on."""
        g = self._rr
        self._rr = (g + 1) % len(self._disturb)
        self._disturb[g] += num_ios
        return g

    def p_corrupt(self, group: int) -> float:
        """Effective per-row corruption probability right now."""
        s = self.spec
        p = s.uber * (1.0 + s.wear_scale * self._wear_gib) \
            * (1.0 + s.disturb_scale * self._disturb[group] / 1e6)
        return min(p, 1.0)

    # -- corruption + recovery ----------------------------------------------

    def draw_corrupt(self, num_ios: np.ndarray, p: float) -> np.ndarray:
        """Corrupt-row count per submission element (binomial, seeded)."""
        return self.rng.binomial(num_ios, p)

    def _step_latency_us(self, factor: float) -> float:
        """One ladder step / re-read, sampled like a device service wave."""
        mean = self.device.base_latency_us * factor
        if self.device.service_cv <= 0.0:
            return mean
        mu = math.log(mean) - 0.5 * self._sigma ** 2
        return float(self.rng.lognormal(mu, self._sigma))

    def recover_rows(self, k: int, stats: IntegrityStats,
                     replica_p: float = -1.0) -> float:
        """Walk ``k`` corrupt rows through the retry ladder; returns the
        slowest row's recovery chain latency (rows recover concurrently —
        the submission completes when its worst row does).

        ``replica_p >= 0`` enables the replica fallback at that corruption
        probability (the replica wears independently); ``< 0`` means no
        replica — an exhausted ladder goes straight to the SM re-fetch.
        With ``checksums=False`` nothing is detected: the rows are served
        corrupt and only ``undetected`` is bumped."""
        s = self.spec
        if not s.checksums:
            stats.undetected += k
            return 0.0
        stats.corrupt_reads += k
        worst = 0.0
        for _ in range(k):
            chain = 0.0
            recovered = False
            for factor in s.retry_ladder:
                chain += self._step_latency_us(factor)
                stats.retry_steps += 1
                stats.repair_ios += 1
                if self.rng.random() < s.retry_success:
                    recovered = True
                    stats.retry_recovered += 1
                    break
            if not recovered and replica_p >= 0.0:
                chain += self._step_latency_us(1.0)
                stats.replica_reads += 1
                stats.repair_ios += 1
                recovered = self.rng.random() >= replica_p
            if not recovered:
                # both copies bad (or no replica): re-fetch from the SM
                # source of truth — always succeeds, at catalog latency
                chain += self._step_latency_us(s.refetch_penalty)
                stats.refetch_reads += 1
                stats.repair_ios += 1
            worst = max(worst, chain)
        return worst

    def sample_read_us(self, n: int = 1) -> np.ndarray:
        """Independent replica-read latency samples (base latency with the
        device's dispersion) — hedges and loss fallbacks go to a *different*
        device inside the host, modeled as an unloaded independent plane."""
        mean = self.device.base_latency_us
        if self.device.service_cv <= 0.0:
            return np.full(n, mean, np.float64)
        mu = math.log(mean) - 0.5 * self._sigma ** 2
        return self.rng.lognormal(mu, self._sigma, n)


# -- end-to-end checksum arithmetic (materialized payloads) -------------------

_CKSUM_MULT = np.uint64(0x9E3779B97F4A7C15)


def row_checksums(rows: np.ndarray) -> np.ndarray:
    """Per-row checksum of a [n, dim] float32 payload array: a multiply-mix
    over the raw bit patterns. Computed at fill/refresh time; any single
    bit flip in a row changes its checksum (pinned by the unit test)."""
    bits = np.ascontiguousarray(rows, np.float32).view(np.uint32) \
        .astype(np.uint64)
    pos = np.arange(bits.shape[-1], dtype=np.uint64) + np.uint64(1)
    mixed = (bits + pos) * _CKSUM_MULT
    return (mixed ^ (mixed >> np.uint64(31))).sum(axis=-1, dtype=np.uint64)


def verify_rows(rows: np.ndarray, checksums: np.ndarray) -> np.ndarray:
    """Boolean mask of rows whose recomputed checksum matches."""
    return row_checksums(rows) == np.asarray(checksums, np.uint64)
