"""Redundancy plane: k-way replication, hedged reads, scrub/rebuild stream.

This is the host-side half of the data-integrity story. The media half
(:mod:`repro_torch.devices.integrity`) decides *when* rows come back corrupt and
what the ECC retry ladder costs; this module decides what the host does
about it:

* :class:`ReplicationSpec` — the layout and recovery policy: ``k`` copies
  of every SM row striped across the host's devices (k=2 default — primary
  on device ``i``, replica on ``i+1 mod n``), hedged reads that duplicate a
  slow primary read to the replica after ``hedge_after_us``, and the
  rebuild stream's shape (wave size / gap / IO cost) used after a
  ``device_loss`` failure event.
* :class:`RebuildStream` — the background re-replication worker. It is
  deliberately the same shape as :class:`~repro_torch.devices.writes.UpdateStream`
  (``pop_until`` yielding ``(at_us, service_us)`` waves) so the sampled
  device plane admits rebuild waves into the *same* channel-slot ledger as
  model-refresh writes — rebuild traffic competes with foreground reads
  exactly like the write plane does. In analytic mode the stream instead
  contributes ``rebuild_iops`` to the background-load term of the
  closed-form latency.
* :class:`RedundancyPlane` — the single object the IO engine consults
  (``IOEngine.integrity``). It owns the media-error model, the replica
  layout, the hedging decision, the rebuild stream, and the
  :class:`~repro_torch.devices.integrity.IntegrityStats` counters that roll up
  into host and cluster reports.

Determinism contract: all randomness flows through the media model's
seeded generator, consumed in submission order; a plane whose spec is
inert (``uber=0``, hedging off, no device loss) consumes **zero** draws
and returns every latency unchanged, so attaching it to a host is
bit-invisible — the oracle ``tests/test_integrity.py`` pins.

A copy of ``repro.runtime.redundancy`` (``tests/test_torch_devices.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.io_sim import DeviceModel
from repro_torch.devices.integrity import (IntegritySpec, IntegrityStats,
                                           MediaErrorModel)


def _finite(name: str, v: float, lo: float = 0.0) -> None:
    if not (isinstance(v, (int, float)) and math.isfinite(v) and v >= lo):
        raise ValueError(f"{name} must be finite and >= {lo}, got {v!r}")


@dataclasses.dataclass(frozen=True)
class ReplicationSpec:
    """Row-replication layout + hedging + rebuild policy for one host."""
    k: int = 2                          # copies per row (1 = no replica)
    # hedged reads: if the primary submission's modeled latency exceeds this,
    # fire a duplicate read at the replica and take the faster completion.
    # inf disables hedging (and consumes no RNG).
    hedge_after_us: float = math.inf
    # rebuild stream (after a device_loss event): rows re-replicated per
    # wave, mean gap between waves, and the per-wave channel service time
    # as a multiple of the device's base latency.
    rebuild_rows_per_wave: int = 4096
    rebuild_gap_us: float = 400.0
    rebuild_service_factor: float = 4.0
    # analytic-mode interference: background IOPS the rebuild adds while
    # active (sampled mode uses the wave stream through the channel ledger
    # instead).
    rebuild_iops: float = 20_000.0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"replication k must be >= 1, got {self.k!r}")
        if not (isinstance(self.hedge_after_us, (int, float))
                and self.hedge_after_us > 0.0
                and not math.isnan(self.hedge_after_us)):
            raise ValueError(
                f"hedge_after_us must be > 0 (inf = off), "
                f"got {self.hedge_after_us!r}")
        if self.rebuild_rows_per_wave < 1:
            raise ValueError("rebuild_rows_per_wave must be >= 1")
        _finite("rebuild_gap_us", self.rebuild_gap_us)
        if self.rebuild_gap_us <= 0.0:
            raise ValueError("rebuild_gap_us must be > 0")
        _finite("rebuild_service_factor", self.rebuild_service_factor)
        _finite("rebuild_iops", self.rebuild_iops)

    @property
    def hedging(self) -> bool:
        return math.isfinite(self.hedge_after_us)


class RebuildStream:
    """Background re-replication after a device loss.

    Mirrors :class:`~repro_torch.devices.writes.UpdateStream`'s ``pop_until``
    interface so :meth:`DeviceSim._admit_writes` can admit rebuild waves
    into the channel-slot ledger alongside model-refresh writes. Waves are
    evenly spaced (``gap_us``) — rebuild is a paced scanner, not a Poisson
    process — and the stream exhausts itself (``next_us = inf``) once every
    lost row has been re-replicated."""

    def __init__(self, spec: ReplicationSpec, device: DeviceModel):
        self.spec = spec
        self.device = device
        self.rows_total = 0
        self.rows_done = 0
        self.next_us = math.inf
        self.waves = 0
        self._service_us = device.base_latency_us * spec.rebuild_service_factor

    @property
    def active(self) -> bool:
        return self.rows_done < self.rows_total

    def start(self, at_us: float, rows: int) -> None:
        """Arm the stream: ``rows`` rows to re-replicate, first wave one
        gap after the loss."""
        self.rows_total += rows
        if math.isinf(self.next_us):
            self.next_us = at_us + self.spec.rebuild_gap_us

    def pop_until(self, t_us: float):
        """Yield ``(at_us, service_us)`` rebuild waves due by ``t_us``,
        advancing internal progress. Same contract as
        ``UpdateStream.pop_until``."""
        while self.next_us <= t_us and self.active:
            at = self.next_us
            self.rows_done = min(
                self.rows_done + self.spec.rebuild_rows_per_wave,
                self.rows_total)
            self.waves += 1
            if self.active:
                self.next_us = at + self.spec.rebuild_gap_us
            else:
                self.next_us = math.inf
            yield at, self._service_us

    def drain(self, t_us: float) -> None:
        """Advance progress to ``t_us`` without yielding (analytic mode —
        no channel ledger to admit into)."""
        for _ in self.pop_until(t_us):
            pass

    def reset_clock(self) -> None:
        """Measurement-boundary rewind (``DeviceSim.reset_clock`` contract):
        an in-flight rebuild re-schedules its next wave from t=0; progress
        (rows_done) is state, not clock, and persists."""
        if self.active:
            self.next_us = self.spec.rebuild_gap_us


class RedundancyPlane:
    """Per-host data-integrity plane attached to the IO engine.

    The engine calls :meth:`extra_bg_iops` before computing a submission's
    latency (analytic-mode rebuild interference) and :meth:`apply` after
    (corruption draws, retry ladders, hedging, loss fallbacks). In sampled
    mode the rebuild stream is also registered in
    ``DeviceSim.extra_streams`` so waves occupy real channel slots."""

    def __init__(self, integrity: Optional[IntegritySpec],
                 replication: Optional[ReplicationSpec],
                 device: DeviceModel, num_devices: int, total_rows: int,
                 seed: int = 0, sim=None):
        self.integrity = integrity if integrity is not None \
            else IntegritySpec()
        self.replication = replication if replication is not None \
            else ReplicationSpec()
        self.device = device
        self.num_devices = max(1, int(num_devices))
        self.total_rows = max(1, int(total_rows))
        self.seed = seed
        self.sim = sim
        self.model = MediaErrorModel(self.integrity, device, seed)
        self.stats = IntegrityStats()
        self.telemetry = None   # obs handle; None = bit-invisible
        self.rebuild = RebuildStream(self.replication, device)
        self._lost_remaining = 0         # rows still without full redundancy
        self._rebuilt_ack = 0            # rebuild progress folded into stats
        if sim is not None:
            sim.extra_streams.append(self.rebuild)

    # -- hot-path predicates (cheap, checked per submission) -----------------

    @property
    def inert(self) -> bool:
        """True when apply() is a guaranteed no-op that consumes no RNG:
        nothing corrupts, nothing hedges, nothing was lost, nothing
        rebuilds."""
        return (not self.integrity.active
                and not self.replication.hedging
                and self._lost_remaining == 0
                and not self.rebuild.active)

    # -- IO-engine hooks -----------------------------------------------------

    def extra_bg_iops(self, at_us: float) -> float:
        """Analytic-mode rebuild interference: while the rebuild stream is
        active it adds ``rebuild_iops`` of background load (sampled mode
        returns 0 — waves occupy channel slots instead)."""
        if self.sim is not None or not self.rebuild.active:
            return 0.0
        return self.replication.rebuild_iops

    def apply(self, at_us, num_ios: np.ndarray,
              lat_us: np.ndarray) -> np.ndarray:
        """Post-latency integrity pass over one submission batch.

        Deterministic order per submission: (1) advance rebuild progress to
        the submission clock; (2) observe write-plane wear; (3) hedging
        mask + replica samples; (4) loss-window fallback reads; (5)
        binomial corruption draws and per-corrupt-row recovery chains.
        Scalar ``at_us`` applies one clock to the whole batch (analytic
        batches); an array applies per-element clocks (sorted arrival
        order, matching ``DeviceSim.submit_batch``)."""
        if self.inert:
            return lat_us
        n = np.asarray(num_ios)
        lat = np.asarray(lat_us, np.float64).copy()
        at = np.asarray(at_us, np.float64)
        t_max = float(at.max()) if at.size else 0.0
        self._advance(t_max)

        spec = self.integrity
        rep = self.replication
        model = self.model
        stats = self.stats
        nz = np.nonzero(n > 0)[0]

        # (3) hedged reads: duplicate a slow primary to the replica and
        # take the faster path. The replica is an independent device inside
        # the host (unloaded plane sample), so the hedge completes at
        # hedge_after + replica_read — a tail cut, not a mean cut.
        if rep.hedging and rep.k >= 2 and nz.size:
            slow = nz[lat[nz] > rep.hedge_after_us]
            if slow.size:
                alt = rep.hedge_after_us + model.sample_read_us(slow.size)
                wins = alt < lat[slow]
                lat[slow] = np.minimum(lat[slow], alt)
                stats.hedged_reads += int(slow.size)
                stats.repair_ios += int(slow.size)
                stats.hedge_wins += int(wins.sum())
                if self.telemetry is not None:
                    self.telemetry.tracer.span(
                        "io.hedged_read", "integrity", t_max,
                        float(lat[slow].max()), n=int(slow.size),
                        wins=int(wins.sum()))

        # (4) device loss: until the rebuild restores redundancy, a read
        # has P(primary on the dead device and not yet rebuilt); those rows
        # are served from the replica (extra read) — or re-fetched from the
        # SM when k==1 left no surviving copy.
        if self._lost_remaining > 0 and nz.size:
            p_lost = min(self._lost_remaining / self.total_rows, 1.0)
            hit = model.rng.binomial(n[nz], p_lost)
            hz = np.nonzero(hit > 0)[0]
            for j in hz:
                i = nz[j]
                k = int(hit[j])
                if rep.k >= 2:
                    extra = float(model.sample_read_us(k).max())
                    stats.replica_reads += k
                else:
                    extra = model._step_latency_us(spec.refetch_penalty)
                    stats.refetch_reads += k
                stats.repair_ios += k
                lat[i] += extra

        # (5) media corruption: binomial per element at the current
        # wear/disturb-scaled rate, then the ECC retry ladder per corrupt
        # row (replica fallback when k >= 2).
        if spec.active and nz.size:
            group = model.note_reads(int(n[nz].sum()))
            p = model.p_corrupt(group)
            if p > 0.0:
                bad = model.draw_corrupt(n[nz], p)
                bz = np.nonzero(bad > 0)[0]
                replica_p = p if rep.k >= 2 else -1.0
                for j in bz:
                    lat[nz[j]] += model.recover_rows(
                        int(bad[j]), stats, replica_p)
                if bz.size and self.telemetry is not None:
                    self.telemetry.recorder.record(
                        t_max, "retry_ladder", rows=int(bad[bz].sum()))

        return lat if isinstance(lat_us, np.ndarray) else type(lat_us)(lat)

    def apply_scalar(self, at_us: float, num_ios: int,
                     lat_us: float) -> float:
        """Single-submission convenience wrapper (sequential serve path)."""
        if self.inert:
            return lat_us
        out = self.apply(np.asarray([at_us]), np.asarray([num_ios]),
                         np.asarray([lat_us], np.float64))
        return float(out[0])

    # -- failure / rebuild lifecycle -----------------------------------------

    def device_loss(self, at_us: float) -> int:
        """A device died: 1/num_devices of all rows lose a copy. Arms the
        rebuild stream to re-replicate them; returns the row count lost."""
        rows = self.total_rows // self.num_devices
        self.stats.rows_lost += rows
        self._lost_remaining += rows
        self.rebuild.start(at_us, rows)
        if self.telemetry is not None:
            self.telemetry.recorder.record(at_us, "rebuild_start", rows=rows)
        return rows

    def _advance(self, t_us: float) -> None:
        """Fold elapsed background activity into plane state: rebuild
        progress (analytic mode drains here; sampled mode progresses via
        the channel ledger but shares the same stream object) and
        write-plane wear observation."""
        if self.rebuild.rows_total > 0:
            if self.sim is None:
                self.rebuild.drain(t_us)
            done = self.rebuild.rows_done
            new = done - self._rebuilt_ack
            if new > 0:
                self._rebuilt_ack = done
                self.stats.rows_rebuilt += new
                self._lost_remaining = max(0, self._lost_remaining - new)
                if self._lost_remaining == 0 and self.telemetry is not None:
                    self.telemetry.recorder.record(
                        t_us, "rebuild_complete",
                        rows=self.stats.rows_rebuilt)
        if self.sim is not None and (self.integrity.wear_scale > 0.0
                                     or self.integrity.disturb_scale > 0.0):
            upd = self.sim.update
            if upd is not None:
                self.model.observe_update(upd.waves, upd.spec.chunk_bytes)

    def advance(self, t_us: float) -> None:
        """End-of-measurement hook: drain the rebuild stream to ``t_us`` so
        conservation (rows_lost == rows_rebuilt once rebuilt) is visible in
        the report even if no foreground read arrived after the last
        wave."""
        if self.sim is not None:
            # sampled mode: drain waves due by t_us ourselves — pop_until
            # is monotone, so the ledger (which popped up to its own clock)
            # and this drain never double-pop the same wave.
            self.rebuild.drain(t_us)
        self._advance(t_us)

    def take_undetected(self) -> int:
        """Consume the undetected-corruption count (checksums off). Used by
        the store's poison hook to perturb pooled outputs — proving the
        injection reaches real data when detection is disabled."""
        u = self.stats.undetected
        self.stats.undetected = 0
        return u

    # -- lifecycle plumbing --------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the measurement counters (warmup boundary). Wear, disturb
        and rebuild *state* persist — only the counters reset, mirroring
        how ``reset_measurement`` rewinds clocks but not RNGs."""
        self.stats = IntegrityStats()

    def begin_replay(self) -> None:
        """Full reset for a fresh controlled replay: new stats, fresh RNG,
        fresh wear state, rebuild disarmed. Mirrors
        ``ControlledHost.begin_replay``'s contract that every replay of the
        same trace is bit-identical."""
        self.stats = IntegrityStats()
        self.model = MediaErrorModel(self.integrity, self.device, self.seed)
        old = self.rebuild
        self.rebuild = RebuildStream(self.replication, self.device)
        self._lost_remaining = 0
        self._rebuilt_ack = 0
        if self.sim is not None:
            streams = self.sim.extra_streams
            if old in streams:
                streams[streams.index(old)] = self.rebuild
            else:
                streams.append(self.rebuild)
