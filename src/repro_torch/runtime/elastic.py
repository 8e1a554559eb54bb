"""Elastic training runtime, port of ``repro.runtime.elastic``:
checkpoint/restart + mesh shrink/grow on (simulated) node failure,
deterministic data replay.

The contract with real hardware: a node failure surfaces as an exception
from the step function or as a missing heartbeat; the runner then (1)
rebuilds the largest usable mesh from the surviving devices, (2) rebuilds
the step for the new mesh, (3) restores the last published checkpoint onto
it (checkpoint/manager stores leaves unsharded), and (4) replays the data
cursor — the pipeline is stateless-addressable so `step` is the only
cursor (data/tokens.py).

In the reference a mesh is a ``jax.sharding.Mesh`` over ``jax.devices()``.
Here a mesh stays the list of ``torch.device``s the step runs on (one card
may stand for several logical replicas), and ``state_shardings(mesh,
state_like)`` names the device the checkpoint is restored onto.  It is not
a ``DeviceMesh`` (``launch/mesh.py``): a ``DeviceMesh`` spans the ranks of
a process group, which is fixed when the group starts, so a runner inside
one process cannot shrink or grow it; the re-meshes it simulates are of
the replicas it runs itself.  This module is hardware-agnostic: `DeviceFailure` is
raised by the fault injector in tests, and by a heartbeat watchdog in a
real deployment.  Global batch is preserved across re-meshes (per-device
batch rescales), so the training trajectory stays comparable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager


class DeviceFailure(RuntimeError):
    """Raised when a device/host is lost (injected in tests; mapped from
    runtime errors in deployment)."""


@dataclass
class ElasticConfig:
    ckpt_every: int = 20
    max_failures: int = 8
    min_devices: int = 1


@dataclass
class ElasticRunner:
    make_step: Callable          # (mesh) -> step_fn(state, batch) -> state, metrics
    init_state: Callable         # (mesh) -> state tree
    state_shardings: Callable    # (mesh, state_like) -> the restore's device
    data_fn: Callable            # (step) -> batch (numpy, global)
    ckpt: CheckpointManager
    cfg: ElasticConfig = field(default_factory=ElasticConfig)

    def _usable_devices(self, devices):
        """Largest power-of-two prefix (keeps meshes well-shaped)."""
        n = 1 << int(math.log2(max(len(devices), 1)))
        return devices[:n]

    def make_mesh(self, devices) -> list:
        """The mesh: the largest power-of-two prefix of ``devices``."""
        return [torch.device(d) for d in self._usable_devices(devices)]

    def _restore(self, mesh, state_like):
        return self.ckpt.restore(
            state_like, device=self.state_shardings(mesh, state_like))

    def run(self, n_steps: int, devices=None, fail_at: dict | None = None):
        """fail_at: {step: n_devices_to_kill} fault injection for tests.
        ``devices``: a list of ``torch.device``s (default: every visible
        card).  Returns (state, log)."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("ElasticRunner.run: no CUDA device is "
                                   "visible; pass devices= explicitly")
        devices = list(devices)
        fail_at = dict(fail_at or {})
        log = {"remesh_steps": [], "device_counts": [], "losses": []}

        mesh = self.make_mesh(devices)
        step_fn = self.make_step(mesh)
        state = self.init_state(mesh)
        start = 0
        if self.ckpt.latest_step() is not None:
            state, start = self._restore(mesh, state)
            start += 1

        step = start
        failures = 0
        while step < n_steps:
            try:
                if step in fail_at:
                    kill = fail_at.pop(step)
                    devices = devices[: max(len(devices) - kill,
                                            self.cfg.min_devices)]
                    raise DeviceFailure(f"lost {kill} devices at step {step}")
                batch = self.data_fn(step)
                state, metrics = step_fn(state, batch)
                log["losses"].append(float(metrics.get("loss", np.nan)))
                log["device_counts"].append(len(mesh))
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
            except DeviceFailure as e:
                failures += 1
                if failures > self.cfg.max_failures:
                    raise RuntimeError("too many failures") from e
                # --- elastic re-mesh ---
                mesh = self.make_mesh(devices)
                step_fn = self.make_step(mesh)
                state_like = self.init_state(mesh)
                try:
                    state, last = self._restore(mesh, state_like)
                    step = last + 1
                except FileNotFoundError:
                    state, step = state_like, 0
                log["remesh_steps"].append(step)
        self.ckpt.wait()
        return state, log
