"""Fault tolerance: supervised training with checkpoint/restart, straggler
timeouts and re-placement of the state, as in the JAX package's
``repro/train/fault_tolerance.py``.

Faults are exercised by injection (a step function raises at chosen
steps). The pieces:

* ``Supervisor.run`` — drives the step function; on an exception it
  restores the last committed checkpoint and replays. Batches are a function
  of (seed, step), so the replay follows the optimizer trajectory of an
  uninterrupted run. A fault before the first checkpoint resumes at step 0
  without resetting the state, as in the reference. Under a mesh
  (``distributed.sharding.axis_rules``) the ranks hold one state, so rank 0
  alone writes each checkpoint, after a barrier, and every rank restores
  (after rank 0's write has landed).
* ``StragglerMonitor`` — a step slower than ``straggler_factor`` times the
  median of the last 50 steps is an event (and calls ``on_straggler``).
* ``elastic_remesh`` — rebuilds the step for a new placement and restores
  the state onto it from the last checkpoint, which is stored unsharded:
  on a new mesh every rank restores the whole state onto ``state_like``'s
  tensors (their devices and dtypes), after a barrier, and given the
  parameters' specs on the new mesh keeps this rank's shard of every
  parameter, moment and residual; on one process the placement is a
  device.

A sharded state is gathered whole for a checkpoint (``save_state`` runs on
every rank), so rank 0 writes what a replicated run writes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.distributed.shard import map_tree, shard_leaf
from repro_torch.distributed.sharding import current_mesh
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0     # step slower than median×factor => slow
    min_steps_for_median: int = 5


class StragglerMonitor:
    def __init__(self, cfg: FTConfig, on_straggler: Optional[Callable] = None):
        self.cfg = cfg
        self.times: list[float] = []
        self.on_straggler = on_straggler
        self.events: list[int] = []

    def record(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) >= self.cfg.min_steps_for_median:
            window = sorted(self.times[-50:])
            med = window[len(window) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.events.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)


class Supervisor:
    """Checkpoint/restart driver around an arbitrary step closure."""

    def __init__(self, cfg: FTConfig, *, save_state: Callable[[], Any],
                 load_state: Callable[[Any], None]):
        self.cfg = cfg
        self.save_state = save_state      # () -> tree of the current state
        self.load_state = load_state      # tree -> install state
        self.ckptr = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.monitor = StragglerMonitor(cfg)
        self.restarts = 0

    def _restore_latest(self) -> int:
        mesh = current_mesh()
        if mesh is not None:
            mesh.barrier()               # rank 0's last write has landed
        step = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0
        self.load_state(ckpt_lib.restore(self.cfg.ckpt_dir, step, self.save_state()))
        return step

    def _save(self, step: int) -> None:
        mesh = current_mesh()
        if mesh is None:
            self.ckptr.save(step, self.save_state())
            return
        state = self.save_state()        # every rank: a sharded leaf is gathered
        mesh.barrier()
        if mesh.rank == 0:
            self.ckptr.save(step, state)

    def run(self, step_fn: Callable[[int], dict], total_steps: int,
            start_step: int = 0) -> list[dict]:
        """step_fn(step) -> metrics. Restores and replays on a failure."""
        logs = []
        step = start_step
        while step < total_steps:
            try:
                t0 = time.monotonic()
                metrics = step_fn(step)
                self.monitor.record(step, time.monotonic() - t0)
                logs.append({"step": step, **metrics})
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == total_steps:
                    self._save(step)
            except KeyboardInterrupt:
                raise
            except Exception as e:                       # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}") from e
                self.ckptr.wait()
                step = self._restore_latest()
                logs.append({"step": step, "event": "restart", "error": repr(e)})
        self.ckptr.wait()
        return logs


def elastic_remesh(make_step_for_mesh: Callable[[Any], Callable], new_mesh,
                   ckpt_dir: str, state_like: Any, specs=None):
    """Rebuild the step for ``new_mesh`` and restore the last checkpoint
    onto ``state_like``'s placement (its tensors' devices and dtypes, whole
    shapes) -> (step function, state, step). ``new_mesh`` is a
    ``launch.mesh.Mesh`` (every rank of it calls this and restores the
    whole state) or, on one process, a device. ``specs``: the parameters'
    spec tree re-derived for ``new_mesh`` (``launch.specs.param_specs``);
    the parameters, the moments and the residuals of the state are then
    this rank's shards on it."""
    if hasattr(new_mesh, "barrier"):
        new_mesh.barrier()
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError("no checkpoint to re-mesh from")
    state = ckpt_lib.restore(ckpt_dir, step, state_like)
    if specs is not None:
        def cut(tree):
            return map_tree(lambda t, s: shard_leaf(t, s, new_mesh), tree, specs)
        state = dict(state, params=cut(state["params"]),
                     opt=state["opt"]._replace(m=cut(state["opt"].m), v=cut(state["opt"].v)))
        if "err" in state:
            state["err"] = cut(state["err"])
    return make_step_for_mesh(new_mesh), state, step
