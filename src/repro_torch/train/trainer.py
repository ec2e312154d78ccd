"""Fault-tolerant training loop: checkpoint/resume, straggler tracking,
bounded-restart recovery.  The counterpart of `repro/train/trainer.py`,
name for name.  The inner step is train/step.py's eager step; everything
here is host-side control."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpointer
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device, tensor_from
from repro_torch.launch import sharding as sharding_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.runtime.fault_tolerance import RestartPolicy, StragglerDetector
from repro_torch.train import step as train_step_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    async_checkpoint: bool = True
    seed: int = 0


class Trainer:
    """Trains on `device` (None: the card).  `shardings`: the state's layout
    on a mesh (`launch/sharding.state_shardings`), or None for plain tensors.
    With it, the fresh state is placed leaf by leaf as it says, every rank
    draws the same global batch and places it as `batch_shardings` says (so
    a resume's data cursor holds on any mesh), checkpoints are gathered and
    written by rank 0, and a resume restores onto these shardings."""

    def __init__(
        self,
        cfg: ModelConfig,
        api: ModelApi,
        hp: train_step_lib.TrainHParams,
        tc: TrainerConfig,
        data: DataConfig,
        *,
        shardings=None,
        fail_injector: Optional[Callable[[int], None]] = None,
        device: DeviceLike = None,
    ):
        self.cfg, self.api, self.hp, self.tc, self.data = cfg, api, hp, tc, data
        self.device = resolve_device(device)
        self.pipeline = SyntheticTokens(cfg, data)
        self.step_fn = train_step_lib.make_train_step(cfg, api, hp)
        self.straggler = StragglerDetector(n_hosts=data.n_hosts)
        self.restart = RestartPolicy()
        self.recoveries = 0          # total failures survived (never forgiven)
        self._success_streak = 0
        self.fail_injector = fail_injector
        self._ckpt_thread = None
        self.shardings = shardings
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def _fresh_state(self):
        state = train_step_lib.init_state(self.cfg, self.api, self.tc.seed, self.hp,
                                          device=self.device)
        if self.shardings is None:
            return state
        return sharding_lib.place_tree(state, self.shardings)

    def _batch(self, step: int) -> dict:
        batch = self.pipeline.batch(step)
        if self.shardings is None:
            return batch
        mesh = sharding_lib.leaves_of(self.shardings)[0].mesh
        tensors = {k: tensor_from(v).to(self.device) for k, v in batch.items()}
        placed = sharding_lib.batch_shardings(tensors, mesh, self.cfg.use_tp)
        return {k: sharding_lib.place(v, placed[k]) for k, v in tensors.items()}

    def _try_resume(self, state):
        if not self.tc.ckpt_dir:
            return state, 0
        last = checkpointer.latest_step(self.tc.ckpt_dir)
        if last is None:
            return state, 0
        state, manifest = checkpointer.restore(self.tc.ckpt_dir, last, state, self.shardings)
        return state, int(manifest["extra"]["data_step"])

    def _checkpoint(self, state, data_step: int):
        if not self.tc.ckpt_dir:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        self._ckpt_thread = checkpointer.save(
            self.tc.ckpt_dir, data_step, state,
            extra=dict(data_step=data_step, arch=self.cfg.arch_id),
            async_=self.tc.async_checkpoint,
        )
        checkpointer.prune(self.tc.ckpt_dir, keep=self.tc.ckpt_keep)

    # ------------------------------------------------------------------
    def run(self) -> list[dict]:
        """Train to total_steps, recovering from injected/real step failures
        via restore-from-checkpoint with bounded backoff."""
        state = self._fresh_state()
        state, step = self._try_resume(state)
        while step < self.tc.total_steps:
            try:
                # perf_counter, not time(): straggler detection compares
                # per-step durations across hosts, and a wall-clock (NTP)
                # step would record a negative or inflated step time
                t0 = time.perf_counter()
                if self.fail_injector is not None:
                    self.fail_injector(step)
                batch = self._batch(step)
                state, metrics = self.step_fn(state, batch)
                # reading the metrics waits for the device: dt is the step's
                rec = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.straggler.record(self.data.host_id, dt)
                step += 1
                if step % self.tc.log_every == 0 or step == self.tc.total_steps:
                    rec.update(step=step, seconds=dt)
                    self.history.append(rec)
                if self.tc.ckpt_dir and step % self.tc.ckpt_every == 0:
                    self._checkpoint(state, step)
                self._success_streak += 1
                if self._success_streak >= 100:  # forgive old failures slowly
                    self.restart.on_success_window()
                    self._success_streak = 0
            except (RuntimeError, FloatingPointError) as e:  # step failure
                if "restart budget" in str(e):
                    raise
                self.recoveries += 1
                self._success_streak = 0
                delay = self.restart.on_failure()
                time.sleep(min(delay, 0.01))  # bounded in tests
                state = self._fresh_state()
                state, step = self._try_resume(state)
        if self.tc.ckpt_dir:
            self._checkpoint(state, step)
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
        self.final_state = state
        return self.history
